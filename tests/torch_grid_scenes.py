"""Scenes of the grid tests (imported by tests/test_torch_grid*.py,
tests/test_torch_cuda.py and chip_smoke.py): the cornell box with one
procedural torus mesh instance, built number for number in both packages
from numpy, so the JAX reference and the port render the same triangles.
Only ``jax_cornell_torus`` imports the JAX package."""
import dataclasses

import numpy as np

TORUS = dict(center=(0.0, 0.25, -0.35), major=0.35, minor=0.12,
             axis=(0.0, 0.5, 0.866))


def torus_arrays(n_major: int, n_minor: int):
    """(v, vn) (2 n_major n_minor, 3, 3) float32: a torus of n_major x
    n_minor quads with per-vertex normals, each face wound as
    ``cornell_box`` winds its walls (cross(e2, e1) against the outward
    normal, which the single-sided test accepts from outside)."""
    a = np.asarray(TORUS["axis"], np.float64)
    a /= np.linalg.norm(a)
    u = np.cross(a, [1.0, 0.0, 0.0])
    u /= np.linalg.norm(u)
    w = np.cross(a, u)
    c = np.asarray(TORUS["center"], np.float64)
    big, small = TORUS["major"], TORUS["minor"]

    def vertex(i, j):
        th = 2.0 * np.pi * (i % n_major) / n_major
        ph = 2.0 * np.pi * (j % n_minor) / n_minor
        ring = np.cos(th) * u + np.sin(th) * w
        nrm = np.cos(ph) * ring + np.sin(ph) * a
        return c + big * ring + small * nrm, nrm

    v, vn = [], []
    for i in range(n_major):
        for j in range(n_minor):
            q = [vertex(i, j), vertex(i + 1, j), vertex(i + 1, j + 1),
                 vertex(i, j + 1)]
            for tri in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
                p = [x[0] for x in tri]
                n = [x[1] for x in tri]
                gn = np.cross(p[2] - p[0], p[1] - p[0])
                if np.dot(gn, n[0] + n[1] + n[2]) > 0:
                    p[1], p[2], n[1], n[2] = p[2], p[1], n[2], n[1]
                v.append(p)
                vn.append(n)
    return (np.asarray(v, np.float32), np.asarray(vn, np.float32))


def _with_mesh(types, scene, v, vn, material: int, **kw):
    tris = types.make_triangles(v, vn, np.full(v.shape[0], material,
                                               np.int32), **kw)
    b = tris.bounds()
    mesh = types.MeshInstance(tris=tris, bounds_min=b.pmin,
                              bounds_max=b.pmax)
    merged = scene.bounds.merge(b)
    return dataclasses.replace(scene, meshes=(mesh,),
                               bounds_min=merged.pmin,
                               bounds_max=merged.pmax)


def jax_cornell_torus(cols: int, rows: int, n_major: int = 16,
                      n_minor: int = 4):
    """The JAX package's cornell box plus the torus (material 4)."""
    from raytracing_tpu.core import types as jtypes
    from raytracing_tpu.models.scenes import cornell_box
    return _with_mesh(jtypes, cornell_box(cols=cols, rows=rows),
                      *torus_arrays(n_major, n_minor), 4)


def cornell_torus(cols: int, rows: int, n_major: int = 16, n_minor: int = 4,
                  device=None):
    """The port's cornell box plus the torus (material 4) on ``device``."""
    from raytracing_tpu_torch.core import types
    from raytracing_tpu_torch.models.scenes import cornell_box
    return _with_mesh(types, cornell_box(cols=cols, rows=rows, device=device),
                      *torus_arrays(n_major, n_minor), 4, device=device)


def miss_field(n_spheres: int, cols: int, rows: int, device=None):
    """The port's sphere_field(n_spheres) with its cloud moved 40 behind a
    camera at the origin that looks away from it (+z), its light kept and
    the scene box widened to hold the camera: every ray is live (mint 0),
    and every hypothesis of every segment, bounce and shadow ray has a
    factor of its soft coverage exactly 0 (the cloud lies 35 or more
    behind or beside each ray, the light's disk out of view), so kernel
    2s's warps see only empty span masks and every cotangent is 0."""
    import torch
    from raytracing_tpu_torch.core.types import (Camera, Lights, build_scene,
                                                 make_spheres)
    from raytracing_tpu_torch.models.scenes import sphere_field
    ref = sphere_field(n_spheres, cols=cols, rows=rows)
    rng = np.random.default_rng(7)  # sphere_field's seed and layout
    spread = 4.0
    centers = rng.uniform(-spread, spread, (n_spheres, 3)).astype(np.float32)
    radii = rng.uniform(0.15, 0.5, n_spheres).astype(np.float32)
    mats = rng.integers(0, 5, n_spheres).astype(np.int32)
    centers[:, 2] -= 40.0
    lights = Lights.make([[0.0, spread * 2.5, 0.0]], [[0.0, -1.0, 0.0]],
                         [[25.0, 25.0, 25.0]], [spread * 0.5])
    cam = Camera.look_at([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                         60.0, cols, rows)
    scene = build_scene(camera=cam, spheres=make_spheres(centers, radii,
                                                         mats),
                        lights=lights, materials=ref.materials,
                        focal_length=spread * 3.0, lens_diameter=0.0)
    return dataclasses.replace(
        scene, bounds_min=torch.full((3,), -60.0),
        bounds_max=torch.full((3,), 60.0)).to(device)
