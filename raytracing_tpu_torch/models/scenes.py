"""Programmatic scenes, numpy-built and number for number those of
``raytracing_tpu.models.scenes``: ``cornell_box``, ``big_mesh_scene`` (a
reference mesh JSON) and ``sphere_field``."""
from __future__ import annotations

import numpy as np

import torch

from ..core.types import AABB, Camera, Lights, Scene, build_scene, \
    make_spheres, make_triangles

# the reference's assignment folders that hold tri/ meshes, searched in
# this order under RT_REFERENCE_DIR
_MESH_DIRS = ("Assign07-3D_uniform_grid_acceleration",
              "Assign06-1D_uniform_slab_acceleration",
              "Assign05-Bounding_Box", "Assign04-Triangle_Mesh",
              "Assign10-Path_Tracing")


def _quad(p00, p10, p11, p01, normal):
    """Two triangles for a quad, consistent winding, shared normal."""
    v = np.asarray([(p00, p10, p11), (p00, p11, p01)], np.float32)
    n = np.broadcast_to(np.asarray(normal, np.float32), (2, 3, 3)).copy()
    return v, n


def cornell_box(cols: int = 320, rows: int = 240,
                sphere_center=(-0.4, -0.55, 0.2), sphere_radius=0.45,
                sphere2_center=(0.45, -0.65, -0.3), sphere2_radius=0.35,
                light_irradiance=(5.0, 5.0, 5.0), light_radius=0.25,
                focal_length=2.8, lens_diameter=0.0,
                device="cpu") -> Scene:
    """2-unit Cornell box: 10 wall triangles wound to face inward, two
    spheres, five materials and one ceiling disk light."""
    s = 1.0
    eps = 0.01
    quads = [
        # back wall (z = -s), normal +z
        _quad([-s, -s, -s + eps], [s, -s, -s + eps],
              [s, s, -s + eps], [-s, s, -s + eps], [0, 0, 1]),
        # floor (y = -s), normal +y
        _quad([-s, -s + eps, s], [s, -s + eps, s],
              [s, -s + eps, -s], [-s, -s + eps, -s], [0, 1, 0]),
        # ceiling (y = +s), normal -y
        _quad([-s, s - eps, -s], [s, s - eps, -s],
              [s, s - eps, s], [-s, s - eps, s], [0, -1, 0]),
        # left wall (x = -s), red, normal +x
        _quad([-s + eps, -s, s], [-s + eps, -s, -s],
              [-s + eps, s, -s], [-s + eps, s, s], [1, 0, 0]),
        # right wall (x = +s), green, normal -x
        _quad([s - eps, -s, -s], [s - eps, -s, s],
              [s - eps, s, s], [s - eps, s, -s], [-1, 0, 0]),
    ]
    v = np.concatenate([q[0] for q in quads])
    n = np.concatenate([q[1] for q in quads])
    # materials: 0 white, 1 red, 2 green, 3 blue, 4 yellow
    materials = np.array([
        [1.0, 1.0, 1.0, 1.0],
        [0.9, 0.2, 0.2, 1.0],
        [0.2, 0.9, 0.2, 1.0],
        [0.255, 0.412, 0.882, 1.0],
        [0.9, 0.9, 0.1, 1.0],
    ], np.float32)
    tri_mats = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 2], np.int32)
    # single-sided test accepts div = dot(cross(e2, e1), d) > 0, so
    # cross(e2, e1) must be anti-parallel to the outward normal
    for i in range(v.shape[0]):
        gn = np.cross(v[i, 2] - v[i, 0], v[i, 1] - v[i, 0])
        if np.dot(gn, n[i, 0]) > 0:
            v[i] = v[i, ::-1]

    triangles = make_triangles(v, n, tri_mats)
    spheres = make_spheres([sphere_center, sphere2_center],
                           [sphere_radius, sphere2_radius], [3, 4])
    lights = Lights.make([[0.0, 0.85, 0.0]], [[0.0, -1.0, 0.0]],
                         [list(light_irradiance)], [light_radius])
    cam = Camera.look_at([0.0, 0.0, 2.6], [0.0, -0.1, 0.0], [0.0, 1.0, 0.0],
                         60.0, cols, rows)
    return build_scene(camera=cam, spheres=spheres, triangles=triangles,
                       lights=lights, materials=materials,
                       focal_length=focal_length,
                       lens_diameter=lens_diameter).to(device)


def big_mesh_scene(name: str = "house_of_parliament.json",
                   cols: int = 512, rows: int = 512, device=None) -> Scene:
    """A reference mesh JSON (house_of_parliament.json: 5,322 triangles)
    from ``tri/`` of the reference's assignment folders under
    ``RT_REFERENCE_DIR``, normalised to the unit cube, one overhead disk
    light, the camera framed on its bounds; raises FileNotFoundError when
    no folder holds it. Past kernel 1's resident budget its triangles
    stream. ``device``: None is ``default_device()``, the card."""
    from ..io.mesh_json import load_mesh_json, normalize_unit_cube
    from .assignments import _device, _ref

    path = next((p for p in (_ref(f"{d}/tri/{name}") for d in _MESH_DIRS)
                 if p), None)
    if path is None:
        raise FileNotFoundError(name)
    dev = _device(device)
    md = normalize_unit_cube(load_mesh_json(path))
    tris = make_triangles(md.positions, md.normals, md.material_indices)
    lights = Lights.make([[0.0, 2.5, 0.0]], [[0.0, -1.0, 0.0]],
                         [[8.0, 8.0, 8.0]], [0.8])
    bounds = AABB(pmin=torch.as_tensor(md.bounds_min),
                  pmax=torch.as_tensor(md.bounds_max))
    return build_scene(camera=Camera.auto_frame(bounds, cols, rows),
                       triangles=tris, lights=lights,
                       materials=md.materials, focal_length=2.0,
                       lens_diameter=0.0).to(dev)


def sphere_field(n_spheres: int, cols: int = 512, rows: int = 512,
                 seed: int = 7, spread: float = 4.0,
                 device="cpu") -> Scene:
    """Random sphere cloud with one overhead light, camera aimed at it."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_spheres, 3)).astype(np.float32)
    radii = rng.uniform(0.15, 0.5, n_spheres).astype(np.float32)
    mats = rng.integers(0, 5, n_spheres).astype(np.int32)
    materials = np.array([
        [0.9, 0.3, 0.3, 1.0], [0.3, 0.9, 0.3, 1.0], [0.3, 0.3, 0.9, 1.0],
        [0.9, 0.9, 0.3, 1.0], [0.9, 0.9, 0.9, 1.0]], np.float32)
    spheres = make_spheres(centers, radii, mats)
    lights = Lights.make([[0.0, spread * 2.5, 0.0]], [[0.0, -1.0, 0.0]],
                         [[25.0, 25.0, 25.0]], [spread * 0.5])
    cam = Camera.look_at([0.0, 0.0, spread * 3.0], [0.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0], 60.0, cols, rows)
    return build_scene(camera=cam, spheres=spheres, lights=lights,
                       materials=materials, focal_length=float(spread * 3.0),
                       lens_diameter=0.0).to(device)
