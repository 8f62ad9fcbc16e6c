"""The reference's ten-assignment progression as ready-to-run model configs
(``raytracing_tpu.models.assignments``).

Each ``assignNN()`` returns ``(render_fn, args, cfg)`` such that
``render_fn(*args)`` gives an (H, W, 3) float image of that assignment's
capability:

  01  one sphere, primary rays, fake depth shade
  02  PDB molecule spheres, closest hit, CPK colours
  03  wavefront split: ray generation and trace as two stages
  04  triangle mesh + spheres through a shared maxt, direct shade
  05  AABB-gated traversal (scene-bounds ray clip): 04's pipeline
  06  1-D slab grid (an n x 1 x 1 grid), 07  3-D uniform grid: 04's scene
      through kernel 1's grid mode, direct shade, blocked layout of 64
  08  shadow rays, ambient + cosine shade (direct mode of kernel 1)
  09  thin-lens camera, stratified lens sampling (direct mode of kernel 1)
  10  progressive Monte Carlo path tracing (kernel 1)

Scenes are built on ``device`` (default: the card; tests pass "cpu", where
the kernels' plain versions run). Reference data files (PDB molecules, XML
scenes, mesh JSON) are read from the directory named by the environment
variable ``RT_REFERENCE_DIR`` when it is set and holds them; otherwise the
programmatic scenes of ``models/scenes.py`` stand in, as in the JAX package
when its reference directory is absent. ``scene_xml=`` of 07, 08 and 10
loads an XML scene (``io.scene_xml.load_scene``); 07 then grids each mesh
at ``mesh_slabs`` and renders in kernel 1's grid mode.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..accel import prepare_grids
from ..core.config import RenderConfig
from ..core.types import AABB, Camera, make_spheres
from ..io.pdb import load_pdb
from ..io.scene_xml import load_scene
from ..render.direct import render_direct
from ..render.pathtracer import image, init_state, render_passes
from ..render.simple import render_fake_shade
from .scenes import cornell_box


def _device(device):
    if device is None:
        from .. import default_device
        return default_device()
    return torch.device(device)


def _ref(path: str) -> str | None:
    root = os.environ.get("RT_REFERENCE_DIR")
    if not root:
        return None
    p = os.path.join(root, path)
    return p if os.path.exists(p) else None


def molecule_scene(name: str = "c60.pdb", cols: int = 512, rows: int = 512,
                   device=None):
    """(spheres, per-sphere colours, camera) from a reference PDB file, or
    the JAX package's synthetic fallback molecule; the camera is framed
    from the bounds."""
    dev = _device(device)
    path = _ref(f"Assign02-Multi_Sphere_Ray_Tracing/mol/{name}") \
        or _ref(f"Assign10-Path_Tracing/mol/{name}")
    if path:
        mol = load_pdb(path)
        spheres = make_spheres(mol.centers, mol.radii, device=dev)
        colors = torch.as_tensor(mol.colors[mol.color_ids], device=dev)
        bounds = AABB(pmin=torch.as_tensor(mol.bounds_min, device=dev),
                      pmax=torch.as_tensor(mol.bounds_max, device=dev))
    else:
        rng = np.random.default_rng(0)
        centers = rng.normal(size=(64, 3)).astype(np.float32) * 3
        radii = rng.uniform(0.6, 1.2, 64).astype(np.float32)
        spheres = make_spheres(centers, radii, device=dev)
        colors = torch.as_tensor(
            rng.uniform(0.2, 1.0, (64, 4)).astype(np.float32), device=dev)
        bounds = spheres.bounds()
    return spheres, colors, Camera.auto_frame(bounds, cols, rows)


def assign01(cols=512, rows=512, device=None):
    """Single hard-coded sphere, fake depth shade."""
    dev = _device(device)
    spheres = make_spheres([[0.0, 0.0, 0.0]], [0.5], device=dev)
    colors = torch.ones((1, 4), device=dev)
    cam = Camera.look_at([0, 0, 2], [0, 0, 0], [0, 1, 0], 60.0, cols, rows,
                         device=dev)
    return render_fake_shade, (cam, spheres, colors), RenderConfig(
        width=cols, height=rows)


def assign02(cols=512, rows=512, molecule="c60.pdb", device=None):
    spheres, colors, cam = molecule_scene(molecule, cols, rows, device)
    return render_fake_shade, (cam, spheres, colors), RenderConfig(
        width=cols, height=rows)


def assign03(cols=512, rows=512, molecule="c60.pdb", device=None):
    """Wavefront split: a ray-generation stage, then a trace stage reading
    its ray buffer (the Assign03 two-kernel structure)."""
    from ..core.types import dot3
    from ..ops.closest_hit import (closest_hit_spheres, palette_lookup,
                                   sphere_hit_attrs)
    from ..render.camera import pinhole_rays, pixel_grid

    spheres, colors, cam = molecule_scene(molecule, cols, rows, device)

    def gen_stage():
        col, row = pixel_grid(cam)
        return pinhole_rays(cam, col, row)

    def trace_stage(rays):
        ch = closest_hit_spheres(rays, spheres)
        _, n, _ = sphere_hit_attrs(rays, spheres, ch)
        shade = dot3(n, cam.w)
        rgb = palette_lookup(colors[:, :3], ch.idx) * shade[:, None]
        img = torch.where(ch.valid[:, None], rgb, 0.0)
        return img.reshape(cam.rows, cam.cols, 3)

    def run():
        return trace_stage(gen_stage())

    return run, (), RenderConfig(width=cols, height=rows)


def _mesh_scene(cols, rows, device, use_grid: bool = False, n_slabs=1):
    scene = cornell_box(cols=cols, rows=rows, device=_device(device))
    # the megakernel route, as in the JAX package (kernel 1's direct mode;
    # grid scenes in its grid mode with the blocked layout of 64)
    cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=0,
                       use_grid=use_grid, n_slabs=n_slabs,
                       use_megakernel=True, mega_block=64 if use_grid else 0)
    if use_grid:
        scene = prepare_grids(scene, n_slabs)
    return scene, cfg


def assign04(cols=512, rows=512, device=None):
    """Triangle mesh + spheres composed through a shared maxt; direct
    shade."""
    scene, cfg = _mesh_scene(cols, rows, device)
    return render_direct, (scene, cfg), cfg


def assign05(cols=512, rows=512, device=None):
    """AABB culling: 04's pipeline, every ray clipped to the scene AABB."""
    return assign04(cols, rows, device)


def assign06(cols=512, rows=512, n_slabs=8, device=None):
    """1-D slab acceleration: a true n x 1 x 1 grid, binning by x-extent
    and the walk stepping along x alone."""
    scene, cfg = _mesh_scene(cols, rows, device, use_grid=True,
                             n_slabs=(n_slabs, 1, 1))
    return render_direct, (scene, cfg), cfg


def assign07(cols=512, rows=512, n_slabs=4, scene_xml: str | None = None,
             mesh_slabs: int | str = "xml", device=None):
    """Full 3-D uniform grid DDA. ``scene_xml`` swaps in a mesh-instancing
    XML scene (e.g. cornell_teapot.xml): each mesh gets its own grid at its
    XML ``nslabs`` (``mesh_slabs="xml"``), at an int, or by the cost model
    ("auto"), and the walls stay brute force."""
    if scene_xml is not None:
        scene = prepare_grids(load_scene(scene_xml, cols, rows,
                                         _device(device)),
                              n_slabs, mesh_slabs=mesh_slabs)
        cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=0,
                           use_grid=True, n_slabs=n_slabs,
                           use_megakernel=True, mega_block=64)
        return render_direct, (scene, cfg), cfg
    scene, cfg = _mesh_scene(cols, rows, device, use_grid=True,
                             n_slabs=n_slabs)
    return render_direct, (scene, cfg), cfg


def assign08(cols=320, rows=240, scene_xml: str | None = None, device=None):
    """Point or disk lights, shadow rays and ambient + cosine shade: the
    XML scene ``scene_xml``, else the reference's cornell.xml where
    ``RT_REFERENCE_DIR`` holds it, else cornell."""
    if scene_xml is None:
        scene_xml = _ref("Assign08-Shadow_Tracing/scenes/cornell.xml")
    if scene_xml:
        scene = load_scene(scene_xml, cols, rows, _device(device))
    else:
        scene = cornell_box(cols=cols, rows=rows, device=_device(device))
    cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=0,
                       use_megakernel=True)
    return render_direct, (scene, cfg), cfg


def assign09(cols=320, rows=240, spp=4, focal_length=2.8,
             lens_diameter=0.25, device=None):
    """Thin-lens depth of field with stratified lens sampling."""
    scene = cornell_box(cols=cols, rows=rows, focal_length=focal_length,
                        lens_diameter=lens_diameter, device=_device(device))
    cfg = RenderConfig(width=cols, height=rows, spp=spp, bounces=0,
                       use_megakernel=True)
    return render_direct, (scene, cfg), cfg


def assign10(cols=320, rows=240, spp=1, bounces=5, passes=32,
             scene_xml: str | None = None, device=None):
    """Progressive Monte Carlo path tracing (the flagship pipeline)."""
    dev = _device(device)
    scene = (load_scene(scene_xml, cols, rows, dev) if scene_xml
             else cornell_box(cols=cols, rows=rows, device=dev))
    cfg = RenderConfig(width=cols, height=rows, spp=spp, bounces=bounces,
                       use_megakernel=True)

    def run():
        state = render_passes(scene, init_state(cfg, dev), cfg, passes)
        return image(state, cfg)

    return run, (), cfg


ALL = {f"assign{i:02d}": fn for i, fn in enumerate(
    [assign01, assign02, assign03, assign04, assign05, assign06, assign07,
     assign08, assign09, assign10], start=1)}
