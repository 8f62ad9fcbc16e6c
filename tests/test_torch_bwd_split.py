"""Kernel 2 past 64 objects per type as a record and a sweep
(``MKG.pathtrace_pass_bwd_split``): kernel 1's uncontracted recording
instance writes the pass's champions and occlusion bits, then kernel 3
sweeps that record over the whole tables. On CPU tensors both pieces are
their plain versions (``MK.pathtrace_pass_reference`` /
``MK.direct_pass_reference`` recording over the forward's own streamed
chunks or grids, then ``pathtrace_pass_bwd_champ_reference``), so these
tests run the composition's wiring.

* The split against kernel 2's plain version
  (``pathtrace_pass_bwd_reference``, the brute forward under autograd) on
  the same tables, u-planes and seeded cotangent, all five groups, in path
  mode, with the roulette (from depth 1) and in direct mode, over
  sphere_field(130) (resident spheres), the cornell + torus scene's 138
  triangles streamed (its record names original rows through the Morton
  order), the same torus in its mesh grid and sphere_field(300) in its
  3^3 sphere grid (the resident budget patched to 64), at 16x12 b2.
* The split on the resident and streamed tables against JAX's
  ``_bwd_reference`` over the brute tables (the least (t, id) champion on
  both sides), in path and direct mode (the roulette's plain backward is
  held to JAX's in ``tests/test_torch_rr.py``).
* The routing: ``pathtrace_pass_bwd`` sends what ``large_route`` names to
  the split on the card and still raises on CPU tensors.

Tolerances (``tests/test_torch_bwd_large.py``'s): both sides in float64
(JAX under ``jax_enable_x64``), per group cosine >= 0.9999 and max |d| <=
1e-3 of the group's largest entry; a grazing sphere hit's discriminant
cancels in float32, where the hard gradient ~1/sqrt(dis) is largest.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.core import rng as jrng
from raytracing_tpu.models.scenes import sphere_field as jax_sphere_field
from raytracing_tpu.ops.pallas.megakernel_grad import _bwd_reference
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.accel.grid import build_sphere_grid
from raytracing_tpu_torch.models import scenes
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_grid_scenes import cornell_torus, jax_cornell_torus
from torch_threads import one_thread  # noqa: F401

W, H, B = 16, 12, 2
TORUS = (16, 4)          # 128 faces + cornell's 10 walls: 138 triangles
N_SPHERES = 130
GRID_SPHERES = 300
RR_START = 1
GRAD_SEED = 3
MODES = ("path", "rr", "direct")
SCENES = ("resident", "streamed", "mesh-grid", "sphere-grid")


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _cfg(mode: str, grid: bool = False) -> RenderConfig:
    return RenderConfig(width=W, height=H,
                        bounces=0 if mode == "direct" else B,
                        russian_roulette=mode == "rr",
                        rr_start_depth=RR_START, use_megakernel=True,
                        use_grid=grid)


def _kw(cfg: RenderConfig, mode: str) -> dict:
    return dict(spp=1, width=W, bounces=cfg.bounces, two_sided=False,
                normalize_emitter=True, seed=cfg.seed,
                russian_roulette=cfg.russian_roulette,
                rr_start_depth=cfg.rr_start_depth,
                mode="direct" if mode == "direct" else "path")


def _scene(name: str, monkeypatch):
    if name == "resident":
        return scenes.sphere_field(N_SPHERES, cols=W, rows=H)
    if name == "streamed":
        return cornell_torus(W, H, *TORUS)
    if name == "mesh-grid":
        return prepare_grids(cornell_torus(W, H, *TORUS), 2, mesh_slabs=3)
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    sc = prepare_grids(scenes.sphere_field(GRID_SPHERES, cols=W, rows=H), 1)
    return dataclasses.replace(sc, mega_sph_grid=build_sphere_grid(
        sc.spheres, sc.sphere_bounds_min, sc.sphere_bounds_max, 3))


def _u_planes(cfg: RenderConfig, mode: str, n_lights: int) -> torch.Tensor:
    if mode == "direct":
        ipar = torch.zeros(2, dtype=torch.int32)
        return mega.u_planes_for_direct(MK.pass_key_of(ipar, cfg.seed), cfg,
                                        n_lights)
    return mega.u_planes_for_pass(pt.init_state(cfg, "cpu")["key"], 0, cfg,
                                  n_lights)


def _grad_gate(name, got, want):
    a = np.asarray(want, np.float64).ravel()
    b = np.asarray(got, np.float64).ravel()
    assert np.isfinite(b).all(), name
    scale = np.abs(a).max()
    assert scale > 0, name
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.9999, (name, cos)
    assert np.abs(a - b).max() <= 1e-3 * scale, (name, np.abs(a - b).max(),
                                                 scale)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCENES)
def test_split_matches_plain_kernel2(name, mode, monkeypatch):
    """The record over the forward's own streamed chunks or grids, then the
    plain sweep, against the brute plain backward in float64: every group
    the scene has rows of, at the module's gates."""
    sc = _scene(name, monkeypatch)
    cfg = _cfg(mode, grid=name.endswith("grid"))
    t32 = mega.scene_tables(sc, cfg)
    t = [x.double() for x in t32]
    grid = mega.grid_tables(sc, t[1], t[2]) if cfg.use_grid else None
    chunks = mega.chunk_tables(sc, cfg, t[1], t[2])
    assert (grid is not None, chunks is not None) == (
        name.endswith("grid"), name == "streamed")
    if name == "sphere-grid":
        assert grid.sph is not None and not grid.tri
    assert MKG.large_route(t[1], t[2], grid, chunks)
    ipar = torch.zeros(2, dtype=torch.int32)
    u = _u_planes(cfg, mode, sc.lights.count).double()
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(W * H, 3)))
    kw = _kw(cfg, mode)
    want = MKG.pathtrace_pass_bwd_reference(t[0], ipar, *t[1:], g, u, **kw)
    large = MKG.large_launches
    got = MKG.pathtrace_pass_bwd_split(t[0], ipar, *t[1:], g, u, grid=grid,
                                       chunks=chunks, **kw)
    assert MKG.large_launches == large      # the CPU launches nothing
    for n, a, b in zip(MKG.DIFF_ALL, want, got):
        assert b.shape == a.shape and b.dtype == torch.float64, n
        if a.numel():
            _grad_gate(n, b.numpy(), a.numpy())


def _jax_inputs(name: str, mode: str):
    """JAX's tables over the brute rows, its u-planes and the cotangent."""
    js = (jax_sphere_field(N_SPHERES, cols=W, rows=H) if name == "resident"
          else jax_cornell_torus(W, H, *TORUS))
    jcfg = JaxConfig(width=W, height=H,
                     bounces=0 if mode == "direct" else B,
                     russian_roulette=mode == "rr", rr_start_depth=RR_START)
    tables = [np.asarray(t, np.float64)
              for t in jmega.scene_tables(js, jcfg)]
    if mode == "direct":
        key = jrng.pass_key(jrng.base_key(jcfg.seed), 0)
        u = jmega.u_planes_for_direct(key, jcfg, js.lights.count)
    else:
        u = jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], 0, jcfg,
                                    js.lights.count)
    g = np.random.default_rng(GRAD_SEED).normal(size=(W * H, 3))
    return jcfg, tables, np.asarray(u, np.float64), g


@pytest.mark.parametrize("mode", ["path", "direct"])
@pytest.mark.parametrize("name", ["resident", "streamed"])
def test_split_past_64_matches_jax(name, mode):
    """The split (the streamed torus recorded over its Morton chunks)
    against JAX's _bwd_reference over the brute tables, all five groups in
    float64: both pick the least (t, id) champion."""
    jcfg, tables, u, g = _jax_inputs(name, mode)
    cfg = _cfg(mode)
    kw = _kw(cfg, mode)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = [np.asarray(x) for x in _bwd_reference(
            tables[0], np.zeros(2, np.int32), *tables[1:], g, u,
            **{k: v for k, v in kw.items() if k != "seed"},
            seed=jcfg.seed)]
    finally:
        jax.config.update("jax_enable_x64", x64)
    sc = (scenes.sphere_field(N_SPHERES, cols=W, rows=H)
          if name == "resident" else cornell_torus(W, H, *TORUS))
    t = [torch.tensor(x) for x in tables]   # JAX's arrays are read-only
    chunks = mega.chunk_tables(sc, cfg, t[1], t[2])
    assert (chunks is not None) == (name == "streamed")
    got = MKG.pathtrace_pass_bwd_split(
        t[0], torch.zeros(2, dtype=torch.int32), *t[1:], torch.as_tensor(g),
        torch.tensor(u), chunks=chunks, **kw)
    for n, a, b in zip(MKG.DIFF_ALL, want, got):
        if b.numel():
            assert b.shape == a.shape, n
            _grad_gate(n, b.numpy(), a)


def test_kernel2_routes_past_64_to_the_split():
    """``pathtrace_pass_bwd`` takes CUDA tensors only, at any size; past 64
    objects (``large_route``) it is the split, whose CPU run is the plain
    record and sweep; the split without a group computes nothing."""
    sc = scenes.sphere_field(80, cols=8, rows=6)
    cfg = RenderConfig(width=8, height=6, bounces=1, use_megakernel=True)
    t = mega.scene_tables(sc, cfg)
    ipar = torch.zeros(2, dtype=torch.int32)
    g = torch.ones((48, 3))
    kw = dict(spp=1, width=8, bounces=1, two_sided=False,
              normalize_emitter=True, seed=0)
    assert MKG.large_route(t[1], t[2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        MKG.pathtrace_pass_bwd(t[0], ipar, *t[1:], g, None, **kw)
    got = MKG.pathtrace_pass_bwd_split(t[0], ipar, *t[1:], g, None, **kw)
    want = MKG.pathtrace_pass_bwd_reference(t[0], ipar, *t[1:], g, None,
                                            **kw)
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    none = MKG.pathtrace_pass_bwd_split(t[0], ipar, *t[1:], g, None,
                                        diff_wrt=(), **kw)
    assert not any(x.any() for x in none)
