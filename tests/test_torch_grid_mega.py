"""Kernel 1's grid mode (``ops/megakernel.py`` with ``grid``; its plain
version here, the CUDA kernel on the card in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``) against the JAX package and against the port's
own brute-force route, and the blocked layout.

Scenes: the cornell box with a 128-triangle torus mesh (16 x 4 segments,
its kernel grid 3^3 over the mesh, the walls the brute prefix) and
sphere_field(300) with the resident sphere budget patched, so that its
sphere grid is on. Tolerances: against JAX's interpret-mode grid kernel
(render_direct_mega, and one path pass b1 through render_pass_mega on the
same draws) rtol/atol 2e-4; against the port's brute route every
champion id and occlusion bit equal and the accumulator within 1e-6
(each gridded item gets the brute loops' arithmetic and the least (t, id)
pair wins, so the two are equal). JAX's interpret-mode grid kernel is
slow on the CPU (~30 s for the direct image at 16x12, ~70 s for a path
pass b1), so the JAX comparisons run at 12x8.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.accel import prepare_grids as jprepare
from raytracing_tpu.models import scenes as jscenes
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.accel.grid import build_grid
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from raytracing_tpu_torch.render.direct import render_direct
from torch_grid_scenes import jax_cornell_torus

W, H = 12, 8
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _cfg(cls, **kw):
    return cls(**{**dict(width=W, height=H, bounces=1, use_grid=True,
                         n_slabs=2, use_megakernel=True), **kw})


@pytest.fixture(scope="module")
def torus():
    """(JAX scene, port scene), both prepared with a 3^3 mesh grid."""
    js = jprepare(jax_cornell_torus(W, H), 2, mesh_slabs=3)
    ps = prepare_grids(scene_from_numpy(scene_to_numpy(
        jax_cornell_torus(W, H))), 2, mesh_slabs=3)
    assert ps.folded_tri_grid[0].n == (3, 3, 3)
    return js, ps


def test_grid_direct_matches_jax_kernel(torus):
    """render_direct in grid mode (kernel 1's direct mode) against JAX's
    render_direct_mega in its interpret-mode grid kernel."""
    js, ps = torus
    want = np.asarray(jmega.render_direct_mega(js, _cfg(JaxConfig, bounces=0),
                                               interpret=True))
    got = render_direct(ps, _cfg(RenderConfig, bounces=0)).numpy()
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_grid_path_pass_matches_jax_kernel(torus):
    """One path pass b1 through render_pass_mega in grid mode, the same
    u-planes, against JAX's interpret-mode grid kernel."""
    js, ps = torus
    jcfg, cfg = _cfg(JaxConfig), _cfg(RenderConfig)
    ju = jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], 0, jcfg,
                                 js.lights.count)
    want = np.asarray(jmega.render_pass_mega(js, jpt.init_state(jcfg), jcfg,
                                             u_planes=ju,
                                             interpret=True)["acc"])
    got = mega.render_pass_mega(ps, pt.init_state(cfg, "cpu"), cfg,
                                u_planes=torch.as_tensor(np.array(ju)))
    np.testing.assert_allclose(got["acc"].numpy(), want, rtol=TOL, atol=TOL)


def _tables(scene, cfg):
    return mega.scene_tables(scene, cfg)


def _pass(scene, cfg, grid, work=None):
    """The plain pass with its record on the pass-0 u-planes: (acc, ids,
    occs)."""
    tables = _tables(scene, cfg)
    u = mega.u_planes_for_pass(pt.init_state(cfg, "cpu")["key"], 0, cfg,
                               scene.lights.count)
    return MK.pathtrace_pass_reference(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((cfg.total_rays, 3)), u, spp=cfg.spp, width=cfg.width,
        bounces=cfg.bounces, two_sided=cfg.two_sided_triangles,
        normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
        russian_roulette=cfg.russian_roulette,
        rr_start_depth=cfg.rr_start_depth, record=True, grid=grid, work=work)


def _assert_equal_route(got, want):
    acc, ids, occs = got
    wacc, wids, woccs = want
    assert (ids >= 0).any()
    np.testing.assert_array_equal(ids.numpy(), wids.numpy())
    np.testing.assert_array_equal(occs.numpy(), woccs.numpy())
    np.testing.assert_allclose(acc.numpy(), wacc.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["path", "roulette", "direct"])
def test_grid_mode_equals_brute_route(torus, mode):
    """Grid mode against the brute route over the same tables (the plain
    version; the brute kernel keeps at most 64 triangles): every id and
    bit equal (the record names original rows), acc within 1e-6; 24x16
    b2, the roulette from depth 1. Direct mode on the image."""
    _, ps = torus
    kw = dict(width=24, height=16, bounces=2, use_grid=True,
              use_megakernel=True)
    if mode == "roulette":
        kw.update(russian_roulette=True, rr_start_depth=1)
    cfg = RenderConfig(**kw)
    grid = mega.grid_tables(ps)
    if mode == "direct":
        cfg = replace(cfg, bounces=0)
        tables = _tables(ps, cfg)
        key = torch.as_tensor(np.array([0, 7], np.uint32))
        u = mega.u_planes_for_direct(key, cfg, ps.lights.count)
        got, want = (MK.direct_pass_reference(
            *tables, torch.zeros((cfg.total_rays, 3)), u, key=key, spp=1,
            width=24, two_sided=False, grid=g) for g in (grid, None))
        assert got.max() > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        return
    work = {}
    _assert_equal_route(_pass(ps, cfg, grid, work), _pass(ps, cfg, None))
    # the walk reached the mesh's items: fewer tests than brute force
    assert 0 < int(work["tri_tests"]) and int(work["cells"]) > 0
    assert work["tri_tests"] <= work["tri_tests_raw"]


@pytest.mark.parametrize("mode", ["path", "direct"])
def test_sphere_grid_equals_brute_route(monkeypatch, mode):
    """The kernel's sphere grid (sphere_field(300), the resident budget
    patched to 64 as JAX's test patches SMEM_TABLE_MAX) against the brute
    route: every id and bit equal, acc within 1e-6 (24x16 b1)."""
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    ps = scene_from_numpy(scene_to_numpy(
        jscenes.sphere_field(300, cols=24, rows=16)))
    ps = prepare_grids(ps, 1)
    assert ps.mega_sph_grid is not None and ps.mega_sph_grid.n == (2, 2, 2)
    cfg = RenderConfig(width=24, height=16, bounces=1, use_grid=True,
                       use_megakernel=True)
    grid = mega.grid_tables(ps)
    assert grid.tri == () and grid.sph is ps.mega_sph_grid
    if mode == "direct":
        got = render_direct(ps, replace(cfg, bounces=0))
        monkeypatch.undo()
        want = render_direct(ps, replace(cfg, bounces=0, use_grid=False))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        return
    work = {}
    _assert_equal_route(_pass(ps, cfg, grid, work), _pass(ps, cfg, None))
    assert int(work["sph_tests"]) < 300 * cfg.total_rays


def test_grid_work_counts_each_item_once_per_walk():
    """The plain walk's work counts (the grid-mode bound): one sphere
    binned into all 4 cells of a (4, 1, 1) grid, two rays along x that
    miss it; each walk takes 4 steps and tests the sphere 4 times, but
    only once per ray is it a distinct test."""
    g = build_grid(np.zeros((1, 3), np.float32),
                   np.array([[4.0, 1.0, 1.0]], np.float32), np.zeros(3),
                   np.array([4.0, 1.0, 1.0]), (4, 1, 1))
    sph = torch.tensor([[2.0, 0.5, 0.5, 0.3, 0.0, 1.0, 0.0, 0.0]])
    o = torch.tensor([[-1.0, 0.95, 0.95], [-1.0, 0.05, 0.95]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    work = {}
    out = MK._trace(o, d, torch.zeros(2), torch.full((2,), 100.0), sph,
                    torch.zeros((0, MK.TRI_COLS)), False,
                    MK.KernelGrids(tri=(), sph=g, start=0, rows=(1, 0)), work)
    assert (out[-1] == -1).all()
    assert work == {"cells": 8, "side_cells": 0, "sph_tests_raw": 8,
                    "sph_tests": 2}


def test_blocked_layout_is_bit_equal(torus):
    """mega_block only maps the kernel's threads to pixels: the image of
    B = 4 equals that of B = 0 bit for bit (on the CPU the plain version,
    which ignores it; on the card tests/test_torch_cuda.py); B = 64 does
    not tile 48x36, so it runs row-major there (JAX's _effective_block).
    Without use_grid the torus scene's 138 triangles stream, whose blocked
    layout tests/test_torch_stream.py checks; a scene of resident tables
    takes the block and keeps the row-major map: the same image."""
    _, ps = torus
    cfg = _cfg(RenderConfig, bounces=0)
    img0 = render_direct(ps, cfg)
    img4 = render_direct(ps, replace(cfg, mega_block=4))
    assert torch.equal(img0, img4)
    st0 = pt.render_pass(ps, pt.init_state(cfg, "cpu"),
                         replace(cfg, bounces=1))
    st4 = pt.render_pass(ps, pt.init_state(cfg, "cpu"),
                         replace(cfg, bounces=1, mega_block=4))
    assert torch.equal(st0["acc"], st4["acc"])
    assert mega.effective_block(RenderConfig(width=48, height=36,
                                             mega_block=64)) == 0
    brute = replace(cfg, use_grid=False)
    assert torch.equal(render_direct(_cornell(), replace(brute, mega_block=4)),
                       render_direct(_cornell(), brute))
    assert mega.effective_block(replace(cfg, mega_block=4)) == 4


def _cornell():
    """The port's cornell box at W x H: 10 resident triangles."""
    return scene_from_numpy(scene_to_numpy(jscenes.cornell_box(cols=W,
                                                               rows=H)))


def test_wrapper_rejects_bad_grids_and_blocks(torus):
    _, ps = torus
    cfg = _cfg(RenderConfig, bounces=0)
    tables = _tables(ps, cfg)
    grid = mega.grid_tables(ps)
    acc = torch.zeros((cfg.total_rays, 3))
    kw = dict(key=torch.zeros(2, dtype=torch.int32), spp=1, width=W,
              two_sided=False)
    with pytest.raises(ValueError, match="tile"):
        MK.direct_pass(*tables, acc, None, block=5, grid=grid, **kw)
    many = grid._replace(tri=grid.tri * (MK.GRIDS_MAX + 1))
    with pytest.raises(ValueError, match="grids"):
        MK.direct_pass(*tables, acc, None, grid=many, **kw)
    g0 = grid.tri[0]
    bad = grid._replace(tri=(dataclasses.replace(
        g0, cell_offsets=g0.cell_offsets.long()),))
    with pytest.raises(ValueError, match="int32"):
        MK.direct_pass(*tables, acc, None, grid=bad, **kw)
    # a brute prefix past the resident budget still raises
    with pytest.raises(ValueError, match="resident"):
        MK.direct_pass(*tables, acc, None, grid=grid._replace(start=65),
                       **kw)
    # JAX's grid-mode training runs kernel 2 over duplicated rows; the
    # port's kernel 2 replays over the grids and the scene's own rows
    assert mega.bwd_impl_for(ps, replace(cfg, mega_bwd_impl="pallas")) \
        == "pallas"
