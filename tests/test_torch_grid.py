"""The port's uniform grids against the JAX package: the build
(``accel/grid.py``, ``accel.prepare_grids``), carrying prepared scenes
across the packages, the DDA traversal (``accel/traverse.py``) and the
stage route's grid branch.

Same inputs on both sides, made with numpy (seeded AABBs and rays, the
cornell box with a 128-triangle torus mesh from ``torch_grid_scenes``).
Tolerances: the CSR arrays, grid resolutions, starts and item ids equal;
the traversal's champion ids equal to the brute-force search's on every
ray (rays along cell faces and through cell edges and corners included)
and its hit distances within 1e-5 of JAX's grid traversal; images and
accumulators of the stage route at rtol/atol 2e-4. The torus mesh gets an
explicit 3^3 grid (``auto_slabs(128)`` is 1, which would cross no cell).
"""
import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.accel import prepare_grids as jprepare
from raytracing_tpu.accel import traverse as jtraverse
from raytracing_tpu.accel.grid import _bin_csr_python
from raytracing_tpu.accel.grid import build_grid as jbuild_grid
from raytracing_tpu.io.png import read_png
from raytracing_tpu.models import scenes as jscenes
from raytracing_tpu.ops.pallas import megakernel as JMK
from raytracing_tpu.render import direct as jdirect
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig, cli
from raytracing_tpu_torch.accel import auto_slabs, prepare_grids
from raytracing_tpu_torch.accel import traverse
from raytracing_tpu_torch.accel.grid import bin_csr, build_grid
from raytracing_tpu_torch.core.types import Rays, scene_from_numpy, \
    scene_to_numpy
from raytracing_tpu_torch.ops import closest_hit as CH
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import direct
from raytracing_tpu_torch.render import pathtracer as pt
from torch_grid_scenes import jax_cornell_torus
from torch_threads import one_thread  # noqa: F401

W, H = 16, 12
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _boxes(case: str):
    """(lo, hi, pmin, pmax, n) of a seeded binning case."""
    g = np.random.default_rng(5)
    lo = g.uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    hi = lo + g.uniform(0.0, 0.6, (300, 3)).astype(np.float32)
    pmin, pmax = lo.min(0), hi.max(0)
    n = {"cubic": 3, "slab": (8, 1, 1), "anisotropic": (2, 3, 5),
         "degenerate": (4, 2, 3), "boundaries": 4}[case]
    if case == "degenerate":          # every box on the plane y = pmin.y
        lo[:, 1] = hi[:, 1] = pmin[1]
        pmax[1] = pmin[1]
    if case == "boundaries":          # corners on cell faces and edges
        w = (pmax - pmin) / 4
        k = g.integers(0, 5, (300, 3))
        lo = (pmin + k * w).astype(np.float32)
        hi = (lo + w * g.integers(0, 2, (300, 3))).astype(np.float32)
        pmax = np.maximum(pmax, hi.max(0))
    return lo, hi, pmin, pmax, n


@pytest.mark.parametrize("case", ["cubic", "slab", "anisotropic",
                                  "degenerate", "boundaries"])
def test_csr_equals_jax_binning(case):
    """The vectorised binning gives _bin_csr_python's offsets and payload
    exactly (ids ascending within a cell), and the dense table JAX's."""
    lo, hi, pmin, pmax, n = _boxes(case)
    offsets, payload = bin_csr(lo, hi, pmin, pmax, n)
    want_off, want_pay = _bin_csr_python(lo, hi, pmin, pmax, n)
    np.testing.assert_array_equal(offsets, want_off)
    np.testing.assert_array_equal(payload, want_pay)
    assert offsets.dtype == want_off.dtype and payload.dtype == np.int32
    g = build_grid(lo, hi, pmin, pmax, n)
    jg = jbuild_grid(lo, hi, pmin, pmax, n, use_native=False)
    np.testing.assert_array_equal(g.items.numpy(), np.asarray(jg.items))
    assert g.n == jg.n and g.max_per_cell == jg.max_per_cell


def _torus_pair(mesh_slabs=3, n_slabs=2, cols=W, rows=H):
    js = jprepare(jax_cornell_torus(cols, rows), n_slabs,
                  mesh_slabs=mesh_slabs)
    ps = prepare_grids(scene_from_numpy(scene_to_numpy(
        jax_cornell_torus(cols, rows))), n_slabs, mesh_slabs=mesh_slabs)
    return js, ps


def _csr(g):
    return g.cell_offsets.numpy(), g.item_indices.numpy()


@pytest.mark.parametrize("mesh_slabs", [3, "auto", "xml"])
def test_prepare_grids_matches_jax(mesh_slabs):
    """Per mesh grid: resolution, start and absolute item ids (JAX's kernel
    grid carried back to cell order by scene_to_numpy); the stage route's
    sphere, scene-triangle and mesh grids equal."""
    js, ps = _torus_pair(mesh_slabs)
    carried = scene_from_numpy(scene_to_numpy(js))
    assert len(ps.folded_tri_grid) == len(js.folded_tri_grid) == 1
    for g, jg, cg in zip(ps.folded_tri_grid, js.folded_tri_grid,
                         carried.folded_tri_grid):
        assert g.n == tuple(jg.n) and g.start == jg.start == 10
        for a, b in zip(_csr(g), _csr(cg)):
            np.testing.assert_array_equal(a, b)
        assert g.item_indices.min().item() >= 10
    want_n = {3: (3, 3, 3), "auto": (auto_slabs(128),) * 3,
              "xml": (2, 2, 2)}[mesh_slabs]
    assert ps.folded_tri_grid[0].n == want_n
    for key in ("sphere_grid", "triangle_grid"):
        for a, b in zip(_csr(getattr(ps, key)), _csr(getattr(carried, key))):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(_csr(ps.meshes[0].grid), _csr(carried.meshes[0].grid)):
        np.testing.assert_array_equal(a, b)
    assert ps.mega_sph_grid is None and js.mega_sph_grid is None


def test_prepare_grids_meshless_and_sphere_grid(monkeypatch):
    """cornell (no mesh): one kernel grid over the whole fold from 0; past
    the resident sphere budget (patched, as JAX's tests patch
    SMEM_TABLE_MAX) the kernel's sphere grid at auto_slabs of the spheres,
    equal to JAX's."""
    jc = jprepare(jscenes.cornell_box(cols=W, rows=H), 2)
    pc = prepare_grids(scene_from_numpy(scene_to_numpy(
        jscenes.cornell_box(cols=W, rows=H))), 2)
    (g,), (cg,) = pc.folded_tri_grid, \
        scene_from_numpy(scene_to_numpy(jc)).folded_tri_grid
    assert g.start == 0 and g.n == (2, 2, 2)
    for a, b in zip(_csr(g), _csr(cg)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(JMK, "SMEM_TABLE_MAX", 64)
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 8)
    jsf = jprepare(jscenes.sphere_field(300, cols=W, rows=H), 1)
    psf = prepare_grids(scene_from_numpy(scene_to_numpy(
        jscenes.sphere_field(300, cols=W, rows=H))), 1)
    cs = scene_from_numpy(scene_to_numpy(jsf)).mega_sph_grid
    assert psf.mega_sph_grid.n == cs.n == (auto_slabs(300),) * 3
    for a, b in zip(_csr(psf.mega_sph_grid), _csr(cs)):
        np.testing.assert_array_equal(a, b)


def test_scene_carries_meshes_and_grids():
    """scene_to_numpy / scene_from_numpy carry mesh instances and every
    grid; the port's own prepared scene round-trips unchanged, and the
    carried unprepared mesh scene folds the JAX package's triangles."""
    js, ps = _torus_pair()
    back = scene_from_numpy(scene_to_numpy(ps))
    assert len(back.meshes) == 1 and back.meshes[0].nslabs == 1
    np.testing.assert_array_equal(back.meshes[0].tris.v.numpy(),
                                  np.asarray(js.meshes[0].tris.v))
    for key in ("sphere_grid", "triangle_grid", "mega_sph_grid"):
        a, b = getattr(ps, key), getattr(back, key)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.n == b.n and a.start == b.start
            np.testing.assert_array_equal(a.pmin, b.pmin)
            for x, y in zip(_csr(a), _csr(b)):
                np.testing.assert_array_equal(x, y)
    for a, b in zip(ps.folded_tri_grid, back.folded_tri_grid):
        assert a.n == b.n and a.start == b.start
        np.testing.assert_array_equal(a.items.numpy(), b.items.numpy())
    from raytracing_tpu.render.stages import _all_triangles as jfold
    from raytracing_tpu_torch.render.stages import _all_triangles
    np.testing.assert_array_equal(_all_triangles(ps).v.numpy(),
                                  np.asarray(jfold(js).v))
    np.testing.assert_array_equal(ps.bounds_min.numpy(),
                                  np.asarray(js.bounds_min))


def _grid_rays(grid, n_random: int, seed: int):
    """Seeded rays through the grid, plus rays that run along cell faces
    (a zero direction component on a face plane) and rays through cell
    edges and corners (aimed at lattice points)."""
    g = np.random.default_rng(seed)
    pmin, pmax, n = grid.pmin, grid.pmax, np.asarray(grid.n)
    w = (pmax - pmin) / n
    ext = pmax - pmin
    o = g.uniform(pmin - ext, pmax + ext, (n_random, 3))
    tgt = g.uniform(pmin, pmax, (n_random, 3))
    # along faces: origin on a face plane, no motion across it
    k = g.integers(0, n + 1, (64, 3))
    face = pmin + k * w
    of = g.uniform(pmin - 0.2 * ext, pmax + 0.2 * ext, (64, 3))
    df = g.normal(size=(64, 3))
    ax = g.integers(0, 3, 64)
    of[np.arange(64), ax] = face[np.arange(64), ax]
    df[np.arange(64), ax] = 0.0
    # through lattice points (cell edges and corners)
    corner = pmin + g.integers(0, n + 1, (64, 3)) * w
    oc = corner + g.normal(size=(64, 3)) * ext
    o = np.concatenate([o, of, oc]).astype(np.float32)
    d = np.concatenate([tgt - o[:n_random], df,
                        corner - oc]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _rays(o, d):
    n = o.shape[0]
    return Rays(torch.as_tensor(o), torch.as_tensor(d), torch.zeros(n),
                torch.full((n,), float("inf")))


@pytest.mark.parametrize("kind", ["spheres", "triangles"])
def test_traversal_matches_brute_and_jax(kind):
    """The march's champion equals the brute-force search's on every ray
    (along faces and through edges and corners too), and JAX's grid
    traversal in validity and, within 1e-5, in t: sphere_field(200) in a
    3^3 sphere grid, the torus in a 3^3 grid over its bounds."""
    from raytracing_tpu.accel.grid import build_triangle_grid as jbuild_tri
    from raytracing_tpu.core.types import Rays as JRays
    from raytracing_tpu_torch.accel.grid import build_triangle_grid
    if kind == "spheres":
        jsc = jprepare(jscenes.sphere_field(200, cols=W, rows=H), 3)
        psc = scene_from_numpy(scene_to_numpy(jsc))
        grid, jgrid = psc.sphere_grid, jsc.sphere_grid
        obj, jobj = psc.spheres, jsc.spheres
        search, jsearch = (traverse.grid_closest_spheres,
                           jtraverse.grid_closest_spheres)
        brute = CH.closest_hit_spheres
    else:
        jsc = jax_cornell_torus(W, H)
        psc = scene_from_numpy(scene_to_numpy(jsc))
        jm, m = jsc.meshes[0], psc.meshes[0]
        grid = build_triangle_grid(m.tris, m.bounds_min, m.bounds_max, 3)
        jgrid = jbuild_tri(jm.tris, jm.bounds_min, jm.bounds_max, 3)
        obj, jobj = m.tris, jm.tris
        search, jsearch = (traverse.grid_closest_triangles,
                           jtraverse.grid_closest_triangles)
        brute = CH.closest_hit_triangles
    o, d = _grid_rays(grid, 3000, 1)
    got = search(_rays(o, d), obj, grid)
    want = brute(_rays(o, d), obj)
    n = o.shape[0]
    jwant = jsearch(JRays(o, d, np.zeros(n, np.float32),
                          np.full(n, np.inf, np.float32)), jobj, jgrid)
    assert got.valid.sum() > 200
    np.testing.assert_array_equal(got.idx.numpy(), want.idx.numpy())
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jwant.valid))
    v = got.valid.numpy()
    np.testing.assert_allclose(got.t.detach().numpy()[v],
                               np.asarray(jwant.t)[v], rtol=1e-5, atol=1e-5)


def test_march_visits_every_cell_a_ray_crosses():
    """A ray along the diagonal of a 4^3 grid passes exactly through cell
    corners: the walk visits the diagonal cells and the side cells of
    both crossing orders at each corner (counted apart from the walk's 4
    steps), and no cell twice."""
    g = build_grid(np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32),
                   np.zeros(3), np.ones(3), 4)
    o = torch.tensor([[-0.5, -0.5, -0.5]])
    d = torch.tensor([[1.0, 1.0, 1.0]]) / 3 ** 0.5
    seen = []

    def visit(cell, active):
        seen.extend(cell[active].tolist())
        return torch.full((1,), float("inf"))

    steps, side = traverse.march(o, d, torch.zeros(1),
                                 torch.full((1,), 9.0), g, visit)
    diag = [(k * 4 + k) * 4 + k for k in range(4)]
    assert all(c in seen for c in diag)
    assert steps.item() == 4 and side.item() == 3 * 6
    assert len(seen) == len(set(seen)) == steps.item() + side.item()


@pytest.mark.parametrize("renderer", ["direct", "path"])
def test_stage_route_grid_matches_jax(renderer):
    """use_grid on the stage route (use_megakernel=False): the torus scene's
    direct image, and one path pass b1 with the same draws, against the
    JAX package's grid pipeline (rtol/atol 2e-4)."""
    js, ps = _torus_pair(mesh_slabs=3, n_slabs=2)
    kw = dict(width=W, height=H, bounces=1, use_grid=True, n_slabs=2)
    jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
    if renderer == "direct":
        want = np.asarray(jdirect.render_direct(js, jcfg))
        got = direct.render_direct(ps, cfg).numpy()
    else:
        want = np.asarray(jpt._render_pass(js, jpt.init_state(jcfg),
                                           jcfg)["acc"])
        got = pt.render_pass(ps, pt.init_state(cfg, "cpu"), cfg)["acc"]
        got = got.detach().numpy()
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cli_grid_flags(tmp_path):
    """--grid, --mesh-slabs and --block render cornell in kernel 1's grid
    mode (its plain version on the CPU): the image render_direct gives."""
    out = str(tmp_path / "g.png")
    assert cli.main(["--cpu", "--width", "16", "--height", "12",
                     "--renderer", "direct", "--grid", "2", "--mesh-slabs",
                     "3", "--block", "4", "--passes", "1", "-o", out]) == 0
    scene = prepare_grids(cli.load_named_scene("cornell", 16, 12, "cpu"), 2,
                          mesh_slabs=3)
    want = direct.render_direct(scene, RenderConfig(
        width=16, height=12, use_grid=True, n_slabs=2, use_megakernel=True,
        mega_block=4))
    np.testing.assert_array_equal(
        read_png(out), (want.numpy() * 255 + 0.5).astype(np.uint8))
