"""The differentiable direct pass (``mode="direct"``) against the JAX
package, and the blocked layout and ray offset repairs that came with it.

Each backward case holds the port's plain version against JAX on the same
packed tables, the same ``u_planes_for_direct`` draws and a seeded numpy
cotangent: kernel 2's (``pathtrace_pass_bwd_reference(mode="direct")``)
against ``_bwd_reference(mode="direct")`` on cornell at spp 1 and at spp 4
through a lens of diameter 0.25 (config 4), on sphere_field(80) and on
the torus scene over its streamed Morton chunks; kernel 3's
(``pathtrace_pass_bwd_champ_reference``) on the plain record against
``_bwd_champion(mode="direct")`` on the same record; the plain record
against JAX's ``record=True`` direct record (the soft program's direct
mode: ``tests/test_torch_direct_soft.py``). Then the routes of
``pathtrace_pass_diff(mode="direct")`` on CPU tensors, a finite-gradient
probe, and the repairs: the ray offset in direct mode and the blocked
layout on brute tables. The CUDA kernels are held to these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 23).

Tolerances: cotangents within 1e-3 of each group's largest entry (as
``tests/test_torch_megakernel_grad.py``; measured <= 1.3e-6 on these
inputs); records: every champion id equal and at most 1% of the occlusion
bits apart (measured: none).
"""
import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.core import rng as jrng
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.models.scenes import sphere_field as jax_sphere_field
from raytracing_tpu.ops.pallas import megakernel as JMK
from raytracing_tpu.ops.pallas.megakernel_grad import (_bwd_champion,
                                                       _bwd_reference)
from raytracing_tpu.render import mega as jmega
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.ops import megakernel_soft as MKS
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_grid_scenes import cornell_torus, jax_cornell_torus
from torch_threads import one_thread  # noqa: F401

GRAD_SEED = 5
PASS = 3               # the differentiable pass's index (its draws' key)
BW = 2e-2              # soft bandwidth and tau
# (width, height, spp, lens diameter, scene): config 2's pinhole, config
# 4's thin lens, a sphere table past 64 rows, the torus scene streamed
CASES = {"cornell": (16, 12, 1, 0.0, "cornell"),
         "cornell_spp4_lens": (8, 6, 4, 0.25, "cornell"),
         "spheres80": (8, 6, 1, 0.0, "spheres"),
         "torus_streamed": (8, 6, 1, 0.0, "torus")}


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _kw(w: int, spp: int) -> dict:
    # bounces are ignored in direct mode, as JAX ignores them
    return dict(spp=spp, width=w, bounces=5, two_sided=False,
                normalize_emitter=False, seed=0)


def _inputs(name: str):
    """(JAX scene, port scene, numpy tables, numpy u-planes, numpy g)."""
    w, h, spp, lens, kind = CASES[name]
    if kind == "cornell":
        js = cornell_box(cols=w, rows=h, lens_diameter=lens)
    elif kind == "spheres":
        js = jax_sphere_field(80, cols=w, rows=h)
    else:
        js = jax_cornell_torus(w, h)
    ps = (cornell_torus(w, h) if kind == "torus"
          else scene_from_numpy(scene_to_numpy(js)))
    jcfg = JaxConfig(width=w, height=h, spp=spp)
    tables = [np.asarray(t) for t in jmega.scene_tables(js, jcfg)]
    key = jrng.pass_key(jrng.base_key(0), PASS)
    u = np.asarray(jmega.u_planes_for_direct(key, jcfg, js.lights.count))
    g = np.random.default_rng(GRAD_SEED).normal(
        size=(jcfg.total_rays, 3)).astype(np.float32)
    return js, ps, tables, u, g


def _port(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _grad_gate(name, got, want, rel=1e-3, cos_min=None):
    a, b = want.astype(np.float64).ravel(), got.astype(np.float64).ravel()
    assert np.isfinite(b).all(), name
    scale = np.abs(a).max()
    assert scale > 0, name
    assert np.abs(a - b).max() <= rel * scale, (name, np.abs(a - b).max(),
                                                scale)
    if cos_min is not None:
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= cos_min, (name, cos)


@pytest.fixture(scope="module", params=sorted(CASES))
def oracle(request):
    """JAX's direct-mode cotangents of one case (all five groups), once."""
    name = request.param
    js, ps, tables, u, g = _inputs(name)
    w, _, spp, _, _ = CASES[name]
    ipar = np.asarray([PASS, 0], np.int32)
    want = [np.asarray(x) for x in _bwd_reference(
        tables[0], ipar, *tables[1:], g, u, mode="direct",
        russian_roulette=False, rr_start_depth=0, **_kw(w, spp))]
    return name, ps, tables, u, g, want


def test_direct_plain_backward_matches_jax(oracle):
    """Kernel 2's plain version in direct mode against _bwd_reference, all
    five groups; the torus scene's forward over its streamed Morton chunks
    (the brute version's champions, so JAX's brute tables' cotangents)."""
    name, ps, tables, u, g, want = oracle
    w, h, spp, _, _ = CASES[name]
    t = _port(*tables)
    chunks = None
    if name == "torus_streamed":
        cfg = RenderConfig(width=w, height=h, spp=spp)
        assert mega.streamed(ps, cfg)[0]
        chunks = mega.chunk_tables(ps, cfg, t[1], t[2])
    got = MKG.pathtrace_pass_bwd_reference(
        t[0], torch.tensor([PASS, 0], dtype=torch.int32), *t[1:],
        *_port(g, u), mode="direct", chunks=chunks, **_kw(w, spp))
    for group, a, b in zip(MKG.DIFF_ALL, want, got):
        if b.numel() == 0:      # JAX pads an empty table with a zero row
            assert not a.any(), group
            continue
        assert b.shape == a.shape, group
        _grad_gate(group, b.numpy(), a)


@pytest.fixture(scope="module")
def cornell_record():
    """The plain direct record of cornell 16x12 and JAX's recording
    kernel's (interpret mode) on the same draws."""
    _, _, tables, u, g = _inputs("cornell")
    t = _port(*tables)
    acc, ids, occs = MK.direct_pass_reference(
        t[0], *t[1:], torch.zeros((g.shape[0], 3)), *_port(u),
        key=rng.base_key(0), spp=1, width=16, two_sided=False, record=True)
    jacc, jids, joccs = JMK.pathtrace_pass_pallas(
        tables[0], np.zeros(2, np.int32), *tables[1:],
        np.zeros((g.shape[0], 3), np.float32), u, spp=1, width=16,
        bounces=0, two_sided=False, normalize_emitter=False, seed=0,
        mode="direct", interpret=True, record=True)
    return tables, u, g, (acc, ids, occs), (jacc, jids, joccs)


def test_direct_record_matches_jax(cornell_record):
    """JAX's one recorded segment: ids (1, R) the primary champions, occs
    (L, R) one bit per light; the accumulator within 2e-4."""
    _, _, _, (acc, ids, occs), (jacc, jids, joccs) = cornell_record
    assert ids.shape == (1, acc.shape[0]) and ids.dtype == torch.int32
    assert occs.shape == (1, acc.shape[0]) and occs.dtype == torch.bool
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (occs.numpy() != (np.asarray(joccs) > 0)).mean() <= 0.01
    assert occs.any() and (ids >= 0).any() and (ids < 0).any()
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=2e-4,
                               atol=2e-4)
    MKG._check_record(ids, occs, acc.shape[0], 1, 5, torch.device("cpu"),
                      "direct")
    with pytest.raises(ValueError, match=r"\(6, 192\)"):
        MKG._check_record(ids, occs, acc.shape[0], 1, 5,
                          torch.device("cpu"), "path")


def test_direct_champion_backward_matches_jax(cornell_record):
    """Kernel 3's plain version on the plain record against _bwd_champion
    on the same record, all five groups; and against kernel 2's plain
    version, which picks the same champions."""
    tables, u, g, (_, ids, occs), _ = cornell_record
    ipar = np.asarray([PASS, 0], np.int32)
    want = [np.asarray(x) for x in _bwd_champion(
        tables[0], ipar, *tables[1:], g, u,
        ids.numpy().astype(np.float32), occs.numpy().astype(np.float32),
        mode="direct", russian_roulette=False, rr_start_depth=0,
        **_kw(16, 1))]
    t = _port(*tables)
    tip = torch.as_tensor(ipar)
    got = MKG.pathtrace_pass_bwd_champ(
        t[0], tip, *t[1:], *_port(g, u), ids, occs, mode="direct",
        **_kw(16, 1))
    k2 = MKG.pathtrace_pass_bwd_reference(t[0], tip, *t[1:], *_port(g, u),
                                          mode="direct", **_kw(16, 1))
    for group, a, b, c in zip(MKG.DIFF_ALL, want, got, k2):
        _grad_gate(group, b.numpy(), a)
        _grad_gate(group, c.numpy(), b.numpy())


def _probe_tables():
    """A 3 x 1 film looking down -z from the origin, a sphere at (0, 0, -3)
    of radius 1, an occluder of radius 0.5 at (0, 0, 1) behind the camera,
    eps 0, and two lights: a disk of radius 0 exactly on the centre ray's
    hit point (0, 0, -2), so its shadow ray has d2 = 0, and one at (0, 0,
    5), which the occluder hides. The side pixels miss everything."""
    par = torch.tensor([0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 3, 1, 3, 1, 1,
                        0, -10, -10, -10, 10, 10, 10, 0, 0.1],
                       dtype=torch.float32)
    sph = torch.tensor([[0, 0, -3, 1, 0, 1, 0, 0], [0, 0, 1, 0.5, 0, 1, 0, 0]],
                       dtype=torch.float32)
    tri = torch.zeros((0, MK.TRI_COLS))
    mat = torch.tensor([[0.8, 0.6, 0.4, 1.0]])
    lig = torch.zeros((2, MK.LIG_COLS))
    for i, z in enumerate((-2.0, 5.0)):
        lig[i, 2] = z
        lig[i, 5] = -1.0                     # normal
        lig[i, 6:12] = 1.0                   # irradiance
        lig[i, 13] = 1.0                     # area
        lig[i, 14], lig[i, 18] = 1.0, 1.0    # tangent, bitangent
    lig[1, 12] = 0.1
    return par, sph, tri, mat, lig


def test_direct_backward_is_finite_at_its_guards():
    """The finite-gradient probe: a shadow ray of length 0 (d2 = 0), an
    occluded light and missed rays, through the plain versions of kernels
    2, 3 and 2s (the CUDA kernels are held to them on the card)."""
    par, sph, tri, mat, lig = _probe_tables()
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    kw = dict(spp=1, width=3, bounces=0, two_sided=False,
              normalize_emitter=False, seed=0)
    u = torch.full((6, 3), 0.5)
    acc, ids, occs = MK.direct_pass_reference(
        par, sph, tri, mat, lig, torch.zeros((3, 3)), u,
        key=rng.base_key(0), spp=1, width=3, two_sided=False, record=True)
    assert ids.tolist() == [[-1, 0, -1]]
    assert occs.tolist() == [[False, False, False], [False, True, False]]
    # centre: ambient twice (the zero-length shadow ray's cosine is 0)
    np.testing.assert_allclose(acc[1].numpy(), 0.2 * mat[0, :3].numpy(),
                               rtol=1e-6)
    g = torch.ones((3, 3))
    for got in (MKG.pathtrace_pass_bwd_reference(
                    par, ipar, sph, tri, mat, lig, g, u, mode="direct",
                    **kw),
                MKG.pathtrace_pass_bwd_champ_reference(
                    par, ipar, sph, tri, mat, lig, g, u, ids, occs,
                    mode="direct", **kw),
                MKS.pathtrace_pass_bwd_soft_reference(
                    par, ipar, sph, tri, mat, lig, g, u, mode="direct",
                    soft_bandwidth=BW, soft_tau=BW, **kw)):
        for group, x in zip(MKG.DIFF_ALL, got):
            assert torch.isfinite(x).all(), group
        assert got[0][25] != 0 and got[3].any()     # ambient, albedo


def _train_cfg(**kw):
    return RenderConfig(width=16, height=12, use_megakernel=True,
                        mega_grad_wrt=("sph", "mat"), **kw)


def _direct_image(acc, cfg, n_lights):
    """render_direct_mega's image before its clip: the per-pixel mean over
    spp divided by the lights."""
    return acc.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2) / n_lights


@pytest.mark.parametrize("route", ["kernel2", "cell", "soft"])
def test_direct_diff_pass_routes_on_the_cpu(route):
    """pathtrace_pass_diff(mode="direct") on CPU tensors through each
    route: its value is the plain direct pass (u-planes and the PRNG
    route's pass key alike), and the cotangents of a direct train step's
    loss are the plain backward's of the same cotangent of acc."""
    ps = scene_from_numpy(scene_to_numpy(cornell_box(cols=16, rows=12)))
    cfg = _train_cfg()
    tables = mega.scene_tables(ps, cfg)
    ipar = torch.tensor([PASS, 0], dtype=torch.int32)
    kw = _kw(16, 1)
    soft = dict(soft_bandwidth=BW, soft_tau=BW) if route == "soft" else {}
    for u in (None, mega.u_planes_for_direct(
            rng.pass_key(rng.base_key(0), PASS), cfg, 1)):
        leaves = [t.clone().requires_grad_(n in ("sph", "mat"))
                  for n, t in zip(MKG.DIFF_ALL, tables)]
        acc0 = torch.zeros((cfg.total_rays, 3))
        acc = MKG.pathtrace_pass_diff(
            leaves[0], ipar, *leaves[1:], acc0, u, mode="direct",
            diff_wrt=("sph", "mat"), bwd_cell=route == "cell", **soft, **kw)
        want = MK.direct_pass_reference(
            *tables, acc0, u, key=MK.pass_key_of(ipar, 0), spp=1, width=16,
            two_sided=False)
        assert torch.equal(acc.detach(), want)
        loss = (_direct_image(acc, cfg, 1) ** 2).mean()
        g_acc, = torch.autograd.grad(loss, acc, retain_graph=True)
        got = torch.autograd.grad(loss, [leaves[1], leaves[3]])
        bwd = (MKS.pathtrace_pass_bwd_soft_reference if route == "soft"
               else MKG.pathtrace_pass_bwd_reference)
        ref = bwd(tables[0], ipar, *tables[1:], g_acc, u, mode="direct",
                  diff_wrt=("sph", "mat"), **soft, **kw)
        for a, b in zip(got, (ref[1], ref[3])):
            assert a.abs().max() > 0
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_direct_ray_offset_halves_equal_the_full_film():
    """Rays [R/2, R) of a call at ray offset R/2 are rays [R/2, R) of the
    full call: the camera and the PRNG draws are keyed by the global ray
    id, as path mode's are; likewise for the differentiable pass and its
    record."""
    ps = scene_from_numpy(scene_to_numpy(cornell_box(cols=16, rows=12)))
    cfg = RenderConfig(width=16, height=12)
    tables = mega.scene_tables(ps, cfg)
    n = cfg.total_rays
    key = rng.pass_key(rng.base_key(0), PASS)
    kw = dict(key=key, spp=1, width=16, two_sided=False, record=True)
    full = MK.direct_pass(*tables, torch.zeros((n, 3)), None, **kw)
    halves = [MK.direct_pass(*tables, torch.zeros((n // 2, 3)), None,
                             ray_offset=off, **kw) for off in (0, n // 2)]
    for a, b0, b1 in zip(full, *halves):
        assert torch.equal(a, torch.cat([b0, b1], -2 if a.dim() == 2 and
                                        a.shape[-1] == 3 else -1))
    diff = [MKG.pathtrace_pass_diff(
        tables[0], torch.tensor([PASS, off], dtype=torch.int32),
        *tables[1:], torch.zeros((n // 2, 3)), None, mode="direct",
        **_kw(16, 1)) for off in (0, n // 2)]
    assert torch.equal(torch.cat(diff), full[0])


def test_direct_mode_arguments():
    """mode must be "path" or "direct"; a direct call ignores bounces and
    the roulette (JAX's n_draw_pairs and _tile_program)."""
    ps = scene_from_numpy(scene_to_numpy(cornell_box(cols=8, rows=6)))
    tables = mega.scene_tables(ps, RenderConfig(width=8, height=6))
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    acc0 = torch.zeros((48, 3))
    kw = _kw(8, 1)
    with pytest.raises(ValueError, match="mode"):
        MKG.pathtrace_pass_diff(tables[0], ipar, *tables[1:], acc0, None,
                                mode="stage", **kw)
    a = MKG.pathtrace_pass_diff(tables[0], ipar, *tables[1:], acc0, None,
                                mode="direct", **kw)
    b = MKG.pathtrace_pass_diff(tables[0], ipar, *tables[1:], acc0, None,
                                mode="direct", **{**kw, "bounces": 0},
                                russian_roulette=True)
    assert torch.equal(a, b)
    assert MKG.n_draws_of(3, 5, True, "direct") == 4


def _train_grads(cfg, ps):
    p = {"center": ps.spheres.center.clone().requires_grad_(True),
         "mat": ps.materials.clone().requires_grad_(True)}
    sc = replace(ps, spheres=replace(ps.spheres, center=p["center"]),
                 materials=p["mat"])
    state = pt.init_state(cfg, "cpu")
    u = mega.u_planes_for_pass(state["key"], 0, cfg, ps.lights.count)
    acc = mega.render_pass_mega(sc, state, cfg, u_planes=u)["acc"]
    loss = (acc ** 2).mean()
    return loss.detach(), torch.autograd.grad(loss, list(p.values()))


@pytest.mark.parametrize("impl", ["pallas", "cell"])
def test_blocked_layout_trains_as_unblocked(impl):
    """mega_block on brute tables (which raised before): cornell 32x24 b1
    with mega_block=8 renders and trains equal to the unblocked render
    (values and ("sph", "mat") gradients at rtol 1e-5 / atol 1e-6, JAX's
    test_megakernel_grad.py:173-193), through kernel 2's route and the
    cell route; render_direct at mega_block=4 equals its row-major image.
    The brute instances keep the row-major map (on the card
    tests/test_torch_cuda.py holds the kernels)."""
    js = cornell_box(cols=32, rows=24)
    ps = scene_from_numpy(scene_to_numpy(js))
    cfg0 = RenderConfig(width=32, height=24, bounces=1, use_megakernel=True,
                        mega_grad_wrt=("sph", "mat"), mega_bwd_impl=impl)
    cfg8 = replace(cfg0, mega_block=8)
    assert mega.supported_diff(ps, cfg8) and mega.effective_block(cfg8) == 8
    v0, g0 = _train_grads(cfg0, ps)
    v8, g8 = _train_grads(cfg8, ps)
    np.testing.assert_allclose(v8.item(), v0.item(), rtol=1e-6)
    for a, b in zip(g8, g0):
        assert b.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    d0 = mega.render_direct_mega(ps, replace(cfg0, mega_block=0))
    d4 = mega.render_direct_mega(ps, replace(cfg0, mega_block=4))
    assert torch.equal(d0, d4)
