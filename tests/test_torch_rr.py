"""Russian roulette in the port against the JAX package.

The plain version of kernel 1 with Russian roulette (``pathtrace_pass_
reference(russian_roulette=True)``) against JAX's XLA stage pipeline and
JAX's Pallas kernel in interpret mode on the same draws; the in-kernel PRNG
route against the u-planes route; the plain versions of kernels 2 and 3
with the roulette against JAX's ``_bwd_reference`` and ``_bwd_champion``;
the differentiable route against ``jax.grad`` through JAX's
``render_pass_mega``; a finite-gradient probe; the roulette's mean against
fixed depth; and the stage route's roulette gradient at the clip bound.
The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13).

Cornell's white material is exactly (1, 1, 1) and its yellow (0.9, 0.9,
0.1): after a white bounce the throughput's channels tie, and its maximum
sits on the clip bound 1. There JAX's jnp.maximum and jnp.clip split the
cotangent (1/2 at a bound, 1/2 and 1/4 among tied channels), which the
plain versions reproduce and the gradient tests check.

Tolerances: the forward at rtol/atol 2e-4 (``tests/test_megakernel.py:
48-50``; the XLA pipeline divides by p where the kernels multiply by 1 / p,
one rounding apart); the plain backwards within 1e-3 of each group's
largest entry, as ``tests/test_torch_megakernel_grad.py`` holds them; end
to end rtol 5e-3 and atol 5e-3 x the largest entry; the roulette's mean
within 3% of fixed depth over 48 passes (its estimator is unbiased; the
difference measured here is ~0.5%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.ops.pallas import megakernel as JMK
from raytracing_tpu.ops.pallas.megakernel_grad import (_bwd_champion,
                                                       _bwd_reference)
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_threads import one_thread  # noqa: F401

W, H = 32, 24
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _pair(w, h):
    js = cornell_box(cols=w, rows=h)
    return js, scene_from_numpy(scene_to_numpy(js))


@pytest.fixture(scope="module")
def cornell():
    return _pair(W, H)


@pytest.fixture(scope="module")
def cornell_small():
    return _pair(16, 12)


def _rr(w, h, bounces, start, **kw):
    return dict(width=w, height=h, bounces=bounces, russian_roulette=True,
                rr_start_depth=start, **kw)


def _kw(cfg):
    return dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
                two_sided=cfg.two_sided_triangles,
                normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
                russian_roulette=cfg.russian_roulette,
                rr_start_depth=cfg.rr_start_depth)


def _jax_kw(cfg):
    kw = _kw(cfg)
    kw.pop("seed")
    return kw


def _jax_u(js, jcfg, passes=0):
    return jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], passes, jcfg,
                                   js.lights.count)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_draw_layout_counts_the_roulette_slot(cornell):
    """One slot per depth more, in JAX's order: lens, NEE, then per depth
    [rr], bounce, NEE; the u-planes of a roulette pass are JAX's bit for
    bit."""
    js, ps = cornell
    assert MK.n_draws_of(1, 5, True) == 1 + 1 + 5 * 3
    assert MK.n_draws_of(1, 5) == 1 + 1 + 5 * 2
    jcfg = JaxConfig(**_rr(W, H, 3, 2))
    cfg = RenderConfig(**_rr(W, H, 3, 2))
    assert pt.pass_draw_count(cfg, 1) == MK.n_draws_of(1, 3, True)
    np.testing.assert_array_equal(
        mega.u_planes_for_pass(pt.init_state(cfg, "cpu")["key"], 4, cfg,
                               ps.lights.count).numpy(),
        np.asarray(_jax_u(js, jcfg, 4)))


def test_plain_roulette_pass_matches_xla_pipeline(cornell):
    """render_pass with russian_roulette on the megakernel route (the plain
    version on the CPU) against JAX's XLA stage pipeline: the same draws,
    the same paths ended (the slot of depth 0 drawn, not played)."""
    js, ps = cornell
    kw = _rr(W, H, 3, 1)
    jcfg = JaxConfig(**kw)
    want = np.asarray(jpt._render_pass(js, jpt.init_state(jcfg), jcfg)["acc"])
    cfg = RenderConfig(use_megakernel=True, **kw)
    got = pt.render_pass(ps, pt.init_state(cfg, "cpu"), cfg)["acc"].numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the roulette changed the image against fixed depth
    fixed = pt.render_pass(ps, pt.init_state(cfg, "cpu"),
                           replace(cfg, russian_roulette=False))["acc"]
    assert not np.allclose(got, fixed.numpy(), rtol=TOL, atol=TOL)


def test_plain_roulette_pass_matches_jax_kernel_interpret(cornell_small):
    """Against JAX's Pallas kernel in interpret mode (16x12 b2, roulette
    from depth 0) on the same u-planes, with the champion record: the ids
    of the paths the roulette ended are -1 in both."""
    js, ps = cornell_small
    jcfg = JaxConfig(**_rr(16, 12, 2, 0))
    cfg = RenderConfig(**_rr(16, 12, 2, 0))
    jtables = jmega.scene_tables(js, jcfg)
    ju = _jax_u(js, jcfg)
    jacc, jids, joccs = JMK.pathtrace_pass_pallas(
        jtables[0], jnp.zeros((2,), jnp.int32), *jtables[1:],
        jnp.zeros((16 * 12, 3)), ju, record=True, interpret=True,
        **_kw(jcfg))
    tables = [_t(x) for x in jtables]
    acc, ids, occs = MK.pathtrace_pass_reference(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((16 * 12, 3)), _t(ju), record=True, **_kw(cfg))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=TOL,
                               atol=TOL)
    jids = np.asarray(jids).astype(np.int32)
    np.testing.assert_array_equal(ids.numpy(), jids)
    live = np.repeat(jids >= 0, 1, axis=0)
    np.testing.assert_array_equal(occs.numpy()[live],
                                  np.asarray(joccs)[live] > 0.5)
    # some live path ended by the roulette before the last segment
    assert ((jids[1] >= 0) & (jids[2] < 0)).any()


def test_roulette_prng_route_equals_u_planes_route(cornell):
    """The draws made by the plain version itself (the kernel's PRNG
    route) equal the u-planes route's, two passes in one call."""
    _, ps = cornell
    cfg = RenderConfig(use_megakernel=True, seed=11, **_rr(W, H, 3, 1))
    st_u = pt.init_state(cfg, "cpu")
    for p in range(2):
        u = mega.u_planes_for_pass(st_u["key"], p, cfg, ps.lights.count)
        st_u = mega.render_pass_mega(ps, st_u, cfg, u_planes=u)
    st = pt.render_passes(ps, pt.init_state(cfg, "cpu"), cfg, 2)
    np.testing.assert_array_equal(st["acc"].numpy(), st_u["acc"].numpy())


def _grad_close(want, got, tol=1e-3):
    for name, a, b in zip(MKG.DIFF_ALL, want, got):
        a, b = np.asarray(a)[:b.shape[0]], b.numpy()
        assert b.shape == a.shape, name
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale,
                                   err_msg=name)


def test_plain_roulette_backward_matches_jax_bwd_reference(cornell):
    """Kernel 2's plain version with the roulette from depth 1 against
    JAX's _bwd_reference(russian_roulette=True): same tables, u-planes and
    cotangent."""
    js, _ = cornell
    jcfg = JaxConfig(**_rr(W, H, 3, 1))
    cfg = RenderConfig(**_rr(W, H, 3, 1))
    jtables = jmega.scene_tables(js, jcfg)
    ju = _jax_u(js, jcfg)
    g = np.random.default_rng(1).normal(
        size=(W * H, 3)).astype(np.float32)
    ipar = np.zeros((2,), np.int32)
    want = _bwd_reference(*jtables[:1], ipar, *jtables[1:], g, ju,
                          mode="path", seed=cfg.seed, **_jax_kw(cfg))
    t = [_t(x) for x in jtables]
    got = MKG.pathtrace_pass_bwd_reference(
        t[0], torch.as_tensor(ipar), *t[1:], torch.as_tensor(g), _t(ju),
        **_kw(cfg))
    _grad_close(want, got)


def test_plain_roulette_champion_backward_matches_jax(cornell):
    """Kernel 3's plain version with the roulette against JAX's
    _bwd_champion on the plain version's own record (ids of the paths the
    roulette ended are -1)."""
    js, _ = cornell
    jcfg = JaxConfig(**_rr(W, H, 3, 0))
    cfg = RenderConfig(**_rr(W, H, 3, 0))
    jtables = jmega.scene_tables(js, jcfg)
    ju = _jax_u(js, jcfg)
    t = [_t(x) for x in jtables]
    ipar = torch.zeros(2, dtype=torch.int32)
    _, ids, occs = MK.pathtrace_pass_reference(
        t[0], ipar, *t[1:], torch.zeros((W * H, 3)), _t(ju), record=True,
        **_kw(cfg))
    g = np.random.default_rng(7).normal(size=(W * H, 3)).astype(np.float32)
    want = _bwd_champion(
        jtables[0], np.zeros((2,), np.int32), *jtables[1:], g, ju,
        jnp.asarray(ids.numpy().astype(np.float32)),
        jnp.asarray(occs.numpy().astype(np.float32)), mode="path",
        seed=cfg.seed, **_jax_kw(cfg))
    got = MKG.pathtrace_pass_bwd_champ_reference(
        t[0], ipar, *t[1:], torch.as_tensor(g), _t(ju), ids, occs,
        **_kw(cfg))
    _grad_close(want, got)


PARAMS = ("center", "radius", "mat", "irr", "lpos", "eye")


def _port_route_grads(ps, cfg):
    p = {"center": ps.spheres.center, "radius": ps.spheres.radius,
         "mat": ps.materials, "irr": ps.lights.irradiance,
         "lpos": ps.lights.position, "eye": ps.camera.eye}
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    sc = replace(ps, spheres=replace(ps.spheres, center=p["center"],
                                     radius=p["radius"]),
                 lights=replace(ps.lights, irradiance=p["irr"],
                                position=p["lpos"]),
                 materials=p["mat"], camera=replace(ps.camera, eye=p["eye"]))
    st = pt.render_pass(sc, pt.init_state(cfg, "cpu"), cfg)
    loss = torch.mean(st["acc"] ** 2)
    loss.backward()
    return loss.item(), {k: p[k].grad.numpy() for k in PARAMS}


def test_roulette_route_grads_match_jax_render_pass_mega(cornell_small):
    """render_pass + backward() with the roulette from depth 0 on cornell,
    where white walls tie all three channels on the clip bound, against
    jax.grad through JAX's render_pass_mega (interpret mode; one bounce
    keeps its compile short): the tie rule decides the materials'
    gradient."""
    js, ps = cornell_small
    kw = _rr(16, 12, 1, 0, use_megakernel=True)
    jcfg = JaxConfig(**kw)
    state0 = jpt.init_state(jcfg)

    def loss(p):
        sc = dataclasses.replace(
            js,
            spheres=dataclasses.replace(js.spheres, center=p["center"],
                                        radius=p["radius"]),
            lights=dataclasses.replace(js.lights, irradiance=p["irr"],
                                       position=p["lpos"]),
            materials=p["mat"],
            camera=dataclasses.replace(js.camera, eye=p["eye"]))
        st = jmega.render_pass_mega(sc, state0, jcfg, interpret=True)
        return jnp.mean(st["acc"] ** 2)

    params = {"center": js.spheres.center, "radius": js.spheres.radius,
              "mat": js.materials, "irr": js.lights.irradiance,
              "lpos": js.lights.position, "eye": js.camera.eye}
    v, gx = jax.value_and_grad(loss)(params)
    vp, gp = _port_route_grads(ps, RenderConfig(**kw))
    np.testing.assert_allclose(vp, float(v), rtol=1e-5)
    for k in PARAMS:
        a, b = np.asarray(gx[k]), gp[k]
        assert np.isfinite(b).all(), k
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(b, a, rtol=5e-3,
                                   atol=5e-3 * np.abs(a).max(), err_msg=k)


def test_roulette_gradients_are_finite_at_five_bounces(cornell):
    """Every group through the roulette's 1 / p at b5 from depth 0,
    through the route and through kernel 2's plain version."""
    _, ps = cornell
    cfg = RenderConfig(use_megakernel=True, **_rr(W, H, 5, 0))
    _, g = _port_route_grads(ps, cfg)
    for k in PARAMS:
        assert np.isfinite(g[k]).all(), k
        assert np.abs(g[k]).max() > 0, k
    tables = mega.scene_tables(ps, cfg)
    gacc = torch.as_tensor(np.random.default_rng(5).normal(
        size=(cfg.total_rays, 3)).astype(np.float32))
    out = MKG.pathtrace_pass_bwd_reference(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:], gacc,
        None, **_kw(cfg))
    for name, d in zip(MKG.DIFF_ALL, out):
        assert torch.isfinite(d).all(), name


def test_roulette_keeps_the_mean_energy(cornell):
    """48 passes with the roulette from depth 2 (as bench.py runs config
    5) against 48 passes at fixed depth: the roulette ends paths early and
    weights the survivors by 1 / p, so the mean radiance holds to 3%."""
    _, ps = cornell
    cfg = RenderConfig(use_megakernel=True, **_rr(W, H, 5, 2))
    rr = pt.render_passes(ps, pt.init_state(cfg, "cpu"), cfg, 48)["acc"]
    fixed_cfg = replace(cfg, russian_roulette=False)
    fixed = pt.render_passes(ps, pt.init_state(fixed_cfg, "cpu"), fixed_cfg,
                             48)["acc"]
    m_rr, m_fixed = rr.double().mean().item(), fixed.double().mean().item()
    assert abs(m_rr - m_fixed) <= 0.03 * m_fixed, (m_rr, m_fixed)


def test_stage_roulette_gradient_splits_at_the_clip_bound(cornell):
    """The stage route's roulette against jax.grad of JAX's XLA pipeline
    from depth 0: after a bounce off cornell's white (1, 1, 1) walls the
    throughput's maximum sits on the clip bound 1, where JAX's jnp.clip
    passes half the cotangent (torch.clamp would pass all of it)."""
    js, ps = cornell
    kw = _rr(W, H, 2, 0)
    jcfg = JaxConfig(**kw)
    state0 = jpt.init_state(jcfg)

    def loss(mat):
        st = jpt._render_pass(dataclasses.replace(js, materials=mat), state0,
                              jcfg)
        return jnp.mean(st["acc"] ** 2)

    want = np.asarray(jax.grad(loss)(js.materials))
    cfg = RenderConfig(**kw)
    assert not cfg.use_megakernel
    mat = ps.materials.clone().requires_grad_(True)
    st = pt.render_pass(replace(ps, materials=mat), pt.init_state(cfg, "cpu"),
                        cfg)
    torch.mean(st["acc"] ** 2).backward()
    got = mat.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=5e-3,
                               atol=5e-3 * np.abs(want).max())
