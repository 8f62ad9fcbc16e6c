"""Whether the soft program's per-ray ill-conditioning past 64 objects is
the program's or the port's, on ray 204 of ``chip_smoke.py``'s phase 22
case sphere_field(256) at 24x16 b5 (the ray phase 22 excuses there, its
cotangent moving by 2.9% of the norm between draws moved by +-2^-22 on the
card): JAX's ``soft_pass_value`` on XLA's CPU against the port's plain
version with the same tables, draws and cotangent (phase 22's:
``GRAD_SEED`` 2, the first seeded tangent over the sphere table, as
``chip_smoke._ray_moves`` draws it).

A ray's share is <g_r, d acc_r / d sph . v>: forward-mode AD in the port
(as ``_ray_moves``), reverse mode in JAX (its soft program past 64 objects
is a custom_vjp checkpoint, which has no forward mode); the two modes give
the same number in the port. Each program is read in float32 at the draws
u, u + 2^-22 and u - 2^-22, and in float64 (JAX under ``jax_enable_x64``).
JAX rounds the bandwidth to float32 in both precisions
(``jnp.float32(bandwidth)``), so the port's float64 run is handed that
float32 value.

``test_float64_camera_matches_jax`` holds the port's primary rays in
float64 to JAX's: a float64 witness needs the port's float64 program to be
float64 throughout (its pixel coordinates were float32 once, which moved
ray 204's float64 value by 5%). The ray-204 reading is slow (~3 minutes,
JAX's eager soft program) and runs with ``-m slow -s``; it prints the
numbers ``PERF.md`` section 7 cites and asserts only on the port: its
float64 value and share equal JAX's, and its float32 share lies far from
its float64 share (float32 does not pin the ray down).
"""
import jax
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from raytracing_tpu.ops.pallas.megakernel import _PAR
from raytracing_tpu.ops.pallas.megakernel_grad import (_primary_rays,
                                                       soft_pass_value)
from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_soft as MKS
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt

W, H, BOUNCES = 24, 16, 5       # chip_smoke LARGE_W x LARGE_H, BOUNCES
GRAD_SEED = 2                   # chip_smoke GRAD_SEED
RAY = 204                       # phase 22's excused ray on sphere_field(256)
BW = 2e-2                       # chip_smoke EDGE_BW
BW32 = float(np.float32(BW))    # the bandwidth as JAX's program holds it


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("spp,lens", [(1, 0.25), (4, 0.25)])
def test_float64_camera_matches_jax(x64, spp, lens):
    """The port's camera (MK._camera_rays) on a float64 par equals JAX's
    _primary_rays in float64 to 1e-12: every coordinate in par's type."""
    import jax.numpy as jnp
    w, h = 12, 8
    scene = cornell_box(cols=w, rows=h, lens_diameter=lens)
    cfg = RenderConfig(width=w, height=h, spp=spp)
    par = mega.scene_tables(scene, cfg)[0].double()
    n = cfg.total_rays
    uv = np.random.default_rng(GRAD_SEED).random((n, 2))
    o, d, mint, _ = MK._camera_rays(par, torch.as_tensor(uv), n, 0, spp, w)
    assert o.dtype == d.dtype == torch.float64
    jpar = jnp.asarray(par.numpy())

    def P(name, off=0):
        return jpar[_PAR[name] + off]

    pairs = iter([(jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]))])
    ridf = jnp.arange(n).astype(jnp.float32)
    ox, oy, oz, dx, dy, dz, jmint, _, _ = _primary_rays(
        P, lambda: next(pairs), ridf, ridf >= 0, spp=spp, width=w)
    want_o = np.stack([np.asarray(x) for x in (ox, oy, oz)], -1)
    want_d = np.stack([np.asarray(x) for x in (dx, dy, dz)], -1)
    assert want_d.dtype == np.float64
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mint.numpy(), np.asarray(jmint), rtol=1e-12)


def _inputs():
    scene = sphere_field(256, cols=W, rows=H)
    cfg = RenderConfig(width=W, height=H, bounces=BOUNCES,
                       use_megakernel=True)
    tables = list(mega.scene_tables(scene, cfg))
    u = mega.u_planes_for_pass(pt.init_state(cfg, "cpu")["key"], 0, cfg,
                               scene.lights.count)
    g = np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32)
    v = np.random.default_rng(GRAD_SEED).normal(
        size=tuple(tables[1].shape)).astype(np.float32)
    kw = dict(spp=1, width=W, bounces=BOUNCES, two_sided=False,
              normalize_emitter=cfg.normalize_emitter, soft_bandwidth=BW,
              soft_tau=BW)
    return tables, u, g[RAY:RAY + 1], v, kw


def _moved(u, sign):
    """The draws moved by sign * 2^-22, kept in [0, 1) (_ray_moves')."""
    d = 2.0 ** -22
    if sign > 0:
        return torch.where(u + d < 1.0, u + d, u - d)
    return torch.where(u - d >= 0.0, u - d, u + d)


def _port(tables, planes, g, v, kw, dtype, forward=True):
    """(value, share) of the ray in the port's plain soft program."""
    t = [x.to(dtype) for x in tables]
    col = planes[:, RAY:RAY + 1].contiguous().to(dtype)
    ipar = torch.tensor([0, RAY], dtype=torch.int32)
    tv, tg = torch.as_tensor(v).to(dtype), torch.as_tensor(g).to(dtype)
    if forward:
        with fwAD.dual_level():
            duals = list(t)
            duals[1] = fwAD.make_dual(t[1], tv)
            acc = MKS.soft_pass_value(duals[0], ipar, *duals[1:], col, **kw)
            p = fwAD.unpack_dual(acc)
            return (p.primal.double().numpy(),
                    float((p.tangent * tg).double().sum()))
    sph = t[1].clone().requires_grad_(True)
    acc = MKS.soft_pass_value(t[0], ipar, sph, *t[2:], col, **kw)
    ct, = torch.autograd.grad(acc, sph, grad_outputs=tg)
    return acc.detach().double().numpy(), float((ct * tv).double().sum())


def _jax(tables, planes, g, v, kw, dtype):
    """(value, share) of the ray in JAX's soft program (reverse mode)."""
    t = [np.asarray(x, dtype) for x in tables]
    col = np.asarray(planes[:, RAY:RAY + 1], dtype)
    ipar = np.asarray([0, RAY], np.int32)

    def f(sph):
        return soft_pass_value(t[0], ipar, sph, *t[2:], col, **kw)

    val, vjp = jax.vjp(f, t[1])
    ct, = vjp(g.astype(dtype))
    return (np.asarray(val, np.float64),
            float((np.asarray(ct, np.float64) * v).sum()))


@pytest.mark.slow
def test_soft_ray_204_conditioning_is_the_programs():
    tables, u, g, v, kw = _inputs()
    kw64 = dict(kw, soft_bandwidth=BW32, soft_tau=BW32)
    draws = (("u", u), ("up", _moved(u, 1)), ("down", _moved(u, -1)))
    port = {k: _port(tables, p, g, v, kw, torch.float32) for k, p in draws}
    rev = _port(tables, u, g, v, kw, torch.float32, forward=False)
    jx = {k: _jax(tables, p, g, v, kw, np.float32) for k, p in draws}
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        j64 = _jax(tables, u, g, v, kw, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)
    p64 = _port(tables, u, g, v, kw64, torch.float64)
    for name, r, r64 in (("port", port, p64), ("jax", jx, j64)):
        move = abs(r["up"][1] - r["down"][1])
        print(f"ray {RAY} {name}: float32 value {r['u'][0].ravel()} share "
              f"{r['u'][1]:.6g}, moved +-2^-22 {r['up'][1]:.6g} / "
              f"{r['down'][1]:.6g} (move {move:.6g} = "
              f"{move / abs(r['u'][1]):.3%} of the share); float64 value "
              f"{r64[0].ravel()} share {r64[1]:.10g}")
    # the port's forward and reverse modes read the same share
    np.testing.assert_allclose(rev[1], port["u"][1], rtol=1e-5)
    # float64: the port's program is JAX's on this ray
    np.testing.assert_allclose(p64[0], j64[0], rtol=1e-6)
    np.testing.assert_allclose(p64[1], j64[1], rtol=1e-6)
    # float32 does not pin the port's share down
    ratio = abs(port["u"][1] / p64[1])
    assert ratio > 5.0 or ratio < 0.2, ratio
