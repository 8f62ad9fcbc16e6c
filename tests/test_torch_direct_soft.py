"""The soft program's direct mode (kernel 2s's ``mode="direct"``) against
the JAX package: the port's ``soft_pass_value(mode="direct")`` against
JAX's ``soft_pass_value(mode="direct")`` (``megakernel_grad.py:2668``,
its direct branch ``:2039-2075``), value and cotangents (autograd against
``jax.vjp``), on cornell 16x12 with the same packed tables,
``u_planes_for_direct`` draws and seeded cotangent; kernel 2s's plain
version is that autograd. The CUDA kernel is held to the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 23).

Both sides run in float64 (JAX under ``jax_enable_x64``): the soft program
is ill-conditioned per ray near silhouettes (``tests/test_torch_edge_parity
.py``). JAX rounds the bandwidth to float32 (``jnp.float32(bandwidth)``),
so both are handed that float32 value. The gates are those of
``tests/test_torch_edge_parity.py``: values within rtol = atol = 2e-4 on at
least 99.9% of entries and none beyond 1e-3; cotangents per group cosine
>= 0.9999 and max |d| <= 1e-3 of the group's largest entry.
"""
import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.core import rng as jrng
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.ops.pallas.megakernel_grad import soft_pass_value
from raytracing_tpu.render import mega as jmega
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.ops import megakernel_soft as MKS

W, H = 16, 12
GRAD_SEED = 5
PASS = 3
BW = float(np.float32(2e-2))   # as JAX's program holds it


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _value_gate(got, want):
    err = np.abs(got - want)
    beyond = err > 2e-4 + 2e-4 * np.abs(want)
    assert np.isfinite(got).all()
    assert beyond.mean() <= 1e-3, (beyond.mean(), err.max())
    assert err.max() <= 1e-3, err.max()


def _grad_gate(name, got, want):
    a, b = want.ravel(), got.astype(np.float64).ravel()
    assert np.isfinite(b).all(), name
    scale = np.abs(a).max()
    assert scale > 0, name
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.9999, (name, cos)
    assert np.abs(a - b).max() <= 1e-3 * scale, (name, np.abs(a - b).max(),
                                                 scale)


def test_direct_soft_value_and_vjp_match_jax():
    """soft_pass_value(mode="direct") and its autograd cotangents against
    JAX's value and jax.vjp, all five groups; kernel 2s's plain version
    (pathtrace_pass_bwd_soft_reference) equals that autograd."""
    js = cornell_box(cols=W, rows=H)
    jcfg = JaxConfig(width=W, height=H)
    tables = [np.asarray(t, np.float64)
              for t in jmega.scene_tables(js, jcfg)]
    u = np.asarray(jmega.u_planes_for_direct(
        jrng.pass_key(jrng.base_key(0), PASS), jcfg, js.lights.count),
        np.float64)
    g = np.random.default_rng(GRAD_SEED).normal(size=(W * H, 3))
    ipar = np.asarray([PASS, 0], np.int32)
    kw = dict(spp=1, width=W, bounces=0, two_sided=False,
              normalize_emitter=False, soft_bandwidth=BW, soft_tau=BW)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        def f(*tabs):
            return soft_pass_value(tabs[0], ipar, *tabs[1:], u,
                                   mode="direct", **kw)

        want, vjp = jax.vjp(f, *tables)
        want = np.asarray(want)
        wgrads = [np.asarray(x) for x in vjp(g)]
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert want.dtype == np.float64 and want.any()
    t = [torch.as_tensor(x).requires_grad_(True) for x in tables]
    tu, tg = torch.as_tensor(u), torch.as_tensor(g)
    tip = torch.as_tensor(ipar)
    got = MKS.soft_pass_value(t[0], tip, *t[1:], tu, mode="direct", **kw)
    _value_gate(got.detach().numpy(), want)
    grads = torch.autograd.grad(got, t, grad_outputs=tg)
    plain = MKS.pathtrace_pass_bwd_soft_reference(
        t[0].detach(), tip, *[x.detach() for x in t[1:]], tg, tu, seed=0,
        mode="direct", **kw)
    for group, a, b, c in zip(MKG.DIFF_ALL, wgrads, grads, plain):
        _grad_gate(group, b.numpy(), a)
        np.testing.assert_array_equal(c.numpy(), b.numpy())
