"""The edge-aware (soft) route against the JAX package: the port's
``soft_pass_value`` against JAX's ``soft_pass_value``, and kernel 2s's
plain version ``pathtrace_pass_bwd_soft_reference`` against JAX's
``_bwd_reference`` with ``soft_bandwidth > 0``, on the same tables,
u-planes and cotangent (cornell, from ``scene_tables`` of the JAX scene).

JAX runs eagerly, never under jit (an XLA-CPU compile of the whole-tile vjp
takes minutes, ``tests/test_edge_grad.py``), and each JAX oracle is computed
once per module. XLA's CPU backend flushes subnormal floats to zero, and
the soft blend of opposing normals can leave subnormal components, which
decide the bounce's tangent frame (its least |component|): the port's CPU
arithmetic flushes them too in this module (``torch.set_flush_denormal``).

Gates: values within rtol = atol = 2e-4 on at least 99.9% of entries and
none beyond 1e-3 (the b5 hard parity test's allowance); cotangents per
group cosine >= 0.9999 and max |d| <= 1e-3 of the group's largest entry.

Two inputs of the backward cases are chosen away from places where float32
rounding alone picks a branch of the program, measured on this pair of
programs: (1) cornell 16x12 b2 runs in float64 on both sides (JAX under
``jax_enable_x64``): in float32 every group but par meets the gates, and
par misses max |d| (1.8e-3 of its scale) through two silhouette rays whose
discriminant b^2 - c cancels, each program's float32 par 8e-3 from its own
float64 value; (2) the roulette case tints cornell's white material (1, 1,
1) to (0.95, 0.9, 0.85): with it, a throughput of (0.99999988, 1.0,
0.99999988) sits on the survival clip's bound 1 and one ray's branch turns
the mat cosine to 0.9947; tinted, every group agrees to 5e-6 of scale in
float32.
"""
import numpy as np
import pytest
import jax
import torch

from raytracing_tpu import RenderConfig as JConfig
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.ops.pallas.megakernel_grad import (_bwd_reference,
                                                       soft_pass_value)
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.ops import megakernel_soft as MKS
from torch_edge_scenes import split_tables
from torch_threads import one_thread  # noqa: F401

RR_START = 1
GRAD_SEED = 3


@pytest.fixture(scope="module", autouse=True)
def jax_cpu_semantics():
    """The partitionable threefry layout the port reproduces, and XLA-CPU's
    flush of subnormals."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    jax.config.update("jax_threefry_partitionable", old)


def _inputs(w, h, bounces, rr=False):
    """(scene, numpy tables, numpy u-planes, kwargs) of cornell at w x h."""
    cfg = JConfig(width=w, height=h, bounces=bounces, russian_roulette=rr,
                  rr_start_depth=RR_START)
    scene = cornell_box(cols=w, rows=h)
    tables = [np.asarray(t) for t in jmega.scene_tables(scene, cfg)]
    u = np.asarray(jmega.u_planes_for_pass(jpt.init_state(cfg)["key"], 0,
                                           cfg, scene.lights.count))
    kw = dict(spp=1, width=w, bounces=bounces, two_sided=False,
              normalize_emitter=True, russian_roulette=rr,
              rr_start_depth=RR_START)
    return scene, tables, u, kw


def _port(tables, u):
    return [torch.as_tensor(t) for t in tables], torch.as_tensor(u)


def _value_gate(got, want):
    err = np.abs(got - want)
    beyond = err > 2e-4 + 2e-4 * np.abs(want)
    assert np.isfinite(got).all()
    assert beyond.mean() <= 1e-3, (beyond.mean(), err.max())
    assert err.max() <= 1e-3, err.max()


@pytest.mark.parametrize("bw", [2e-2, 5e-2])
@pytest.mark.parametrize("bounces,rr", [(1, False), (2, False), (2, True)])
def test_torch_edge_soft_value_matches_jax(bounces, rr, bw):
    _, tables, u, kw = _inputs(16, 12, bounces, rr)
    ipar = np.zeros(2, np.int32)
    want = np.asarray(soft_pass_value(tables[0], ipar, *tables[1:], u,
                                      soft_bandwidth=bw, soft_tau=bw, **kw))
    t, tu = _port(tables, u)
    got = MKS.soft_pass_value(t[0], torch.as_tensor(ipar), *t[1:], tu,
                              soft_bandwidth=bw, soft_tau=bw, **kw).numpy()
    assert got.shape == want.shape == (16 * 12, 3)
    _value_gate(got, want)


def test_torch_edge_two_level_composite_matches_jax():
    """66 hypotheses (6 spheres, 60 wall triangles): each type composites
    as a chunk, then the two chunks' blends composite again."""
    scene, tables, u, kw = _inputs(8, 6, 1)
    tables = split_tables(tables, np.asarray(scene.triangles.v),
                          np.asarray(scene.triangles.vn))
    assert tables[1].shape[0] + tables[2].shape[0] > 64
    assert max(tables[1].shape[0], tables[2].shape[0]) <= 64
    ipar = np.zeros(2, np.int32)
    want = np.asarray(soft_pass_value(tables[0], ipar, *tables[1:], u,
                                      soft_bandwidth=2e-2, soft_tau=2e-2,
                                      **kw))
    t, tu = _port(tables, u)
    got = MKS.soft_pass_value(t[0], torch.as_tensor(ipar), *t[1:], tu,
                              soft_bandwidth=2e-2, soft_tau=2e-2,
                              **kw).numpy()
    _value_gate(got, want)


@pytest.fixture(scope="module",
                params=[(16, 12, False, np.float64), (8, 6, True, np.float32)],
                ids=["16x12-b2-f64", "8x6-b2-rr"])
def backward(request):
    """JAX's soft cotangents (all five groups) and the inputs, once (see
    the module docstring for the float64 case and the roulette's tint)."""
    w, h, rr, dtype = request.param
    _, tables, u, kw = _inputs(w, h, 2, rr)
    if rr:
        tables[3] = tables[3].copy()
        tables[3][0, :3] = (0.95, 0.9, 0.85)
    tables = [t.astype(dtype) for t in tables]
    u = u.astype(dtype)
    g = np.random.default_rng(GRAD_SEED).normal(size=(w * h, 3)).astype(dtype)
    ipar = np.zeros(2, np.int32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        want = _bwd_reference(tables[0], ipar, *tables[1:], g, u, seed=1234,
                              mode="path", soft_bandwidth=2e-2,
                              soft_tau=2e-2, **kw)
        want = [np.asarray(x) for x in want]
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert all(x.dtype == dtype for x in want)
    return tables, u, g, kw, want


def _grad_gate(name, got, want):
    a, b = want.astype(np.float64).ravel(), got.astype(np.float64).ravel()
    assert np.isfinite(b).all(), name
    scale = np.abs(a).max()
    assert scale > 0, name
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.9999, (name, cos)
    assert np.abs(a - b).max() <= 1e-3 * scale, (name, np.abs(a - b).max(),
                                                 scale)


@pytest.mark.parametrize("wrt", [MKG.DIFF_ALL, ("sph", "mat")],
                         ids=["all", "sph-mat"])
def test_torch_edge_soft_backward_matches_jax(backward, wrt):
    tables, u, g, kw, want = backward
    t, tu = _port(tables, u)
    got = MKS.pathtrace_pass_bwd_soft_reference(
        t[0], torch.zeros(2, dtype=torch.int32), *t[1:], torch.as_tensor(g),
        tu, seed=1234, diff_wrt=wrt, soft_bandwidth=2e-2, soft_tau=2e-2,
        **kw)
    for name, a, b in zip(MKG.DIFF_ALL, want, got):
        assert b.shape == a.shape, name
        if name in wrt:
            _grad_gate(name, b.numpy(), a)
        else:
            assert not b.any(), name
