"""The edge-aware (soft) backward past 64 objects per type against the JAX
package: kernel 2s's plain version (``pathtrace_pass_bwd_soft_reference``,
which the kernel's large-table instance is held to on the card) against JAX's
``_bwd_reference`` with ``soft_bandwidth > 0`` on the same tables, u-planes
and cotangent: the cornell + torus scene's 138 triangles in JAX's Morton
order (``tri_chunk_tables``, padded with zero rows to 256: four
``SOFT_CHUNK`` spans) and 70 spheres (two spans), so the two-level
composite runs over two or more spans of each type, without and with the
roulette. Also: the differentiable pass hands the soft backward the
triangles in that order and returns their cotangents to the original rows;
zero padding rows change no value; edge x grid equals the brute edge
route; a finite-gradient probe.

JAX runs eagerly (a compile of the whole-tile vjp takes minutes; each
oracle ~50 s at 8x6 b2). Gates as ``tests/test_torch_edge_parity.py``'s:
per group cosine >= 0.9999 and max |d| <= 1e-3 of the group's largest
entry, the plain case in float64 on both sides (JAX under
``jax_enable_x64``), the roulette case in float32 with cornell's white
tinted to (0.95, 0.9, 0.85) -- that module's docstring says why: float32
rounding picks branches of the soft program at the roulette's clip bound
and at cancelling discriminants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JConfig
from raytracing_tpu.ops.pallas.megakernel_grad import _bwd_reference
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu.render.stages import _all_triangles as jall_triangles
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.ops import megakernel_soft as MKS
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_grid_scenes import cornell_torus, jax_cornell_torus
from torch_threads import one_thread  # noqa: F401

W, H, B = 8, 6, 2
TORUS = (16, 4)
EXTRA_SPHERES = 68
RR_START = 1
GRAD_SEED = 3
BW = 2e-2
ALL = MKG.DIFF_ALL


@pytest.fixture(scope="module", autouse=True)
def jax_cpu_semantics():
    """The partitionable threefry layout the port reproduces, and XLA-CPU's
    flush of subnormals (``tests/test_torch_edge_parity.py``)."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    jax.config.update("jax_threefry_partitionable", old)


def _kw(rr):
    return dict(spp=1, width=W, bounces=B, two_sided=False,
                normalize_emitter=True, russian_roulette=rr,
                rr_start_depth=RR_START)


def _tables(rr):
    """Numpy tables: the torus scene's, its triangles in JAX's Morton
    order padded to whole chunks (32 columns), EXTRA_SPHERES seeded small
    spheres added; and the u-planes."""
    js = jax_cornell_torus(W, H, *TORUS)
    cfg = JConfig(width=W, height=H, bounces=B, russian_roulette=rr,
                  rr_start_depth=RR_START)
    par, sph, tri, mat, lig = (np.asarray(t)
                               for t in jmega.scene_tables(js, cfg))
    sorted_tri, _ = jmega.tri_chunk_tables(js, jnp.asarray(tri),
                                           jall_triangles(js))
    tri_s = np.asarray(sorted_tri)[:, :32]
    rng = np.random.default_rng(0)
    lo, hi = par[18:21], par[21:24]
    extra = np.zeros((EXTRA_SPHERES, 8), np.float32)
    extra[:, 0:3] = lo + (hi - lo) * rng.uniform(0.2, 0.8,
                                                 (EXTRA_SPHERES, 3))
    extra[:, 3] = 0.03 * np.linalg.norm(hi - lo)
    extra[:, 4] = sph[0, 4]
    extra[:, 5] = 1.0
    sph = np.concatenate([sph, extra])
    if rr:
        mat = mat.copy()
        mat[0, :3] = (0.95, 0.9, 0.85)
    u = np.asarray(jmega.u_planes_for_pass(jpt.init_state(cfg)["key"], 0,
                                           cfg, js.lights.count))
    return [par, sph, tri_s, mat, lig], u


@pytest.mark.parametrize("rr,dtype", [(False, np.float64),
                                      (True, np.float32)],
                         ids=["f64", "rr-tinted"])
def test_plain_soft_backward_two_level_matches_jax(rr, dtype):
    tables, u = _tables(rr)
    spans = [-(-t.shape[0] // MKS.SOFT_CHUNK) for t in tables[1:3]]
    assert min(spans) >= 2, spans
    tables = [t.astype(dtype) for t in tables]
    u = u.astype(dtype)
    g = np.random.default_rng(GRAD_SEED).normal(size=(W * H, 3)).astype(dtype)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        want = [np.asarray(x) for x in _bwd_reference(
            tables[0], np.zeros(2, np.int32), *tables[1:], g, u, seed=1234,
            mode="path", soft_bandwidth=BW, soft_tau=BW, **_kw(rr))]
    finally:
        jax.config.update("jax_enable_x64", x64)
    got = MKS.pathtrace_pass_bwd_soft_reference(
        torch.as_tensor(tables[0]), torch.zeros(2, dtype=torch.int32),
        *(torch.as_tensor(t) for t in tables[1:]), torch.as_tensor(g),
        torch.as_tensor(u), seed=1234, soft_bandwidth=BW, soft_tau=BW,
        **_kw(rr))
    for name, a, b in zip(ALL, want, got):
        assert b.shape == a.shape, name
        a, b = a.astype(np.float64).ravel(), b.numpy().astype(np.float64)
        b = b.ravel()
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max()
        assert scale > 0, name
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999, name
        assert np.abs(a - b).max() <= 1e-3 * scale, name


def test_zero_padding_rows_are_value_neutral():
    """The soft program over the Morton-sorted triangles with and without
    the zero rows that pad them to whole chunks (a span of them all, and
    one in part): the same value to float32 rounding (the spans' products
    and sums group their factors differently)."""
    tables, u = _tables(False)
    t = [torch.as_tensor(x) for x in tables]
    n = 138
    assert t[2].shape[0] == 256 and not t[2][n:].any()
    kw = dict(_kw(False), soft_bandwidth=BW, soft_tau=BW)
    ipar = torch.zeros(2, dtype=torch.int32)
    padded = MKS.soft_pass_value(t[0], ipar, t[1], t[2], *t[3:],
                                 torch.as_tensor(u), **kw)
    bare = MKS.soft_pass_value(t[0], ipar, t[1], t[2][:n].contiguous(),
                               *t[3:], torch.as_tensor(u), **kw)
    assert padded.abs().max() > 0
    torch.testing.assert_close(padded, bare, rtol=1e-5, atol=1e-6)


def _edge_grads(sc, cfg):
    m = sc.meshes[0]
    tv = m.tris.v.detach().clone().requires_grad_(True)
    c = sc.spheres.center.detach().clone().requires_grad_(True)
    s = replace(sc, spheres=replace(sc.spheres, center=c),
                meshes=(replace(m, tris=replace(m.tris, v=tv)),))
    st = pt.render_pass(s, pt.init_state(cfg, "cpu"), cfg)
    torch.mean(st["acc"] ** 2).backward()
    return st["acc"].detach(), tv.grad, c.grad


def test_soft_cotangents_return_to_original_rows():
    """The edge route past 64 triangles: its tables' cotangents equal the
    plain soft backward run by hand on the Morton-sorted rows
    (``soft_tri_order``) and mapped back through ``perm``
    (``MKG.unpermute_rows``); the order matters (the table's own order
    gives other cotangents), padding rows' cotangents are dropped."""
    sc = cornell_torus(W, H, *TORUS)
    cfg = RenderConfig(width=W, height=H, bounces=B, use_megakernel=True,
                       mega_edge_bandwidth=BW, mega_grad_wrt=ALL)
    tables = [x.detach().clone().requires_grad_(True)
              for x in mega.scene_tables(sc, cfg)]
    chunks = mega.chunk_tables(sc, cfg, tables[1], tables[2])
    st = mega.soft_tri_order(sc, tables[2], chunks)
    assert st is chunks.tri
    kw = dict(spp=1, width=W, bounces=B, two_sided=False,
              normalize_emitter=True, seed=0)
    u = mega.u_planes_for_pass(pt.init_state(cfg, "cpu")["key"], 0, cfg,
                               sc.lights.count)
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(W * H, 3)).astype(np.float32))
    acc = MKG.pathtrace_pass_diff(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((W * H, 3)), u, chunks=chunks, soft_bandwidth=BW,
        soft_tau=BW, soft_tri=st, **kw)
    acc.backward(g)
    plain = [x.detach() for x in tables]
    sorted_ = MKS.pathtrace_pass_bwd_soft_reference(
        plain[0], torch.zeros(2, dtype=torch.int32), plain[1], st.rows,
        *plain[3:], g, u, soft_bandwidth=BW, soft_tau=BW, **kw)
    want = MKG.unpermute_rows(sorted_[2], st.perm, plain[2].shape[0])
    torch.testing.assert_close(tables[2].grad, want, rtol=0, atol=0)
    for i in (0, 1, 3, 4):
        torch.testing.assert_close(tables[i].grad, sorted_[i], rtol=0,
                                   atol=0)
    own = MKS.pathtrace_pass_bwd_soft_reference(
        plain[0], torch.zeros(2, dtype=torch.int32), *plain[1:], g, u,
        soft_bandwidth=BW, soft_tau=BW, **kw)
    assert not torch.allclose(own[2], want)
    # unpermute_rows: row perm[r] gets sorted row r, padding dropped
    perm = torch.tensor([2, 0, 1, -1], dtype=torch.int32)
    d = torch.arange(8.0).reshape(4, 2)
    assert MKG.unpermute_rows(d, perm, 3).tolist() == [[2, 3], [4, 5],
                                                      [0, 1]]


def test_edge_grid_past_64_matches_brute_edge_route():
    """Edge x grid on the torus scene (kernel 1's grid forward; the soft
    backward over a sorted copy built for it alone) against the brute
    edge route over the streamed table: the same accumulator and
    cotangents."""
    cfg = RenderConfig(width=W, height=H, bounces=B, use_megakernel=True,
                       mega_edge_bandwidth=BW, mega_grad_wrt=ALL)
    brute = _edge_grads(cornell_torus(W, H, *TORUS), cfg)
    grid = _edge_grads(prepare_grids(cornell_torus(W, H, *TORUS), 2),
                       replace(cfg, use_grid=True))
    for a, b in zip(grid, brute):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rr", [False, True])
def test_edge_route_past_64_gradient_is_finite(rr):
    """A finite-gradient probe of kernel 2s's route past 64 objects (its
    plain version on the CPU): the torus scene (138 triangles, Morton-
    sorted) at b5, every group finite and nonzero."""
    sc = cornell_torus(W, H, *TORUS)
    cfg = RenderConfig(width=W, height=H, bounces=5, use_megakernel=True,
                       mega_edge_bandwidth=BW, russian_roulette=rr,
                       rr_start_depth=RR_START, mega_grad_wrt=ALL)
    tables = [x.detach().clone().requires_grad_(True)
              for x in mega.scene_tables(sc, cfg)]
    chunks = mega.chunk_tables(sc, cfg, tables[1], tables[2])
    acc = MKG.pathtrace_pass_diff(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((W * H, 3)), None, spp=1, width=W, bounces=5,
        two_sided=False, normalize_emitter=True, seed=0,
        russian_roulette=rr, rr_start_depth=RR_START, chunks=chunks,
        soft_bandwidth=BW, soft_tau=BW,
        soft_tri=mega.soft_tri_order(sc, tables[2], chunks))
    torch.mean(acc ** 2).backward()
    for name, t in zip(ALL, tables):
        assert torch.isfinite(t.grad).all(), name
        assert t.grad.abs().max() > 0, name
    assert tables[2].shape[0] > MK.UNROLL_OBJECTS
