"""The port's hit searches (``ops/hit_kernels.py``, ``ops/closest_hit.py``)
against the JAX package: the plain versions of kernels 4 and 5 against
the Pallas kernels themselves in interpret mode, and the chunked all-pairs
search of ``use_pallas=False`` against JAX's matmul scan.

Inputs are made with numpy from seeds: random rays aimed into a cloud of
spheres or a triangle soup, with dead rays (mint == maxt, both INF and
finite), short windows, masked objects and duplicated objects (exact ties,
which go to the lowest index). Tolerances: idx equal on every ray; t
within rtol 1e-6 for triangles (the two packages build the triangle
constants with different cross-product routines, which may round the last
bit apart) and 1e-4 for spheres. XLA's CPU build of the interpret-mode
sphere kernel fuses and reorders its float32 arithmetic, while the port's
plain version equals a numpy float32 evaluation in the kernel's order bit
for bit (``test_plain_sphere_arithmetic_order``); for a ray that starts
far from a sphere the discriminant is a cancellation, and the two differ
by up to 8e-6 relative on ordinary hits (6e-5 at t ~ 8, less than either
differs from float64: up to 1.3e-4) and by 3.1e-5 on one grazing hit
(ROADMAP Queue 3, grazing sphere hits).
The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.core import types as jtypes
from raytracing_tpu.ops import closest_hit as jch
from raytracing_tpu.ops import intersect as jintersect
from raytracing_tpu.ops.pallas.hit_kernels import (sphere_search_pallas,
                                                   triangle_search_pallas)
from raytracing_tpu_torch.core import types
from raytracing_tpu_torch.ops import closest_hit as ch
from raytracing_tpu_torch.ops import hit_kernels as HK
from raytracing_tpu_torch.ops import intersect as I
from torch_threads import one_thread  # noqa: F401

N_RAYS = 384


def _rays(seed: int, n: int = N_RAYS):
    """(o, d, mint, maxt) numpy float32: rays from a shell around the
    origin toward random points near it; every 8th ray dead (INF/INF),
    every 16th dead at a finite t, every 5th with a short window."""
    g = np.random.default_rng(seed)
    o = g.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    o[:, 2] = np.abs(o[:, 2]) + 3.0
    aim = g.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mint = np.zeros((n,), np.float32)
    maxt = np.full((n,), 40.0, np.float32)
    mint[::5] = 4.0
    maxt[::5] = 9.0
    mint[::8] = maxt[::8] = np.inf
    mint[3::16] = maxt[3::16] = 2.5
    return o, d, mint, maxt


def _spheres(seed: int, n: int = 40):
    g = np.random.default_rng(seed)
    c = g.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    r = g.uniform(0.2, 0.7, n).astype(np.float32)
    c[7], r[7] = c[3], r[3]            # exact duplicate: ties go to 3
    c[20], r[20] = c[11], r[11]
    mask = np.ones((n,), bool)
    mask[[5, 13]] = False
    return c, r, mask


def _triangles(seed: int, n: int = 48):
    g = np.random.default_rng(seed)
    p0 = g.uniform(-2.0, 2.0, (n, 1, 3))
    v = (p0 + g.uniform(-1.2, 1.2, (n, 3, 3))).astype(np.float32)
    v[9] = v[2]                        # exact duplicate: ties go to 2
    v[30] = v[17]
    mask = np.ones((n,), bool)
    mask[[4, 25]] = False
    return v, mask


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _assert_same_champions(got, want, rtol=1e-6, hits_at_least=20):
    gt, gi = (np.asarray(x) for x in got)
    wt, wi = (np.asarray(x) for x in want)
    assert gi.dtype == np.int32 and gt.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isfinite(gt), np.isfinite(wt))
    fin = np.isfinite(wt)
    assert fin.sum() >= hits_at_least
    np.testing.assert_allclose(gt[fin], wt[fin], rtol=rtol)
    assert (gi[~fin] == -1).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_sphere_search_matches_pallas_interpret(seed):
    o, d, mint, maxt = _rays(seed)
    c, r, mask = _spheres(seed + 10)
    want = sphere_search_pallas(*_j(o, d, mint, maxt, c, r, mask),
                                interpret=True)
    before = HK.sphere_launches
    got = HK.sphere_search(*_t(o, d, mint, maxt, c, r, mask))
    assert HK.sphere_launches == before      # CPU tensors: plain version
    _assert_same_champions(got, want, rtol=1e-4)
    dead = mint == maxt
    assert (got[1].numpy()[dead] == -1).all()
    # the duplicated spheres never win: ties go to the lower index
    assert not np.isin(got[1].numpy(), [7, 20, 5, 13]).any()
    assert np.isin(got[1].numpy(), [3, 11]).any()


def test_plain_sphere_arithmetic_order():
    """The plain sphere search computes each champion's t in the Pallas
    kernel's (and the CUDA kernel's) order, unfused: a numpy float32
    evaluation of that order gives the same bits."""
    o, d, mint, maxt = _rays(0)
    c, r, mask = _spheres(10)
    t, i = HK.sphere_search(*_t(o, d, mint, maxt, c, r, mask))
    t, i = t.numpy(), i.numpy()
    hit = i >= 0
    f = np.float32
    o, d, c, r = o[hit], d[hit], c[i[hit]], r[i[hit]]
    m = o - c

    def dot(x, y):
        return (x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1]) + x[:, 2] * y[:, 2]
    a = dot(d, d)
    b = f(2) * dot(m, d)
    cq = dot(m, m) - r * r
    dis = b * b - (f(4) * a) * cq
    sq = np.sqrt(dis)
    inv2a = f(0.5) / a
    t0, t1 = (-b - sq) * inv2a, (-b + sq) * inv2a
    tmn = np.minimum(t0, t1)
    want = np.where(tmn >= mint[hit], tmn, np.maximum(t0, t1))
    np.testing.assert_array_equal(t[hit], want)


@pytest.mark.parametrize("two_sided", [False, True])
def test_plain_triangle_search_matches_pallas_interpret(two_sided):
    o, d, mint, maxt = _rays(2)
    v, mask = _triangles(3)
    want = triangle_search_pallas(*_j(o, d, mint, maxt, v, mask),
                                  two_sided=two_sided, interpret=True)
    before = HK.triangle_launches
    got = HK.triangle_search(*_t(o, d, mint, maxt, v, mask),
                             two_sided=two_sided)
    assert HK.triangle_launches == before
    _assert_same_champions(got, want)
    assert not np.isin(got[1].numpy(), [9, 30, 4, 25]).any()


def test_triangle_search_sides():
    """Two-sided hits are a superset of single-sided ones; a ray that sees
    a triangle from its back hits it only two-sided."""
    o, d, mint, maxt = _rays(4)
    v, mask = _triangles(5)
    one = HK.triangle_search(*_t(o, d, mint, maxt, v, mask), two_sided=False)
    two = HK.triangle_search(*_t(o, d, mint, maxt, v, mask), two_sided=True)
    f1, f2 = torch.isfinite(one[0]), torch.isfinite(two[0])
    assert (f2 | ~f1).all() and (f2 & ~f1).any()
    assert (two[0] <= one[0]).all()


def _rays_of(o, d, mint, maxt, pkg):
    if pkg is types:
        return types.Rays(*_t(o, d, mint, maxt))
    return jtypes.Rays(*_j(o, d, mint, maxt))


@pytest.mark.parametrize("obj_chunk", [16, 2048])
def test_xla_route_search_matches_jax_scan(obj_chunk):
    """``use_pallas=False``: the chunked all-pairs search against JAX's
    matmul scan, closest and any-hit, spheres and triangles (two-sided),
    one chunk and several."""
    o, d, mint, maxt = _rays(6)
    c, r, mask = _spheres(7)
    v, tmask = _triangles(8)
    mats = np.arange(c.shape[0], dtype=np.int32) % 4
    js = jtypes.Spheres(*_j(c, r), jnp.asarray(mats), jnp.asarray(mask))
    ps = types.Spheres(*_t(c, r, mats, mask))
    jt = jtypes.make_triangles(v, mat_ids=np.arange(48) % 3)
    jt = jtypes.Triangles(v=jt.v, vn=jt.vn, mat_id=jt.mat_id,
                          mask=jnp.asarray(tmask))
    pt = types.Triangles(v=torch.as_tensor(np.array(jt.v)),
                         vn=torch.as_tensor(np.array(jt.vn)),
                         mat_id=torch.as_tensor(np.array(jt.mat_id)),
                         mask=torch.as_tensor(tmask))
    jr, pr = _rays_of(o, d, mint, maxt, jtypes), _rays_of(o, d, mint, maxt,
                                                            types)
    cases = [
        (jch.closest_hit_spheres(jr, js, obj_chunk=obj_chunk),
         ch.closest_hit_spheres(pr, ps, obj_chunk=obj_chunk)),
        (jch.closest_hit_triangles(jr, jt, obj_chunk=obj_chunk,
                                   two_sided=True),
         ch.closest_hit_triangles(pr, pt, obj_chunk=obj_chunk,
                                  two_sided=True)),
    ]
    for want, got in cases:
        _assert_same_champions((got.t, got.idx), (want.t, want.idx))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
    want = jch.anyhit_spheres(jr, js, obj_chunk=obj_chunk)
    got = ch.anyhit_spheres(pr, ps, obj_chunk=obj_chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jch.anyhit_triangles(jr, jt, obj_chunk=obj_chunk, two_sided=True)
    got = ch.anyhit_triangles(pr, pt, obj_chunk=obj_chunk, two_sided=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("two_sided", [False, True])
def test_all_pairs_forms_match_jax_oracles(two_sided):
    """The split (matmul) forms the ``use_pallas=False`` search runs and
    the reference's cross-product (pairwise) oracle forms, against JAX's
    pairwise oracles: the same hits everywhere, t to rtol 1e-4 (the split
    form's expanded quadratic cancels more on far rays)."""
    o, d, mint, maxt = _rays(13, 128)
    c, r, mask = _spheres(14)
    v, tmask = _triangles(15)
    port = (I.sphere_ts_matmul(*_t(o, d, mint, maxt, c, r, mask)).T,
            I.sphere_ts_pairwise(*_t(o, d, mint, maxt, c, r, mask)),
            I.triangle_ts_matmul(*_t(o, d, mint, maxt),
                                 I.tri_constants(torch.as_tensor(v)),
                                 torch.as_tensor(tmask), two_sided).T,
            I.triangle_ts_pairwise(*_t(o, d, mint, maxt, v, tmask),
                                   two_sided))
    want_s = np.asarray(jintersect.sphere_ts_pairwise(
        *_j(o, d, mint, maxt, c, r, mask)))
    want_t = np.asarray(jintersect.triangle_ts_pairwise(
        *_j(o, d, mint, maxt, v, tmask), two_sided=two_sided))
    for got, want in zip(port, (want_s, want_s, want_t, want_t)):
        got = got.numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert fin.sum() > 30
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)


def test_both_routes_pick_the_same_champions():
    """The hit kernels' route and the all-pairs route of the port agree on
    every champion, its recomputed t, and the hit attributes."""
    o, d, mint, maxt = _rays(9)
    c, r, mask = _spheres(10)
    rays = types.Rays(*_t(o, d, mint, maxt))
    sp = types.Spheres(*_t(c, r, np.arange(40, dtype=np.int32) % 5, mask))
    a = ch.closest_hit_spheres(rays, sp, use_pallas=True)
    b = ch.closest_hit_spheres(rays, sp, use_pallas=False, obj_chunk=8)
    np.testing.assert_array_equal(a.idx.numpy(), b.idx.numpy())
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), rtol=1e-6)
    for x, y in zip(ch.sphere_hit_attrs(rays, sp, a),
                    ch.sphere_hit_attrs(rays, sp, b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)
    occ_a = ch.anyhit_spheres(rays, sp, use_pallas=True)
    np.testing.assert_array_equal(occ_a.numpy(), a.valid.numpy())


def test_wrappers_reject_bad_arguments():
    o, d, mint, maxt = _t(*_rays(11, 16))
    rows = HK.sphere_rows(*_t(*_spheres(12)))
    for bad in (dict(o=o.double()), dict(d=d[:, :2].contiguous()),
                dict(mint=mint[:8]), dict(rows=rows[:, :6].contiguous()),
                dict(o=o.t().contiguous().t())):
        args = {**dict(o=o, d=d, mint=mint, maxt=maxt, rows=rows), **bad}
        with pytest.raises(ValueError):
            HK.sphere_search_rows(**args)
    with pytest.raises(RuntimeError, match="not differentiable"):
        HK.sphere_search_rows(o.clone().requires_grad_(True), d, mint, maxt,
                              rows)
    with pytest.raises(ValueError, match="shape"):
        HK.triangle_search_rows(o, d, mint, maxt, rows)
