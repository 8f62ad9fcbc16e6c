"""The exactness premise of kernel 2s's sparse span composites past 64
objects (``csrc/pathtrace_soft_span.cuh``), on the plain versions of
``raytracing_tpu_torch/ops/megakernel_soft.py``, which stay dense and remain
the oracle.

The kernel drops every hypothesis whose alpha is exactly 0 for every ray
of a warp. That is exact because such a hypothesis puts a factor of
exactly 1 on every other one's product, adds exactly 0 to the coverage and
the blend, and gets a cotangent that is multiplied by one of its zero
factors. Here:

(a) ``_composite_span`` gives bit-equal coverage and blend with the
    exactly-zero columns removed (order kept): seeded spans that mix zero
    and tiny nonzero alphas, a span whose every alpha is 0, one with a
    single live column, live columns at indices 0 and 63;
(b) through autograd of ``_tri_hyp`` / ``_sphere_hyp`` and the two-level
    ``_composite_span`` on the cornell + torus scene's rows (992 faces in
    Morton order, 16 spans), every row whose alpha is 0 for every ray gets
    a row cotangent of exactly 0, and the rays' cotangents are unchanged,
    to 1 ulp, when those rows (and the spans left empty) are dropped;
(c) the shadow product (``_Scene.vis``, one product per span) gives the
    same bits, and the same cotangents, under the same dropping;
(d) why the kernel votes on alpha's factors, not on alpha: a row whose
    alpha is 0 only because the product of two nonzero sigmoids underflows
    gets a nonzero (denormal) cotangent, so it must stay live;
(e) ``live_stats``, which the kernel's live-work bound reads, counts per
    ray what a direct count of alpha's factors gives on the primary
    segment, and per warp at least what each of its rays needs.

Small sizes: a 16x12 film, spans of 64. No kernel is built.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core.types import dot3
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_soft as MKS
from raytracing_tpu_torch.render import mega

sys.path.insert(0, str(Path(__file__).parent))
from torch_grid_scenes import cornell_torus  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

W, H = 16, 12
TORUS = (31, 16)  # 992 faces: 16 Morton spans with the padding
BW = TAU = 2e-2
SEED = 13


# ---------------------------------------------------------------------------
# (a) one span's composite
# ---------------------------------------------------------------------------

def _span(case: str, rng, R: int = 96, n: int = 64):
    """alphas, ts (R, n), fields (R, n, 10) and the columns that are
    exactly 0 for every ray."""
    a = rng.uniform(0.0, 1.0, (R, n)).astype(np.float32)
    # per ray some zeros, some tiny nonzero alphas (normal and denormal)
    a *= rng.uniform(0.0, 1.0, (R, n)) < 0.6
    tiny = rng.uniform(0.0, 1.0, (R, n)) < 0.1
    a[tiny] = rng.choice(np.array([1e-30, 1e-38, 1e-44], np.float32),
                         tiny.sum())
    if case == "mixed":
        dead = rng.uniform(0.0, 1.0, n) < 0.7
        dead[[0, n - 1]] = False
    elif case == "all_dead":
        dead = np.ones(n, bool)
    elif case == "single_live":
        dead = np.ones(n, bool)
        dead[37] = False
    else:  # "edges": live columns 0 and 63 only
        dead = np.ones(n, bool)
        dead[[0, n - 1]] = False
    a[:, dead] = 0.0
    t = rng.uniform(0.0, 3.0, (R, n)).astype(np.float32)
    f = rng.normal(size=(R, n, 10)).astype(np.float32)
    return (torch.from_numpy(a), torch.from_numpy(t), torch.from_numpy(f),
            torch.from_numpy(dead))


@pytest.mark.parametrize("first_good", [1e-9, 1e-6])
@pytest.mark.parametrize("case", ["mixed", "all_dead", "single_live",
                                  "edges"])
def test_span_composite_drops_zero_columns_bitwise(case, first_good):
    a, t, f, dead = _span(case, np.random.default_rng(SEED))
    assert (a[:, dead] == 0).all()
    cov, blend = MKS._composite_span(a, t, f, first_good, TAU)
    keep = ~dead
    if not keep.any():
        # an empty span: coverage exactly 0, no blend -- the outer
        # composite drops it by the same rule
        assert (cov == 0).all() and (blend == 0).all()
        return
    cov2, blend2 = MKS._composite_span(a[:, keep], t[:, keep], f[:, keep],
                                       first_good, TAU)
    assert torch.equal(cov, cov2)
    assert torch.equal(blend, blend2)


# ---------------------------------------------------------------------------
# (b), (c) the torus scene's rows
# ---------------------------------------------------------------------------

def _torus():
    """The cornell + torus scene's tables (triangles in the soft backward's
    Morton order, padded), its primary rays and a seeded cotangent of the
    surface's coverage and blend."""
    scene = cornell_torus(W, H, *TORUS)
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    tables = list(mega.scene_tables(scene, cfg))
    chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
    tables[2] = mega.soft_tri_order(scene, tables[2], chunks).rows
    o, d, mint, _ = MK._camera_rays(tables[0], torch.zeros(W * H, 2), W * H,
                                    0, 1, W)
    rng = np.random.default_rng(SEED)
    g = torch.from_numpy(rng.normal(size=(W * H, 11)).astype(np.float32))
    return tables, (o, d, mint), g


def _rows_hyps(sc, ray, kind: str, idx: torch.Tensor, fields: bool = True):
    """alphas, ts (R, n) and fields (R, n, 10) of rows idx of one type, as
    ``_Scene.span_hyps`` computes a span's."""
    r = ray.over_rows()
    if kind == "s":
        rows = sc.sph[idx]
        a, t = MKS._sphere_hyp(rows, r, sc.bw)
        f = (MKS._sphere_fields(rows, r, t, sc.alb_s[idx]) if fields
             else None)
        return a, t, f
    rows = sc.tri[idx]
    a, t, beta, gamma = MKS._tri_hyp(rows, r, sc.bw, sc.two_sided)
    f = (MKS._tri_fields(rows, r, t, beta, gamma, sc.alb_t[idx]) if fields
         else None)
    return a, t, f


def _two_level(sc, ray, keep):
    """JAX's two-level composite (``_Scene.trace``) over the rows in keep
    (per type, a bool per row): each span's kept rows in order, a span
    with none dropped. Returns cov and the blend (R, 10)."""
    covs, blends = [], []
    for kind, lo, hi in sc.spans():
        idx = torch.arange(lo, hi)[keep[kind][lo:hi]]
        if idx.numel() == 0:
            continue
        a, t, f = _rows_hyps(sc, ray, kind, idx)
        cov, blend = MKS._composite_span(a, t, f, 1e-9, sc.tau)
        covs.append(cov)
        blends.append(blend)
    bm = torch.stack(blends, 1)
    return MKS._composite_span(torch.stack(covs, 1), bm[..., 0], bm, 1e-6,
                               sc.tau)


def _dead(sc, ray):
    """Per type, the rows whose alpha is exactly 0 for every ray, and the
    same rows' verdict by alpha's factors (a sigmoid, the mask or the side
    exactly 0), which is the kernel's vote."""
    out, by_factor = {}, {}
    r = ray.over_rows()
    with torch.no_grad():
        a, t = MKS._sphere_hyp(sc.sph, r, sc.bw)
        out["s"] = (a == 0).all(0)
        m = r.o - sc.sph[:, 0:3]
        b = dot3(m, r.d)
        dis = b * b - (dot3(m, m) - sc.sph[:, 3] ** 2)
        fz = ((torch.sigmoid(MKS._div(dis, sc.bw)) == 0)
              | (sc.sph[:, 5] <= 0)
              | (torch.sigmoid(MKS._div(t - r.mint, sc.bw)) == 0))
        by_factor["s"] = fz.all(0)
        a, t, beta, gamma = MKS._tri_hyp(sc.tri, r, sc.bw, sc.two_sided)
        out["t"] = (a == 0).all(0)
        margin = torch.minimum(torch.minimum(beta, gamma),
                               1.0 - beta - gamma)
        side = dot3(sc.tri[:, 0:3], r.d) > 0.0
        fz = ((torch.sigmoid(MKS._div(margin, sc.bw)) == 0)
              | (sc.tri[:, 17] <= 0) | ~side
              | (torch.sigmoid(MKS._div(t - r.mint, sc.bw)) == 0))
        by_factor["t"] = fz.all(0)
    return out, by_factor


def _leaves(tables, rays, dtype=torch.float32):
    sph, tri, mat = (tables[i].to(dtype).requires_grad_(True)
                     for i in (1, 2, 3))
    o, d, mint = (x.to(dtype).requires_grad_(True) for x in rays)
    return sph, tri, mat, o, d, mint


def _ulp32(a: torch.Tensor, b: torch.Tensor, rows: bool = False) -> float:
    """The largest |a - b| (float64) in float32 ulps of max(|a|, |b|): at
    each entry, or with ``rows`` at the largest entry of its row (a table
    row's words, whose small ones are sums that cancel)."""
    m = torch.maximum(a.abs(), b.abs())
    if rows:
        m = m.reshape(m.shape[0], -1).amax(1).reshape(-1, *(1,) * (m.dim() - 1))
    m = m.float()
    sp = (torch.nextafter(m, torch.full_like(m, float("inf"))) - m).double()
    d = (a - b).abs()
    return float(torch.where(d == 0, 0.0, d / sp).max())


def test_two_level_is_the_plain_trace():
    """The test's two-level composite over every row is the plain
    version's soft_trace, bit for bit."""
    tables, rays, _ = _torus()
    sc = MKS._Scene(tables[1], tables[2], tables[3], tables[4], BW, TAU,
                    False)
    ray = MKS._Ray(*rays)
    cov, blend = _two_level(sc, ray, {"s": torch.ones(2, dtype=torch.bool),
                                      "t": torch.ones(tables[2].shape[0],
                                                      dtype=torch.bool)})
    cov2, tbar, pbar, _, alb = sc.trace(ray)
    assert torch.equal(cov, cov2)
    assert torch.equal(blend[:, 0], tbar)
    assert torch.equal(blend[:, 1:4], pbar)
    assert torch.equal(blend[:, 7:10], alb)


def _surface_grads(tables, rays, g, keep, dtype):
    """Cotangents (tri, sph, mat, o, d, mint) of <g, (cov, blend)> of the
    two-level composite over the rows in keep, in dtype, and the surface."""
    sph, tri, mat, o, d, mint = _leaves(tables, rays, dtype)
    sc = MKS._Scene(sph, tri, mat, tables[4].to(dtype), BW, TAU, False)
    cov, blend = _two_level(sc, MKS._Ray(o, d, mint), keep)
    g = g.to(dtype)
    loss = (g[:, 0] * cov).sum() + (g[:, 1:] * blend).sum()
    return torch.autograd.grad(loss, (tri, sph, mat, o, d, mint)), cov, blend


def test_surface_dead_rows_have_zero_cotangents():
    """(b). The float32 surface is bit-equal without the dead rows and
    their cotangents are exactly 0. The plain version's backward sums a
    block of rows as a vector (reassociating when a term goes: 5-6 ulps
    on this data in float32), where the kernel's loops add in row order;
    so the rays' and the live rows' cotangents under the dropping are held
    in float64, to a float32 ulp (a row's: of its largest word): what was
    dropped moves nothing a float32 result can show."""
    tables, rays, g = _torus()
    sc = MKS._Scene(tables[1], tables[2], tables[3], tables[4], BW, TAU,
                    False)
    dead, by_factor = _dead(sc, MKS._Ray(*rays))
    # the premise holds here with the kernel's vote: no row is 0 for every
    # ray by an underflowed product alone
    assert torch.equal(dead["t"], by_factor["t"])
    assert torch.equal(dead["s"], by_factor["s"])
    n_tri = tables[2].shape[0]
    assert 0 < int(dead["t"].sum()) < n_tri
    every = {"s": torch.ones(2, dtype=torch.bool),
             "t": torch.ones(n_tri, dtype=torch.bool)}
    keep = {"s": torch.ones(2, dtype=torch.bool), "t": ~dead["t"]}
    spans_left = sum(bool(keep["t"][lo:hi].any()) for k, lo, hi in sc.spans()
                     if k == "t")
    assert spans_left < n_tri // MKS.SOFT_CHUNK  # a whole span goes too
    full, cov, blend = _surface_grads(tables, rays, g, every, torch.float32)
    dropped, cov2, blend2 = _surface_grads(tables, rays, g, keep,
                                           torch.float32)
    assert torch.equal(cov, cov2) and torch.equal(blend, blend2)
    # every row that is dead for every ray: a cotangent of exactly 0
    assert (full[0][dead["t"]] == 0).all()
    assert full[0][~dead["t"]].abs().max() > 0
    assert (dropped[0][dead["t"]] == 0).all()
    full, _, _ = _surface_grads(tables, rays, g, every, torch.float64)
    dropped, _, _ = _surface_grads(tables, rays, g, keep, torch.float64)
    for name, a, b in zip(("o", "d", "mint"), full[3:], dropped[3:]):
        assert _ulp32(a, b) <= 1.0, name
    live = ~dead["t"]
    assert _ulp32(full[0][live], dropped[0][live], rows=True) <= 1.0
    assert _ulp32(full[1], dropped[1], rows=True) <= 1.0
    assert _ulp32(full[2], dropped[2], rows=True) <= 1.0


def _shadow_rays(tables):
    """Seeded shadow rays across the room toward the light: origins on the
    floor, directions to points of the light's disk, and their lengths."""
    rng = np.random.default_rng(SEED + 1)
    n = W * H
    lig = tables[4][0]
    so = torch.from_numpy(np.stack([rng.uniform(-0.9, 0.9, n),
                                    np.full(n, -0.99),
                                    rng.uniform(-0.9, 0.9, n)], 1)
                          .astype(np.float32))
    tgt = lig[0:3] + torch.from_numpy(
        rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)) * torch.tensor(
            [1.0, 0.0, 1.0])
    dl = tgt - so
    dist = torch.sqrt(dot3(dl, dl))
    return so, dl / dist[:, None], dist


def _vis_kept(sc, o, d, dist, keep):
    """``_Scene.vis`` over the rows in keep: each span's product of its
    kept rows' factors in order."""
    ray = MKS._Ray(o, d, torch.zeros_like(dist))
    vis = torch.ones_like(dist)
    for kind, lo, hi in sc.spans():
        idx = torch.arange(lo, hi)[keep[kind][lo:hi]]
        if idx.numel() == 0:
            continue
        a, t, _ = _rows_hyps(sc, ray, kind, idx, fields=False)
        inside = a * torch.sigmoid(MKS._div(dist[:, None] - t, sc.bw))
        vis = vis * MKS._ordered_prod(1.0 - inside)
    return vis


def _vis_grads(tables, rays, g, keep, dtype):
    """Cotangents (tri, sph, o, d, dist) of <g, vis> over the rows in keep
    (every row: the plain ``_Scene.vis``), in dtype, and vis."""
    sph, tri, mat, o, d, dist = _leaves(tables, rays, dtype)
    sc = MKS._Scene(sph, tri, mat, tables[4].to(dtype), BW, TAU, False)
    vis = (sc.vis(o, d, dist) if keep is None
           else _vis_kept(sc, o, d, dist, keep))
    out = torch.autograd.grad((g[:, 0].to(dtype) * vis).sum(),
                              (tri, sph, o, d, dist), allow_unused=True)
    return out, vis


def test_shadow_product_drops_dead_rows():
    """(c), as (b): the float32 product bit-equal, the dead rows'
    cotangents exactly 0, the rest in float64 to a float32 ulp."""
    tables, _, g = _torus()
    rays = _shadow_rays(tables)
    sc = MKS._Scene(tables[1], tables[2], tables[3], tables[4], BW, TAU,
                    False)
    dead, by_factor = _dead(sc, MKS._Ray(rays[0], rays[1],
                                         torch.zeros_like(rays[2])))
    assert torch.equal(dead["t"], by_factor["t"])
    assert 0 < int(dead["t"].sum()) < tables[2].shape[0]
    keep = {"s": ~dead["s"], "t": ~dead["t"]}
    full, vis = _vis_grads(tables, rays, g, None, torch.float32)
    dropped, vis2 = _vis_grads(tables, rays, g, keep, torch.float32)
    assert torch.equal(vis, vis2)
    assert (vis < 1).any() and (vis > 0).any()
    assert (full[0][dead["t"]] == 0).all()
    assert (full[1][dead["s"]] == 0).all()
    full, _ = _vis_grads(tables, rays, g, None, torch.float64)
    dropped, _ = _vis_grads(tables, rays, g, keep, torch.float64)
    for name, a, b in zip(("o", "d", "dist"), full[2:], dropped[2:]):
        assert _ulp32(a, b) <= 1.0, name
    assert _ulp32(full[0][~dead["t"]], dropped[0][~dead["t"]],
                  rows=True) <= 1.0


# ---------------------------------------------------------------------------
# (d) the vote is on alpha's factors
# ---------------------------------------------------------------------------

def test_underflowed_alpha_keeps_a_cotangent():
    """A sphere seen at a silhouette margin and a depth whose sigmoids are
    both nonzero (about 1e-23 each, x = -53) has alpha exactly 0 (their
    product underflows), yet its plain cotangent under a large alpha
    cotangent is a nonzero denormal: the kernel keeps such a row live
    (hyp_vote votes on the factors, not on alpha)."""
    torch.set_flush_denormal(False)
    o = torch.zeros(1, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]])
    rad, dis = 0.5, -1.06  # dis / bw = -53; the centre 1.06 behind mint
    lateral = (rad * rad - dis) ** 0.5
    row = torch.tensor([[lateral, 0.0, dis, rad, 0.0, 1.0, 0.0, 0.0]],
                       requires_grad=True)
    ray = MKS._Ray(o, d, torch.zeros(1)).over_rows()
    a, t = MKS._sphere_hyp(row, ray, BW)
    with torch.no_grad():
        m = ray.o - row[..., 0:3]
        b = dot3(m, ray.d)
        dis_ = b * b - (dot3(m, m) - row[..., 3] ** 2)
        s1 = torch.sigmoid(MKS._div(dis_, BW))
        s2 = torch.sigmoid(MKS._div(t - ray.mint, BW))
    assert float(a) == 0.0 and float(s1) > 0.0 and float(s2) > 0.0
    gr, = torch.autograd.grad(1e3 * a.sum(), row)
    assert gr.abs().max() > 0.0
    assert gr.abs().max() < 1e-37  # denormal: below anything float32 shows


# ---------------------------------------------------------------------------
# (e) live_stats' counts
# ---------------------------------------------------------------------------

def test_live_stats_counts_each_rays_factors():
    """(e) On the torus scene's primary segment (direct mode): per ray on
    its path, the rows that evaluate each factor of alpha (up to the first
    exactly 0), the live rows, the ordered pairs of live rows within each
    span and of the spans holding one, and those spans, as a direct count
    of the factors gives; each warp's union of live rows holds at least
    every one of its rays' own."""
    tables, _, _ = _torus()
    n, seed = W * H, 5
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    st = MKS.live_stats(tables[0], ipar, *tables[1:], None,
                        blocks=[(0, n)], spp=1, width=W, bounces=0,
                        two_sided=False, normalize_emitter=True, seed=seed,
                        soft_bandwidth=BW, soft_tau=TAU, mode="direct")
    u = MK.diff_draws(ipar, None, n, tables[4].shape[0], 0, seed,
                      torch.device("cpu"), False, "direct", 1)
    o, d, mint, _ = MK._camera_rays(tables[0], u[0:2].t(), n, 0, 1, W)
    live = mint < float("inf")
    r = MKS._Ray(o, d, mint).over_rows()
    sc = MKS._Scene(tables[1], tables[2], tables[3], tables[4], BW, TAU,
                    False)
    want = {"reach_s": np.zeros(3), "reach_t": np.zeros(4), "rows_s": 0,
            "rows_t": 0, "pairs": 0, "spans": 0}
    spans = torch.zeros(n, dtype=torch.int64)
    pairs = torch.zeros(n, dtype=torch.int64)
    for kind, lo, hi in sc.spans():
        if kind == "s":
            fs, _ = MKS._sphere_factors(sc.sph[lo:hi], r, BW)
        else:
            fs, *_ = MKS._tri_factors(sc.tri[lo:hi], r, BW, False)
        nz = torch.stack(torch.broadcast_tensors(*fs), -1) != 0.0
        # factors a row evaluates: through its first zero, or all
        first = torch.where(nz.all(-1), nz.shape[-1],
                            (~nz).to(torch.int64).argmax(-1) + 1)
        for k in range(nz.shape[-1]):
            want[f"reach_{kind}"][k] += float((first > k)[live].sum())
        own = nz.all(-1).sum(1)
        want[f"rows_{kind}"] += int(own[live].sum())
        pairs += own * (own - 1)
        spans += own > 0
    pairs += spans * (spans - 1)
    want["pairs"] = int(pairs[live].sum())
    want["spans"] = int(spans[live].sum())
    sur = st["surface"]
    m = int(live.sum())
    assert sur["ray_segments"] == m > 0
    for key, x in want.items():
        assert np.allclose(np.asarray(sur[key]) * m, x), key
    assert 0 < sur["rows_t"] < tables[2].shape[0]
    for kind in ("surface", "shadow"):
        x = st[kind]
        assert x["warp_segments"] == n // 32
        assert x["union_rows"] * x["warp_segments"] >= \
            (x["rows_s"] + x["rows_t"]) * x["ray_segments"] / 32
        assert 0 < x["max_union"] <= MKS.SOFT_CHUNK
