"""Edge-aware gradients: kernel 2's soft route, the counterpart of
``_tile_program_soft`` in ``raytracing_tpu/ops/pallas/megakernel_grad.py``
(``:1516-2144``; ``soft_pass_value`` ``:2668``, ``_bwd_reference`` with
``soft_bandwidth > 0`` ``:2364``), path mode, with or without Russian
roulette, and direct mode (``mode="direct"``: the primary segment's
blended surface shaded per light by ``clip(ambient + soft_vis *
clip(cos))``, weighted by its coverage; ``_soft_direct``).

The forward value of an edge-aware pass stays kernel 1's hard pass; its
backward is the exact adjoint of a different program, the pass with every
visibility decision smoothed:

* each object's coverage is a sigmoid of its silhouette coordinate (a
  sphere's discriminant, a triangle's barycentric margin) times a sigmoid of
  its depth past the window's start;
* the closest hit is an alpha-composited blend of all hypotheses,
  ``w_i = alpha_i prod_{j != i} (1 - alpha_j sigmoid((t_i - t_j) / tau))``,
  into one surface per segment (past ``UNROLL_OBJECTS`` hypotheses, each
  ``SOFT_CHUNK`` span of one type composites locally and the chunks' blends
  composite as hypotheses);
* shadow rays see the product of every occluder's soft transmittance;
* the primary segment's emitter hit is a soft race against the blended
  surface, and the path goes on with weight ``1 - lw``;
* paths never end early, except by Russian roulette, which stays hard.

Four functions:

* ``soft_pass_value`` -- the soft accumulator delta (R, 3), vectorised over
  rays and looping over objects line for line with ``_tile_program_soft``
  (past 64 hypotheses vectorised over each span as well, as JAX's
  value-level route ``vec=True`` is), draws in the hard pass's slot order
  (``MK.pass_draws``);
* ``pathtrace_pass_bwd_soft_reference`` -- kernel 2s's plain version:
  ``(dpar, dsph, dtri, dmat, dlig)`` of ``sum(g * soft_pass_value)`` by
  ``torch.autograd.grad``;
* ``pathtrace_pass_bwd_soft`` -- the wrapper of the hand-written CUDA
  adjoint ``csrc/megakernel_soft.cu`` (kernel 2s): CUDA tensors or it
  raises; it counts its launches in the module integers ``soft_launches``
  (at most 64 objects per type) and ``soft_large_launches`` (past 64, the
  two-level composite over every span, its large-table instance);
* ``live_stats`` -- the work of that large-table instance, counted with
  the plain version: per ray the rows, pairs and spans whose coverage has
  no factor exactly 0 (what the function needs; the kernel skips the
  rest), and per warp of 32 rays the union of its rays' live rows (what
  the kernel runs); ``chip_smoke.py``'s bound and ``profile_kernels``
  read these counts.

Past 64 objects the spans follow the rows in the order they are handed:
the differentiable pass hands the triangles in JAX's Morton order, padded
with zero rows to whole chunks (``render/mega.soft_tri_order``); a zero row
has coverage 0 and changes no value.

Every guard of the JAX program is kept as a double ``where`` (the sphere
root's square root, the triangle and emitter-plane divisions, the
composite's ``1 / cov``, the blended normal's fallback), and every
``jnp.clip`` and ``jnp.maximum`` is a minimum of a maximum (``core.types``
``clip`` and ``at_least``) so that its
cotangent splits at ties and bounds as JAX's does. One deliberate
difference from JAX's arithmetic: a sigmoid's argument ``x / bw`` (or
``/ tau``) is ``x`` times the reciprocal, as in kernel 2s (``_div``).
JAX's quirks stay: NEE
uses the throughput before the albedo update and the squared distance to
the light's centre; the emitter term applies on depth 0 only.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import rng
from ..core.sampling import cosine_hemisphere, sample_disk_point
from ..core.types import at_least, clip, cross3, dot3, safe_normalize
from . import _build
from . import intersect as I
from . import megakernel as MK
from . import megakernel_grad as MKG

# hypotheses per chunk of the two-level composite (JAX's SOFT_CHUNK)
SOFT_CHUNK = 64

soft_launches = 0        # kernel 2s, at most 64 objects per type
soft_large_launches = 0  # kernel 2s past 64 (rt_pathtrace_bwd_soft_large)

_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    "rt_pathtrace_bwd_soft": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _I, _I,                                  # g, n_rays, ray_offset
        _VP, _U, _U,                                  # u_planes, pass key
        _I, _I, _I, _I, _I,                # spp, width, bounces, rr, start
        _I, _I, _I,                           # direct, two_sided, normalize
        _I, _F, _F,                          # diff_wrt bits, bandwidth, tau
        _VP, _VP, _VP, _VP, _VP,                      # dpar .. dlig
        _VP]),                                        # stream
}
# past 64 objects per type: the two-level composite over every SOFT_CHUNK
# span, the same arguments and before the stream the live spans' tape
# (pointer, floats), whose size rt_soft_large_tape gives
_SIGNATURES["rt_pathtrace_bwd_soft_large"] = (ctypes.c_int, [
    *_SIGNATURES["rt_pathtrace_bwd_soft"][1][:-1], _VP, ctypes.c_longlong,
    _VP])
_SIGNATURES["rt_soft_large_tape"] = (ctypes.c_int, [
    _I, _I, _I, _I, _I, _I,   # n_sph, n_tri, n_mat, n_lig, bounces, n_rays
    _VP])                     # long long floats (out)
# what the last launch took (last_launch)
_SIGNATURES["rt_soft_last"] = (None, [_VP])
LAST_KEYS = ("group", "warps", "resident", "smem_bytes", "rows_global",
             "warps_per_sm", "registers", "local_bytes")


def soft_flags(rr: bool, direct: bool) -> tuple:
    """nvcc flags of kernel 2s's build for one mode: each build holds only
    its mode's instances (``csrc/megakernel_soft.cu`` RT_SOFT_MODE: path,
    path with the roulette, direct), so the three compile at once."""
    mode = 2 if direct else int(rr)
    return tuple(MKG.ADJ_FLAGS) + (f"-DRT_SOFT_MODE={mode}",)


# the three builds, in RT_SOFT_MODE order
SOFT_BUILDS = tuple(soft_flags(rr, direct)
                    for rr, direct in ((False, False), (True, False),
                                       (False, True)))
_last_flags = SOFT_BUILDS[0]


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as kernel 2s computes it: x times the correctly rounded
    reciprocal of s in x's precision. JAX divides; the two differ by at
    most an ulp in a sigmoid's argument, and the kernel saves an IEEE
    division per sigmoid (1.7x on the card). The plain version follows the
    kernel so that both take the same branch where a ray sits at a tie
    (the roulette's clip bound on cornell's white albedo)."""
    return x * (1.0 / torch.full_like(x[..., :1], s))


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """JAX's _safe_sqrt: sqrt(max(x, 0)) whose cotangent is 0 at x <= 0."""
    pos = x > 0.0
    return torch.where(pos, I.sqrt_rn(torch.where(pos, x, 1.0)), 0.0)


def _albedos(mat: torch.Tensor, mf: torch.Tensor) -> torch.Tensor:
    """(N, 3) materials[mf].rgb of per-object float ids ``mf`` (N,), zeros
    for ids that name no row (JAX's mat_rgb)."""
    if mat.shape[0] == 0:
        return torch.zeros((mf.shape[0], 3), device=mf.device)
    idx = mf.to(torch.int64).clamp(0, mat.shape[0] - 1)
    ok = (mf == idx.to(mf.dtype)) & (mf >= 0.0) & (mf < mat.shape[0])
    return torch.where(ok[:, None], mat[idx, 0:3], 0.0)


class _Ray:
    """One segment's rays: origin, direction, window start, o x d."""

    def __init__(self, o, d, mint):
        self.o, self.d, self.mint = o, d, mint
        self.oxd = cross3(o, d)

    def over_rows(self) -> "_Ray":
        """The same rays with a row axis (R, 1, ...), against which a block
        of rows (n, C) gives every (ray, row) pair."""
        r = _Ray.__new__(_Ray)
        r.o, r.d, r.oxd = self.o[:, None], self.d[:, None], self.oxd[:, None]
        r.mint = self.mint[:, None]
        return r


def _sphere_factors(row, ray: _Ray, bw: float):
    """((mask, sigmoid of the discriminant, sigmoid of the near root past
    mint), t) of a sphere row (unit directions, a = 1): alpha's factors in
    the order kernel 2s evaluates them. Shapes as ``_sphere_hyp``."""
    m = ray.o - row[..., 0:3]
    b = dot3(m, ray.d)
    cq = dot3(m, m) - row[..., 3] * row[..., 3]
    dis = b * b - cq
    msk = torch.where(row[..., 5] > 0.0, 1.0, 0.0)
    t = -b - _safe_sqrt(dis)
    return (msk, torch.sigmoid(_div(dis, bw)),
            torch.sigmoid(_div(t - ray.mint, bw))), t


def _sphere_hyp(row, ray: _Ray, bw: float):
    """(alpha, t) of a sphere row: sigmoid of the discriminant times a
    sigmoid of the near root past mint. A row (8,) against rays (R, ...)
    gives (R,); a block of rows (n, 8) against ``ray.over_rows()`` gives
    (R, n)."""
    (msk, s1, s2), t = _sphere_factors(row, ray, bw)
    return s1 * msk * s2, t


def _sphere_fields(row, ray: _Ray, t, alb):
    p = ray.o + t[..., None] * ray.d
    n = safe_normalize(p - row[..., 0:3])
    return torch.cat([t[..., None], p, n, alb.expand(*t.shape, 3)], -1)


def _tri_factors(row, ray: _Ray, bw: float, two_sided: bool):
    """((mask, side, sigmoid of the barycentric margin, sigmoid of t past
    mint), t, beta, gamma) of a triangle row (constant-split
    Moller-Trumbore; t = 1e6 where the ray sees the plane's back): alpha's
    factors in the order kernel 2s evaluates them. Shapes as
    ``_sphere_hyp``."""
    ng, c1, c2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    e1, e2, k = row[..., 9:12], row[..., 12:15], row[..., 15]
    div = dot3(ng, ray.d)
    side_ok = (div != 0.0) if two_sided else (div > 0.0)
    idiv = 1.0 / torch.where(div == 0.0, 1.0, div)
    beta = (dot3(e2, ray.oxd) - dot3(c2, ray.d)) * idiv
    gamma = (dot3(c1, ray.d) - dot3(e1, ray.oxd)) * idiv
    t = torch.where(side_ok, (k - dot3(ng, ray.o)) * idiv, 1e6)
    margin = torch.minimum(torch.minimum(beta, gamma), 1.0 - beta - gamma)
    return (torch.where(row[..., 17] > 0.0, 1.0, 0.0),
            side_ok.to(margin.dtype), torch.sigmoid(_div(margin, bw)),
            torch.sigmoid(_div(t - ray.mint, bw))), t, beta, gamma


def _tri_hyp(row, ray: _Ray, bw: float, two_sided: bool):
    """(alpha, t, beta, gamma) of a triangle row: sigmoid of the
    barycentric margin times a sigmoid of t past mint, on the side the
    ray may see. Shapes as ``_sphere_hyp``."""
    (msk, side, sm, s2), t, beta, gamma = _tri_factors(row, ray, bw,
                                                      two_sided)
    return sm * msk * side * s2, t, beta, gamma


def _tri_fields(row, ray: _Ray, t, beta, gamma, alb):
    p = ray.o + t[..., None] * ray.d
    al = clip(1.0 - beta - gamma, 0.0, 1.0)
    be = clip(beta, 0.0, 1.0)
    ga = clip(gamma, 0.0, 1.0)
    n = safe_normalize(al[..., None] * row[..., 18:21]
                       + be[..., None] * row[..., 21:24]
                       + ga[..., None] * row[..., 24:27])
    return torch.cat([t[..., None], p, n, alb.expand(*t.shape, 3)], -1)


def _composite(alphas, ts, fields, first_good: float, tau: float):
    """JAX's _composite: (cov, blend (R, 10)) of hypotheses ``alphas``,
    ``ts`` (R,) and ``fields`` (R, 10) = (t, p, n, albedo)."""
    ws = []
    cov = torch.zeros_like(alphas[0])
    for i, (a_i, t_i) in enumerate(zip(alphas, ts)):
        trans = torch.ones_like(a_i)
        for j, (a_j, t_j) in enumerate(zip(alphas, ts)):
            if i != j:
                s_ij = torch.sigmoid(_div(t_i - t_j, tau))
                trans = trans * (1.0 - a_j * s_ij)
        w = a_i * trans
        ws.append(w)
        cov = cov + w
    cov = clip(cov, 0.0, 1.0)
    good = cov > first_good
    icov = 1.0 / torch.where(good, cov, 1.0)
    blend = torch.zeros_like(fields[0])
    for w, f in zip(ws, fields):
        blend = blend + torch.where(good, w * icov, 0.0)[:, None] * f
    return cov, blend


def _composite_span(alphas, ts, fields, first_good: float, tau: float):
    """``_composite`` over a hypothesis axis, as JAX's ``_composite_vec``
    (``megakernel_grad.py:1723``): alphas and ts (R, n), fields (R, n,
    10). Each weight's product over the span's other hypotheses (its factor
    at j = i set to 1), the coverage and the blend run along the axis in
    hypothesis order, the order of kernel 2s's loops (a vectorised
    reduction reassociates), so that a hypothesis whose alpha is exactly 0
    for every ray can be dropped without changing a bit (its factors are
    exactly 1, its terms exactly 0)."""
    n = alphas.shape[1]
    occ = alphas[:, None, :] * torch.sigmoid(
        _div(ts[:, :, None] - ts[:, None, :], tau))
    self_ = torch.eye(n, dtype=torch.bool, device=alphas.device)
    occ = torch.where(self_, torch.zeros_like(occ), occ)
    trans = torch.ones_like(alphas)
    for j in range(n):
        trans = trans * (1.0 - occ[:, :, j])
    w = alphas * trans
    cov = torch.zeros_like(alphas[:, 0])
    for i in range(n):
        cov = cov + w[:, i]
    cov = clip(cov, 0.0, 1.0)
    good = cov > first_good
    icov = 1.0 / torch.where(good, cov, 1.0)
    wn = torch.where(good[:, None], w * icov[:, None], 0.0)
    blend = torch.zeros_like(fields[:, 0])
    for i in range(n):
        blend = blend + wn[:, i, None] * fields[:, i]
    return cov, blend


def _ordered_prod(x: torch.Tensor) -> torch.Tensor:
    """The product of x (R, n) along its last axis in column order (a
    factor of exactly 1 changes no bit)."""
    p = torch.ones_like(x[:, 0])
    for j in range(x.shape[1]):
        p = p * x[:, j]
    return p


class _Scene:
    """The tables and settings one soft pass reads."""

    def __init__(self, sph, tri, mat, lig, bw, tau, two_sided):
        self.sph, self.tri, self.lig = sph, tri, lig
        self.bw, self.tau, self.two_sided = bw, tau, two_sided
        self.alb_s = _albedos(mat, sph[:, 4])
        self.alb_t = _albedos(mat, tri[:, 16])

    def paths(self, live) -> None:
        """The rays (R,) bool still on their paths: inside the scene box,
        not ended by the roulette (read by live_stats' counter only)."""

    def hyps(self, ray: _Ray, kind: str, lo: int, hi: int):
        """Hypotheses (alphas, ts, fields) of rows [lo, hi) of one type."""
        alphas, ts, fields = [], [], []
        for i in range(lo, hi):
            if kind == "s":
                a, t = _sphere_hyp(self.sph[i], ray, self.bw)
                f = _sphere_fields(self.sph[i], ray, t, self.alb_s[i])
            else:
                a, t, beta, gamma = _tri_hyp(self.tri[i], ray, self.bw,
                                             self.two_sided)
                f = _tri_fields(self.tri[i], ray, t, beta, gamma,
                                self.alb_t[i])
            alphas.append(a)
            ts.append(t)
            fields.append(f)
        return alphas, ts, fields

    def span_hyps(self, ray: _Ray, kind: str, lo: int, hi: int,
                  fields: bool = True):
        """Hypotheses of rows [lo, hi) of one type as blocks: alphas and
        ts (R, n) and, with ``fields``, fields (R, n, 10)."""
        r = ray.over_rows()
        if kind == "s":
            rows = self.sph[lo:hi]
            a, t = _sphere_hyp(rows, r, self.bw)
            f = _sphere_fields(rows, r, t, self.alb_s[lo:hi]) if fields \
                else None
        else:
            rows = self.tri[lo:hi]
            a, t, beta, gamma = _tri_hyp(rows, r, self.bw, self.two_sided)
            f = (_tri_fields(rows, r, t, beta, gamma, self.alb_t[lo:hi])
                 if fields else None)
        return a, t, f

    def spans(self):
        """JAX's ``_chunk_ranges``: (kind, lo, hi) of every SOFT_CHUNK span
        of the sphere table, then of the triangle table, in the order the
        rows are given."""
        return [(kind, lo, min(lo + SOFT_CHUNK, n))
                for kind, n in (("s", self.sph.shape[0]),
                                ("t", self.tri.shape[0]))
                for lo in range(0, n, SOFT_CHUNK)]

    def trace(self, ray: _Ray):
        """JAX's soft_trace: (cov, tbar, pbar, nbar, albbar)."""
        n_sph, n_tri = self.sph.shape[0], self.tri.shape[0]
        if n_sph + n_tri <= MK.UNROLL_OBJECTS:
            a_s, t_s, f_s = self.hyps(ray, "s", 0, n_sph)
            a_t, t_t, f_t = self.hyps(ray, "t", 0, n_tri)
            cov, blend = _composite(a_s + a_t, t_s + t_t, f_s + f_t, 1e-6,
                                    self.tau)
        else:
            # two levels, vectorised over each span as JAX's value-level
            # route is: each SOFT_CHUNK span of one type composites
            # locally, then the chunks' blends composite as hypotheses
            covs, blends = zip(*(
                _composite_span(*self.span_hyps(ray, *span), 1e-9, self.tau)
                for span in self.spans()))
            blend_m = torch.stack(blends, 1)
            cov, blend = _composite_span(torch.stack(covs, 1),
                                         blend_m[..., 0], blend_m, 1e-6,
                                         self.tau)
        # the blended normal can be tiny (opposing normals at an edge):
        # such rays take the fallback (0, 0, 1)
        nraw = blend[:, 4:7]
        n2 = dot3(nraw, nraw)
        good = n2 > 1e-8
        nbar = torch.where(good[:, None],
                           nraw * torch.rsqrt(torch.where(good, n2, 1.0))
                           [:, None],
                           torch.tensor([0.0, 0.0, 1.0], device=n2.device))
        return cov, blend[:, 0], blend[:, 1:4], nbar, blend[:, 7:10]

    def vis(self, o, d, dist):
        """JAX's soft_vis: the product over every object of 1 - its
        coverage inside the shadow segment [0, dist]."""
        ray = _Ray(o, d, torch.zeros_like(dist))
        vis = torch.ones_like(dist)
        if self.sph.shape[0] + self.tri.shape[0] > MK.UNROLL_OBJECTS:
            # a product, so the spans' form is exact (JAX's vis_span_vec),
            # each span's in row order as kernel 2s's
            for span in self.spans():
                a, t, _ = self.span_hyps(ray, *span, fields=False)
                inside = a * torch.sigmoid(_div(dist[:, None] - t, self.bw))
                vis = vis * _ordered_prod(1.0 - inside)
            return vis
        for i in range(self.sph.shape[0]):
            a, t = _sphere_hyp(self.sph[i], ray, self.bw)
            vis = vis * (1.0 - a * torch.sigmoid(_div(dist - t, self.bw)))
        for i in range(self.tri.shape[0]):
            a, t, _, _ = _tri_hyp(self.tri[i], ray, self.bw, self.two_sided)
            vis = vis * (1.0 - a * torch.sigmoid(_div(dist - t, self.bw)))
        return vis


def _soft_direct(sc: _Scene, par, lig, o, d, mint, path_w, draw):
    """The soft accumulator delta of direct mode (JAX's
    ``_tile_program_soft`` direct branch, ``megakernel_grad.py:2039-2075``):
    per light ``albedo * clip(ambient + soft_vis * clip(cos))`` of the
    blended surface, weighted by ``path_w * cov``; the shadow ray's length
    is ``sqrt(max(d2, 1e-20))``."""
    eps, ambient = par[24], par[25]
    cov, _, pbar, nbar, alb = sc.trace(_Ray(o, d, mint))
    acc = torch.zeros_like(o)
    w = path_w * cov
    for li in range(lig.shape[0]):
        lr = lig[li]
        tgt = sample_disk_point(lr[0:3], lr[14:17], lr[17:20], lr[12], draw())
        so = pbar + eps * nbar
        dl = tgt - so
        dist = I.sqrt_rn(at_least(dot3(dl, dl), 1e-20))
        sd = safe_normalize(dl)
        vis = sc.vis(so, sd, dist)
        cosx = clip(dot3(sd, nbar), 0.0, 1.0)
        shade = clip(ambient + vis * cosx, 0.0, 1.0)
        acc = acc + w[:, None] * alb * shade[:, None]
    return acc


def _soft_pass(par, sph, tri, mat, lig, u, ray_offset: int, n: int, *,
               spp: int, width: int, bounces: int, two_sided: bool,
               normalize_emitter: bool, russian_roulette: bool,
               rr_start_depth: int, bw: float, tau: float,
               mode: str = "path", scene=_Scene) -> torch.Tensor:
    """The soft accumulator delta (n, 3) of rays [ray_offset, ray_offset +
    n) for the draws ``u`` (2 * n_draws, n); ``mode`` "path" or "direct"
    (``_soft_direct``); ``scene`` makes the _Scene (live_stats' counter)."""
    sc = scene(sph, tri, mat, lig, bw, tau, two_sided)
    n_lig = lig.shape[0]
    slots = iter(range(u.shape[0] // 2))

    def draw():
        j = next(slots)
        return u[2 * j:2 * j + 2].t()

    lens = draw() if spp == 1 else next(slots)  # slot 0: no draw at spp > 1
    o, d, mint, _ = MK._camera_rays(par, lens, n, ray_offset, spp, width)
    eps = par[24]
    ok = mint < float("inf")
    path_w = torch.where(ok, 1.0, 0.0)
    live = ok
    sc.paths(live)
    if mode == "direct":
        return _soft_direct(sc, par, lig, o, d, mint, path_w, draw)
    acc = torch.zeros((n, 3), device=par.device)
    tp = torch.ones((n, 3), device=par.device)
    cov = pbar = nbar = None
    for depth in range(bounces + 1):
        if depth > 0:
            if russian_roulette:
                u_rr = draw()[:, 0]
                if depth - 1 >= rr_start_depth:
                    p_srv = MK.survival_p(tp)
                    survive = u_rr < p_srv
                    inv_p = 1.0 / p_srv
                    tp = torch.where(survive[:, None], tp * inv_p[:, None],
                                     0.0)
                    path_w = torch.where(survive, path_w, 0.0)
                    live = live & survive
                    sc.paths(live)
            # the bounce from the blended surface
            d = cosine_hemisphere(nbar, draw())
            o = pbar + eps * nbar
            mint = torch.zeros_like(mint)
            path_w = path_w * cov
        cov, tbar, pbar, nbar, alb = sc.trace(_Ray(o, d, mint))
        if depth == 0:
            # the emitter term: a soft race against the blended surface
            for li in range(n_lig):
                lr = lig[li]
                irr = lr[9:12] if normalize_emitter else lr[6:9]
                lp, ln, rad = lr[0:3], lr[3:6], lr[12]
                den = dot3(d, ln)
                num = dot3(lp - o, ln)
                goodl = den.abs() > 1e-12
                idiv = 1.0 / torch.where(goodl, den, 1.0)
                t_l = torch.where(goodl, num * idiv, 1e6)
                q = o + t_l[:, None] * d - lp
                on_disk = torch.sigmoid(_div(rad * rad - dot3(q, q), bw))
                front = torch.sigmoid(_div(t_l - mint, bw))
                race = torch.sigmoid(_div(tbar - t_l, bw))
                before = cov * race + (1.0 - cov)
                lw = on_disk * front * before * goodl.to(den.dtype)
                acc = acc + (path_w * lw)[:, None] * irr
                path_w = path_w * (1.0 - lw)
        for li in range(n_lig):
            lr = lig[li]
            lp, ln, irr = lr[0:3], lr[3:6], lr[6:9]
            tgt = sample_disk_point(lp, lr[14:17], lr[17:20], lr[12], draw())
            so = pbar + eps * nbar
            dl = tgt - so
            dist = I.sqrt_rn(at_least(dot3(dl, dl), 1e-20))
            sd = safe_normalize(dl)
            vis = sc.vis(so, sd, dist)
            q = pbar - lp
            cosx = clip(dot3(sd, nbar), 0.0, 1.0)
            cosy = clip(-dot3(sd, ln), 0.0, 1.0)
            geom = lr[13] * cosx * cosy / at_least(dot3(q, q), 1e-20)
            gain = path_w * cov * vis * geom
            acc = acc + gain[:, None] * tp * alb * irr
            tp = tp * alb
    return acc


def soft_pass_value(par, ipar, sph, tri, mat, lig, u_planes, *, spp: int,
                    width: int, bounces: int, two_sided: bool,
                    normalize_emitter: bool, mode: str = "path",
                    russian_roulette: bool = False, rr_start_depth: int = 0,
                    soft_bandwidth: float = 1e-2,
                    soft_tau: float = 1e-2) -> torch.Tensor:
    """JAX's ``soft_pass_value``: the soft program's accumulator delta (R,
    3) for the draws ``u_planes`` (2 * n_draws, R; in direct mode
    ``u_planes_for_direct``'s layout), differentiable by autograd wrt every
    table. ``ipar`` (2,) int32: [pass index, ray offset]; ``mode`` "path"
    or "direct"."""
    MKG._check_mode(mode)
    return _soft_pass(par, sph, tri, mat, lig, u_planes, int(ipar[1]),
                      u_planes.shape[1], spp=spp, width=width,
                      bounces=bounces, two_sided=two_sided,
                      normalize_emitter=normalize_emitter,
                      russian_roulette=russian_roulette,
                      rr_start_depth=rr_start_depth, bw=soft_bandwidth,
                      tau=soft_tau, mode=mode)


def pathtrace_pass_bwd_soft_reference(par, ipar, sph, tri, mat, lig, g,
                                      u_planes, *, spp: int, width: int,
                                      bounces: int, two_sided: bool,
                                      normalize_emitter: bool, seed: int,
                                      russian_roulette: bool = False,
                                      rr_start_depth: int = 0,
                                      diff_wrt=MKG.DIFF_ALL,
                                      soft_bandwidth: float = 1e-2,
                                      soft_tau: float = 1e-2,
                                      mode: str = "path"):
    """Plain version of kernel 2s, JAX's ``_bwd_reference`` with
    ``soft_bandwidth > 0``: ``(dpar, dsph, dtri, dmat, dlig)`` of ``sum(g *
    soft_pass_value(...))`` for one pass, by autograd. The draws are
    ``u_planes`` or those of pass ``ipar[0]`` of ``seed``
    (``MK.diff_draws``). Groups outside ``diff_wrt`` come back as
    zeros."""
    MKG._check_mode(mode)
    sel = MKG._check_wrt(diff_wrt)
    u = MK.diff_draws(ipar, u_planes, g.shape[0], lig.shape[0], bounces,
                      seed, g.device, russian_roulette, mode, spp)

    def program(t):
        return _soft_pass(
            t["par"], t["sph"], t["tri"], t["mat"], t["lig"], u,
            int(ipar[1]), g.shape[0], spp=spp, width=width, bounces=bounces,
            two_sided=two_sided, normalize_emitter=normalize_emitter,
            russian_roulette=russian_roulette, rr_start_depth=rr_start_depth,
            bw=soft_bandwidth, tau=soft_tau, mode=mode)

    return MKG._autograd_cotangents(dict(par=par, sph=sph, tri=tri, mat=mat,
                                         lig=lig), sel, g, program)


class _LiveCount(_Scene):
    """live_stats' scene: on every span of each segment's composite
    ("surface") and each shadow ray ("shadow") past 64 objects, the work
    the soft program needs on each ray still on its path (a row's
    factors of alpha up to the first that is exactly 0 for that ray, and
    the rows, pairs and spans live for it), and what kernel 2s's warps of
    32 consecutive rays run (the union of their rays' live rows). ``sums``
    collects both per kind."""

    def __init__(self, *args, sums: dict):
        super().__init__(*args)
        self.sums, self.live, self.seg = sums, None, None

    def paths(self, live) -> None:
        self.live = live

    def span_hyps(self, ray: _Ray, kind: str, lo: int, hi: int,
                  fields: bool = True):
        out = super().span_hyps(ray, kind, lo, hi, fields)
        r = ray.over_rows()
        if kind == "s":
            factors, _ = _sphere_factors(self.sph[lo:hi], r, self.bw)
        else:
            factors, *_ = _tri_factors(self.tri[lo:hi], r, self.bw,
                                       self.two_sided)
        on = torch.ones(out[0].shape, dtype=torch.bool,
                        device=out[0].device)
        seg = self.seg
        for k, f in enumerate(factors):
            seg[f"reach_{kind}"][k] += on.sum(1)  # rows that evaluate f
            on = on & (f != 0.0)
        n_on = on.sum(1)
        seg[f"rows_{kind}"] += n_on
        seg["pairs"] += n_on * (n_on - 1)
        seg["spans"] += n_on > 0
        u = (on & self.live[:, None]).reshape(-1, 32, on.shape[1]).any(1)
        u = u.sum(1)
        seg["union_rows"] += u
        if kind == "s":
            seg["union_rows_sph"] += u
        seg["union_pairs"] += u * (u - 1)
        seg["union_spans"] += u > 0
        seg["max_union"] = max(seg["max_union"], int(u.max()))
        return out

    def _segment(self, kind: str, run, *args):
        n, dev = self.live.shape[0], self.live.device
        z = lambda m: torch.zeros(m, dtype=torch.int64,  # noqa: E731
                                  device=dev)
        self.seg = dict(reach_s=[z(n) for _ in range(3)],
                        reach_t=[z(n) for _ in range(4)], rows_s=z(n),
                        rows_t=z(n), pairs=z(n), spans=z(n),
                        union_rows=z(n // 32), union_rows_sph=z(n // 32),
                        union_pairs=z(n // 32), union_spans=z(n // 32),
                        max_union=0)
        out = run(*args)
        seg, live = self.seg, self.live
        seg["pairs"] = seg["pairs"] + seg["spans"] * (seg["spans"] - 1)
        seg["union_pairs"] = (seg["union_pairs"]
                              + seg["union_spans"] * (seg["union_spans"] - 1))
        st = self.sums.setdefault(kind, dict(ray_segments=0,
                                             warp_segments=0, max_union=0))
        st["ray_segments"] += int(live.sum())
        st["warp_segments"] += n // 32
        st["max_union"] = max(st["max_union"], seg.pop("max_union"))
        for key, x in seg.items():
            if key.startswith("union"):
                st[key] = st.get(key, 0) + int(x.sum())
            elif key.startswith("reach"):
                st[key] = [a + int(b[live].sum()) for a, b in
                           zip(st.get(key, [0] * len(x)), x)]
            else:
                st[key] = st.get(key, 0) + int(x[live].sum())
        return out

    def trace(self, ray: _Ray):
        return self._segment("surface", super().trace, ray)

    def vis(self, o, d, dist):
        return self._segment("shadow", super().vis, o, d, dist)


def live_stats(par, ipar, sph, tri, mat, lig, u_planes, *, blocks,
               spp: int, width: int, bounces: int, two_sided: bool,
               normalize_emitter: bool, seed: int,
               russian_roulette: bool = False, rr_start_depth: int = 0,
               soft_bandwidth: float = 1e-2, soft_tau: float = 1e-2,
               mode: str = "path") -> dict:
    """The work of kernel 2s's large-table instance (past 64 objects),
    counted by the plain version (``_LiveCount``) on the rays of
    ``blocks`` ((ray offset, count) pairs of whole warps) of pass
    ``ipar[0]`` with its draws (``u_planes`` or the pass's own). A row is
    live for a ray where no factor of its alpha is exactly 0 (the kernel
    drops the others exactly; a ray is on its path inside the scene box
    until the roulette ends it). Returns "rows" (what a dense pass
    evaluates) and, for "surface" (the segments' composites) and "shadow"
    (the shadow rays):

    * what the function needs, as means per ray-segment on its path
      (``ray_segments`` of them): ``reach_s`` and ``reach_t``, per factor
      of a sphere's (mask, discriminant, depth) and a triangle's (mask,
      side, margin, depth) alpha the rows that evaluate it (up to the
      first factor exactly 0); ``rows_s`` and ``rows_t``, the live rows;
      ``pairs``, the ordered pairs of live rows within each span and of
      the spans holding one; ``spans``, those spans;
    * what the kernel's warps run, as means per warp-segment
      (``warp_segments``): ``union_spans`` (spans with a row live for some
      ray of the warp), ``union_rows`` (of them ``union_rows_sph`` in
      sphere spans), ``union_rows_per_span``, ``union_pairs`` (as
      ``pairs`` over the unions) and the largest union of a span,
      ``max_union`` (64: the warp's slots fill it)."""
    MKG._check_mode(mode)
    sums: dict = {}
    with torch.no_grad():
        for off, n in blocks:
            if off % 32 or n % 32:
                raise ValueError(f"block ({off}, {n}) is not whole warps")
            ip = torch.tensor([int(ipar[0]), off], dtype=torch.int32)
            u = MK.diff_draws(ip, None if u_planes is None
                              else u_planes[:, off:off + n].contiguous(), n,
                              lig.shape[0], bounces, seed, par.device,
                              russian_roulette, mode, spp)
            _soft_pass(par, sph, tri, mat, lig, u, off, n, spp=spp,
                       width=width, bounces=bounces, two_sided=two_sided,
                       normalize_emitter=normalize_emitter,
                       russian_roulette=russian_roulette,
                       rr_start_depth=rr_start_depth, bw=soft_bandwidth,
                       tau=soft_tau, mode=mode,
                       scene=lambda *a: _LiveCount(*a, sums=sums))
    out = {"rows": sph.shape[0] + tri.shape[0]}
    for kind, st in sums.items():
        rays, warps = max(st["ray_segments"], 1), max(st["warp_segments"], 1)
        out[kind] = dict(
            ray_segments=st["ray_segments"],
            **{k: ([x / rays for x in v] if k.startswith("reach")
                   else v / rays)
               for k, v in st.items() if k.startswith(("reach", "rows",
                                                       "pairs", "spans"))},
            warp_segments=st["warp_segments"],
            **{k: v / warps for k, v in st.items()
               if k.startswith("union")},
            union_rows_per_span=(st["union_rows"]
                                 / max(st["union_spans"], 1)),
            max_union=st["max_union"])
    return out


def last_launch() -> dict:
    """What kernel 2s's last launch in this process took: its group size
    (lanes per ray; 1 for the large-table entry's thread per ray), warps per
    block, whether the sphere and triangle tables were staged in shared
    memory, the block's shared-memory bytes, whether their row cotangents
    went straight to global memory, resident warps per SM, and the kernel's
    registers and local-memory bytes per thread."""
    lib = _build.load("megakernel_soft", _SIGNATURES, _last_flags)
    out = (ctypes.c_int * len(LAST_KEYS))()
    lib.rt_soft_last(out)
    return dict(zip(LAST_KEYS, out))


def pathtrace_pass_bwd_soft(par, ipar, sph, tri, mat, lig, g, u_planes, *,
                            spp: int, width: int, bounces: int,
                            two_sided: bool, normalize_emitter: bool,
                            seed: int, russian_roulette: bool = False,
                            rr_start_depth: int = 0, diff_wrt=MKG.DIFF_ALL,
                            soft_bandwidth: float = 1e-2,
                            soft_tau: float = 1e-2, mode: str = "path"):
    """Kernel 2s: the cotangents of ``pathtrace_pass_bwd_soft_reference``
    from the hand-written CUDA adjoint, for CUDA tensors (anything else
    raises). ``g`` (R, 3) is the cotangent of the pass's accumulator; the
    draws are ``u_planes`` or, without them, those of pass ``ipar[0]`` of
    ``seed``, made in-kernel (``MK.diff_draws``). Groups outside
    ``diff_wrt`` come back as zeros; ``mode`` "direct" runs the adjoint of
    the soft direct shade. Up to 64 objects per type the tables and
    each group's gradient buffer sit in shared memory (counter
    ``soft_launches``); past that, up to ``MKG.DIFF_TABLE_MAX`` per type,
    the large-table instance composites every ``SOFT_CHUNK`` span of the
    rows in the order given (counter ``soft_large_launches``)."""
    global soft_launches, soft_large_launches, _last_flags
    sel = MKG._check_wrt(diff_wrt)
    MKG._check_bwd_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp,
                        width, bounces, russian_roulette, "kernel 2s",
                        resident=False, mode=mode)
    if not (soft_bandwidth > 0.0 and soft_tau > 0.0):
        raise ValueError(f"the soft route needs a bandwidth and tau > 0, got "
                         f"{soft_bandwidth} and {soft_tau}")
    if max(sph.shape[0], tri.shape[0]) > MKG.DIFF_TABLE_MAX:
        raise NotImplementedError(
            f"{sph.shape[0]} sphere / {tri.shape[0]} triangle rows: kernel "
            f"2s composites at most {MKG.DIFF_TABLE_MAX} per type "
            "(DIFF_TABLE_MAX); larger tables render forward-only")
    large = max(sph.shape[0], tri.shape[0]) > MK.UNROLL_OBJECTS
    outs = tuple(torch.zeros_like(t) for t in (par, sph, tri, mat, lig))
    wrt = sum(1 << i for i, n in enumerate(MKG.DIFF_ALL) if n in sel)
    if not wrt:
        return outs
    roff = int(ipar[1])
    k0, k1 = rng.key_words(MK.pass_key_of(ipar, seed))
    n_b, rr, direct = MKG._c_settings(bounces, russian_roulette, mode)
    ptr = MK._ptr
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        args = (ptr(par), ptr(sph), sph.shape[0], ptr(tri), tri.shape[0],
                ptr(mat), mat.shape[0], ptr(lig), lig.shape[0], ptr(g),
                g.shape[0], roff, ptr(u_planes), k0, k1, spp, width, n_b,
                rr, rr_start_depth, direct, int(two_sided),
                int(normalize_emitter), wrt, soft_bandwidth, soft_tau,
                *(ptr(t) for t in outs), stream)
        flags = soft_flags(rr != 0, direct != 0)
        lib = _build.load("megakernel_soft", _SIGNATURES, flags)
        if large:
            # the live spans' tape, from torch's allocator on this stream
            n = ctypes.c_longlong(0)
            err = lib.rt_soft_large_tape(sph.shape[0], tri.shape[0],
                                         mat.shape[0], lig.shape[0], n_b,
                                         g.shape[0], ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"kernel 2s's tape size failed with CUDA "
                                   f"error {err}")
            tape = torch.empty(max(n.value, 1), device=g.device)
            err = lib.rt_pathtrace_bwd_soft_large(*args[:-1], ptr(tape),
                                                  tape.numel(), stream)
        else:
            err = lib.rt_pathtrace_bwd_soft(*args)
        if err != 0:
            raise RuntimeError(f"kernel 2s launch failed with CUDA error "
                               f"{err}")
        _last_flags = flags
        if large:
            soft_large_launches += 1
        else:
            soft_launches += 1
    return outs
