"""Intersection primitives (``raytracing_tpu.ops.intersect`` and the
kernels' object bodies, ``ops/pallas/megakernel.py:544-646, 1053-1099``,
``ops/pallas/hit_kernels.py``).

Two families:

* per-object tests over a ray batch (``sphere_hit``, ``triangle_hit``):
  the plain versions of the CUDA kernels loop over objects and call these
  once per object, like the kernels' champion loops. The triangle test is
  the constant-split Moller-Trumbore form over ``tri_constants``, so a
  plain version and its kernel read the same packed table;
* all-pairs forms, (objects, rays) matrices of hit parameters, for the
  stage pipeline's ``use_pallas=False`` search (``*_ts_matmul``, plain
  broadcast arithmetic in the JAX package's split form) and as oracles
  (``*_ts_pairwise``, the reference's cross-product form); and the
  champion-only helpers ``sphere_normal``, ``triangle_barycentrics`` and
  ``interpolate_normal``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.types import cross3, dot3, safe_normalize

INF = math.inf


class TriConstants(NamedTuple):
    """Per-triangle constants, all (T, 3) / (T,)."""
    p0: torch.Tensor
    e1: torch.Tensor     # p1 - p0
    e2: torch.Tensor     # p2 - p0
    n_geo: torch.Tensor  # cross(e2, e1): the single-sided test's orientation
    c1: torch.Tensor     # cross(e1, p0)
    c2: torch.Tensor     # cross(e2, p0)
    k: torch.Tensor      # dot(p0, n_geo)


def tri_constants(v: torch.Tensor) -> TriConstants:
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    n_geo = torch.linalg.cross(e2, e1)
    return TriConstants(p0=p0, e1=e1, e2=e2, n_geo=n_geo,
                        c1=torch.linalg.cross(e1, p0),
                        c2=torch.linalg.cross(e2, p0),
                        k=(p0 * n_geo).sum(-1))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as the kernels' ``sqrtf``.
    PyTorch's float32 sqrt on the CPU (SLEEF) is not: on AVX-512 it rounds
    0.6% of inputs to the other neighbour. Through float64 it is exact."""
    return torch.sqrt(x.double()).to(x.dtype)


def sphere_hit(o, d, a, inv2a, mint, maxt, row) -> tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(ok, t) of one packed sphere row [center xyz, radius, mat, mask, ..]
    (or one row per ray, (R, 8)): the nearest root inside [mint, maxt].
    ``a = |d|^2`` and ``inv2a = 0.5 / a`` are per ray."""
    m = o - row[..., 0:3]
    r = row[..., 3]
    b = 2.0 * dot3(m, d)
    cq = dot3(m, m) - r * r
    dis = b * b - 4.0 * a * cq
    # sqrt(max(dis, 0)) with the double where of the JAX package's
    # _safe_sqrt: its cotangent is 0, not 0/0, where dis <= 0 (a miss, or a
    # ray whose discriminant is exactly 0 -- which a 1024^2 image has)
    pos = dis > 0.0
    sq = torch.where(pos, sqrt_rn(torch.where(pos, dis, 1.0)), 0.0)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    tmn = torch.minimum(t0, t1)
    tmx = torch.maximum(t0, t1)
    in_mn = (tmn >= mint) & (tmn <= maxt)
    in_mx = (tmx >= mint) & (tmx <= maxt)
    ok = (in_mn | in_mx) & (dis >= 0.0) & (row[..., 5] > 0.0)
    return ok, torch.where(in_mn, tmn, tmx)


def triangle_hit(o, d, oxd, mint, maxt, row, two_sided: bool
                 ) -> tuple[torch.Tensor, ...]:
    """(ok, t, beta, gamma) of one packed triangle row [n_geo, c1, c2, e1,
    e2, k, mat, mask, vn0, vn1, vn2, pad] (or one row per ray, (R, >= 18));
    ``oxd = cross(o, d)`` per ray."""
    ng, c1, c2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    e1, e2, k = row[..., 9:12], row[..., 12:15], row[..., 15]
    div = dot3(d, ng)
    side_ok = (div != 0.0) if two_sided else (div > 0.0)
    idiv = 1.0 / torch.where(div == 0.0, 1.0, div)
    beta = (dot3(oxd, e2) - dot3(d, c2)) * idiv
    gamma = (dot3(d, c1) - dot3(oxd, e1)) * idiv
    t = (k - dot3(o, ng)) * idiv
    ok = side_ok & (beta >= 0.0) & (beta <= 1.0) & (gamma >= 0.0) \
        & (beta + gamma <= 1.0) & (t >= mint) & (t <= maxt) \
        & (row[..., 17] > 0.0)
    return ok, t, beta, gamma


def _outer_dot(obj: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """(O, 3) x (R, 3) -> (O, R) dot products, by broadcasting."""
    return dot3(obj[:, None, :], rays[None, :, :])


def sphere_ts_matmul(o, d, mint, maxt, center, radius, mask) -> torch.Tensor:
    """All-pairs nearest hit parameter, (S, R), INF where no hit, in the
    split form: b = 2 (o.d - d.c), c = |o|^2 - 2 o.c + |c|^2 - r^2."""
    od, oo, a = dot3(o, d), dot3(o, o), dot3(d, d)
    dc = _outer_dot(center, d)
    oc = _outer_dot(center, o)
    cc = dot3(center, center) - radius * radius
    b = 2.0 * (od[None, :] - dc)
    c = oo[None, :] - 2.0 * oc + cc[:, None]
    return _sphere_select_t(a[None, :], b, c, mint[None, :], maxt[None, :],
                            mask[:, None])


def sphere_ts_pairwise(o, d, mint, maxt, center, radius, mask
                       ) -> torch.Tensor:
    """All-pairs nearest hit parameter, (R, S), in the reference's
    o - c form (the oracle)."""
    omc = o[:, None, :] - center[None, :, :]
    a = dot3(d, d)[:, None]
    b = 2.0 * dot3(omc, d[:, None, :])
    c = dot3(omc, omc) - (radius * radius)[None, :]
    return _sphere_select_t(a, b, c, mint[:, None], maxt[:, None],
                            mask[None, :])


def _sphere_select_t(a, b, c, mint, maxt, mask) -> torch.Tensor:
    """The nearest root of a t^2 + b t + c inside [mint, maxt]."""
    dis = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(dis, min=0.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    tmin_ok = (tmin >= mint) & (tmin <= maxt)
    tmax_ok = (tmax >= mint) & (tmax <= maxt)
    t = torch.where(tmin_ok, tmin, torch.where(tmax_ok, tmax, INF))
    return torch.where((dis >= 0.0) & mask, t, INF)


def sphere_normal(p: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Outward normal at a hit point."""
    return safe_normalize(p - center)


def triangle_ts_matmul(o, d, mint, maxt, tc: TriConstants, mask,
                       two_sided: bool = False) -> torch.Tensor:
    """All-pairs Moller-Trumbore hit parameter, (T, R), INF where no hit,
    from the constant split: div = d.n_geo, beta = ((o x d).e2 - d.c2) /
    div, gamma = (d.c1 - (o x d).e1) / div, t = (k - o.n_geo) / div."""
    oxd = cross3(o, d)
    div = _outer_dot(tc.n_geo, d)
    o_ng = _outer_dot(tc.n_geo, o)
    beta_num = _outer_dot(tc.e2, oxd) - _outer_dot(tc.c2, d)
    gamma_num = _outer_dot(tc.c1, d) - _outer_dot(tc.e1, oxd)
    side_ok = (div != 0.0) if two_sided else (div > 0.0)
    idiv = 1.0 / torch.where(div == 0.0, 1.0, div)
    beta = beta_num * idiv
    gamma = gamma_num * idiv
    t = (tc.k[:, None] - o_ng) * idiv
    ok = side_ok & (beta >= 0.0) & (beta <= 1.0) & (gamma >= 0.0) \
        & (beta + gamma <= 1.0) & (t >= mint[None, :]) \
        & (t <= maxt[None, :]) & mask[:, None]
    return torch.where(ok, t, INF)


def triangle_ts_pairwise(o, d, mint, maxt, v, mask, two_sided: bool = False
                         ) -> torch.Tensor:
    """All-pairs Moller-Trumbore, (R, T), in the reference's cross-product
    form (the oracle)."""
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = (p1 - p0)[None]
    e2 = (p2 - p0)[None]
    dd = d[:, None, :]
    div = dot3(cross3(e2, e1), dd)
    s = o[:, None, :] - p0[None]
    beta_num = dot3(cross3(s, dd), e2)
    gamma_num = dot3(cross3(s, e1), dd)
    t_num = dot3(cross3(s, e2), e1)
    side_ok = (div != 0.0) if two_sided else (div > 0.0)
    idiv = 1.0 / torch.where(div == 0.0, 1.0, div)
    beta = beta_num * idiv
    gamma = gamma_num * idiv
    t = t_num * (-idiv)
    ok = side_ok & (beta >= 0.0) & (beta <= 1.0) & (gamma >= 0.0) \
        & (beta + gamma <= 1.0) & (t >= mint[:, None]) \
        & (t <= maxt[:, None]) & mask[None, :]
    return torch.where(ok, t, INF)


def triangle_barycentrics(o, d, v) -> tuple[torch.Tensor, torch.Tensor]:
    """(beta, gamma) of each ray's plane hit on its own triangle v (R, 3,
    3): the champion-only recompute."""
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    div = dot3(cross3(e2, e1), d)
    idiv = 1.0 / torch.where(div == 0.0, 1.0, div)
    s = o - p0
    beta = dot3(cross3(s, d), e2) * idiv
    gamma = dot3(cross3(s, e1), d) * idiv
    return beta, gamma


def interpolate_normal(beta, gamma, vn) -> torch.Tensor:
    """Barycentric interpolation of the vertex normals vn (R, 3, 3),
    normalized."""
    n = (1.0 - beta - gamma)[:, None] * vn[:, 0] \
        + beta[:, None] * vn[:, 1] + gamma[:, None] * vn[:, 2]
    return safe_normalize(n)


def aabb_window(o, d, pmin, pmax) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Slab test of rays (R, 3) against one box: (tmin, tmax, ok)."""
    sd = torch.where(d == 0.0, 1e-30, d)
    t0 = (pmin - o) / sd
    t1 = (pmax - o) / sd
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    tmin = torch.clamp(torch.maximum(near[:, 0], torch.maximum(near[:, 1],
                                                               near[:, 2])),
                       min=0.0)
    tmax = torch.minimum(far[:, 0], torch.minimum(far[:, 1], far[:, 2]))
    return tmin, tmax, tmin <= tmax


def light_disk_t(o, d, position, normal, radius) -> torch.Tensor:
    """Ray against one disk light: plane hit + radius check; INF on a miss
    (rays whose origin lies on the plane miss, as in the reference)."""
    den = dot3(d, normal)
    num = dot3(position - o, normal)
    t = num / torch.where(den == 0.0, 1.0, den)
    q = o + t[:, None] * d - position
    on_disk = dot3(q, q) <= radius * radius
    return torch.where((den != 0.0) & (num != 0.0) & on_disk, t, INF)
