"""Intersection primitives of the plain pass (``raytracing_tpu.ops.intersect``
and the kernel's object bodies, ``ops/pallas/megakernel.py:544-646,
1053-1099``).

Per-object tests over a ray batch: the plain version loops over objects
and calls these once per object, like the kernel's champion loops. The
triangle test is the constant-split Moller-Trumbore form over
``tri_constants``, so the plain version and the CUDA kernel read the same
packed table."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.types import dot3

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


def sphere_hit(o, d, a, inv2a, mint, maxt, row) -> tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(ok, t) of one packed sphere row [center xyz, radius, mat, mask, ..]:
    the nearest root inside [mint, maxt]. ``a = |d|^2`` and ``inv2a =
    0.5 / a`` are per ray."""
    m = o - row[0:3]
    r = row[3]
    b = 2.0 * dot3(m, d)
    cq = dot3(m, m) - r * r
    dis = b * b - 4.0 * a * cq
    # sqrt(max(dis, 0)) with the double where of the JAX package's
    # _safe_sqrt: its cotangent is 0, not 0/0, where dis <= 0 (a miss, or a
    # ray whose discriminant is exactly 0 -- which a 1024^2 image has)
    pos = dis > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, dis, 1.0)), 0.0)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    tmn = torch.minimum(t0, t1)
    tmx = torch.maximum(t0, t1)
    in_mn = (tmn >= mint) & (tmn <= maxt)
    in_mx = (tmx >= mint) & (tmx <= maxt)
    ok = (in_mn | in_mx) & (dis >= 0.0) & (row[5] > 0.0)
    return ok, torch.where(in_mn, tmn, tmx)


def triangle_hit(o, d, oxd, mint, maxt, row, two_sided: bool
                 ) -> tuple[torch.Tensor, ...]:
    """(ok, t, beta, gamma) of one packed triangle row [n_geo, c1, c2, e1,
    e2, k, mat, mask, vn0, vn1, vn2, pad]; ``oxd = cross(o, d)`` per ray."""
    ng, c1, c2 = row[0:3], row[3:6], row[6:9]
    e1, e2, k = row[9:12], row[12:15], row[15]
    div = dot3(d, ng)
    side_ok = (div != 0.0) if two_sided else (div > 0.0)
    idiv = 1.0 / torch.where(div == 0.0, 1.0, div)
    beta = (dot3(oxd, e2) - dot3(d, c2)) * idiv
    gamma = (dot3(d, c1) - dot3(oxd, e1)) * idiv
    t = (k - dot3(o, ng)) * idiv
    ok = side_ok & (beta >= 0.0) & (beta <= 1.0) & (gamma >= 0.0) \
        & (beta + gamma <= 1.0) & (t >= mint) & (t <= maxt) & (row[17] > 0.0)
    return ok, t, beta, gamma


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
