"""Closest-hit and any-hit over whole object batches
(``raytracing_tpu.ops.closest_hit``).

The champion search runs without gradients (JAX's ``stop_gradient``):
``use_pallas=True`` sends it to the hit kernels of ``ops/hit_kernels.py``
(kernels 4 and 5 on the card), ``use_pallas=False`` to a chunked scan of
all-pairs (C, R) matrices (``_champion_scan``). Then each champion's hit
distance is recomputed differentiably from its own object's parameters,
with the JAX package's double-``where`` guards, so gradients are exact
wherever the champion assignment is locally constant.

The JAX package fetches champion rows with one-hot matmuls (the TPU's MXU
instead of a gather); here ``_fetch`` is an indexed gather on
``idx.clamp(min=0)`` zeroed where idx < 0, which gives the same rows and
the same zeros.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.types import Rays, Spheres, Triangles, dot3
from . import hit_kernels as HK
from . import intersect as I

INF = math.inf


class Champion(NamedTuple):
    t: torch.Tensor      # (R,) differentiable hit distance; INF = miss
    idx: torch.Tensor    # (R,) int32 object index; -1 = miss
    valid: torch.Tensor  # (R,) bool


def _miss(rays: Rays) -> Champion:
    dev = rays.o.device
    return Champion(t=torch.full((rays.n,), INF, device=dev),
                    idx=torch.full((rays.n,), -1, dtype=torch.int32,
                                   device=dev),
                    valid=torch.zeros((rays.n,), dtype=torch.bool,
                                      device=dev))


def _champion_scan(ts_of_chunk, n_obj: int, chunk: int, rays: Rays
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Champion over chunks of (C, R) t-matrices: ``ts_of_chunk(lo, hi)``
    gives objects [lo, hi). Ties go to the lowest index (argmin takes the
    first minimum, and a later chunk must be strictly better)."""
    best = _miss(rays)
    best_t, best_i = best.t, best.idx
    for lo in range(0, n_obj, chunk):
        cmin, carg = ts_of_chunk(lo, min(lo + chunk, n_obj)).min(0)
        better = cmin < best_t
        best_t = torch.where(better, cmin, best_t)
        best_i = torch.where(better, carg.to(torch.int32) + lo, best_i)
    return best_t, best_i


def _anyhit_scan(ts_of_chunk, n_obj: int, chunk: int, rays: Rays
                 ) -> torch.Tensor:
    occ = _miss(rays).valid
    for lo in range(0, n_obj, chunk):
        occ = occ | torch.isfinite(ts_of_chunk(lo, min(lo + chunk,
                                                       n_obj))).any(0)
    return occ


def _window(rays: Rays):
    return (rays.o.detach(), rays.d.detach(), rays.mint.detach(),
            rays.maxt.detach())


def _sphere_ts(rays: Rays, spheres: Spheres):
    """(lo, hi) -> all-pairs t (hi - lo, R) of spheres [lo, hi)."""
    win = _window(rays)
    c, r = spheres.center.detach(), spheres.radius.detach()
    return lambda lo, hi: I.sphere_ts_matmul(*win, c[lo:hi], r[lo:hi],
                                             spheres.mask[lo:hi])


def _triangle_ts(rays: Rays, tris: Triangles, two_sided: bool):
    """(lo, hi) -> all-pairs t (hi - lo, R) of triangles [lo, hi)."""
    win = _window(rays)
    v = tris.v.detach()
    return lambda lo, hi: I.triangle_ts_matmul(
        *win, I.tri_constants(v[lo:hi]), tris.mask[lo:hi], two_sided)


def _fetch(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``data`` (O, k) at ``idx`` (R,); zeros where idx < 0."""
    rows = data[idx.clamp(min=0).long()]
    return torch.where((idx >= 0)[:, None], rows, 0.0)


def palette_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, k) table at (R,) int ids; zeros where idx < 0 or >= M."""
    ok = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(ok, idx, 0).long()]
    return torch.where(ok[:, None], rows, 0.0)


def _ray_args(rays: Rays):
    return tuple(x.contiguous() for x in _window(rays))


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def _sphere_search(rays: Rays, spheres: Spheres, obj_chunk: int,
                   use_pallas: bool, rows: torch.Tensor | None,
                   tree: HK.SphereTree | None = None):
    """(best_t, best_idx) without gradients."""
    with torch.no_grad():
        if not use_pallas:
            return _champion_scan(_sphere_ts(rays, spheres), spheres.count,
                                  obj_chunk, rays)
        if rows is None:
            rows = HK.sphere_rows(spheres.center, spheres.radius,
                                  spheres.mask)
        return HK.sphere_search_rows(*_ray_args(rays), rows, tree)


def closest_hit_spheres(rays: Rays, spheres: Spheres, *,
                        obj_chunk: int = 2048, use_pallas: bool = False,
                        rows: torch.Tensor | None = None,
                        tree: HK.SphereTree | None = None) -> Champion:
    """Closest valid sphere hit per ray. ``rows``: the packed table of
    ``hit_kernels.sphere_rows`` (packed here when None); ``tree``: kernel
    4's box tree over it (``hit_kernels.sphere_tree``, built by the
    search where the table needs one and None is passed)."""
    if spheres.count == 0:
        return _miss(rays)
    best_t, best_i = _sphere_search(rays, spheres, obj_chunk, use_pallas,
                                    rows, tree)
    return sphere_champion(rays, spheres, best_t, best_i)


def sphere_champion(rays: Rays, spheres: Spheres, best_t: torch.Tensor,
                    best_i: torch.Tensor) -> Champion:
    """The Champion of a search's (best_t, best_i), its t recomputed
    differentiably from the champion sphere's parameters."""
    valid = torch.isfinite(best_t) & rays.alive

    # differentiable recompute for the champions; lanes that are not
    # champions may give dis <= 0 or INF, so inputs are sanitised before
    # the sqrt and the selects (double where)
    idx = torch.where(valid, best_i, -1)
    cr = _fetch(torch.cat([spheres.center, spheres.radius[:, None]], -1),
                idx)
    c, r = cr[:, :3], cr[:, 3]
    omc = rays.o - c
    a = dot3(rays.d, rays.d)
    b = 2.0 * dot3(omc, rays.d)
    cq = dot3(omc, omc) - r * r
    dis = b * b - 4.0 * a * cq
    dis = torch.where(valid & (dis > 0.0), dis, 1.0)
    sq = torch.sqrt(dis)
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    finite_best = torch.where(valid, best_t, 0.0)
    tt = torch.where((t0 - finite_best).abs() <= (t1 - finite_best).abs(),
                     t0, t1)
    t = torch.where(valid, tt, INF)
    return Champion(t=t, idx=idx, valid=valid)


def sphere_hit_attrs(rays: Rays, spheres: Spheres, champ: Champion
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p, normal, mat_id) at the champions; t is replaced by 0 on invalid
    lanes so that no INF or NaN enters the graph."""
    t_safe = torch.where(champ.valid, champ.t, 0.0)
    p = rays.at(t_safe)
    fetched = _fetch(torch.cat([spheres.center,
                                spheres.mat_id[:, None].to(torch.float32)],
                               -1), champ.idx)
    center = fetched[:, :3]
    mat = torch.where(champ.valid, fetched[:, 3].to(torch.int32), -1)
    n = I.sphere_normal(torch.where(champ.valid[:, None], p, p + 1.0),
                        center)
    return p, n, mat


def anyhit_spheres(rays: Rays, spheres: Spheres, *, obj_chunk: int = 2048,
                   use_pallas: bool = False,
                   rows: torch.Tensor | None = None,
                   tree: HK.SphereTree | None = None) -> torch.Tensor:
    """Occlusion: any valid sphere hit inside each ray's window (``rows``,
    ``tree`` as in ``closest_hit_spheres``)."""
    if spheres.count == 0:
        return _miss(rays).valid
    with torch.no_grad():
        if use_pallas:
            occ = torch.isfinite(_sphere_search(rays, spheres, obj_chunk,
                                                True, rows, tree)[0])
        else:
            occ = _anyhit_scan(_sphere_ts(rays, spheres), spheres.count,
                               obj_chunk, rays)
    return occ & rays.alive


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

def _triangle_search(rays: Rays, tris: Triangles, obj_chunk: int,
                     two_sided: bool, use_pallas: bool,
                     rows: torch.Tensor | None,
                     tree: HK.TriangleTree | None = None):
    """(best_t, best_idx) without gradients. Where it packs the rows
    itself it builds their tree too (``HK.pass_triangle_tree``); a caller
    that passes rows past ``HK.TRIANGLE_BRUTE_MAX`` passes their tree."""
    with torch.no_grad():
        if not use_pallas:
            return _champion_scan(_triangle_ts(rays, tris, two_sided),
                                  tris.count, obj_chunk, rays)
        if rows is None:
            rows = HK.triangle_rows(tris.v, tris.mask)
            tree = HK.pass_triangle_tree(tris.v, rows)
        return HK.triangle_search_rows(*_ray_args(rays), rows, two_sided,
                                       tree)


def closest_hit_triangles(rays: Rays, tris: Triangles, *,
                          obj_chunk: int = 2048, two_sided: bool = False,
                          use_pallas: bool = False,
                          rows: torch.Tensor | None = None,
                          tree: HK.TriangleTree | None = None) -> Champion:
    """Closest valid Moller-Trumbore hit per ray. ``rows``: the packed
    table of ``hit_kernels.triangle_rows`` (packed here when None, with
    its tree); ``tree``: kernel 5's box tree over it
    (``hit_kernels.pass_triangle_tree``), which a caller passing ``rows``
    past ``HK.TRIANGLE_BRUTE_MAX`` passes too."""
    if tris.count == 0:
        return _miss(rays)
    best_t, best_i = _triangle_search(rays, tris, obj_chunk, two_sided,
                                      use_pallas, rows, tree)
    return triangle_champion(rays, tris, best_t, best_i)


def triangle_champion(rays: Rays, tris: Triangles, best_t: torch.Tensor,
                      best_i: torch.Tensor) -> Champion:
    """The Champion of a search's (best_t, best_i), its t recomputed
    differentiably from the champion triangle's vertices."""
    valid = torch.isfinite(best_t) & rays.alive

    # differentiable recompute for the champions (guarded division)
    idx = torch.where(valid, best_i, -1)
    v = _fetch(tris.v.reshape(tris.count, 9), idx).reshape(rays.n, 3, 3)
    p0 = v[:, 0]
    e1 = v[:, 1] - p0
    e2 = v[:, 2] - p0
    n_geo = torch.linalg.cross(e2, e1)
    div = dot3(rays.d, n_geo)
    safe_div = torch.where(valid & (div != 0.0), div, 1.0)
    t = dot3(p0 - rays.o, n_geo) / safe_div
    t = torch.where(valid, t, INF)
    return Champion(t=t, idx=idx, valid=valid)


def triangle_hit_attrs(rays: Rays, tris: Triangles, champ: Champion
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p, interpolated normal, mat_id) at the champions."""
    t_safe = torch.where(champ.valid, champ.t, 0.0)
    p = rays.at(t_safe)
    packed = torch.cat([tris.v.reshape(tris.count, 9),
                        tris.vn.reshape(tris.count, 9),
                        tris.mat_id[:, None].to(torch.float32)], -1)
    fetched = _fetch(packed, champ.idx)
    v = fetched[:, :9].reshape(rays.n, 3, 3)
    vn = fetched[:, 9:18].reshape(rays.n, 3, 3)
    beta, gamma = I.triangle_barycentrics(rays.o, rays.d, v)
    n = I.interpolate_normal(beta, gamma, vn)
    mat = torch.where(champ.valid, fetched[:, 18].to(torch.int32), -1)
    return p, n, mat


def anyhit_triangles(rays: Rays, tris: Triangles, *, obj_chunk: int = 2048,
                     two_sided: bool = False, use_pallas: bool = False,
                     rows: torch.Tensor | None = None,
                     tree: HK.TriangleTree | None = None) -> torch.Tensor:
    """Occlusion: any valid triangle hit inside each ray's window
    (``rows``, ``tree`` as in ``closest_hit_triangles``)."""
    if tris.count == 0:
        return _miss(rays).valid
    with torch.no_grad():
        if use_pallas:
            occ = torch.isfinite(_triangle_search(rays, tris, obj_chunk,
                                                  two_sided, True, rows,
                                                  tree)[0])
        else:
            occ = _anyhit_scan(_triangle_ts(rays, tris, two_sided),
                               tris.count, obj_chunk, rays)
    return occ & rays.alive
