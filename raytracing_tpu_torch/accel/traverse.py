"""3-axis DDA traversal of the uniform grid, vectorised over rays
(``raytracing_tpu.accel.traverse``): the stage route's
``grid_closest_spheres`` / ``grid_closest_triangles``, and ``march``, the
walk that the plain version of kernel 1's grid mode
(``ops/megakernel.py``) runs.

All rays march in lockstep: per step each active ray's cell is visited,
its items (the dense ``items`` row) tested over the ray's whole live
window, and the ray advances along the axis of the nearest cell face
(Amanatides-Woo; the reference's slab march, Assign10 code.cl:675-800).
The walk is conservative so that it never skips a cell the hit lies in:

* it starts at the point ``margin`` before the ray enters the grid;
* where two or three faces are crossed within ``margin`` of each other
  (a ray through a cell edge or corner) it also visits the side cells of
  the other crossing orders, then steps over all of them at once;
* it stops once the next cell's entry exceeds the champion's t (or the
  window's end) by more than ``margin``.

``margin`` is ``REL_MARGIN`` of the grid's exit distance plus the ray's
shortest cell crossing. Extra visits change nothing (a hit is
idempotent). Champions are the least (t, id) pair, ties to the lower id,
as the brute-force loops give them; the JAX package's march stops at the
first cell face past the champion (``best_t <= t_step``) and leaves ties
across cells to the visit order.

JAX's per-cell one-hot fetch, its dense cell scan and its gather
thresholds are TPU vector-machine trade-offs: here each step gathers the
active rays' item rows.
"""
from __future__ import annotations

import math

import torch

from ..core.types import Rays, Spheres, Triangles, cross3, dot3
from ..ops import intersect as I
from ..ops.closest_hit import Champion, sphere_champion, triangle_champion
from .grid import Grid

INF = math.inf
REL_MARGIN = 1e-4
# each non-empty proper subset of the axes, as a mask: the side cells of a
# crossing through an edge or a corner
_SUBSETS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
            (0, 1, 1))


def _grid_consts(grid: Grid, dev):
    return (torch.as_tensor(grid.pmin, device=dev),
            torch.as_tensor(grid.pmax, device=dev),
            torch.as_tensor(grid.width(), device=dev),
            torch.as_tensor(grid.n, device=dev))


def march(o, d, mint, maxt, grid: Grid,
          visit) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk every ray's live window [mint, maxt] through ``grid``.

    ``visit(cell (R,) int64, active (R,) bool)`` tests the cell's items for
    the active rays and returns each ray's current bound (R,): the
    champion's t, INF without one, -INF once an any-hit ray is occluded.
    Returns per ray (R,) the steps of the walk (one cell each) and the
    side cells visited besides them at edge and corner crossings."""
    dev = o.device
    pmin, pmax, w, nv = _grid_consts(grid, dev)
    sd = torch.where(d == 0.0, 1e-30, d)
    t0 = (pmin - o) / sd
    t1 = (pmax - o) / sd
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    ad = d.abs()
    t_delta = torch.where(ad > 0.0, w / torch.where(ad > 0.0, ad, 1.0), INF)
    margin = REL_MARGIN * (far.abs() + t_delta.amin(-1))
    lo = torch.maximum(near, mint)
    hi = torch.minimum(far, maxt)
    active = (mint != maxt) & (lo <= hi + margin)
    t = lo - margin
    p = o + torch.where(active, t, 0.0)[:, None] * d
    c = torch.minimum(torch.clamp(torch.floor((p - pmin) / w), min=0.0),
                      (nv - 1).to(p.dtype)).to(torch.int64)
    pos = d > 0.0
    step = torch.where(pos, 1, -1)
    bnd = pmin + (c + pos.to(torch.int64)).to(p.dtype) * w
    t_next = torch.where(ad > 0.0, (bnd - o) / sd, INF)
    n_x, n_y = grid.n[0], grid.n[1]

    def cell_id(cc):
        return (cc[:, 2] * n_y + cc[:, 1]) * n_x + cc[:, 0]

    def inside(cc):
        return ((cc >= 0) & (cc < nv)).all(-1)

    steps = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
    side = torch.zeros_like(steps)
    for _ in range(sum(grid.n) + 1):      # every step advances some axis
        if not bool(active.any()):
            break
        bound = visit(cell_id(c), active)
        steps += active
        tn = t_next.amin(-1)
        go = active & (tn <= torch.minimum(hi, bound) + margin)
        tie = go[:, None] & (t_next <= (tn + margin)[:, None])
        n_tie = tie.sum(-1)
        for sub in _SUBSETS:
            sm = torch.tensor(sub, dtype=torch.bool, device=dev)
            cs = c + torch.where(sm, step, 0)
            # sub a proper subset of the tied axes, its cell inside
            sel = (go & (tie | ~sm).all(-1) & (n_tie > sum(sub))
                   & inside(cs))
            if bool(sel.any()):
                visit(cell_id(torch.where(sel[:, None], cs, 0)), sel)
                side += sel
        c = c + torch.where(tie, step, 0)
        t_next = t_next + torch.where(tie, t_delta, 0.0)
        active = go & inside(c)
    return steps, side


def cell_items(grid: Grid, cell: torch.Tensor, active: torch.Tensor):
    """(ray, item) pairs of the active rays' cells: the rows of the dense
    item table, padding dropped. Returns (ray (P,), item (P,)) int64."""
    rays = torch.nonzero(active).squeeze(1)
    ids = grid.items[cell[rays]].to(torch.int64)          # (A, K)
    keep = ids >= 0
    ray = rays[:, None].expand_as(ids)[keep]
    return ray, ids[keep]


def lex_min(t, obj, ray, n: int):
    """Per ray the least (t, obj) pair among its pairs (INF t = no hit):
    (t (n,), obj (n,), pair index (n,) or -1)."""
    dev = t.device
    tmin = torch.full((n,), INF, dtype=t.dtype, device=dev).scatter_reduce(
        0, ray, t, "amin")
    cand = torch.isfinite(t) & (t == tmin[ray])
    big = torch.iinfo(torch.int64).max
    omin = torch.full((n,), big, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, ray[cand], obj[cand], "amin")
    win = cand & (obj == omin[ray])
    widx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    widx[ray[win]] = torch.nonzero(win).squeeze(1)
    return tmin, torch.where(widx >= 0, omin, -1), widx


def sphere_rows(spheres: Spheres) -> torch.Tensor:
    """(S, 8) rows [center, radius, 0, mask, 0, 0] for ``I.sphere_hit``."""
    z = torch.zeros((spheres.count, 1), device=spheres.center.device)
    return torch.cat([spheres.center, spheres.radius[:, None], z,
                      spheres.mask[:, None].to(torch.float32), z, z], -1)


def triangle_rows(tris: Triangles) -> torch.Tensor:
    """(T, 18) rows [n_geo, c1, c2, e1, e2, k, 0, mask] for
    ``I.triangle_hit``."""
    tc = I.tri_constants(tris.v)
    z = torch.zeros((tris.count, 1), device=tris.v.device)
    return torch.cat([tc.n_geo, tc.c1, tc.c2, tc.e1, tc.e2, tc.k[:, None],
                      z, tris.mask[:, None].to(torch.float32)], -1)


def _grid_search(rays: Rays, grid: Grid, rows, test):
    """(best_t, best_idx) of the march, without gradients; ``test(o, d,
    mint, maxt, row)`` -> (ok, t) per pair."""
    o, d, mint, maxt = (x.detach() for x in (rays.o, rays.d, rays.mint,
                                             rays.maxt))
    n = o.shape[0]
    best_t = torch.full((n,), INF, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)

    def visit(cell, active):
        nonlocal best_t, best_i
        ray, item = cell_items(grid, cell, active)
        ok, t = test(o[ray], d[ray], mint[ray], maxt[ray], rows[item])
        t = torch.where(ok, t, INF)
        tmin, omin, _ = lex_min(t, item, ray, n)
        better = (omin >= 0) & ((tmin < best_t) | ((tmin == best_t)
                                                   & (omin < best_i)))
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, omin, best_i)
        return best_t

    with torch.no_grad():
        march(o, d, mint, maxt, grid, visit)
    return best_t, best_i.to(torch.int32)


def grid_closest_spheres(rays: Rays, spheres: Spheres, grid: Grid
                         ) -> Champion:
    """The closest sphere through the grid, its t recomputed
    differentiably (as ``ops.closest_hit.closest_hit_spheres``)."""
    with torch.no_grad():
        rows = sphere_rows(spheres)

    def test(o, d, mint, maxt, row):
        a = dot3(d, d)
        return I.sphere_hit(o, d, a, 0.5 / a, mint, maxt, row)

    best_t, best_i = _grid_search(rays, grid, rows, test)
    return sphere_champion(rays, spheres, best_t, best_i)


def grid_closest_triangles(rays: Rays, tris: Triangles, grid: Grid,
                           two_sided: bool = False) -> Champion:
    """The closest triangle through the grid, its t recomputed
    differentiably (as ``ops.closest_hit.closest_hit_triangles``)."""
    with torch.no_grad():
        rows = triangle_rows(tris)

    def test(o, d, mint, maxt, row):
        return I.triangle_hit(o, d, cross3(o, d), mint, maxt, row,
                              two_sided)[:2]

    best_t, best_i = _grid_search(rays, grid, rows, test)
    return triangle_champion(rays, tris, best_t, best_i)
