"""The whole progressive path-tracing pass: the counterpart of
``raytracing_tpu/ops/pallas/megakernel.py`` (path mode, with or without
Russian roulette, and direct mode, over resident, gridded or streamed
tables).

Two versions of one function:

* ``pathtrace_pass_reference`` -- the plain PyTorch version, vectorised
  over rays and looping over objects. Its math and its draw-slot order
  (lens, NEE per light, then per depth: [rr], bounce, NEE per light)
  follow ``_render_pass_kernel`` (``megakernel.py:404-1528``) line for
  line. The CPU tests hold it against the JAX package.
* ``pathtrace_pass`` -- the wrapper, with the signature of
  ``pathtrace_pass_pallas``. On CUDA tensors it launches the hand-written
  kernel ``csrc/megakernel.cu`` or raises; on CPU tensors it runs the plain
  version. It updates ``acc`` in place (the kernel reads and writes the
  same buffer, as the Pallas call aliases it) and counts its launches in
  the module integer ``launches``. On the card it is forward-only: a call
  whose tensors require grad raises (``ops.megakernel_grad`` differentiates).

``record=True`` (single pass; ``megakernel.py:300-311``) also returns
what the champion backward needs: ``ids`` (1 + bounces, R) int32, each
trace segment's champion (sphere i, n_sph + triangle j, -1 for none) in
schedule order, and ``occs`` ((1 + bounces) * L, R) bool, each NEE
shadow ray's occlusion bit in schedule order (segment-major). Segments
after a path died hold -1 / False.

The brute loops' tables stay resident: at most ``SPH_RESIDENT_MAX``
spheres (JAX's ``SMEM_TABLE_MAX // 8``, which JAX's kernel also loops over
resident) and ``TRI_RESIDENT_MAX`` triangles; in grid mode that bounds the
brute prefix only, and a streamed table (below) is not resident.

Draws: with ``u_planes`` (``(2 * n_draws, R)``, plane ``2j + c`` for slot
``j``, component ``c``) both versions read them; without, both make the
draws of ``jax.random.uniform(pass_key, (R, n_draws, 2))`` themselves,
keyed by ``fold_in(PRNGKey(seed), pass)`` -- the kernel in-kernel, bit for
bit the same (``csrc/threefry.cuh``).

Russian roulette (``russian_roulette=True``, ``megakernel.py:1486-1500``)
takes one more draw slot per depth (u0 only) and, from ``rr_start_depth``
on, ends a path unless u0 < p = clip(max(throughput), 0.05, 1), scaling
the throughput of a survivor by 1 / p.

Grid mode (``grid``, a ``KernelGrids``; ``render/mega.grid_tables`` makes
it from ``accel.prepare_grids``' grids, the counterpart of the Pallas
kernel's grid operands): the triangles below ``grid.start`` and, without
a sphere grid, the spheres are the brute prefix that stays resident (the
caps below apply to it); each triangle grid and the sphere grid are
walked per ray cell by cell in order (``accel/traverse.march`` in the
plain version, ``csrc/pathtrace.cuh`` grid_walk in the kernel), with the
brute loops' arithmetic, a candidate winning on the least (t, id) pair,
so ids, record and accumulator are the brute version's. The plain
version, the oracle, tests every item of each cell it visits from the
whole tables; the kernel reads each triangle grid's cell-major copy
(``KernelGrids.copies``, ``render/mega.grid_cells``): each cell's rows
contiguous, in leaves of ``GRID_LEAF`` rows under a box tree per cell,
walked nearest child first over the live window [mint, min(maxt,
champion t)], the boxes widened as the streamed trees' are (below), the
record naming original rows; the sphere grid's cells every item through
the CSR, as the plain version. ``grid_walk_work`` counts what that walk
does on the plain version's rays (the bound's work).
``block`` (the blocked layout) maps the kernel's threads to
pixel blocks in grid mode and over streamed chunks; draws, accumulator and
record stay row-major, so the image is the same: the brute instances keep
the row-major map and the plain version ignores it.

Streamed tables (``chunks``, a ``KernelChunks``; ``render/mega.chunk_tables``
builds it, the counterpart of the Pallas kernel's ``chk`` / ``sph_chunks``
operands, ``megakernel.py:874-935`` and ``:1226-1270``): the triangle
table, the sphere table or both are read from a Morton-sorted copy (read
through ``perm`` instead, the table cost the kernel 1.1-1.6x, PERF.md),
the record naming original rows (sphere i, n_sph + triangle j), never
sorted ones, so kernel 3 runs on the original tables unchanged. The plain
version, the oracle, keeps JAX's chunks of ``STREAM_CHUNK`` rows: per
traced segment each ray slab-tests every chunk's box against its live
window [mint, min(maxt, champion t)] (``chunk_overlap``) and tests the
rows of the chunks it overlaps, with the brute loops' arithmetic. The
kernel walks each stream's ``StreamTree`` instead (``render/mega.
chunk_tree``): the loose rows (room-sized, outside every box) first, then
an implicit binary tree of boxes over leaves of ``STREAM_LEAF`` sorted
rows, nearest child first, culled by the same slab test against the same
live window. A candidate wins on the least (t, original id) pair, so ids,
record and accumulator are the brute version's in any visiting order.
Every box is JAX's widened by ``CHUNK_PAD`` of the scene's scale (the
largest coordinate of its bounds and its camera eye) on every side: a
per-ray slab test can drop, by rounding, a box whose row the brute loop
hits (an axis-aligned wall's box has no thickness, an edge shared by two
boxes is hit at one t from both); the widening only visits more, and the
slab test's rounding is monotone, so a box that contains another
overlaps every window the inner one does. ``tree_walk_work`` counts what
the kernel's walk does on the plain version's rays (the bound's work).
Streaming runs in instances of the grid-mode build (``GRID_FLAGS``) of
its own, with or without grids: in grid mode a sphere table past the
resident budget without a sphere grid streams, as in JAX.

Direct mode (``direct_pass_reference`` / ``direct_pass``, the kernel's
``mode="direct"``, ``megakernel.py:1362-1401``): per ray the primary hit,
then per light a disk sample, a shadow ray and ``albedo * clip(ambient +
(occluded ? 0 : cos), 0, 1)``; no emitter term, throughput or bounce. Its
draws are ``render/mega.u_planes_for_direct``'s (slot 0 the lens, slot 1 +
li light li), or without u-planes those the stage route's ``render_direct``
draws (``direct_draw_planes``), which the kernel makes in-kernel bit for
bit. ``record=True`` (one pass) records JAX's one segment
(``megakernel.py:1642-1644``): ``ids`` (1, R), the primary champion, and
``occs`` (L, R), one occlusion bit per light.

Resident spheres walked as a tree (both modes): past
``SPH_BRUTE_MAX[mode]`` resident spheres (no grid, no streamed table;
``sphere_walks``) the kernel walks a box tree over the spheres instead of
looping over them: the wrapper builds the table's ``SphereTree`` on the
card once per call (``sphere_tree_build``, leaves of ``SPH_TREE_LEAF``
rows; ``pass_tree`` for a caller that hands one tree to several calls)
and launches the tree instances, which test each visited row in the brute
loop's arithmetic and keep the least (t, original index) pair, so ``acc``,
``ids`` and ``occs`` are the brute instances' bit for bit under the same
build flags. On CPU tensors the wrappers run the brute plain versions;
``pathtrace_walk_reference`` and ``direct_walk_reference`` are the plain
versions of the walk, which also count it.
"""
from __future__ import annotations

import ctypes
import math
import weakref
from typing import NamedTuple

import torch

from ..core import rng
from ..core.sampling import (cosine_hemisphere, sample_disk_point,
                             stratified_lens_uv)
from ..core.types import (AABB, Camera, at_least, clip, cross3, dot3,
                          safe_normalize)
from ..render.camera import clip_to_bounds, focal_points, thin_lens_rays
from . import _build
from . import intersect as I

INF = math.inf

# the kernel keeps the brute loops' tables in shared memory and loops over
# objects. UNROLL_OBJECTS is JAX's unroll budget (the routing threshold of
# the backward); spheres stay resident up to JAX's SMEM_TABLE_MAX // 8, as
# in JAX's kernel; triangles up to JAX's STREAM_MIN_TRIS. Past them a table
# streams in Morton chunks (render/mega.chunk_tables), or walks its grid
UNROLL_OBJECTS = 64
SPH_RESIDENT_MAX = 36 * 1024 // 8
TRI_RESIDENT_MAX = UNROLL_OBJECTS
# rows per streamed chunk (JAX's STREAM_CHUNK; csrc/pathtrace.cuh kChunk)
STREAM_CHUNK = 128
# a streamed chunk's box is widened by this share of the scene's scale
CHUNK_PAD = 1e-4
# the walk's layout over a streamed table (render/mega.chunk_tree): rows per
# leaf box (a power of two up to STREAM_CHUNK), the
# most loose rows (tested first by every ray, outside the boxes), the share
# of the scene box's longest side from which a row's longest side makes it
# loose, and the deepest tree a ray walks (csrc/pathtrace.cuh kTreeDepth,
# its stack)
STREAM_LEAF = 2
LOOSE_MAX = 64
LOOSE_SHARE = 0.5
TREE_DEPTH_MAX = 20
# shared memory a block may opt into on the H100 (227 KB)
SMEM_BYTES_MAX = 232448
# pass keys ride in the kernel's parameter block (csrc/megakernel.cu
# kMaxPasses); longer runs take several launches
MAX_PASSES_PER_LAUNCH = 64

# par (26,): eye, u, v, w, film width, film height, cols, rows, focal
# length, lens radius, scene pmin, pmax, shadow eps, ambient (the JAX
# kernel's _PAR layout)
NPAR = 26
SPH_COLS, TRI_COLS, MAT_COLS, LIG_COLS = 8, 32, 4, 20
# in shared memory par takes 28 floats, so that every table starts on a
# 16-byte boundary (csrc/pathtrace.cuh kParPad)
PAR_PAD = 28

# grids of one launch (csrc/pathtrace.cuh kMaxGrids)
GRIDS_MAX = 8
# rows per leaf of the cells' box trees over a triangle grid's cell-major
# copy (render/mega.grid_cells): a power of two up to CELL_LEAF_MAX
# (csrc/pathtrace.cuh kCellLeafMax)
GRID_LEAF = 1
CELL_LEAF_MAX = 32
# nvcc flags of the library that holds grid mode's instances (the default
# build holds the brute ones; csrc/megakernel.cu RT_GRID_MODE)
GRID_FLAGS = ("-DRT_GRID_MODE=1",)
# rays per chunk of the plain grid walk (bounds its (ray, item) pairs: a
# few GB at 146 triangles per cell)
PLAIN_GRID_CHUNK = 1 << 17

# resident spheres walked as a box tree (sphere_walks): past
# SPH_BRUTE_MAX[mode] rows kernel 1 walks a tree over leaves of
# SPH_TREE_LEAF rows in place of its sphere loop. Timed on one H100 80GB
# HBM3 at 700 W (PERF.md section 6, rows 1d and 1s; profile_kernels --only
# direct / --only path, 1024^2): in direct mode (spp 1) the brute loop is
# faster at 128 spheres (16-pass launches 0.157 against 0.163-0.165 ms per
# pass), the walk from 160 on (0.184-0.185 against 0.196); in path mode
# (b5) the brute loop is as fast at 384 spheres in a recording pass
# (1.969-1.970 against 1.934-1.955 ms) and faster in 16-pass launches
# (1.457-1.459 against 1.637-1.663 ms per pass), the walk faster at 448 in
# a recording pass (2.111 against 2.368-2.370) and as fast in 16-pass
# launches (1.802-1.807 against 1.755-1.758), and from 512 in both (2.15
# against 2.92, 1.86 against 2.23)
SPH_BRUTE_MAX = {"path": 384, "direct": 128}
SPH_TREE_LEAF = 1
# a sphere row's floats; the tree's build kernel (csrc/sphere_tree.cu) is
# one block per table, so at most TREE_BUILD_MAX rows (its sort keys' row
# bits)
SPH_COLS = 8
TREE_BUILD_MAX = 8192

launches = 0          # path mode (csrc/megakernel.cu pathtrace_kernel)
direct_launches = 0   # direct mode (csrc/megakernel.cu direct_kernel)
path_walk_launches = 0    # of launches, the sphere tree's instances
direct_walk_launches = 0  # of direct_launches, the sphere tree's instances
tree_build_launches = 0   # sphere_tree_build's kernel
# the launches of either mode that streamed a table (counted in the two
# above as well)
stream_launches = 0


def n_draws_of(n_lights: int, bounces: int, rr: bool = False) -> int:
    """Draw slots of one pass: lens, NEE per light, then per depth:
    [rr with Russian roulette], bounce and NEE per light."""
    return 1 + n_lights + bounces * (int(rr) + 1 + n_lights)


def draw_planes(key: torch.Tensor, n_rays: int, n_draws: int,
                ray_offset: int = 0, device=None) -> torch.Tensor:
    """Rows ``[ray_offset, ray_offset + n_rays)`` of
    ``jax.random.uniform(key, (N, n_draws, 2))`` in plane layout
    ``(2 * n_draws, n_rays)``: element (r, j, c) has flat index
    ``(r * n_draws + j) * 2 + c``."""
    r = torch.arange(ray_offset, ray_offset + n_rays, dtype=torch.int64,
                     device=device)
    plane = torch.arange(2 * n_draws, dtype=torch.int64, device=device)
    idx = r[None, :] * (2 * n_draws) + plane[:, None]
    y0, y1 = rng.threefry2x32(*rng.key_words(key), idx >> 32,
                              idx & rng.MASK32)
    return rng.bits_to_uniform(y0 ^ y1)


def direct_draw_planes(key: torch.Tensor, n_rays: int, n_lights: int,
                       spp: int, device=None,
                       ray_offset: int = 0) -> torch.Tensor:
    """Direct mode's draws in ``u_planes_for_direct``'s layout ``(2 * (1 +
    L), n_rays)``, rows ``[ray_offset, ray_offset + n_rays)``: the lens
    pair from ``uniform(draw_key(key, LENS), (R, 2))`` (zeros at spp > 1,
    where the lens is stratified), then light li's pair from
    ``uniform(draw_key(key, LIGHT, 0, li), (R, 2))`` -- the stage route's
    ``render_direct`` draws."""
    def pair(k):
        return draw_planes(k, n_rays, 1, ray_offset, device)

    lens = (pair(rng.draw_key(key, rng.LENS)) if spp == 1 else
            torch.zeros((2, n_rays), device=device))
    return torch.cat([lens] + [pair(rng.draw_key(key, rng.LIGHT, 0, li))
                               for li in range(n_lights)])


class CellCopy(NamedTuple):
    """The kernel's cell-major copy of one triangle grid
    (``render/mega.grid_cells``): ``rows`` (R, 32) float32, each cell's
    items' rows, cell after cell, in the Morton order of the items'
    centres within a cell, each cell's run padded with zero rows to whole
    leaves; ``perm`` (R,) int32, the original row of each copied row (the
    item id, a row of the folded triangle table), -1 for padding; ``cell``
    (C, 4) int32, per cell [first copied row, its tree's node 0 (-1
    without a tree), leaf slots, items]: a cell of at most one leaf (slots
    0 or 1) has no tree and its rows are tested directly, a larger one an
    implicit binary tree over its leaves of ``leaf`` rows padded with
    empty leaves to a power of two (node k at node 0 + k: the root 1, the
    children of k 2 k and 2 k + 1, leaf j the node slots + j over the
    cell's rows [j leaf, min((j + 1) leaf, items))); ``nodes`` (N, 8)
    float32, the trees' boxes [pmin xyz, pmax xyz, 0, 0] (a box with
    pmin.x > pmax.x is empty)."""
    rows: torch.Tensor
    perm: torch.Tensor
    cell: torch.Tensor
    nodes: torch.Tensor
    leaf: int


class KernelGrids(NamedTuple):
    """Kernel 1's grid mode: triangle grids (``accel.grid.Grid``, item ids
    absolute into the folded triangle table), the sphere grid or None,
    ``start``, the brute triangle prefix, ``rows``, the scene's own
    (sphere, triangle) row counts, which the tables the grids index hold
    (the edge-aware backward checks its tables against them), and
    ``copies``, the kernel's cell-major copy of each triangle grid
    (``CellCopy``, in ``tri``'s order), which the plain version ignores
    and the kernel walks (the sphere grid's cells are walked through its
    CSR over the whole table)."""
    tri: tuple
    sph: object
    start: int
    rows: tuple
    copies: tuple | None = None


class StreamTree(NamedTuple):
    """The kernel's walk over one streamed table (``render/mega.chunk_tree``),
    indexing its Morton copy: ``nodes`` (2 P, 8) float32, an implicit binary
    tree over P leaves (a power of two): node k's box [pmin xyz, pmax xyz, 0,
    0], the root 1, the children of k 2 k and 2 k + 1, leaf j the node P + j
    over the sorted rows [j L, (j + 1) L) (row 0 unused; a box with pmin
    +inf and pmax -inf is empty: no row of it takes part); ``masks``
    (n_leaves, ceil(L / 32)) int32, bit b of word w set where row j L + 32
    w + b takes part in leaf j (neither padding nor loose); ``loose`` (K,)
    int32, the sorted positions of the loose rows, which every ray tests
    first, -1 after the last; ``leaf`` the rows per leaf, L."""
    nodes: torch.Tensor
    masks: torch.Tensor
    loose: torch.Tensor
    leaf: int

    @property
    def n_slots(self) -> int:
        """Leaf slots of the implicit tree (P)."""
        return self.nodes.shape[0] // 2


class Stream(NamedTuple):
    """One streamed table: ``rows`` its rows in Morton order, padded with
    zero rows to ``n_chunks * STREAM_CHUNK``; ``boxes`` (n_chunks, 8) each
    chunk's box [pmin xyz, pmax xyz, 0, 0]; ``perm`` (n_chunks *
    STREAM_CHUNK,) int32, the original row of each sorted row, -1 for
    padding; ``tree`` the kernel's walk over them (the plain version reads
    the chunks and ignores it; the kernel needs it)."""
    rows: torch.Tensor
    boxes: torch.Tensor
    perm: torch.Tensor
    tree: StreamTree | None = None

    @property
    def n_chunks(self) -> int:
        return self.boxes.shape[0]


class KernelChunks(NamedTuple):
    """Kernel 1's streamed tables: the triangles' and the spheres'
    ``Stream``, each None where that table is not streamed."""
    tri: Stream | None
    sph: Stream | None


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _add_walk_work(work, kind: str, keys, steps, side) -> None:
    """Adds the work of one walk per ray through one grid to ``work``:
    ``cells`` (the walk's steps), ``side_cells`` (the side cells visited
    at edge and corner crossings), ``{kind}_tests_raw`` (every (ray, item)
    test made) and ``{kind}_tests`` (the distinct (ray, item) pairs, the
    ``keys``: an item binned into several cells is tested once per cell,
    and a bound counts it once)."""
    if work is None:
        return
    keys = torch.cat(keys) if keys else steps.new_zeros(0)
    for k, x in (("cells", steps.sum()), ("side_cells", side.sum()),
                 (f"{kind}_tests_raw", keys.numel()),
                 (f"{kind}_tests", torch.unique(keys).numel())):
        work[k] = work.get(k, 0) + int(x)


def _grid_walks(grid: KernelGrids):
    """(kind, grid) of each walk: the triangle grids, then the spheres'."""
    return [("tri", g) for g in grid.tri] + (
        [("sph", grid.sph)] if grid.sph is not None else [])


def _grid_closest(o, d, a, inv2a, oxd, mint, maxt, sph, tri, two_sided,
                  grid: KernelGrids, state, work):
    """The grid walks of ``_trace``: each gridded item the march reaches is
    tested with ``_trace``'s arithmetic and wins on the least (t, id)
    pair; returns the champion state (t, normal, material, id)."""
    from ..accel.traverse import cell_items, lex_min, march
    bt, bn, bm, bo = (x.clone() for x in state)
    n_sph = sph.shape[0]
    for s in range(0, o.shape[0], PLAIN_GRID_CHUNK):
        c = slice(s, s + PLAIN_GRID_CHUNK)
        oc, dc, ac, ic, xc = o[c], d[c], a[c], inv2a[c], oxd[c]
        lo, hi = mint[c], maxt[c]
        m = oc.shape[0]
        for kind, g in _grid_walks(grid):
            table = sph if kind == "sph" else tri
            keys = []

            def visit(cell, active, kind=kind, g=g, table=table, keys=keys):
                ray, item = cell_items(g, cell, active)
                if work is not None:
                    keys.append(ray * table.shape[0] + item)
                rows = table[item]
                if kind == "sph":
                    ok, t = I.sphere_hit(oc[ray], dc[ray], ac[ray], ic[ray],
                                         lo[ray], hi[ray], rows)
                    obj = item
                else:
                    ok, t, beta, gamma = I.triangle_hit(
                        oc[ray], dc[ray], xc[ray], lo[ray], hi[ray], rows,
                        two_sided)
                    obj = item + n_sph
                t = torch.where(ok, t, INF)
                tmin, omin, widx = lex_min(t, obj, ray, m)
                cur_t, cur_o = bt[c], bo[c]
                better = (omin >= 0) & ((tmin < cur_t) | (
                    (tmin == cur_t) & (omin < cur_o)))
                r = torch.nonzero(better).squeeze(1)
                w, row = widx[r], rows[widx[r]]
                if kind == "sph":
                    hn = safe_normalize(oc[r] + tmin[r][:, None] * dc[r]
                                        - row[:, 0:3])
                    mat = row[:, 4]
                else:
                    be, ga = beta[w], gamma[w]
                    alpha = 1.0 - be - ga
                    hn = safe_normalize(alpha[:, None] * row[:, 18:21]
                                        + be[:, None] * row[:, 21:24]
                                        + ga[:, None] * row[:, 24:27])
                    mat = row[:, 16]
                bt[s + r], bn[s + r] = tmin[r], hn
                bm[s + r], bo[s + r] = mat, omin[r]
                return bt[c]

            _add_walk_work(work, kind, keys,
                           *march(oc, dc, lo, hi, g, visit))
    return bt, bn, bm, bo


def _grid_occluded(o, d, a, inv2a, oxd, mint, maxt, sph, tri, two_sided,
                   grid: KernelGrids, occ, work):
    """The grid walks of ``_anyhit`` for the rays ``occ`` leaves free; each
    ray's walk stops at its first occluder."""
    from ..accel.traverse import cell_items, march
    occ = occ.clone()
    for s in range(0, o.shape[0], PLAIN_GRID_CHUNK):
        c = slice(s, s + PLAIN_GRID_CHUNK)
        oc, dc, ac, ic, xc = o[c], d[c], a[c], inv2a[c], oxd[c]
        m = oc.shape[0]
        for kind, g in _grid_walks(grid):
            table = sph if kind == "sph" else tri
            # occluded rays get a dead window: the march skips them
            lo = torch.where(occ[c], maxt[c], mint[c])
            hi = maxt[c]
            keys = []

            def visit(cell, active, kind=kind, g=g, table=table, lo=lo,
                      hi=hi, keys=keys):
                ray, item = cell_items(g, cell, active)
                if work is not None:
                    keys.append(ray * table.shape[0] + item)
                rows = table[item]
                if kind == "sph":
                    ok = I.sphere_hit(oc[ray], dc[ray], ac[ray], ic[ray],
                                      lo[ray], hi[ray], rows)[0]
                else:
                    ok = I.triangle_hit(oc[ray], dc[ray], xc[ray], lo[ray],
                                        hi[ray], rows, two_sided)[0]
                hit = torch.zeros(m, dtype=torch.bool, device=oc.device)
                hit[ray[ok]] = True
                occ[s:s + m] |= hit
                return torch.where(occ[c], -INF, INF)

            _add_walk_work(work, kind, keys,
                           *march(oc, dc, lo, hi, g, visit))
    return occ


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d, with 1e-30 in place of a zero component (JAX's safe_inv)."""
    return 1.0 / torch.where(d == 0.0, 1e-30, d)


def chunk_overlap(box, o, inv, lo, hi) -> torch.Tensor:
    """Whether each ray's window [lo, hi] overlaps the box [pmin, pmax]
    (``box`` (8,)): the slab test of JAX's ``chunk_overlap``, per ray.
    fmin / fmax, as the kernel's fminf / fmaxf, pass over a NaN."""
    t0 = (box[0:3] - o) * inv
    t1 = (box[3:6] - o) * inv
    lo3, hi3 = torch.fmin(t0, t1), torch.fmax(t0, t1)
    near = torch.fmax(torch.fmax(lo3[:, 0], lo3[:, 1]), lo3[:, 2])
    far = torch.fmin(torch.fmin(hi3[:, 0], hi3[:, 1]), hi3[:, 2])
    return torch.fmax(near, lo) <= torch.fmin(far, hi)


def _streams(chunks: KernelChunks | None):
    """(kind, stream) of each streamed table: the spheres', then the
    triangles'."""
    if chunks is None:
        return []
    return [(k, s) for k, s in (("sph", chunks.sph), ("tri", chunks.tri))
            if s is not None]


def _chunk_rows(st: Stream, c: int):
    """Chunk c's rows and their original ids, padding dropped."""
    sl = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
    ids = st.perm[sl].to(torch.int64)
    keep = ids >= 0
    return st.rows[sl][keep], ids[keep]


def _add_stream_work(work, kind: str, tests, visits, row_tests) -> None:
    """Adds one chunk's work over a ray batch to ``work``: ``chunk_tests``
    (slab tests), ``chunk_visits`` (the rays that overlapped it) and
    ``{kind}_tests`` (their (ray, row) tests, each distinct: a trace visits
    a chunk once; a shadow ray stops at its first occluder)."""
    if work is None:
        return
    for k, x in (("chunk_tests", tests), ("chunk_visits", visits),
                 (f"{kind}_tests", row_tests)):
        work[k] = work.get(k, 0) + int(x)


def _block_hit(kind: str, r, rows, o, d, a, inv2a, oxd, mint, maxt,
               two_sided):
    """(ok, t, beta, gamma) (rays, rows) of the rays ``r`` against the
    sphere or triangle ``rows`` as one block, with the brute loops'
    arithmetic (beta and gamma None for spheres)."""
    o1, d1 = o[r][:, None], d[r][:, None]
    lo, hi = mint[r][:, None], maxt[r][:, None]
    if kind == "sph":
        return (*I.sphere_hit(o1, d1, a[r][:, None], inv2a[r][:, None], lo,
                              hi, rows), None, None)
    return I.triangle_hit(o1, d1, oxd[r][:, None], lo, hi, rows, two_sided)


def _stream_closest(o, d, a, inv2a, oxd, mint, maxt, n_sph, two_sided,
                    chunks: KernelChunks, state, work):
    """The streamed chunks of ``_trace``, in ray batches: per chunk the
    slab test of every live ray against [mint, min(maxt, champion t)],
    then the chunk's rows tested as one (rays, rows) block with
    ``_trace``'s arithmetic; a candidate wins on the least (t, original id)
    pair. Returns the champion state (t, normal, material, id)."""
    bt, bn, bm, bo = (x.clone() for x in state)
    inv = safe_inv(d)
    alive = mint != maxt
    big = torch.iinfo(torch.int64).max
    for s in range(0, o.shape[0], PLAIN_GRID_CHUNK):
        c_ = slice(s, s + PLAIN_GRID_CHUNK)
        live = alive[c_]
        for kind, st in _streams(chunks):
            for c in range(st.n_chunks):
                hi = torch.minimum(maxt[c_], bt[c_])
                ov = chunk_overlap(st.boxes[c], o[c_], inv[c_], mint[c_],
                                   hi) & live
                r = torch.nonzero(ov).squeeze(1) + s
                rows, ids = _chunk_rows(st, c)
                _add_stream_work(work, kind, live.sum(), r.numel(),
                                 r.numel() * rows.shape[0])
                if r.numel() == 0:
                    continue
                ok, t, beta, gamma = _block_hit(kind, r, rows, o, d, a,
                                                inv2a, oxd, mint, maxt,
                                                two_sided)
                obj = ids if kind == "sph" else ids + n_sph
                t = torch.where(ok, t, INF)
                tmin = t.amin(1)
                cand = torch.isfinite(t) & (t == tmin[:, None])
                omin = torch.where(cand, obj, big).amin(1)
                w = (cand & (obj == omin[:, None])).to(torch.int8).argmax(1)
                cur_t, cur_o = bt[r], bo[r]
                better = torch.isfinite(tmin) & ((tmin < cur_t) | (
                    (tmin == cur_t) & (omin < cur_o)))
                k = torch.nonzero(better).squeeze(1)
                rk, wk, tk = r[k], w[k], tmin[k]
                row = rows[wk]
                if kind == "sph":
                    hn = safe_normalize(o[rk] + tk[:, None] * d[rk]
                                        - row[:, 0:3])
                    mat = row[:, 4]
                else:
                    be, ga = beta[k, wk], gamma[k, wk]
                    alpha = 1.0 - be - ga
                    hn = safe_normalize(alpha[:, None] * row[:, 18:21]
                                        + be[:, None] * row[:, 21:24]
                                        + ga[:, None] * row[:, 24:27])
                    mat = row[:, 16]
                bt[rk], bn[rk], bm[rk], bo[rk] = tk, hn, mat, omin[k]
    return bt, bn, bm, bo


def _stream_occluded(o, d, a, inv2a, oxd, mint, maxt, two_sided,
                     chunks: KernelChunks, occ, work):
    """The streamed chunks of ``_anyhit`` for the live rays ``occ`` leaves
    free: per chunk the slab test against [mint, maxt], then its rows in
    order; a ray stops at its first occluder (``work`` counts its rows up
    to that one)."""
    occ = occ.clone()
    inv = safe_inv(d)
    alive = mint != maxt
    for s in range(0, o.shape[0], PLAIN_GRID_CHUNK):
        c_ = slice(s, s + PLAIN_GRID_CHUNK)
        for kind, st in _streams(chunks):
            for c in range(st.n_chunks):
                free = alive[c_] & ~occ[c_]
                ov = chunk_overlap(st.boxes[c], o[c_], inv[c_], mint[c_],
                                   maxt[c_]) & free
                r = torch.nonzero(ov).squeeze(1) + s
                rows, _ = _chunk_rows(st, c)
                if r.numel() == 0:
                    _add_stream_work(work, kind, free.sum(), 0, 0)
                    continue
                ok = _block_hit(kind, r, rows, o, d, a, inv2a, oxd, mint,
                                maxt, two_sided)[0]
                hit = ok.any(1)
                first = ok.to(torch.int8).argmax(1) + 1
                _add_stream_work(work, kind, free.sum(), r.numel(),
                                 torch.where(hit, first,
                                             rows.shape[0]).sum())
                occ[r] |= hit
    return occ


def _node_enter(box, o, inv, lo, hi):
    """``chunk_overlap`` of per-ray boxes ``box`` (R, 8) with the entry
    max(near, lo) the kernel's ``node_enter`` keeps; an empty box (pmin.x
    > pmax.x) is missed. Returns (overlaps, entry)."""
    t0 = (box[:, 0:3] - o) * inv
    t1 = (box[:, 3:6] - o) * inv
    lo3, hi3 = torch.fmin(t0, t1), torch.fmax(t0, t1)
    near = torch.fmax(torch.fmax(lo3[:, 0], lo3[:, 1]), lo3[:, 2])
    far = torch.fmin(torch.fmin(hi3[:, 0], hi3[:, 1]), hi3[:, 2])
    enter = torch.fmax(near, lo)
    return (enter <= torch.fmin(far, hi)) & ~(box[:, 0] > box[:, 3]), enter


def _least(t, obj):
    """Per ray the least (t, id) pair of (rays, rows) candidates (t INF
    where none): (t, id), id -1 where none."""
    big = torch.iinfo(torch.int64).max
    tmin = t.amin(1)
    cand = torch.isfinite(t) & (t == tmin[:, None])
    omin = torch.where(cand, obj, big).amin(1)
    return tmin, torch.where(torch.isfinite(tmin), omin, -1)


def _walk_tree(kind: str, st: Stream, o, d, a, inv2a, oxd, mint, maxt,
               two_sided: bool, n_sph: int, closest: bool, champ, out: dict,
               warp: int):
    """One stream's part of a trace (``closest``: ``champ`` the (t, id)
    champion so far, returned improved) or of a shadow ray (``champ`` the
    occlusion bits so far, returned or-ed), walked as the kernel's
    ``lane_walk`` walks it: the loose rows, then from the root the nearer
    child first (the other pushed with its entry and dropped when popped
    past the window's end), the window's end the champion's t. Adds to
    ``out``: ``node_tests`` (slab tests of node boxes), ``leaf_visits``,
    ``{kind}_tests`` (row tests, loose rows included; a shadow ray's rows up
    to its first occluder), ``loose_tests``, and per warp of ``warp``
    consecutive rays the union of its lanes' leaves, ``union_leaves`` and
    ``union_{kind}_tests`` (each such leaf's rows once: what the kernel's
    ``warp_walk``, the spheres' schedule, runs; its per-ray counts are
    these, in each ray's own order)."""
    tree = st.tree
    dev = o.device
    slots, leaf = tree.n_slots, tree.leaf
    perm = st.perm.to(torch.int64)
    obj_all = perm + (0 if kind == "sph" else n_sph)
    inv = safe_inv(d)
    visits = []              # (warp, leaf) of each leaf visit

    def add(key: str, x) -> None:
        out[key] = out.get(key, 0) + int(x)

    if closest:
        bt, bo = (x.clone() for x in champ)
    else:
        occ = champ.clone()
    alive = (mint != maxt) if closest else (mint != maxt) & ~occ

    def hi(r):
        return torch.minimum(maxt[r], bt[r]) if closest else maxt[r]

    def rows_hit(r, rows):
        o1, d1 = o[r][:, None], d[r][:, None]
        lo, hi_ = mint[r][:, None], maxt[r][:, None]
        if kind == "sph":
            return I.sphere_hit(o1, d1, a[r][:, None], inv2a[r][:, None], lo,
                                hi_, rows)[0:2]
        return I.triangle_hit(o1, d1, oxd[r][:, None], lo, hi_, rows,
                              two_sided)[0:2]

    def test_rows(r, pos, live):
        """Rays r against the sorted rows pos (n, k) where ``live``."""
        ok, t = rows_hit(r, st.rows[pos])
        ok = ok & live
        if closest:
            add(f"{kind}_tests", live.sum())
            t2, o2 = _least(torch.where(ok, t, INF), obj_all[pos])
            better = (o2 >= 0) & ((t2 < bt[r]) | ((t2 == bt[r])
                                                   & (o2 < bo[r])))
            bt[r] = torch.where(better, t2, bt[r])
            bo[r] = torch.where(better, o2, bo[r])
        else:
            hit = ok.any(1)
            upto = torch.cumsum(live.to(torch.int64), 1)
            first = ok.to(torch.int8).argmax(1)
            n_t = torch.where(hit, upto.gather(1, first[:, None])[:, 0],
                              live.sum(1))
            add(f"{kind}_tests", n_t.sum())
            occ[r] = occ[r] | hit

    loose = tree.loose.to(torch.int64)
    loose = loose[loose >= 0]
    r = torch.nonzero(alive).squeeze(1)
    if loose.numel() and r.numel():
        pos = loose[None].expand(r.numel(), -1)
        before = out.get(f"{kind}_tests", 0)
        test_rows(r, pos, torch.ones_like(pos, dtype=torch.bool))
        add("loose_tests", out[f"{kind}_tests"] - before)
    if not closest:
        alive = alive & ~occ
    n = o.shape[0]
    depth = TREE_DEPTH_MAX
    stack = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    enter = torch.zeros((n, depth), device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.ones(n, dtype=torch.int64, device=dev)
    r = torch.nonzero(alive).squeeze(1)
    ok, _ = _node_enter(tree.nodes[node[r]], o[r], inv[r], mint[r], hi(r))
    add("node_tests", r.numel())
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[r[ok]] = True
    lane = torch.arange(leaf, device=dev)
    bit = (lane % 32)
    while True:
        r = torch.nonzero(active).squeeze(1)
        if r.numel() == 0:
            break
        nd = node[r]
        at_leaf = nd >= slots
        pop = torch.zeros(n, dtype=torch.bool, device=dev)
        # leaves
        rl = r[at_leaf]
        if rl.numel():
            j = node[rl] - slots
            pos = j[:, None] * leaf + lane
            words = tree.masks[j].to(torch.int64) & 0xFFFFFFFF
            live = ((words[:, lane // 32] >> bit) & 1).bool()
            add("leaf_visits", rl.numel())
            visits.append(torch.stack([rl // warp, j], 1))
            test_rows(rl, pos, live)
            pop[rl] = True
            if not closest:
                active[rl] = ~occ[rl]
        # inner nodes
        ri = r[~at_leaf]
        if ri.numel():
            c0 = 2 * node[ri]
            h = hi(ri)
            h0, e0 = _node_enter(tree.nodes[c0], o[ri], inv[ri], mint[ri], h)
            h1, e1 = _node_enter(tree.nodes[c0 + 1], o[ri], inv[ri],
                                 mint[ri], h)
            add("node_tests", 2 * ri.numel())
            both = h0 & h1
            first = (e1 < e0).to(torch.int64)
            rb = ri[both]
            stack[rb, sp[rb]] = (c0 + 1 - first)[both]
            enter[rb, sp[rb]] = torch.where(first.bool(), e0, e1)[both]
            sp[rb] += 1
            node[ri] = torch.where(both, c0 + first,
                                   torch.where(h0, c0, c0 + 1))
            pop[ri[~(h0 | h1)]] = True
        # pop the next node still in the window
        need = pop & active
        while True:
            rp = torch.nonzero(need).squeeze(1)
            if rp.numel() == 0:
                break
            empty = sp[rp] == 0
            active[rp[empty]] = False
            need[rp[empty]] = False
            rp = rp[~empty]
            sp[rp] -= 1
            fits = enter[rp, sp[rp]] <= hi(rp)
            rk = rp[fits]
            node[rk] = stack[rk, sp[rk]]
            need[rk] = False
    if visits:
        pairs = torch.unique(torch.cat(visits), dim=0)
        live_rows = torch.stack([
            ((tree.masks[pairs[:, 1]].to(torch.int64) & 0xFFFFFFFF)
             >> b) & 1 for b in range(32)]).sum((0, 2))
        add("union_leaves", pairs.shape[0])
        add(f"union_{kind}_tests", live_rows.sum())
    return (bt, bo) if closest else occ


def _walk_cells(g, cp: CellCopy, o, d, oxd, mint, maxt, two_sided: bool,
                n_sph: int, closest: bool, champ, out: dict):
    """One triangle grid's part of a trace (``closest``: ``champ`` the (t, id)
    champion so far, returned improved) or of a shadow ray (``champ`` the
    occlusion bits so far, returned or-ed), walked as the kernel walks it:
    the march over the grid's cells in order (``accel/traverse.march``,
    the kernel's ``grid_walk``), and in each cell visited, over its
    cell-major copy ``cp``, its rows directly where it has at most one
    leaf, else its tree from the root, nearer child first (the other
    pushed with its entry and dropped when popped past the window's end),
    the window's end the champion's t (``lane_tree``). Adds to ``out``:
    ``cells`` and ``side_cells`` (the march's steps and side cells),
    ``node_tests`` (slab tests of node boxes), ``leaf_visits`` (a cell
    without a tree: one), ``tri_tests`` (row tests; a shadow ray's up to
    its first occluder)."""
    from ..accel.traverse import march
    dev = o.device
    cells = cp.cell.to(torch.int64)
    leaf = cp.leaf
    obj_all = cp.perm.to(torch.int64) + n_sph
    inv = safe_inv(d)
    lane = torch.arange(leaf, device=dev)

    def add(key: str, x) -> None:
        out[key] = out.get(key, 0) + int(x)

    if closest:
        bt, bo = (x.clone() for x in champ)
    else:
        occ = champ.clone()

    def hi(r):
        return torch.minimum(maxt[r], bt[r]) if closest else maxt[r]

    def test_leaf(r, row0, count, j):
        """Rays r at leaf j of their cells (first rows row0, count rows)."""
        if r.numel() == 0:
            return
        add("leaf_visits", r.numel())
        pos = (row0 + j * leaf)[:, None] + lane
        live = lane < (count - j * leaf)[:, None]
        ok, t = I.triangle_hit(o[r][:, None], d[r][:, None],
                               oxd[r][:, None], mint[r][:, None],
                               maxt[r][:, None], cp.rows[pos], two_sided)[0:2]
        ok = ok & live
        if closest:
            add("tri_tests", live.sum())
            t2, o2 = _least(torch.where(ok, t, INF), obj_all[pos])
            better = (o2 >= 0) & ((t2 < bt[r]) | ((t2 == bt[r])
                                                   & (o2 < bo[r])))
            bt[r] = torch.where(better, t2, bt[r])
            bo[r] = torch.where(better, o2, bo[r])
        else:
            hit = ok.any(1)
            upto = torch.cumsum(live.to(torch.int64), 1)
            first = ok.to(torch.int8).argmax(1)
            add("tri_tests", torch.where(
                hit, upto.gather(1, first[:, None])[:, 0], live.sum(1)).sum())
            occ[r] = occ[r] | hit

    def walk_trees(r, node0, slots, row0, count):
        """Rays r each walk their cell's tree (node 0 at node0)."""
        n = r.numel()
        if n == 0:
            return
        stack = torch.zeros((n, TREE_DEPTH_MAX), dtype=torch.int64,
                            device=dev)
        enter = torch.zeros((n, TREE_DEPTH_MAX), device=dev)
        sp = torch.zeros(n, dtype=torch.int64, device=dev)
        node = torch.ones(n, dtype=torch.int64, device=dev)
        ok, _ = _node_enter(cp.nodes[node0 + 1], o[r], inv[r], mint[r],
                            hi(r))
        add("node_tests", n)
        active = ok.clone()
        while True:
            i = torch.nonzero(active).squeeze(1)
            if i.numel() == 0:
                break
            at_leaf = node[i] >= slots[i]
            pop = torch.zeros(n, dtype=torch.bool, device=dev)
            il = i[at_leaf]
            if il.numel():
                test_leaf(r[il], row0[il], count[il], node[il] - slots[il])
                pop[il] = True
                if not closest:
                    active[il] = ~occ[r[il]]
            ii = i[~at_leaf]
            if ii.numel():
                ri = r[ii]
                c0 = 2 * node[ii]
                h = hi(ri)
                h0, e0 = _node_enter(cp.nodes[node0[ii] + c0], o[ri], inv[ri],
                                     mint[ri], h)
                h1, e1 = _node_enter(cp.nodes[node0[ii] + c0 + 1], o[ri],
                                     inv[ri], mint[ri], h)
                add("node_tests", 2 * ii.numel())
                both = h0 & h1
                first = (e1 < e0).to(torch.int64)
                ib = ii[both]
                stack[ib, sp[ib]] = (c0 + 1 - first)[both]
                enter[ib, sp[ib]] = torch.where(first.bool(), e0, e1)[both]
                sp[ib] += 1
                node[ii] = torch.where(both, c0 + first,
                                       torch.where(h0, c0, c0 + 1))
                pop[ii[~(h0 | h1)]] = True
            need = pop & active
            while True:
                ip = torch.nonzero(need).squeeze(1)
                if ip.numel() == 0:
                    break
                empty = sp[ip] == 0
                active[ip[empty]] = False
                need[ip[empty]] = False
                ip = ip[~empty]
                sp[ip] -= 1
                fits = enter[ip, sp[ip]] <= hi(r[ip])
                ik = ip[fits]
                node[ik] = stack[ik, sp[ik]]
                need[ik] = False

    def visit(cell, active):
        r = torch.nonzero(active).squeeze(1)
        row0, node0, slots, count = cells[cell[r]].unbind(1)
        flat = (slots <= 1) & (count > 0)
        test_leaf(r[flat], row0[flat], count[flat], 0)
        tree = slots >= 2
        walk_trees(r[tree], node0[tree], slots[tree], row0[tree],
                   count[tree])
        return bt if closest else torch.where(occ, -INF, INF)

    # an occluded ray's window is dead: the march skips it
    lo = mint if closest else torch.where(occ, maxt, mint)
    steps, side = march(o, d, lo, maxt, g, visit)
    add("cells", steps.sum())
    add("side_cells", side.sum())
    return (bt, bo) if closest else occ


def _count_walks(par, ipar, sph, tri, mat, lig, acc, u_planes, *, spp,
                 width, bounces, two_sided, normalize_emitter, seed,
                 russian_roulette, rr_start_depth, mode, key, work,
                 grid=None, chunks=None, brute, walks) -> dict:
    """Runs the plain pass (over ``grid`` or ``chunks``; ``work`` gets its
    counts) and walks each of its traces and shadow rays again as the
    kernel does: the brute loops over ``brute`` (sph, tri) first, then
    ``walks(o, d, a, inv2a, oxd, mint, maxt, closest, champ, out)``.
    Returns the walks' counts, ``traces`` and ``shadows`` (live walks),
    and ``misses`` and ``occ_misses``: the rays whose walked champion
    (least (t, id)) or occlusion bit differs from the plain version's,
    which a walk that culled the rows holding the winner or the first
    occluder would give."""
    out: dict = {}
    n_sph = sph.shape[0]
    sph_b, tri_b = brute

    def trace(o, d, mint, maxt):
        res = _trace(o, d, mint, maxt, sph, tri, two_sided, grid, work,
                     chunks)
        a = dot3(d, d)
        inv2a = 0.5 / a
        oxd = cross3(o, d)
        b = _trace(o, d, mint, maxt, sph_b, tri_b, two_sided)
        ids = b[4] + torch.where(b[4] >= sph_b.shape[0],
                                 n_sph - sph_b.shape[0], 0)
        found = b[3] >= 0.0
        champ = (torch.where(found, b[0], INF), torch.where(found, ids, -1))
        champ = walks(o, d, a, inv2a, oxd, mint, maxt, True, champ, out)
        alive = mint != maxt
        out["traces"] = out.get("traces", 0) + int(alive.sum())
        want = torch.where(res[3] >= 0.0, res[4], -1)
        out["misses"] = out.get("misses", 0) + int(
            ((champ[1] != want) & alive).sum())
        return res

    def anyhit(o, d, mint, maxt):
        occ = _anyhit(o, d, mint, maxt, sph, tri, two_sided, grid, work,
                      chunks)
        a = dot3(d, d)
        inv2a = 0.5 / a
        oxd = cross3(o, d)
        walked = _anyhit(o, d, mint, maxt, sph_b, tri_b, two_sided)
        walked = walks(o, d, a, inv2a, oxd, mint, maxt, False, walked, out)
        alive = mint != maxt
        out["shadows"] = out.get("shadows", 0) + int(alive.sum())
        out["occ_misses"] = out.get("occ_misses", 0) + int(
            ((walked & alive) != occ).sum())
        return occ

    if mode == "direct":
        u = u_planes if u_planes is not None else direct_draw_planes(
            key, acc.shape[0], lig.shape[0], spp, acc.device)
        _direct_reference(par, sph, tri, mat, lig, acc, u, spp=spp,
                          width=width, two_sided=two_sided, trace=trace,
                          anyhit=anyhit)
    else:
        u = pass_draws(ipar, u_planes, acc.shape[0], lig.shape[0], bounces,
                       seed, 0, acc.device, russian_roulette)
        _pass_reference(par, sph, tri, mat, lig, acc, u, int(ipar[1]),
                        spp=spp, width=width, bounces=bounces,
                        two_sided=two_sided,
                        normalize_emitter=normalize_emitter,
                        russian_roulette=russian_roulette,
                        rr_start_depth=rr_start_depth, trace=trace,
                        anyhit=anyhit)
    return out


def tree_walk_work(par, ipar, sph, tri, mat, lig, acc, u_planes, *,
                   chunks: KernelChunks, spp: int, width: int, bounces: int,
                   two_sided: bool, normalize_emitter: bool, seed: int,
                   russian_roulette: bool = False, rr_start_depth: int = 0,
                   mode: str = "path", key=None, warp: int = 32,
                   work=None) -> dict:
    """What kernel 1's walk over the streamed tables' trees does on one
    pass's rays, counted outside the plain version (``_count_walks``): the
    pass runs the plain streamed version (``pathtrace_pass_reference``'s,
    or ``direct_pass_reference``'s with ``mode="direct"`` and ``key``;
    ``work`` gets its Morton chunks' counts), and each of its traces and
    shadow rays is walked again over ``chunks``' trees in the kernel's
    order (``_walk_tree``). Returns the walk's counts summed over the pass,
    ``traces``, ``shadows``, ``misses`` and ``occ_misses``."""
    n_sph = sph.shape[0]

    def walks(o, d, a, inv2a, oxd, mint, maxt, closest, champ, out):
        for kind, st in _streams(chunks):
            champ = _walk_tree(kind, st, o, d, a, inv2a, oxd, mint, maxt,
                               two_sided, n_sph, closest, champ, out, warp)
        return champ

    # the resident tables of the brute loops, which run before the streams
    brute = (sph if chunks.sph is None else sph[:0],
             tri if chunks.tri is None else tri[:0])
    return _count_walks(
        par, ipar, sph, tri, mat, lig, acc, u_planes, spp=spp, width=width,
        bounces=bounces, two_sided=two_sided,
        normalize_emitter=normalize_emitter, seed=seed,
        russian_roulette=russian_roulette, rr_start_depth=rr_start_depth,
        mode=mode, key=key, work=work, chunks=chunks, brute=brute,
        walks=walks)


def grid_walk_work(par, ipar, sph, tri, mat, lig, acc, u_planes, *,
                   grid: KernelGrids, spp: int, width: int, bounces: int,
                   two_sided: bool, normalize_emitter: bool, seed: int,
                   russian_roulette: bool = False, rr_start_depth: int = 0,
                   mode: str = "path", key=None, work=None) -> dict:
    """What kernel 1's grid mode does on one pass's rays, counted outside
    the plain version (``_count_walks``), as ``tree_walk_work`` counts the
    streamed walk: the pass runs the plain grid version (the march over
    each cell's items, ``work`` its counts), and each of its traces and
    shadow rays is walked again as the kernel walks it, the brute prefix
    first, then each grid's march with each visited cell's rows walked over
    its cell-major copy (``grid.copies``, ``_walk_cells``; the sphere
    grid's cells every item, as the plain version). Returns the walks'
    counts summed over the pass (``cells``, ``side_cells``,
    ``node_tests``, ``leaf_visits``, ``{kind}_tests``), ``traces``,
    ``shadows``, ``misses`` and ``occ_misses``."""
    n_sph = sph.shape[0]

    def walks(o, d, a, inv2a, oxd, mint, maxt, closest, champ, out):
        for g, cp in zip(grid.tri, grid.copies):
            champ = _walk_cells(g, cp, o, d, oxd, mint, maxt, two_sided,
                                n_sph, closest, champ, out)
        if grid.sph is not None:
            # the sphere grid's cells: every item through the CSR, as the
            # plain version walks them (their raw tests are the kernel's)
            one = KernelGrids(tri=(), sph=grid.sph, start=0, rows=grid.rows)
            tmp: dict = {}
            if closest:
                t, o2 = champ
                st = (t, torch.zeros_like(o), torch.where(o2 >= 0, 0.0, -1.0),
                      o2)
                res = _grid_closest(o, d, a, inv2a, oxd, mint, maxt, sph,
                                    tri, two_sided, one, st, tmp)
                champ = (res[0], res[3])
            else:
                champ = _grid_occluded(o, d, a, inv2a, oxd, mint, maxt, sph,
                                       tri, two_sided, one, champ, tmp)
            for k, v in (("cells", tmp["cells"]),
                         ("side_cells", tmp["side_cells"]),
                         ("sph_tests", tmp["sph_tests_raw"])):
                out[k] = out.get(k, 0) + int(v)
        return champ

    brute = (sph if grid.sph is None else sph[:0], tri[:grid.start])
    return _count_walks(
        par, ipar, sph, tri, mat, lig, acc, u_planes, spp=spp, width=width,
        bounces=bounces, two_sided=two_sided,
        normalize_emitter=normalize_emitter, seed=seed,
        russian_roulette=russian_roulette, rr_start_depth=rr_start_depth,
        mode=mode, key=key, work=work, grid=grid, brute=brute, walks=walks)


def _brute_counts(sph, tri, grid, chunks) -> tuple[int, int]:
    """The spheres and triangles of the brute loops: all of a table that
    neither a grid nor the chunks cover, the prefix below ``grid.start``."""
    n_bs = sph.shape[0]
    if (grid is not None and grid.sph is not None) or (
            chunks is not None and chunks.sph is not None):
        n_bs = 0
    n_bt = tri.shape[0] if grid is None else grid.start
    if chunks is not None and chunks.tri is not None:
        n_bt = 0
    return n_bs, n_bt


def _tree_stream(sph_tree) -> Stream:
    """A sphere tree (``SphereTree``) as the stream ``_walk_tree``
    walks."""
    return Stream(rows=sph_tree.rows, boxes=sph_tree.rows[:0],
                  perm=sph_tree.perm, tree=sph_tree.tree)


def _trace(o, d, mint, maxt, sph, tri, two_sided, grid=None, work=None,
           chunks=None, sph_tree=None):
    """Closest hit over spheres then triangles (champion loops with a
    strict ``t < best``). Returns (new maxt, hit point, shading normal,
    material id as float (-1 on a miss), champion (sphere i, n_sph +
    triangle j, -1 on a miss) as int64). With ``grid`` the loops cover the
    brute prefix and the grids' walks the rest (``_grid_closest``);
    ``work`` (a dict) then sums the walks' work (``_add_walk_work``). With
    ``chunks`` the streamed tables are read chunk by chunk
    (``_stream_closest``; ``work`` sums ``_add_stream_work``). With
    ``sph_tree`` (a ``SphereTree`` of ``sph``) the sphere loop is the
    walk of the tree in the kernel's order (``_walk_tree``; ``work`` sums
    its counts), with the loop's champion."""
    n = o.shape[0]
    alive = mint != maxt
    a = dot3(d, d)
    inv2a = 0.5 / a
    # the champion state in the rays' precision (the chunk and grid
    # searches write into it in place)
    bt = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    bn = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    bm = torch.full((n,), -1.0, dtype=o.dtype, device=o.device)
    bo = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    n_bs, n_bt = _brute_counts(sph, tri, grid, chunks)
    if sph_tree is not None:
        n_bs = 0
        bt, bo = _walk_tree("sph", _tree_stream(sph_tree), o, d, a, inv2a,
                            None, mint, maxt, False, 0, True, (bt, bo),
                            {} if work is None else work, 32)
        found = bo >= 0
        row = sph[bo.clamp(min=0)]
        ts = torch.where(found, bt, 0.0)
        hn = safe_normalize(o + ts[:, None] * d - row[:, 0:3])
        bn = torch.where(found[:, None], hn, bn)
        bm = torch.where(found, row[:, 4], bm)
    for i in range(n_bs):
        row = sph[i]
        ok, t = I.sphere_hit(o, d, a, inv2a, mint, maxt, row)
        t = torch.where(ok & alive, t, INF)
        better = t < bt
        ts = torch.where(better, t, 0.0)
        hn = safe_normalize(o + ts[:, None] * d - row[0:3])
        bt = torch.where(better, t, bt)
        bn = torch.where(better[:, None], hn, bn)
        bm = torch.where(better, row[4], bm)
        bo = torch.where(better, i, bo)
    oxd = cross3(o, d)          # loop-invariant over triangles
    for i in range(n_bt):
        row = tri[i]
        ok, t, beta, gamma = I.triangle_hit(o, d, oxd, mint, maxt, row,
                                            two_sided)
        t = torch.where(ok & alive, t, INF)
        better = t < bt
        alpha = 1.0 - beta - gamma
        hn = safe_normalize(alpha[:, None] * row[18:21]
                            + beta[:, None] * row[21:24]
                            + gamma[:, None] * row[24:27])
        bt = torch.where(better, t, bt)
        bn = torch.where(better[:, None], hn, bn)
        bm = torch.where(better, row[16], bm)
        bo = torch.where(better, sph.shape[0] + i, bo)
    if chunks is not None:
        bt, bn, bm, bo = _stream_closest(o, d, a, inv2a, oxd, mint, maxt,
                                         sph.shape[0], two_sided, chunks,
                                         (bt, bn, bm, bo), work)
    if grid is not None:
        bt, bn, bm, bo = _grid_closest(o, d, a, inv2a, oxd, mint, maxt, sph,
                                       tri, two_sided, grid,
                                       (bt, bn, bm, bo), work)
    found = bm >= 0.0
    ts = torch.where(found, bt, 0.0)
    return (torch.where(found, bt, maxt), o + ts[:, None] * d, bn, bm,
            torch.where(found, bo, -1))


def _anyhit(o, d, mint, maxt, sph, tri, two_sided, grid=None, work=None,
            chunks=None, sph_tree=None):
    """Occlusion of the segments [mint, maxt] by any object (with ``grid``
    the brute prefix, then ``_grid_occluded``; with ``chunks`` the streamed
    tables, ``_stream_occluded``; with ``sph_tree`` the spheres by the
    tree's walk, as ``_trace``)."""
    alive = mint != maxt
    a = dot3(d, d)
    inv2a = 0.5 / a
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    n_bs, n_bt = _brute_counts(sph, tri, grid, chunks)
    if sph_tree is not None:
        n_bs = 0
        occ = _walk_tree("sph", _tree_stream(sph_tree), o, d, a, inv2a, None,
                         mint, maxt, False, 0, False, occ,
                         {} if work is None else work, 32)
    for i in range(n_bs):
        occ = occ | I.sphere_hit(o, d, a, inv2a, mint, maxt, sph[i])[0]
    oxd = cross3(o, d)
    for i in range(n_bt):
        occ = occ | I.triangle_hit(o, d, oxd, mint, maxt, tri[i],
                                   two_sided)[0]
    occ = occ & alive
    if chunks is not None:
        occ = _stream_occluded(o, d, a, inv2a, oxd, mint, maxt, two_sided,
                               chunks, occ, work)
    if grid is not None:
        occ = _grid_occluded(o, d, a, inv2a, oxd, mint, maxt, sph, tri,
                             two_sided, grid, occ, work) & alive
    return occ


def _albedo(mat, matf):
    """materials[mat_id].rgb, zeros for ids outside the table."""
    m = matf.to(torch.int64)
    ok = (matf >= 0.0) & (m < mat.shape[0])
    rgb = mat[m.clamp(0, mat.shape[0] - 1), 0:3]
    return torch.where(ok[:, None], rgb, 0.0)


def _camera_rays(par, lens_uv, n: int, ray_offset: int, spp: int,
                 width: int):
    """(o, d, mint, maxt) of the primary rays of rays ``[ray_offset,
    ray_offset + n)``, the kernel's camera: pixel decode from the global
    ray id, film point -> focal point -> thin-lens ray from ``lens_uv``
    (n, 2) (stratified lens-cell centres at spp > 1), scene-AABB clip."""
    dev = par.device
    # pixel decode from the global ray id (integer; the kernel's float
    # decode is exact in its < 2^24 range)
    rid = torch.arange(n, dtype=torch.int64, device=dev) + ray_offset
    pix = torch.div(rid, spp, rounding_mode="floor")
    samp = rid - pix * spp
    row = torch.div(pix, width, rounding_mode="floor")
    col = pix - row * width
    # the camera as the kernel reads it from par (cols/rows as scalars of
    # par's type; col/row in that type too, or a float64 par would meet
    # float32 pixel coordinates and round the film point to float32)
    cam = Camera(eye=par[0:3], u=par[3:6], v=par[6:9], w=par[9:12],
                 width=par[12], height=par[13], cols=par[14], rows=par[15])
    fp = focal_points(cam, col.to(par.dtype), row.to(par.dtype), par[16])
    uv = stratified_lens_uv(samp, spp) if spp > 1 else lens_uv
    rays = clip_to_bounds(thin_lens_rays(cam, fp, par[17], uv),
                          AABB(pmin=par[18:21], pmax=par[21:24]))
    return rays.o, rays.d, rays.mint, rays.maxt


def survival_p(tp: torch.Tensor) -> torch.Tensor:
    """Russian roulette's survival probability clip(max(tp), 0.05, 1) of
    throughputs tp (R, 3), written as JAX's jnp.clip is (a minimum of a
    maximum of a chain of maximum), so that its gradient splits at ties and
    bounds as JAX's does (torch.clamp would pass it whole at a bound)."""
    m = torch.maximum(tp[:, 0], torch.maximum(tp[:, 1], tp[:, 2]))
    return torch.minimum(torch.maximum(m, torch.full_like(m, 0.05)),
                         torch.full_like(m, 1.0))


def _pass_reference(par, sph, tri, mat, lig, acc, u, ray_offset: int, *,
                    spp: int, width: int, bounces: int, two_sided: bool,
                    normalize_emitter: bool, russian_roulette: bool = False,
                    rr_start_depth: int = 0, trace=None, anyhit=None,
                    record=None, grid=None, work=None, chunks=None,
                    sph_tree=None) -> torch.Tensor:
    """One pass of ``_render_pass_kernel`` (path mode) over every ray;
    returns the new accumulator.

    ``trace(o, d, mint, maxt)`` -> (maxt, hit point, normal, material,
    champion) and ``anyhit(o, d, mint, maxt)`` -> occluded replace the
    sweeps over the tables, as JAX's ``_tile_program(trace_override=,
    anyhit_override=)`` does; they are called in schedule order. With
    ``record`` (a dict of two lists) each trace appends its champions to
    ``record["ids"]`` and each NEE its occlusion bits to
    ``record["occs"]``; ``sph_tree`` as ``_trace``'s."""
    n, dev = acc.shape[0], acc.device
    n_lig = lig.shape[0]
    slots = iter(range(u.shape[0] // 2))
    if trace is None:
        def trace(o, d, mint, maxt):
            return _trace(o, d, mint, maxt, sph, tri, two_sided, grid, work,
                          chunks, sph_tree)
    if anyhit is None:
        def anyhit(o, d, mint, maxt):
            return _anyhit(o, d, mint, maxt, sph, tri, two_sided, grid, work,
                           chunks, sph_tree)
    if record is not None:
        traced, occluded = trace, anyhit

        def trace(*ray):
            out = traced(*ray)
            record["ids"].append(out[4])
            return out

        def anyhit(*ray):
            occ = occluded(*ray)
            record["occs"].append(occ)
            return occ

    def draw():
        j = next(slots)
        return u[2 * j:2 * j + 2].t()

    lens = draw() if spp == 1 else next(slots)  # slot 0: no draw at spp > 1
    o, d, mint, maxt = _camera_rays(par, lens, n, ray_offset, spp, width)
    eps = par[24]

    maxt, hp, hn, matf, _ = trace(o, d, mint, maxt)

    # emitter hits on the primary segment only
    for li in range(n_lig):
        lr = lig[li]
        irr = lr[9:12] if normalize_emitter else lr[6:9]
        alive = mint != maxt
        t = I.light_disk_t(o, d, lr[0:3], lr[3:6], lr[12])
        hitl = alive & (t < INF) & (t >= mint) & (t < maxt)
        acc = acc + torch.where(hitl[:, None], irr, 0.0)
        mint = torch.where(hitl, INF, mint)
        maxt = torch.where(hitl, INF, maxt)
        matf = torch.where(hitl, -1.0, matf)

    def nee(li, acc, tp, u):
        lr = lig[li]
        lp, ln, irr = lr[0:3], lr[3:6], lr[6:9]
        valid = matf >= 0.0
        tgt = sample_disk_point(lp, lr[14:17], lr[17:20], lr[12], u)
        so = hp + eps * hn
        dl = tgt - so
        d2 = dot3(dl, dl)
        dist = torch.sqrt(torch.where(d2 > 0.0, d2, 1.0))
        dist = torch.where(d2 > 0.0, dist, 0.0)
        sd = safe_normalize(dl)
        occ = anyhit(so, sd, torch.where(valid, 0.0, INF),
                     torch.where(valid, dist, INF))
        # geometric term uses the distance to the light CENTER (reference
        # quirk, kept)
        q = hp - lp
        r2 = dot3(q, q)
        cosx = clip(dot3(sd, hn), 0.0, 1.0)
        cosy = clip(-dot3(sd, ln), 0.0, 1.0)
        geom = lr[13] * cosx * cosy / at_least(r2, 1e-20)
        free = valid & ~occ
        alb = _albedo(mat, matf)
        sh = torch.where(free[:, None], geom[:, None] * irr, 0.0)
        acc = acc + torch.where(valid[:, None], tp * alb * sh, 0.0)
        tp = torch.where(valid[:, None], tp * alb, tp)
        return acc, tp

    tp = torch.ones((n, 3), device=dev)
    for li in range(n_lig):
        acc, tp = nee(li, acc, tp, draw())
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    for depth in range(bounces):
        if russian_roulette:
            # its slot is drawn at every depth, played from rr_start_depth
            u_rr = draw()[:, 0]
            if depth >= rr_start_depth:
                p_srv = survival_p(tp)
                survive = u_rr < p_srv
                inv_p = torch.full_like(p_srv, 1.0) / p_srv
                tp = torch.where(survive[:, None], tp * inv_p[:, None], 0.0)
                matf = torch.where(survive, matf, -1.0)
        valid = matf >= 0.0
        sn = torch.where(valid[:, None], hn, up)
        d = cosine_hemisphere(sn, draw())
        o = hp + eps * hn
        mint = torch.where(valid, 0.0, INF)
        maxt = torch.full((n,), INF, device=dev)
        maxt, hp, hn, matf, _ = trace(o, d, mint, maxt)
        for li in range(n_lig):
            acc, tp = nee(li, acc, tp, draw())
    return acc


def pass_draws(ipar, u_planes, n_rays: int, n_lights: int, bounces: int,
               seed: int, p: int = 0, device=None,
               rr: bool = False) -> torch.Tensor:
    """The draws of pass ``ipar[0] + p``: ``u_planes``, or those the
    kernels make in-kernel, keyed by ``fold_in(PRNGKey(seed), pass)``."""
    if u_planes is not None:
        return u_planes
    pass0, roff = (int(x) for x in ipar.tolist())
    return draw_planes(rng.pass_key(rng.base_key(seed), pass0 + p), n_rays,
                       n_draws_of(n_lights, bounces, rr), roff, device)


def pathtrace_pass_reference(par, ipar, sph, tri, mat, lig, acc, u_planes,
                             *, spp: int, width: int, bounces: int,
                             two_sided: bool, normalize_emitter: bool,
                             seed: int, n_passes: int = 1,
                             russian_roulette: bool = False,
                             rr_start_depth: int = 0,
                             record: bool = False, grid=None, work=None,
                             chunks=None, sph_tree=None):
    """The plain version of ``pathtrace_pass`` on any device; returns a new
    accumulator (``acc`` is not modified), or ``(acc, ids, occs)`` with
    ``record=True`` (one pass). ``grid``: grid mode (a ``KernelGrids``);
    ``chunks``: the streamed tables (a ``KernelChunks``); ``work``: a dict
    that sums its walks' cell steps and item tests (``_add_walk_work``)
    and its chunks' slab and row tests (``_add_stream_work``);
    ``sph_tree`` walks the spheres as ``pathtrace_walk_reference`` says."""
    if record and n_passes != 1:
        raise ValueError("champion recording is single-pass")
    _check_walked(sph_tree, grid, chunks)
    roff = int(ipar[1])
    rec = {"ids": [], "occs": []} if record else None
    for p in range(n_passes):
        u = pass_draws(ipar, u_planes, acc.shape[0], lig.shape[0], bounces,
                       seed, p, acc.device, russian_roulette)
        acc = _pass_reference(par, sph, tri, mat, lig, acc, u, roff,
                              spp=spp, width=width, bounces=bounces,
                              two_sided=two_sided,
                              normalize_emitter=normalize_emitter,
                              russian_roulette=russian_roulette,
                              rr_start_depth=rr_start_depth, record=rec,
                              grid=grid, work=work, chunks=chunks,
                              sph_tree=sph_tree)
    if not record:
        return acc
    occs = (torch.stack(rec["occs"]) if rec["occs"] else
            torch.zeros((0, acc.shape[0]), dtype=torch.bool,
                        device=acc.device))
    return acc, torch.stack(rec["ids"]).to(torch.int32), occs


def _check_walked(sph_tree, grid, chunks) -> None:
    """A sphere tree walks resident spheres only."""
    if sph_tree is not None and (grid is not None or chunks is not None):
        raise ValueError("a sphere tree walks resident spheres: no grid, "
                         "no streamed tables")


def pathtrace_walk_reference(par, ipar, sph, tri, mat, lig, acc, u_planes,
                             *, spp: int, width: int, bounces: int,
                             two_sided: bool, normalize_emitter: bool,
                             seed: int, n_passes: int = 1,
                             russian_roulette: bool = False,
                             rr_start_depth: int = 0, record: bool = False,
                             tree=None, work: dict | None = None):
    """The plain version of kernel 1's path mode over a sphere tree (the
    kTree instances of pathtrace_kernel): ``pathtrace_pass_reference`` with
    each trace's and shadow ray's sphere loop replaced by the walk of
    ``tree`` (an ``SphereTree`` of ``sph``; ``sphere_tree(sph,
    SPH_TREE_LEAF)`` when None) in the kernel's lane order and arithmetic
    (``_walk_tree``: the loose rows, then nearest child first, culled at
    the champion's t, the least (t, original index) winning; a shadow ray
    stops at its first occluder), the triangles after it; the roulette and
    the record as there. Returns what ``pathtrace_pass_reference`` returns,
    equal to it exactly; ``work`` gets the walk's counts summed over every
    trace and shadow ray of every pass (``node_tests``, ``leaf_visits``,
    ``sph_tests``, ``loose_tests``, and per warp of 32 consecutive rays the
    union of its lanes' leaves, ``union_leaves``, and their rows,
    ``union_sph_tests``)."""
    if tree is None:
        tree = sphere_tree(sph, SPH_TREE_LEAF)
    return pathtrace_pass_reference(
        par, ipar, sph, tri, mat, lig, acc, u_planes, spp=spp, width=width,
        bounces=bounces, two_sided=two_sided,
        normalize_emitter=normalize_emitter, seed=seed, n_passes=n_passes,
        russian_roulette=russian_roulette, rr_start_depth=rr_start_depth,
        record=record, sph_tree=tree, work={} if work is None else work)


def _direct_reference(par, sph, tri, mat, lig, acc, u, ray_offset: int = 0,
                      *, spp: int, width: int, two_sided: bool, grid=None,
                      work=None, chunks=None, trace=None, anyhit=None,
                      record=None, sph_tree=None) -> torch.Tensor:
    """One pass of ``_render_pass_kernel`` in direct mode over rays
    ``[ray_offset, ray_offset + R)``; returns the new accumulator.
    ``trace``, ``anyhit`` and ``record`` as ``_pass_reference``'s: the
    record gets the primary champions and one occlusion bit per light;
    ``sph_tree`` as ``_trace``'s."""
    if trace is None:
        def trace(o, d, mint, maxt):
            return _trace(o, d, mint, maxt, sph, tri, two_sided, grid, work,
                          chunks, sph_tree)
    if anyhit is None:
        def anyhit(o, d, mint, maxt):
            return _anyhit(o, d, mint, maxt, sph, tri, two_sided, grid, work,
                           chunks, sph_tree)
    o, d, mint, maxt = _camera_rays(par, u[0:2].t(), acc.shape[0],
                                    ray_offset, spp, width)
    _, hp, hn, matf, obj = trace(o, d, mint, maxt)
    if record is not None:
        record["ids"].append(obj)
    eps, ambient = par[24], par[25]
    valid = matf >= 0.0
    alb = _albedo(mat, matf)
    for li in range(lig.shape[0]):
        lr = lig[li]
        tgt = sample_disk_point(lr[0:3], lr[14:17], lr[17:20], lr[12],
                                u[2 + 2 * li:4 + 2 * li].t())
        so = hp + eps * hn
        dl = tgt - so
        d2 = dot3(dl, dl)
        dist = torch.sqrt(torch.where(d2 > 0.0, d2, 1.0))
        dist = torch.where(d2 > 0.0, dist, 0.0)
        sd = safe_normalize(dl)
        occ = anyhit(so, sd, torch.where(valid, 0.0, INF),
                     torch.where(valid, dist, INF))
        if record is not None:
            record["occs"].append(occ)
        cosx = clip(dot3(sd, hn), 0.0, 1.0)
        shade = clip(ambient + torch.where(occ, 0.0, cosx), 0.0, 1.0)
        acc = acc + torch.where(valid[:, None], alb * shade[:, None], 0.0)
    return acc


def direct_pass_reference(par, sph, tri, mat, lig, acc, u_planes, *,
                          key: torch.Tensor, spp: int, width: int,
                          two_sided: bool, n_passes: int = 1, grid=None,
                          work=None, chunks=None, ray_offset: int = 0,
                          record: bool = False, sph_tree=None):
    """The plain version of ``direct_pass`` on any device; returns a new
    accumulator, or ``(acc, ids, occs)`` with ``record=True`` (one pass:
    ``ids`` (1, R) int32 the primary champions, ``occs`` (L, R) bool the
    occlusion bits, JAX's one recorded segment). Pass p reads ``u_planes``
    or, without them, the draws of ``direct_draw_planes`` keyed by ``key``
    (one pass) or ``pass_key(key, p)``. ``grid``, ``chunks``, ``work`` and
    ``ray_offset`` as ``pathtrace_pass_reference``; ``sph_tree`` walks the
    spheres as ``direct_walk_reference`` says."""
    if record and n_passes != 1:
        raise ValueError("champion recording is single-pass")
    _check_walked(sph_tree, grid, chunks)
    rec = {"ids": [], "occs": []} if record else None
    for p in range(n_passes):
        u = u_planes
        if u is None:
            u = direct_draw_planes(key if n_passes == 1 else
                                   rng.pass_key(key, p), acc.shape[0],
                                   lig.shape[0], spp, acc.device, ray_offset)
        acc = _direct_reference(par, sph, tri, mat, lig, acc, u, ray_offset,
                                spp=spp, width=width, two_sided=two_sided,
                                grid=grid, work=work, chunks=chunks,
                                record=rec, sph_tree=sph_tree)
    if not record:
        return acc
    occs = (torch.stack(rec["occs"]) if rec["occs"] else
            torch.zeros((0, acc.shape[0]), dtype=torch.bool,
                        device=acc.device))
    return acc, torch.stack(rec["ids"]).to(torch.int32), occs


def direct_walk_reference(par, sph, tri, mat, lig, acc, u_planes, *,
                          key: torch.Tensor, spp: int, width: int,
                          two_sided: bool, n_passes: int = 1,
                          ray_offset: int = 0, record: bool = False,
                          tree=None, work: dict | None = None):
    """The plain version of kernel 1's direct mode over a sphere tree (its
    kTree instances): ``direct_pass_reference`` with each trace's and shadow
    ray's sphere loop replaced by the walk of ``tree`` (an
    ``SphereTree`` of ``sph``; ``sphere_tree(sph, SPH_TREE_LEAF)``
    when None) in the kernel's lane order and arithmetic (``_walk_tree``:
    the loose rows, then nearest child first, culled at the champion's t,
    the least (t, original index) winning; a shadow ray stops at its first
    occluder), the triangles after it. Returns what
    ``direct_pass_reference`` returns, equal to it exactly; ``work`` gets
    the walk's counts summed over every trace and shadow ray
    (``node_tests``, ``leaf_visits``, ``sph_tests``, ``loose_tests``,
    ``union_leaves``, ``union_sph_tests``)."""
    if tree is None:
        tree = sphere_tree(sph, SPH_TREE_LEAF)
    return direct_pass_reference(
        par, sph, tri, mat, lig, acc, u_planes, key=key, spp=spp,
        width=width, two_sided=two_sided, n_passes=n_passes,
        ray_offset=ray_offset, record=record, sph_tree=tree,
        work={} if work is None else work)


def pass_key_of(ipar, seed: int) -> torch.Tensor:
    """The key of pass ``ipar[0]``: ``fold_in(PRNGKey(seed), pass)``."""
    return rng.pass_key(rng.base_key(seed), int(ipar[0]))


def diff_draws(ipar, u_planes, n_rays: int, n_lights: int, bounces: int,
               seed: int, device=None, rr: bool = False,
               mode: str = "path", spp: int = 1) -> torch.Tensor:
    """The draws of the differentiable pass ``ipar``: ``u_planes``, or in
    path mode ``pass_draws``', in direct mode ``direct_draw_planes`` keyed
    by ``pass_key_of(ipar, seed)`` (a one-pass direct call keyed as path
    mode keys its passes), rows from the ray offset ``ipar[1]`` on."""
    if u_planes is not None or mode == "path":
        return pass_draws(ipar, u_planes, n_rays, n_lights, bounces, seed, 0,
                          device, rr)
    return direct_draw_planes(pass_key_of(ipar, seed), n_rays, n_lights, spp,
                              device, int(ipar[1]))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rt_pathtrace_pass": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _I, _I,                                  # acc, n_rays, ray_offset
        _VP, _VP, _I,                         # u_planes, host keys, n_passes
        _I, _I, _I, _I, _I,                # spp, width, bounces, rr, start
        _I, _I,                                       # two_sided, normalize
        _VP, _VP, _VP,                       # ids, occs, live (record)
        _I, _VP, _I, _I, _I,        # grid, grids, n_grids, sph grid, start,
        _VP, _VP, _I,                          # streams, sphere tree, block
        _VP]),                                        # stream
    "rt_direct_pass": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _I, _I,                                  # acc, n_rays, ray_offset
        _VP, ctypes.c_uint, ctypes.c_uint,            # u_planes, key
        _I, _I, _I,                         # first pass, per_pass, n_passes
        _I, _I, _I,                                   # spp, width, two_sided
        _VP, _VP, _VP,                       # ids, occs, live (record)
        _I, _VP, _I, _I, _I,        # grid, grids, n_grids, sph grid, start,
        _VP, _VP, _I,                          # streams, sphere tree, block
        _VP]),                                        # stream
}


class _GridDesc(ctypes.Structure):
    """csrc/pathtrace.cuh GridDesc."""
    _fields_ = [("off", ctypes.c_void_p), ("items", ctypes.c_void_p),
                ("pmin", ctypes.c_float * 3), ("width", ctypes.c_float * 3),
                ("pmax", ctypes.c_float * 3), ("n", ctypes.c_int * 3),
                ("rows", ctypes.c_void_p), ("perm", ctypes.c_void_p),
                ("cell", ctypes.c_void_p), ("node", ctypes.c_void_p),
                ("leaf", ctypes.c_int)]


class _StreamDesc(ctypes.Structure):
    """csrc/pathtrace.cuh Stream."""
    _fields_ = [("rows", ctypes.c_void_p), ("perm", ctypes.c_void_p),
                ("node", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("loose", ctypes.c_void_p), ("n", ctypes.c_int),
                ("leaf", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("n_loose", ctypes.c_int)]


def _stream_desc(st: Stream | None, n: int) -> _StreamDesc:
    if st is None:
        return _StreamDesc(None, None, None, None, None, 0, 0, 0, 0)
    t = st.tree
    return _StreamDesc(st.rows.data_ptr(), st.perm.data_ptr(),
                       t.nodes.data_ptr(), t.masks.data_ptr(),
                       t.loose.data_ptr(), n, t.leaf, t.n_slots,
                       t.loose.shape[0])


def _grid_args(grid: KernelGrids | None, chunks: KernelChunks | None,
               n_sph: int, n_tri: int):
    """(grid, descriptors, n_grids, sph grid, start, streams) of the C
    interface: grid mode's build runs grids and streamed chunks alike
    (``grid`` 1 with no grid descriptor streams only). The descriptor
    arrays must outlive the call."""
    streams = None
    if chunks is not None:
        streams = (_StreamDesc * 2)(_stream_desc(chunks.tri, n_tri),
                                    _stream_desc(chunks.sph, n_sph))
    sp = ctypes.addressof(streams) if streams is not None else None
    if grid is None:
        start = 0 if chunks is not None and chunks.tri is not None else n_tri
        return (int(chunks is not None), None, 0, 0, start, sp), streams
    walks = [g for _, g in _grid_walks(grid)]
    desc = (_GridDesc * len(walks))(*(
        _GridDesc(g.cell_offsets.data_ptr(), g.item_indices.data_ptr()
                  if g.item_indices.numel() else None,
                  (ctypes.c_float * 3)(*g.pmin.tolist()),
                  (ctypes.c_float * 3)(*g.width().tolist()),
                  (ctypes.c_float * 3)(*g.pmax.tolist()),
                  (ctypes.c_int * 3)(*g.n),
                  *((cp.rows.data_ptr(), cp.perm.data_ptr(),
                     cp.cell.data_ptr(), cp.nodes.data_ptr(), cp.leaf)
                    if cp is not None else (None, None, None, None, 0)))
        for g, cp in zip(walks, tuple(grid.copies) + (None,))))
    return (1, ctypes.addressof(desc), len(walks),
            int(grid.sph is not None), grid.start, sp), (desc, streams)


def _check_grid(grid: KernelGrids, n_tri: int, dev) -> None:
    """The grids' shapes, types and devices (their item ids index the
    tables by construction, ``accel.prepare_grids``)."""
    walks = _grid_walks(grid)
    if len(walks) > GRIDS_MAX:
        raise ValueError(f"{len(walks)} grids: at most {GRIDS_MAX} per "
                         "launch")
    if not 0 <= grid.start <= n_tri:
        raise ValueError(f"grid start {grid.start} outside [0, {n_tri}]")
    for _, g in walks:
        for t in (g.cell_offsets, g.item_indices):
            if (t.device != dev or t.dtype != torch.int32
                    or not t.is_contiguous()):
                raise ValueError("grid CSR arrays must be contiguous int32 "
                                 f"on {dev}")
        if g.cell_offsets.shape[0] != g.n_cells + 1:
            raise ValueError(f"grid of {g.n} cells has "
                             f"{g.cell_offsets.shape[0]} offsets")
    copies = grid.copies or ()
    if len(copies) != len(grid.tri):
        raise ValueError("grid mode needs each triangle grid's cell-major "
                         "copy: render/mega.grid_tables(scene, sph, tri) "
                         "builds them")
    for g, cp in zip(grid.tri, copies):
        _check_copy(g, cp, dev)


def _check_copy(g, cp: CellCopy, dev) -> None:
    """A grid's cell-major copy (``CellCopy``) as the kernel takes it:
    leaves of a power of two rows up to CELL_LEAF_MAX, rows as wide as the
    table's and whole leaves of them, a row of ``perm`` per copied row, a
    [first row, node 0, slots, items] row per cell, node boxes of 8 floats,
    each cell's rows and tree inside the copy and no deeper than the
    kernel's stack (its contents are ``render/mega.grid_cells``' by
    construction)."""
    leaf = cp.leaf
    if not 0 < leaf <= CELL_LEAF_MAX or leaf & (leaf - 1):
        raise ValueError(f"grid copy: leaves of {leaf} rows, not a "
                         f"power of two up to {CELL_LEAF_MAX}")
    n = cp.rows.shape[0] if cp.rows.dim() == 2 else -1
    for what, t, shape, dtype in (
            ("rows", cp.rows, (n, TRI_COLS), torch.float32),
            ("perm", cp.perm, (n,), torch.int32),
            ("cell", cp.cell, (g.n_cells, 4), torch.int32),
            ("nodes", cp.nodes, (cp.nodes.shape[0], 8), torch.float32)):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.numel() == 0):
            raise ValueError(
                f"grid copy {what} must be a contiguous non-empty "
                f"{shape} {dtype} tensor on {dev}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if n % leaf:
        raise ValueError(f"grid copy: {n} rows are not whole leaves "
                         f"of {leaf}")
    # the cells' rows and trees: read once per cell table (a layout is
    # cached and never written, and a read on the card synchronises)
    if _CHECKED_CELLS.get(id(cp.cell)) is cp.cell:
        return
    row0, node0, slots, count = cp.cell.to(torch.int64).unbind(1)
    leaves = -(-count // leaf)
    tree = slots >= 2
    bad = ((row0 < 0) | (row0 + leaves * leaf > n) | (count < 0)
           | torch.where(tree, (slots < leaves) | (slots & (slots - 1) != 0)
                         | (slots > 1 << TREE_DEPTH_MAX) | (node0 < 0)
                         | (node0 + 2 * slots > cp.nodes.shape[0]),
                         slots != leaves))
    if bool(bad.any()):
        raise ValueError("grid copy: a cell's rows or tree lie "
                         "outside the copy")
    _CHECKED_CELLS[id(cp.cell)] = cp.cell


# the cell tables _check_copy has read, by id (weakly: a table that is
# dropped leaves)
_CHECKED_CELLS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def tree_slots(n_leaves: int) -> int:
    """The implicit tree's leaf slots over ``n_leaves`` leaves: the least
    power of two that holds them."""
    return 1 << max(0, (n_leaves - 1).bit_length())


def morton_codes(cen: torch.Tensor, pmin: torch.Tensor,
                 pmax: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (10 bits per axis) of the points ``cen`` (N, 3)
    against the box [pmin, pmax], as int64: JAX's ``_morton_codes`` (its
    uint32 bit-spreading here in int64, masked)."""
    ext = torch.clamp(pmax - pmin, min=1e-20)
    q = torch.clamp((cen - pmin) / ext * 1024.0, 0.0, 1023.0).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def box_tree(lo: torch.Tensor, hi: torch.Tensor, take: torch.Tensor,
             leaf: int, pad: torch.Tensor, room: torch.Tensor) -> StreamTree:
    """The walk's layout (``StreamTree``) over N sorted rows with boxes
    [lo, hi] (N, 3) (+inf / -inf: none), of which ``take`` (N,) take part,
    N a multiple of ``leaf``; on their device, with no host
    synchronisation (``render/mega.chunk_tree`` and
    ``sphere_tree`` build on it).

    * Loose rows: a row that takes part and whose box's longest side is at
      least ``LOOSE_SHARE`` of ``room`` (a wall of a room; none on a field
      of small spheres), the ``LOOSE_MAX`` longest of them (a tie to the
      lower position). Every ray
      tests them first, so their champion's t culls the tree from the
      start, and they widen no box.
    * Leaves: consecutive runs of ``leaf`` rows; a leaf's box is the least
      box over its other rows that take part (none: the empty box, pmin
      +inf, pmax -inf), widened by ``pad`` on every side (an axis-aligned
      wall's box has no thickness), and its mask names those rows.
    * Nodes: an implicit binary tree over the leaves, padded with empty
      leaves to a power of two; a node's box is the least box over its
      children's, one reshape per level."""
    n, dev = take.shape[0], take.device
    n_leaves = n // leaf
    slots = tree_slots(n_leaves)
    inf = torch.full((), torch.inf, device=dev)
    side = (hi - lo).amax(1)
    score = torch.where(take & (side >= LOOSE_SHARE * room), side, -inf)
    # a stable sort, so that a tie goes to the lower position on every
    # device (csrc/sphere_tree.cu builds the same list)
    top, pos = torch.sort(score, descending=True, stable=True)
    top, pos = top[:min(LOOSE_MAX, n)], pos[:min(LOOSE_MAX, n)]
    picked = top > -inf
    loose = torch.where(picked, pos, -1).to(torch.int32)
    is_loose = torch.zeros(n, dtype=torch.bool, device=dev).scatter(
        0, pos, picked)
    live = take & ~is_loose
    lo_l = torch.where(live[:, None], lo, inf).reshape(n_leaves, leaf,
                                                        3).amin(1) - pad
    hi_l = torch.where(live[:, None], hi, -inf).reshape(n_leaves, leaf,
                                                         3).amax(1) + pad
    empty = torch.full((slots - n_leaves, 3), torch.inf, device=dev)
    levels = [(torch.cat([lo_l, empty]), torch.cat([hi_l, -empty]))]
    while levels[0][0].shape[0] > 1:
        a, b = levels[0]
        levels.insert(0, (a.reshape(-1, 2, 3).amin(1),
                          b.reshape(-1, 2, 3).amax(1)))
    lo_n = torch.cat([torch.zeros((1, 3), device=dev)]
                     + [a for a, _ in levels])
    hi_n = torch.cat([torch.zeros((1, 3), device=dev)]
                     + [b for _, b in levels])
    nodes = torch.cat([lo_n, hi_n, torch.zeros((2 * slots, 2), device=dev)],
                      -1).to(torch.float32).contiguous()
    word = min(leaf, 32)
    bits = (live.reshape(n_leaves, -1, word).to(torch.int64)
            << torch.arange(word, device=dev)).sum(-1)
    masks = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32)
    return StreamTree(nodes=nodes, masks=masks.contiguous(), loose=loose,
                      leaf=leaf)


class SphereTree(NamedTuple):
    """A box tree over a sphere table of S rows (``sphere_tree``), which
    kernel 4 (``HK.sphere_search_rows``) and kernel 1's direct mode
    (``direct_pass``) walk: ``rows`` (N, 8) float32, the rows in the
    stable order of their centres' Morton codes, padded with zero rows to
    N, whole leaves; ``perm`` (N,) int32, the original row of each sorted
    row, -1 for padding; ``tree`` the walk's layout over the sorted rows
    (``StreamTree``: node boxes of an implicit binary tree, leaf masks
    naming the masked-on rows, loose rows)."""
    rows: torch.Tensor
    perm: torch.Tensor
    tree: StreamTree


def sphere_tree(rows: torch.Tensor, leaf: int) -> SphereTree:
    """The box tree of the packed sphere rows ``rows`` (S >= 1, 8) over
    leaves of ``leaf`` rows, on their device, with no host
    synchronisation. Needs no scene: a masked-on row's box is centre -/+
    |radius|, and the rows' own box (over those boxes) gives the Morton
    codes' frame, the loose rule's room (its longest side) and the pad's
    scale (its largest coordinate): every box is widened by ``CHUNK_PAD``
    of it, as kernel 1's streamed trees are by the scene's. Masked-off rows
    take part in no box, mask or loose list. ``sphere_tree_build`` is the
    same build on the card in one launch."""
    with torch.no_grad():
        rows = rows.detach()
        s, dev = rows.shape[0], rows.device
        n = -(-s // leaf) * leaf
        cen, rad = rows[:, 0:3], rows[:, 3:4].abs()
        on = rows[:, 5:6] > 0.0
        lo = torch.where(on, cen - rad, INF)
        hi = torch.where(on, cen + rad, -INF)
        pmin, pmax = lo.amin(0), hi.amax(0)
        order = torch.argsort(morton_codes(cen, pmin, pmax), stable=True)
        pad = n - s
        inf = torch.full((pad, 3), INF, device=dev)
        srows = torch.cat([rows[order], rows.new_zeros((pad, SPH_COLS))])
        perm = torch.cat([order.to(torch.int32),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=dev)])
        lo, hi = torch.cat([lo[order], inf]), torch.cat([hi[order], -inf])
        scale = torch.where(on, cen.abs() + rad, 0.0).amax()
        tree = box_tree(lo, hi, (perm >= 0) & (lo <= hi).all(1), leaf,
                        CHUNK_PAD * scale, (pmax - pmin).amax())
    return SphereTree(rows=srows.contiguous(), perm=perm, tree=tree)


_F = ctypes.c_float
_TREE_SIGNATURES = {
    # rows, [vertices,] rows count, leaf, slots, pad share, loose share,
    # loose count, sorted rows, perm, nodes, masks, loose, stream
    "rt_sphere_tree": (ctypes.c_int, [
        _VP, _I, _I, _I, _F, _F, _I, _VP, _VP, _VP, _VP, _VP, _VP]),
    "rt_triangle_tree": (ctypes.c_int, [
        _VP, _VP, _I, _I, _I, _F, _F, _I, _VP, _VP, _VP, _VP, _VP, _VP]),
}


def tree_outputs(n: int, cols: int, leaf: int, dev):
    """The outputs of a tree build on the card over ``n`` sorted rows of
    ``cols`` floats (whole leaves of ``leaf`` rows): (rows (n, cols),
    perm (n,), ``StreamTree``), views of one block from torch's allocator
    on the current stream (the wrappers run every call: each torch.empty
    costs host time); rows and nodes first, whole 16-byte words, as the
    walks read them in float4s."""
    slots = tree_slots(n // leaf)
    n_loose = min(LOOSE_MAX, n)
    sizes = (n * cols, 16 * slots, n, n // leaf, n_loose)
    parts = torch.empty((sum(sizes),), dtype=torch.int32,
                        device=dev).split(sizes)
    return (parts[0].view(torch.float32).view(n, cols), parts[2],
            StreamTree(nodes=parts[1].view(torch.float32).view(2 * slots, 8),
                       masks=parts[3].view(n // leaf, 1), loose=parts[4],
                       leaf=leaf))


def sphere_tree_build(rows: torch.Tensor, leaf: int) -> SphereTree:
    """``sphere_tree(rows, leaf)`` built on the card by one launch of
    ``csrc/sphere_tree.cu`` (counted in ``tree_build_launches``; no host
    synchronisation, the outputs views of one block from torch's allocator
    on the current stream), equal to it element for element; on CPU
    tensors ``sphere_tree`` itself. rows (S, 8) float32, contiguous, 1 <=
    S <= TREE_BUILD_MAX on the card; leaf a power of two up to 32."""
    global tree_build_launches
    s = rows.shape[0] if rows.dim() == 2 else 0
    if (rows.dim() != 2 or rows.shape[1] != SPH_COLS
            or rows.dtype != torch.float32 or not rows.is_contiguous()):
        raise ValueError(f"rows must be contiguous (S, {SPH_COLS}) float32, "
                         f"got {tuple(rows.shape)} {rows.dtype}")
    if not 0 < leaf <= 32 or leaf & (leaf - 1):
        raise ValueError(f"sphere tree leaves of {leaf} rows: a power of "
                         "two up to 32")
    if s < 1:
        raise ValueError("a sphere tree needs at least one row")
    if rows.device.type == "cpu":
        return sphere_tree(rows, leaf)
    if s > TREE_BUILD_MAX:
        raise ValueError(f"the tree's build kernel takes at most "
                         f"{TREE_BUILD_MAX} rows, got {s}")
    if torch.is_grad_enabled() and rows.requires_grad:
        rows = rows.detach()
    lib = _build.load("sphere_tree", _TREE_SIGNATURES)
    dev = rows.device
    srows, perm, tree = tree_outputs(-(-s // leaf) * leaf, SPH_COLS, leaf,
                                     dev)
    out = SphereTree(rows=srows, perm=perm, tree=tree)
    st = out.tree
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_sphere_tree(
            rows.data_ptr(), s, leaf, st.n_slots, CHUNK_PAD, LOOSE_SHARE,
            st.loose.shape[0], out.rows.data_ptr(), out.perm.data_ptr(),
            st.nodes.data_ptr(), st.masks.data_ptr(), st.loose.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"rt_sphere_tree launch failed with CUDA error "
                           f"{err}")
    tree_build_launches += 1
    return out


def _check_tree(name: str, tree: StreamTree | None, n_rows: int, dev) -> None:
    """A stream's walk layout (``StreamTree``) over ``n_rows`` sorted rows:
    whole leaves of a power of two rows up to 128, a mask word per 32 rows
    of a leaf, a node box per slot of the least power-of-two tree over the
    leaves, no deeper than the kernel's stack, and 1 to LOOSE_MAX loose
    positions."""
    if tree is None:
        raise ValueError(f"{name} stream has no tree: the kernel walks "
                         "render/mega.chunk_tree's layout")
    leaf = tree.leaf
    if not 0 < leaf <= STREAM_CHUNK or leaf & (leaf - 1) or n_rows % leaf:
        raise ValueError(f"{name} stream tree leaves of {leaf} rows do not "
                         f"tile {n_rows} rows")
    slots = tree_slots(n_rows // leaf)
    if slots > 1 << TREE_DEPTH_MAX:
        raise ValueError(f"{name} stream tree of {slots} leaves is deeper "
                         f"than {TREE_DEPTH_MAX} levels")
    for what, t, shape, dtype in (
            ("nodes", tree.nodes, (2 * slots, 8), torch.float32),
            ("masks", tree.masks, (n_rows // leaf, -(-leaf // 32)),
             torch.int32),
            ("loose", tree.loose, (min(LOOSE_MAX, n_rows),), torch.int32)):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} stream tree {what} must be a contiguous {shape} "
                f"{dtype} tensor on {dev}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")


def _check_chunks(chunks: KernelChunks, sph, tri, grid, dev) -> None:
    """The streamed tables' shapes, types and devices: each stream's rows
    as wide as its table, whole chunks of them, a box per chunk, a row
    of ``perm`` per sorted row (its ids index the table by construction,
    ``render/mega.chunk_tables``) and the walk's layout over them
    (``_check_tree``)."""
    if chunks.tri is not None and grid is not None:
        raise ValueError("a triangle table is either streamed or gridded, "
                         "not both")
    if chunks.sph is not None and grid is not None and grid.sph is not None:
        raise ValueError("a sphere table is either streamed or gridded, "
                         "not both")
    for name, st, table in (("tri", chunks.tri, tri), ("sph", chunks.sph,
                                                        sph)):
        if st is None:
            continue
        nc = -(-table.shape[0] // STREAM_CHUNK)
        for what, t, shape, dtype in (
                ("rows", st.rows, (nc * STREAM_CHUNK, table.shape[1]),
                 torch.float32),
                ("boxes", st.boxes, (nc, 8), torch.float32),
                ("perm", st.perm, (nc * STREAM_CHUNK,), torch.int32)):
            if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name} stream {what} must be a contiguous {shape} "
                    f"{dtype} tensor on {dev}, got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")
        _check_tree(name, st.tree, nc * STREAM_CHUNK, dev)


def _check_args(par, ipar, sph, tri, mat, lig, acc, u_planes, spp, width,
                n_draws, n_passes, multi_pass_planes=False, grid=None,
                block=0, resident=True, chunks=None):
    """Devices, types, shapes and limits of a launch of ``n_draws`` draw
    slots per ray and pass; ``multi_pass_planes`` lets one u-planes tensor
    serve every pass (direct mode). With ``grid`` the resident caps apply
    to its brute prefix; ``resident=False`` (kernel 3, which reads the
    sphere and triangle tables from global memory) drops them, as does a
    streamed table (``chunks``). ``acc`` holds rays ``[ipar[1], ipar[1] +
    R)`` of the film, whole rows or not (a ray shard); the blocked layout
    takes whole rows of an unsharded film."""
    dev = acc.device
    if acc.dtype != torch.float32 or acc.dim() != 2 or acc.shape[1] != 3:
        raise ValueError(f"acc must be (R, 3) float32, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    n = acc.shape[0]
    shapes = {"par": (par, (NPAR,)), "sph": (sph, (None, SPH_COLS)),
              "tri": (tri, (None, TRI_COLS)), "mat": (mat, (None, MAT_COLS)),
              "lig": (lig, (None, LIG_COLS)), "acc": (acc, (n, 3))}
    if u_planes is not None:
        shapes["u_planes"] = (u_planes, (2 * n_draws, n))
    for name, (t, shape) in shapes.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, acc on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != ts for s, ts in zip(shape, t.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (ipar.device.type != "cpu" or ipar.dtype != torch.int32
            or tuple(ipar.shape) != (2,)):
        raise ValueError("ipar must be a (2,) int32 CPU tensor "
                         "[pass index, ray offset]")
    k = int(round(spp ** 0.5))
    if spp < 1 or k * k != spp:
        raise ValueError(f"spp must be a perfect square, got {spp}")
    n_sph, n_tri = sph.shape[0], tri.shape[0]
    if grid is not None:
        _check_grid(grid, n_tri, dev)
        n_sph = 0 if grid.sph is not None else n_sph
        n_tri = grid.start
    if chunks is not None:
        _check_chunks(chunks, sph, tri, grid, dev)
        n_sph = 0 if chunks.sph is not None else n_sph
        n_tri = 0 if chunks.tri is not None else n_tri
    if not resident:
        n_sph = n_tri = 0
    if n_sph > SPH_RESIDENT_MAX or n_tri > TRI_RESIDENT_MAX:
        raise ValueError(f"at most {SPH_RESIDENT_MAX} spheres and "
                         f"{TRI_RESIDENT_MAX} triangles stay resident")
    smem = 4 * (PAR_PAD + SPH_COLS * n_sph + TRI_COLS * n_tri + mat.numel()
                + lig.numel())
    if smem > SMEM_BYTES_MAX:
        raise ValueError(f"scene tables take {smem} B of shared memory, "
                         f"more than {SMEM_BYTES_MAX}")
    roff = int(ipar[1])
    if roff < 0 or roff + n >= (1 << 24):
        raise ValueError(
            f"rays [{roff}, {roff + n}) reach 2^24 = {1 << 24}: pixel math "
            "is exact below it (a sharded film's last shard counts its "
            "padding rays)")
    if block:
        rows = n // (spp * width)
        if (block < 0 or n % (spp * width) or width % block or rows % block
                or roff):
            raise ValueError(f"block {block} must tile the {width} x {rows} "
                             "film of an unsharded launch")
    if (roff + n) * n_draws * 2 >= (1 << 32):
        raise ValueError("draw counters must stay below 2^32")
    if n_passes < 1:
        raise ValueError(f"n_passes must be >= 1, got {n_passes}")
    if n_passes != 1 and u_planes is not None and not multi_pass_planes:
        raise ValueError("a u_planes tensor carries one pass of draws; "
                         "multi-pass launches use the in-kernel PRNG")


def _ptr(t: torch.Tensor | None):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _check_launch(acc, tensors, what: str) -> None:
    """The card's wrappers take CUDA tensors that do not require grad."""
    if acc.device.type != "cuda":
        raise ValueError(f"no kernel for device {acc.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        # the kernel writes acc through its raw pointer, which autograd
        # never sees
        raise RuntimeError(f"{what} is forward-only on the card; "
                           "differentiate through ops.megakernel_grad."
                           "pathtrace_pass_diff (one pass per call)")


def _kernel_block(block: int, grid, chunks) -> int:
    """The blocked layout's block edge as the launch takes it: the brute
    instances keep the row-major map (the same image, see the module
    docstring), so only a launch with grids or streamed chunks blocks."""
    return block if grid is not None or chunks is not None else 0


def _lib(grid, chunks, build_flags: tuple):
    """The build of kernel 1 that holds the launch's instances: grid mode's
    (``GRID_FLAGS``; grids or streamed chunks) or the brute ones, with
    ``build_flags`` added."""
    return _build.load("megakernel", _SIGNATURES, tuple(build_flags) + (
        GRID_FLAGS if grid is not None or chunks is not None else ()))


def pathtrace_pass(par, ipar, sph, tri, mat, lig, acc, u_planes, *,
                   spp: int, width: int, bounces: int, two_sided: bool,
                   normalize_emitter: bool, seed: int,
                   n_passes: int = 1, russian_roulette: bool = False,
                   rr_start_depth: int = 0, record: bool = False,
                   grid: KernelGrids | None = None,
                   chunks: KernelChunks | None = None, block: int = 0,
                   build_flags: tuple = (), sphere_walk: bool | None = None,
                   sph_tree: SphereTree | None = None):
    """``n_passes`` progressive passes over ``acc`` (R, 3), in place;
    returns ``acc``, or ``(acc, ids, occs)`` with ``record=True`` (one
    pass; see the module docstring). ``russian_roulette`` plays the
    roulette from depth ``rr_start_depth`` on. ``grid`` runs grid mode,
    ``chunks`` streams tables, ``block`` the blocked layout (see the
    module docstring).
    ``build_flags`` launches a build of the kernel with these nvcc flags
    added (e.g. ``("--fmad=false",)``), beside the default one.
    On the card past ``SPH_BRUTE_MAX["path"]`` resident spheres
    (``sphere_walks``) the call walks a sphere tree built on the card by
    one more launch before its first (counted in ``path_walk_launches``
    and ``tree_build_launches``), or ``sph_tree``, the caller's
    (``pass_tree``), without a build; every launch of the call walks it.
    ``sphere_walk`` True or False forces the walk or the brute loop (a
    test's switch; the CPU ignores it and ``sph_tree``).

    par (26,) f32 scalars; ipar (2,) int32 CPU tensor [pass index, global
    ray offset]; sph (S, 8) [center xyz, radius, mat, mask, pad2]; tri
    (T, 32) [n_geo, c1, c2, e1, e2, k, mat, mask, vn0, vn1, vn2, pad5];
    mat (M, 4) rgba; lig (L, 20) [pos, normal, irr, irr_normalized,
    radius, area, tangent, bitangent]; u_planes (2 * n_draws, R) or None.
    """
    global launches, path_walk_launches, stream_launches
    _check_args(par, ipar, sph, tri, mat, lig, acc, u_planes, spp, width,
                n_draws_of(lig.shape[0], bounces, russian_roulette), n_passes,
                grid=grid, block=block, chunks=chunks)
    if record and n_passes != 1:
        raise ValueError("champion recording is single-pass")
    kw = dict(spp=spp, width=width, bounces=bounces, two_sided=two_sided,
              normalize_emitter=normalize_emitter, seed=seed,
              n_passes=n_passes, russian_roulette=russian_roulette,
              rr_start_depth=rr_start_depth)
    if acc.device.type == "cpu":
        out = pathtrace_pass_reference(par, ipar, sph, tri, mat, lig, acc,
                                       u_planes, record=record, grid=grid,
                                       chunks=chunks, **kw)
        if not record:
            return acc.copy_(out)
        return acc.copy_(out[0]), out[1], out[2]
    _check_launch(acc, (par, sph, tri, mat, lig, acc, u_planes),
                  "pathtrace_pass")
    walk = _walks(sphere_walk, sph, grid, chunks, "path")
    ids, occs, n = _launch_pass(par, ipar, sph, tri, mat, lig, acc, u_planes,
                                record=record, grid=grid, chunks=chunks,
                                block=block, build_flags=build_flags,
                                sphere_walk=walk, sph_tree=sph_tree, **kw)
    launches += n
    path_walk_launches += n if walk else 0
    stream_launches += n if chunks is not None else 0
    return (acc, ids, occs) if record else acc


def _launch_pass(par, ipar, sph, tri, mat, lig, acc, u_planes, *, spp: int,
                 width: int, bounces: int, two_sided: bool,
                 normalize_emitter: bool, seed: int, n_passes: int,
                 russian_roulette: bool, rr_start_depth: int, record: bool,
                 grid, chunks, block: int, build_flags: tuple, live=None,
                 sphere_walk: bool | None = None,
                 sph_tree: SphereTree | None = None):
    """``pathtrace_pass``'s launches on checked CUDA tensors, uncounted:
    (ids, occs, launches made), the record None unless ``record``. With
    ``live`` (a cotangent of acc, (R, 3)) a recording launch traces only
    the rays whose row is nonzero and records the others as misses; acc
    is then scratch. The sphere tree's route as ``_launch_direct``'s."""
    tree, _keep = _walk_desc(_walks(sphere_walk, sph, grid, chunks, "path"),
                             sph, grid, chunks, sph_tree)
    lib = _lib(grid, chunks, build_flags)
    pass0, roff = (int(x) for x in ipar.tolist())
    ids = occs = None
    if record:
        # the kernel writes every slot, dead segments included
        n, n_seg = acc.shape[0], 1 + bounces
        ids = torch.empty((n_seg, n), dtype=torch.int32, device=acc.device)
        occs = torch.empty((n_seg * lig.shape[0], n), dtype=torch.bool,
                           device=acc.device)
    gargs, _desc = _grid_args(grid, chunks, sph.shape[0], tri.shape[0])
    made = 0
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        for first in range(0, n_passes, MAX_PASSES_PER_LAUNCH):
            k = min(MAX_PASSES_PER_LAUNCH, n_passes - first)
            # host-computed pass keys, copied into the kernel's parameters
            keys = (ctypes.c_uint32 * (2 * k))(*(
                w for p in range(k)
                for w in rng.pass_key_words(seed, pass0 + first + p)))
            err = lib.rt_pathtrace_pass(
                _ptr(par), _ptr(sph), sph.shape[0], _ptr(tri), tri.shape[0],
                _ptr(mat), mat.shape[0], _ptr(lig), lig.shape[0],
                _ptr(acc), acc.shape[0], roff, _ptr(u_planes),
                ctypes.addressof(keys), k, spp, width, bounces,
                int(russian_roulette), rr_start_depth, int(two_sided),
                int(normalize_emitter), _ptr(ids), _ptr(occs), _ptr(live),
                *gargs, None if tree is None else ctypes.addressof(tree),
                _kernel_block(block, grid, chunks), stream)
            if err != 0:
                raise RuntimeError(
                    f"megakernel launch failed with CUDA error {err}")
            made += 1
    return ids, occs, made


def sphere_walks(sph, grid=None, chunks=None, mode: str = "path") -> bool:
    """Whether kernel 1 in ``mode`` ("path" or "direct") walks a box tree
    over the spheres: resident spheres (no grid, no streamed table) past
    ``SPH_BRUTE_MAX[mode]`` rows."""
    return (grid is None and chunks is None
            and sph.shape[0] > SPH_BRUTE_MAX[mode])


def pass_tree(sph, grid=None, chunks=None,
              mode: str = "path") -> SphereTree | None:
    """The sphere tree that kernel 1 in ``mode`` walks over the CUDA table
    ``sph`` (``sphere_walks``), built on the card by one launch
    (``sphere_tree_build``), or None where the mode loops over the spheres
    and on the CPU. A caller that launches several passes over one table
    (a differentiable pass: its forward and kernel 2's record) builds it
    once and hands it to each (``pathtrace_pass``'s and ``direct_pass``'s
    ``sph_tree``)."""
    if sph.device.type != "cuda" or not sphere_walks(sph, grid, chunks,
                                                     mode):
        return None
    return sphere_tree_build(sph, SPH_TREE_LEAF)


def _walks(sphere_walk: bool | None, sph, grid, chunks, mode: str) -> bool:
    """A launch's route: ``sphere_walk`` where the caller forces one,
    else ``sphere_walks``."""
    return (sphere_walks(sph, grid, chunks, mode) if sphere_walk is None
            else sphere_walk)


def _walk_desc(walk: bool, sph, grid, chunks, sph_tree: SphereTree | None):
    """(descriptor, tree) of a launch that walks (``walk``): the tree is
    ``sph_tree``, the caller's, checked against ``sph``, or else one built
    here (``sphere_tree_build``, which counts its launch); (None, None) for
    the brute loop. The descriptor holds raw pointers: the caller keeps the
    tree until its launches are queued (freed earlier, its block could go
    to the launch's own outputs, allocated after it, on this stream)."""
    if not walk:
        return None, None
    if grid is not None or chunks is not None or sph.shape[0] == 0:
        raise ValueError("the sphere tree's instances walk resident "
                         "spheres: no grid, no streamed tables, at "
                         "least one sphere")
    if sph_tree is None:
        sph_tree = sphere_tree_build(sph, SPH_TREE_LEAF)
    elif (sph_tree.rows.device != sph.device
          or sph_tree.perm.shape[0] != -(-sph.shape[0]
                                         // sph_tree.tree.leaf)
          * sph_tree.tree.leaf):
        raise ValueError(
            f"sph_tree holds {sph_tree.perm.shape[0]} rows on "
            f"{sph_tree.rows.device}, the table {sph.shape[0]} on "
            f"{sph.device}: pass pass_tree(sph)")
    return _tree_desc(sph_tree), sph_tree


def _tree_desc(tree) -> _StreamDesc:
    """A ``SphereTree`` as the kernel's ``Stream`` descriptor."""
    st = tree.tree
    return _StreamDesc(tree.rows.data_ptr(), tree.perm.data_ptr(),
                       st.nodes.data_ptr(), st.masks.data_ptr(),
                       st.loose.data_ptr(), tree.rows.shape[0], st.leaf,
                       st.n_slots, st.loose.shape[0])


def direct_pass(par, sph, tri, mat, lig, acc, u_planes, *,
                key: torch.Tensor, spp: int, width: int, two_sided: bool,
                n_passes: int = 1, grid: KernelGrids | None = None,
                chunks: KernelChunks | None = None, block: int = 0,
                build_flags: tuple = (), ray_offset: int = 0,
                record: bool = False, sphere_walk: bool | None = None,
                sph_tree: SphereTree | None = None):
    """Kernel 1's direct mode: ``n_passes`` direct-lighting passes added
    into ``acc`` (R, 3), in place; returns ``acc``, or ``(acc, ids, occs)``
    with ``record=True`` (one pass; ``direct_pass_reference`` gives the
    layout). Pass p reads ``u_planes`` ((2 * (1 + L), R),
    ``u_planes_for_direct``'s layout) or, without them, makes
    ``direct_draw_planes``'s draws in-kernel, keyed by ``key`` ((2,)
    uint32 CPU tensor) for a call of one pass and by ``pass_key(key, p)``
    otherwise. ``acc`` holds rays ``[ray_offset, ray_offset + R)`` of the
    film. On CPU tensors it runs ``direct_pass_reference``; on CUDA
    tensors it launches the kernel (one launch per 64 passes) and counts
    ``direct_launches``. Tables, ``grid``, ``chunks`` and ``block`` as
    ``pathtrace_pass``. On the card past ``SPH_BRUTE_MAX["direct"]``
    resident spheres each launch walks a sphere tree, as
    ``pathtrace_pass``'s do (counted in ``direct_walk_launches``);
    ``sphere_walk`` and ``sph_tree`` as there."""
    global direct_launches, direct_walk_launches, stream_launches
    _check_args(par, torch.tensor([0, ray_offset], dtype=torch.int32), sph,
                tri, mat, lig, acc, u_planes, spp, width, 1 + lig.shape[0],
                n_passes, multi_pass_planes=True, grid=grid, block=block,
                chunks=chunks)
    if record and n_passes != 1:
        raise ValueError("champion recording is single-pass")
    kw = dict(key=key, spp=spp, width=width, two_sided=two_sided,
              n_passes=n_passes, grid=grid, chunks=chunks,
              ray_offset=ray_offset)
    if acc.device.type == "cpu":
        out = direct_pass_reference(par, sph, tri, mat, lig, acc, u_planes,
                                    record=record, **kw)
        if not record:
            return acc.copy_(out)
        return acc.copy_(out[0]), out[1], out[2]
    _check_launch(acc, (par, sph, tri, mat, lig, acc, u_planes),
                  "direct_pass")
    walk = _walks(sphere_walk, sph, grid, chunks, "direct")
    ids, occs, n = _launch_direct(par, sph, tri, mat, lig, acc, u_planes,
                                  record=record, block=block,
                                  build_flags=build_flags, sphere_walk=walk,
                                  sph_tree=sph_tree, **kw)
    direct_launches += n
    direct_walk_launches += n if walk else 0
    stream_launches += n if chunks is not None else 0
    return (acc, ids, occs) if record else acc


def _launch_direct(par, sph, tri, mat, lig, acc, u_planes, *, key, spp: int,
                   width: int, two_sided: bool, n_passes: int, grid, chunks,
                   ray_offset: int, record: bool, block: int,
                   build_flags: tuple, live=None,
                   sphere_walk: bool | None = None,
                   sph_tree: SphereTree | None = None):
    """``direct_pass``'s launches on checked CUDA tensors, uncounted:
    (ids, occs, launches made), the record None unless ``record``;
    ``live`` as ``_launch_pass``'s. Where the spheres are walked
    (``sphere_walks``, or ``sphere_walk``) the launches walk ``sph_tree``
    (``pass_tree(sph, mode="direct")``, the caller's), or else a tree this
    call builds (``sphere_tree_build``, which counts its launch)."""
    tree, _keep = _walk_desc(_walks(sphere_walk, sph, grid, chunks,
                                    "direct"), sph, grid, chunks, sph_tree)
    lib = _lib(grid, chunks, build_flags)
    k0, k1 = rng.key_words(key)
    ids = occs = None
    if record:
        # the kernel writes every slot, missed rays included
        ids = torch.empty((1, acc.shape[0]), dtype=torch.int32,
                          device=acc.device)
        occs = torch.empty((lig.shape[0], acc.shape[0]), dtype=torch.bool,
                           device=acc.device)
    gargs, _desc = _grid_args(grid, chunks, sph.shape[0], tri.shape[0])
    made = 0
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        for first in range(0, n_passes, MAX_PASSES_PER_LAUNCH):
            k = min(MAX_PASSES_PER_LAUNCH, n_passes - first)
            err = lib.rt_direct_pass(
                _ptr(par), _ptr(sph), sph.shape[0], _ptr(tri), tri.shape[0],
                _ptr(mat), mat.shape[0], _ptr(lig), lig.shape[0],
                _ptr(acc), acc.shape[0], ray_offset, _ptr(u_planes), k0, k1,
                first, int(n_passes > 1), k, spp, width, int(two_sided),
                _ptr(ids), _ptr(occs), _ptr(live), *gargs,
                None if tree is None else ctypes.addressof(tree),
                _kernel_block(block, grid, chunks), stream)
            if err != 0:
                raise RuntimeError(
                    f"direct-mode launch failed with CUDA error {err}")
            made += 1
    return ids, occs, made
