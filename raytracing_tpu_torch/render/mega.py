"""The megakernel pass: Scene -> packed tables -> one kernel launch per
call (``raytracing_tpu.render.mega``), in path mode (``render_pass_mega``,
with or without Russian roulette) and in direct mode
(``render_direct_mega``).

When a table that the pass reads requires grad (scene parameters being
fitted) and grad mode is on, the pass is differentiable: it runs
``ops.megakernel_grad.pathtrace_pass_diff`` with the backward that
``bwd_impl_for`` picks, as the JAX package does: kernel 2
(``csrc/megakernel_grad.cu``, replaying the pass; past 64 objects per
type and on grid scenes an uncontracted record of the pass by kernel 1 and
kernel 3's sweep of it) or the champion ("cell")
route -- kernel 1 records the champions and occlusion bits, kernel 3
(``csrc/megakernel_champ.cu``) differentiates the record -- which "auto"
takes past 64 objects and in grid mode; in edge mode kernel 2s
(``csrc/megakernel_soft.cu``) at any size the pass covers.
``supported_diff`` gates the differentiable pass (``DIFF_TABLE_MAX``
objects per type).

``supported`` is True only for what the port's kernel 1 covers: no
stale-POI replication and fewer than 2^24 rays. Tables of at most 4608
spheres (JAX's ``SMEM_TABLE_MAX // 8``, the resident table its kernel
loops over) and 64 triangles (JAX's ``STREAM_MIN_TRIS``) stay resident;
larger ones stream in Morton chunks (``chunk_tables``, JAX's
``tri_chunk_tables`` / ``sph_chunk_tables``), routed as JAX's
``render_pass_mega`` and ``render_direct_mega`` route them: triangles past
64 when not in grid mode, spheres past 4608 without a sphere grid, grid
mode included. With ``cfg.use_grid`` the triangles below the grids'
start are the resident prefix (at most 64), the rest are walked in kernel
1's grid mode over the grids of ``accel.prepare_grids`` and, per grid, a
cell-major copy of the call's tables with a box tree per cell
(``grid_tables``, ``grid_cells``).
``cfg.mega_block`` is the blocked layout where it tiles the film
(``effective_block``, JAX's gate): grid mode and streamed tables map the
kernel's threads to pixel blocks, the brute instances keep the row-major
map, which gives the same image. Anything else raises, naming the ROADMAP
item that will cover it or the stage pipeline (``use_megakernel=False``)
that covers it now; nothing falls through to another route. ``use_pallas``
selects the stage pipeline's hit kernels and is ignored here, as in the
JAX package.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.config import RenderConfig
from ..core.types import Scene, at_least, clip, ray_window, tangent_frame
from ..ops import intersect as I
from ..ops import megakernel as MK
from ..ops import megakernel_grad as MKG
from .stages import _all_triangles

# the differentiable pass's table budget per object type (JAX's
# render/mega.py DIFF_TABLE_MAX)
DIFF_TABLE_MAX = MKG.DIFF_TABLE_MAX
# grid mode's differentiable row budget, counted as JAX counts its
# duplicated cell-major diff rows (render/mega.py GRID_DIFF_MAX): the
# triangle prefix plus the grids' payloads, and the sphere grid's payload.
# The port's cell route records original rows, so no table of that size is
# built here; the budget is kept so that the port trains what JAX trains.
GRID_DIFF_MAX = 32768


def scene_tables(scene: Scene, cfg: RenderConfig
                 ) -> tuple[torch.Tensor, ...]:
    """(par (26,), sph (S, 8), tri (T, 32), mat (M, 4), lig (L, 20)) float32
    on the scene's device, packed as the JAX package packs them."""
    cam = scene.camera
    dev = scene.device

    def f32(x):
        return x.to(torch.float32).reshape(1)

    def const(*vals):
        # filled on the device: a tensor built from a Python list would be
        # a pageable host-to-device copy, which synchronises the stream
        return torch.cat([torch.full((1,), float(v), device=dev)
                          for v in vals])

    par = torch.cat([
        cam.eye, cam.u, cam.v, cam.w,
        f32(cam.width), f32(cam.height), const(cfg.width, cfg.height),
        f32(scene.focal_length), f32(scene.lens_radius),
        scene.bounds_min, scene.bounds_max,
        const(cfg.shadow_eps, cfg.ambient),
    ]).to(torch.float32)
    assert par.shape[0] == MK.NPAR

    sp = scene.spheres
    sph = torch.cat([
        sp.center, sp.radius[:, None],
        sp.mat_id[:, None].to(torch.float32),
        sp.mask[:, None].to(torch.float32),
        torch.zeros((sp.count, 2), device=dev),
    ], -1).to(torch.float32).contiguous()

    tris = _all_triangles(scene)
    tc = I.tri_constants(tris.v)
    n = tris.count
    tri = torch.cat([
        tc.n_geo, tc.c1, tc.c2, tc.e1, tc.e2, tc.k[:, None],
        tris.mat_id[:, None].to(torch.float32),
        tris.mask[:, None].to(torch.float32),
        tris.vn.reshape(n, 9),
        torch.zeros((n, 5), device=dev),
    ], -1).to(torch.float32).contiguous()

    mat = scene.materials.to(torch.float32).contiguous()

    lg = scene.lights
    t_ax, b_ax = tangent_frame(lg.normal)
    irr_n = lg.irradiance / at_least(
        torch.linalg.norm(lg.irradiance, dim=-1, keepdim=True), 1e-20)
    lig = torch.cat([
        lg.position, lg.normal, lg.irradiance, irr_n,
        lg.radius[:, None], lg.area[:, None], t_ax, b_ax,
    ], -1).to(torch.float32).contiguous()
    return par, sph, tri, mat, lig


def effective_block(cfg: RenderConfig) -> int:
    """cfg.mega_block where it tiles the film, else 0 (row-major): JAX's
    ``_effective_block``."""
    b = cfg.mega_block
    return b if b and cfg.width % b == 0 and cfg.height % b == 0 else 0


def _scene_grids(scene: Scene) -> MK.KernelGrids:
    """The scene's prepared grids as kernel 1's grid mode reads them,
    without their cell-major copies: ``folded_tri_grid`` (the brute prefix
    ends at the first one's ``start``; without triangle grids it is every
    triangle) and ``mega_sph_grid``; ``rows`` the row counts of
    ``scene_tables``, which packs each of the scene's objects once."""
    grids = tuple(scene.folded_tri_grid or ())
    n_tri = _all_triangles(scene).count
    start = grids[0].start if grids else n_tri
    return MK.KernelGrids(tri=grids, sph=scene.mega_sph_grid, start=start,
                          rows=(scene.spheres.count, n_tri))


def grid_tables(scene: Scene, sph: torch.Tensor,
                tri: torch.Tensor) -> MK.KernelGrids:
    """Kernel 1's grid-mode arguments from the scene's prepared grids
    (``_scene_grids``) and, per triangle grid, the kernel's cell-major copy
    of the table ``scene_tables`` packed for this call (``grid_cells``), so
    a table being trained never reads stale rows or boxes. The grids' CSR
    arrays are used as built and the kernel walks each ray's cells in
    order, so nothing is baked for a camera."""
    g = _scene_grids(scene)
    if not g.tri:
        return g._replace(copies=())
    v = _all_triangles(scene).v.detach().to(torch.float32)
    tri = tri.detach()
    return g._replace(copies=tuple(
        grid_cells(scene, grid, tri, v.amin(1), v.amax(1),
                   lambda: v.mean(1), MK.GRID_LEAF) for grid in g.tri))


class CellLayout(NamedTuple):
    """The part of a grid's cell-major copy that depends only on its CSR
    and its items' centres when first seen (``cell_layout``), on the
    grid's device: ``src`` (R,) int64, the item of each copied row (-1:
    padding), ``cell`` (C, 4) int32 (``MK.CellCopy.cell``), ``n_nodes``,
    and the (node, leaf) pairs of each real leaf of a cell's tree with
    that leaf's node and every node above it (``pair_node``,
    ``pair_leaf``; leaf i the copy's rows [i L, (i + 1) L)), over which
    each node's box is the least box of its leaves'."""
    src: torch.Tensor
    cell: torch.Tensor
    pair_node: torch.Tensor
    pair_leaf: torch.Tensor
    n_nodes: int


# per grid (weakly: a grid that is dropped takes its layouts along), per
# leaf size, its CellLayout
_LAYOUTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def cell_layout(grid, centres, leaf: int) -> CellLayout:
    """The cell-major layout of ``grid`` at leaves of ``leaf`` rows, built
    once on the host (numpy) and cached per grid: each cell's items in the
    Morton order of their centres (``centres()`` (O, 3), called only when
    the layout is built; codes against the grid's box, ties in id order),
    each cell's run padded to whole leaves; a cell of more than one leaf
    gets an implicit binary tree over its leaves, padded with empty leaves
    to a power of two. Only the boxes depend on the tables: ``grid_cells``
    gathers them every call."""
    per = _LAYOUTS.setdefault(grid, {})
    if leaf in per:
        return per[leaf]
    dev = grid.cell_offsets.device
    off = grid.cell_offsets.cpu().numpy().astype(np.int64)
    items = grid.item_indices.cpu().numpy().astype(np.int64)
    counts = np.diff(off)
    cell_of = np.repeat(np.arange(counts.shape[0]), counts)
    cen = centres().detach().to(torch.float32).cpu()
    code = _morton_codes(cen[torch.as_tensor(items)],
                         torch.as_tensor(grid.pmin),
                         torch.as_tensor(grid.pmax)).numpy()
    order = np.lexsort((items, code, cell_of))
    n_leaves = -(-counts // leaf)
    tree = n_leaves >= 2
    depth = np.ceil(np.log2(np.maximum(n_leaves, 1))).astype(np.int64)
    slots = np.where(tree, 1 << depth, n_leaves)
    size = n_leaves * leaf
    row0 = np.cumsum(size) - size
    src = np.full(max(int(size.sum()), leaf), -1, np.int64)
    pos = np.arange(items.shape[0]) - np.repeat(off[:-1], counts)
    src[np.repeat(row0, counts) + pos] = items[order]
    nn = np.where(tree, 2 * slots, 0)
    node0 = np.where(tree, np.cumsum(nn) - nn, -1)
    # each real leaf of a tree: its node and every node above it
    tc = np.nonzero(tree)[0]
    nl = n_leaves[tc]
    j = np.arange(int(nl.sum())) - np.repeat(np.cumsum(nl) - nl, nl)
    k = np.repeat(slots[tc], nl) + j              # the leaf's node in its tree
    up = np.repeat(depth[tc], nl) + 1             # nodes from the leaf up
    lvl = np.arange(int(up.sum())) - np.repeat(np.cumsum(up) - up, up)
    pair_node = np.repeat(np.repeat(node0[tc], nl), up) + (
        np.repeat(k, up) >> lvl)
    pair_leaf = np.repeat(np.repeat(row0[tc] // leaf, nl) + j, up)
    cell = np.stack([row0, node0, slots, counts], 1).astype(np.int32)
    per[leaf] = CellLayout(
        src=torch.as_tensor(src, device=dev),
        cell=torch.as_tensor(cell, device=dev).contiguous(),
        pair_node=torch.as_tensor(pair_node, device=dev),
        pair_leaf=torch.as_tensor(pair_leaf, device=dev),
        n_nodes=max(int(nn.sum()), 1))
    return per[leaf]


def grid_cells(scene: Scene, grid, table: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor, centres, leaf: int) -> MK.CellCopy:
    """The kernel's cell-major copy of ``grid`` (``MK.CellCopy``) over
    ``table`` (its rows indexed by the grid's item ids), with the rows'
    boxes [lo, hi] (O, 3) (+inf / -inf: a row without one): the layout
    (``cell_layout``, cached per grid) and, gathered on the table's device
    with no host synchronisation, the copied rows, each leaf's box over its
    rows' boxes and each node's over its leaves', widened by
    ``MK.CHUNK_PAD`` of the scene's scale as ``chunk_tree`` widens the
    streamed tables' (so the slab test's monotone rounding never culls a
    leaf whose row the brute loop hits; see ``chunk_tree``)."""
    lay = cell_layout(grid, centres, leaf)
    dev = table.device
    ok = lay.src >= 0
    s = lay.src.clamp(min=0)
    rows = torch.where(ok[:, None], table[s], 0.0).to(torch.float32)
    w = _pad_width(scene)
    n_leaves = s.shape[0] // leaf
    # scalars, not tensors made from host values: such a copy to the card
    # would synchronise the stream on every call
    lo_l = torch.where(ok[:, None], lo[s], torch.inf).reshape(
        n_leaves, leaf, 3).amin(1) - w
    hi_l = torch.where(ok[:, None], hi[s], -torch.inf).reshape(
        n_leaves, leaf, 3).amax(1) + w
    at = lay.pair_node[:, None].expand(-1, 3)
    lo_n = torch.full((lay.n_nodes, 3), torch.inf, device=dev).scatter_reduce(
        0, at, lo_l[lay.pair_leaf], "amin")
    hi_n = torch.full((lay.n_nodes, 3), -torch.inf,
                      device=dev).scatter_reduce(0, at, hi_l[lay.pair_leaf],
                                                 "amax")
    nodes = torch.cat([lo_n, hi_n, torch.zeros((lay.n_nodes, 2), device=dev)],
                      -1).to(torch.float32).contiguous()
    return MK.CellCopy(rows=rows.contiguous(), perm=lay.src.to(torch.int32),
                       cell=lay.cell, nodes=nodes, leaf=leaf)


def _prepared(scene: Scene) -> None:
    """Raises unless ``accel.prepare_grids`` built the triangle grids a
    grid-mode render of the scene reads (spheres past the resident budget
    without a sphere grid stream, as in JAX)."""
    if _all_triangles(scene).count and scene.folded_tri_grid is None:
        raise ValueError("use_grid needs the scene's grids: call "
                         "accel.prepare_grids(scene, ...) first")


def streamed(scene: Scene, cfg: RenderConfig) -> tuple[bool, bool]:
    """(triangles stream, spheres stream): JAX's routing
    (``render/mega.py:710-717``, ``:811-814``): the triangles past
    ``TRI_RESIDENT_MAX`` (JAX's ``STREAM_MIN_TRIS``) outside grid mode,
    the spheres past ``SPH_RESIDENT_MAX`` (``SMEM_TABLE_MAX // 8``) unless
    grid mode walks the sphere grid."""
    tri = (not cfg.use_grid
           and _all_triangles(scene).count > MK.TRI_RESIDENT_MAX)
    sph = (scene.spheres.count > MK.SPH_RESIDENT_MAX
           and not (cfg.use_grid and scene.mega_sph_grid is not None))
    return tri, sph


_morton_codes = MK.morton_codes


def _pad_width(scene: Scene) -> torch.Tensor:
    """The widening of a streamed table's boxes: ``MK.CHUNK_PAD`` of the
    scene's scale (the largest coordinate of its bounds and camera eye)."""
    scale = torch.cat([scene.bounds_min.abs(), scene.bounds_max.abs(),
                       scene.camera.eye.abs()]).amax()
    return MK.CHUNK_PAD * scale


def _stream(scene: Scene, table: torch.Tensor, cen: torch.Tensor,
            lo: torch.Tensor, hi: torch.Tensor) -> MK.Stream:
    """A table's ``Stream``: its rows in the stable argsort order of the
    Morton codes of ``cen`` against the scene's bounds, padded with zero
    rows to whole chunks, and that order (``perm``, padded with -1); per
    chunk the box over its rows' boxes [lo, hi] (N, 3) (rows with lo =
    +inf, hi = -inf take no part), widened by ``MK.CHUNK_PAD`` of the
    scene's scale on every side; and the kernel's walk over them
    (``chunk_tree``). All on the table's device, with no host
    synchronisation."""
    n, dev = table.shape[0], table.device
    C = MK.STREAM_CHUNK
    nc = -(-n // C)
    pad = nc * C - n
    order = torch.argsort(_morton_codes(cen, scene.bounds_min,
                                        scene.bounds_max), stable=True)
    rows = torch.cat([table[order],
                      table.new_zeros((pad, table.shape[1]))]).contiguous()
    perm = torch.cat([order.to(torch.int32),
                      torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    inf = torch.full((pad, 3), torch.inf, device=dev)
    lo = torch.cat([lo[order], inf])
    hi = torch.cat([hi[order], -inf])
    w = _pad_width(scene)
    boxes = torch.cat([lo.reshape(nc, C, 3).amin(1) - w,
                       hi.reshape(nc, C, 3).amax(1) + w,
                       torch.zeros((nc, 2), device=dev)],
                      -1).to(torch.float32).contiguous()
    return MK.Stream(rows=rows, boxes=boxes, perm=perm,
                     tree=chunk_tree(scene, lo, hi, perm))


def chunk_tree(scene: Scene, lo: torch.Tensor, hi: torch.Tensor,
               perm: torch.Tensor) -> MK.StreamTree:
    """The kernel's walk over a streamed table's Morton copy
    (``MK.StreamTree``), from the sorted rows' boxes [lo, hi] (N, 3) and
    ``perm`` (N,) (-1: padding), N whole chunks of rows; on their device,
    with no host synchronisation.

    The layout is ``MK.box_tree``'s over the rows that are not padding:
    loose rows (the scene box's longest side is the room), leaves of
    ``MK.STREAM_LEAF`` sorted rows whose boxes are widened by
    ``MK.CHUNK_PAD`` of the scene's scale as the chunks' are, and an
    implicit binary tree of node boxes over the leaves in Morton order.

    Why the culling is exact: the slab test (``MK.chunk_overlap``, the
    kernel's ``node_enter``) rounds monotonically, so in float arithmetic
    a box that contains another overlaps every window the inner one
    overlaps, and each node contains the widened box of every row under
    it. A leaf is thus visited by every ray whose window the chunk of
    Morton rows around its hit would pass, and a candidate wins on the
    least (t, original id) pair whatever the order of the visits."""
    room = (scene.bounds_max - scene.bounds_min).amax()
    return MK.box_tree(lo, hi, perm >= 0, MK.STREAM_LEAF, _pad_width(scene),
                       room)


def tri_chunk_tables(scene: Scene, tri: torch.Tensor) -> MK.Stream:
    """The triangle table ``tri`` (T, 32) streamed: JAX's
    ``tri_chunk_tables`` (order by the Morton codes of the vertex
    centroids, a chunk's box over its vertices), rows kept 32 wide (JAX's
    128-lane padding is the TPU's) and the boxes widened."""
    v = _all_triangles(scene).v.detach().to(torch.float32)
    cen = (v[:, 0] + v[:, 1] + v[:, 2]) / 3.0
    return _stream(scene, tri.detach(), cen, v.amin(1), v.amax(1))


def sph_chunk_tables(scene: Scene, sph: torch.Tensor) -> MK.Stream:
    """The sphere table ``sph`` (S, 8) streamed: JAX's ``sph_chunk_tables``
    (order by the Morton codes of the centres, a chunk's box over centre
    -/+ radius of its rows whose mask is set), the boxes widened."""
    sph = sph.detach()
    cen, r = sph[:, 0:3], sph[:, 3:4]
    on = sph[:, 5:6] > 0.0
    return _stream(scene, sph, cen, torch.where(on, cen - r, torch.inf),
                   torch.where(on, cen + r, -torch.inf))


def chunk_tables(scene: Scene, cfg: RenderConfig, sph: torch.Tensor,
                 tri: torch.Tensor) -> MK.KernelChunks | None:
    """Kernel 1's streamed tables of this call (``streamed`` says which),
    built on the device from the tables ``scene_tables`` packed for it, so
    a table being trained never reads stale boxes; None when nothing
    streams."""
    s_tri, s_sph = streamed(scene, cfg)
    if not (s_tri or s_sph):
        return None
    return MK.KernelChunks(tri=tri_chunk_tables(scene, tri) if s_tri else None,
                           sph=sph_chunk_tables(scene, sph) if s_sph else None)


def supported(scene: Scene | None, cfg: RenderConfig) -> bool:
    """True when the port renders this scene and config; raises
    NotImplementedError naming the ROADMAP Queue 1 item otherwise (and
    ValueError for a grid-mode scene without its prepared grids). With
    ``scene=None`` only the config is checked."""
    if cfg.replicate_stale_poi:
        raise NotImplementedError(
            "replicate_stale_poi is a stage-pipeline option (the JAX "
            "megakernel falls through to the stage pipeline for it): set "
            "use_megakernel=False")
    if cfg.total_rays >= (1 << 24):
        raise NotImplementedError(
            f"{cfg.total_rays} rays: the kernel takes fewer than 2^24 per "
            "call (pixel math is exact below it, a sharded render included); "
            "the JAX package takes the stage pipeline there: set "
            "use_megakernel=False")
    if scene is None:
        return True
    if not cfg.use_grid:
        return True
    _prepared(scene)
    g = _scene_grids(scene)
    if len(g.tri) + (g.sph is not None) > MK.GRIDS_MAX:
        raise NotImplementedError(
            f"kernel 1 walks at most {MK.GRIDS_MAX} grids per launch")
    if g.start > MK.TRI_RESIDENT_MAX:
        raise NotImplementedError(
            f"{g.start} triangles outside the grids: kernel 1 keeps at most "
            f"{MK.TRI_RESIDENT_MAX} resident in grid mode, as JAX's grid "
            "kernel does (accel.prepare_grids' mesh_slabs grids a mesh)")
    return True


def supported_diff(scene: Scene | None, cfg: RenderConfig) -> bool:
    """True when the differentiable pass covers this scene and config, as
    JAX's ``supported_diff`` (``render/mega.py:536-585``) gates it: tables
    of at most ``DIFF_TABLE_MAX`` objects per type, resident or streamed,
    the edge-aware backward (``cfg.mega_edge_bandwidth > 0``) included, in
    grid mode too; grid mode's hard gradient up to ``GRID_DIFF_MAX`` rows
    per type counted as JAX counts its duplicated cell-major rows. Raises
    NotImplementedError otherwise: larger tables render forward-only, as
    in JAX."""
    supported(scene, cfg)
    MKG._check_wrt(cfg.mega_grad_wrt)
    if scene is None:
        return True
    n_sph, n_tri = scene.spheres.count, _all_triangles(scene).count
    if cfg.use_grid and cfg.mega_edge_bandwidth <= 0.0:
        g = _scene_grids(scene)
        tri_rows = g.start + sum(int(x.item_indices.shape[0]) for x in g.tri)
        sph_rows = (int(g.sph.item_indices.shape[0]) if g.sph is not None
                    else n_sph)
        budget = GRID_DIFF_MAX if g.sph is not None else DIFF_TABLE_MAX
        if tri_rows > GRID_DIFF_MAX or sph_rows > budget:
            raise NotImplementedError(
                f"{tri_rows} triangle / {sph_rows} sphere rows: grid-mode "
                f"training covers at most {GRID_DIFF_MAX} rows per type "
                f"(the JAX package's GRID_DIFF_MAX; spheres without a grid "
                f"{DIFF_TABLE_MAX}); larger scenes render forward-only")
    elif max(n_sph, n_tri) > DIFF_TABLE_MAX:
        raise NotImplementedError(
            f"{n_sph} spheres / {n_tri} triangles: the differentiable pass "
            f"covers at most {DIFF_TABLE_MAX} per type (the JAX package's "
            "DIFF_TABLE_MAX), the edge-aware one too; larger tables render "
            "forward-only")
    return True


def bwd_impl_for(scene: Scene | None, cfg: RenderConfig) -> str:
    """The backward the differentiable pass runs (``cfg.mega_bwd_impl``),
    with the JAX package's semantics and names:

    * "pallas" -- kernel 2, the backward by replay: up to 64 objects per
      type over tables in shared memory, past that (and on a grid scene)
      kernel 1's uncontracted recording instance, which replays the search
      over its streamed chunks (JAX's ``_loop_diff`` windows) or grids,
      then kernel 3's sweep of that record over the scene's own
      rows (JAX's kernel 2 replays over its duplicated cell-major diff
      tables there; its AD scatters their cotangents back onto the same
      original rows);
    * "cell" -- the champion route: kernel 1 recording (over streamed
      tables and grids too; the record names original rows), then kernel
      3;
    * "auto" -- JAX's threshold: "cell" for grid mode and past 64 objects
      of either type, "pallas" otherwise;
    * "xla" -- the TPU-only dense backward: raises.

    Returns "pallas" or "cell".

    Edge mode (``cfg.mega_edge_bandwidth > 0``): "auto" and "pallas" give
    "pallas", kernel 2s over the scene's own rows at any size the
    differentiable pass covers, grid mode included (past 64 objects JAX's
    "auto" takes its TPU-only dense "xla" route, which computes the same
    soft cotangents at the value level); "cell" raises, as JAX
    asserts."""
    impl = cfg.mega_bwd_impl
    if impl == "xla":
        raise NotImplementedError(
            "the dense XLA backward is TPU-only and not ported (ROADMAP, "
            "'Do not port'); the plain version is "
            "ops.megakernel_grad.pathtrace_pass_bwd_reference")
    if impl not in ("auto", "pallas", "cell"):
        raise ValueError(f"mega_bwd_impl must be 'auto', 'pallas' or "
                         f"'cell', got {impl!r}")
    supported_diff(scene, cfg)
    if cfg.mega_edge_bandwidth > 0.0:
        if impl == "cell":
            raise ValueError("the champion (cell) backward is hard-gradient "
                             "only; edge mode needs the soft sweep "
                             "(mega_bwd_impl 'auto' or 'pallas')")
        return "pallas"
    big = scene is not None and max(
        scene.spheres.count,
        _all_triangles(scene).count) > MK.UNROLL_OBJECTS
    if impl == "auto":
        return "cell" if big or cfg.use_grid else "pallas"
    return impl


def soft_tri_order(scene: Scene, tri: torch.Tensor,
                   chunks: MK.KernelChunks | None) -> MK.Stream | None:
    """The triangle order of the edge-aware backward, as JAX hands its soft
    route the tables (``render/mega.py:690-700``, ``:711-712``): past 64
    triangles the Morton-sorted rows of ``tri_chunk_tables``, padded with
    zero rows to whole chunks -- the forward's streamed table, or in grid
    mode a sorted copy built for the backward alone; None (the table's own
    order) up to 64. The two-level composite's spans follow this order."""
    if _all_triangles(scene).count <= MK.UNROLL_OBJECTS:
        return None
    if chunks is not None and chunks.tri is not None:
        return chunks.tri
    return tri_chunk_tables(scene, tri)


def u_planes_for_direct(key: torch.Tensor, cfg: RenderConfig, n_lights: int,
                        device=None) -> torch.Tensor:
    """The draws of one direct pass in the kernel's plane layout, (2 * (1 +
    L), R): the lens pair (``draw_key(key, LENS)``; zeros at spp > 1),
    then one pair per light (``draw_key(key, LIGHT, 0, li)``) -- exactly
    the JAX package's ``u_planes_for_direct``, and the stage route's
    ``render_direct`` draws."""
    return MK.direct_draw_planes(key, cfg.total_rays, n_lights, cfg.spp,
                                 device)


def render_direct_mega(scene: Scene, cfg: RenderConfig,
                       key: torch.Tensor | None = None,
                       u_planes: torch.Tensor | None = None,
                       n_passes: int = 1) -> torch.Tensor:
    """The direct-lighting image (H, W, 3) in [0, 1] through kernel 1's
    direct mode, one launch per call (per 64 passes): the JAX package's
    ``render_direct_mega``. ``n_passes`` independent estimates are
    averaged; pass p draws from ``key`` (one pass) or ``pass_key(key, p)``
    as the stage route's ``render_direct`` does, or reads ``u_planes``
    (``u_planes_for_direct``) in every pass. ``key`` defaults to
    ``PRNGKey(cfg.seed)``."""
    supported(scene, cfg)
    if key is None:
        key = rng.base_key(cfg.seed)
    par, sph, tri, mat, lig = scene_tables(scene, cfg)
    acc = torch.zeros((cfg.total_rays, 3), device=scene.device)
    MK.direct_pass(par, sph, tri, mat, lig, acc, u_planes, key=key,
                   spp=cfg.spp, width=cfg.width,
                   two_sided=cfg.two_sided_triangles, n_passes=n_passes,
                   grid=grid_tables(scene, sph, tri) if cfg.use_grid
                   else None,
                   chunks=chunk_tables(scene, cfg, sph, tri),
                   block=effective_block(cfg))
    n_lights = max(scene.lights.count, 1)
    img = acc.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2) \
        / (n_lights * n_passes)
    return clip(img, 0.0, 1.0)


def u_planes_for_pass(key: torch.Tensor, passes: int, cfg: RenderConfig,
                      n_lights: int, device=None) -> torch.Tensor:
    """The pass-wide uniforms in the kernel's plane layout, (2 * n_draws, R):
    exactly the JAX package's ``u_planes_for_pass``."""
    from .pathtracer import pass_draw_count
    return MK.draw_planes(rng.pass_key(key, passes), cfg.total_rays,
                          pass_draw_count(cfg, n_lights), 0, device)


def render_pass_mega(scene: Scene, state: dict, cfg: RenderConfig,
                     u_planes: torch.Tensor | None = None,
                     n_passes: int = 1, ray_offset: int = 0) -> dict:
    """``n_passes`` progressive passes; same state contract as the JAX
    ``render_pass_mega``.

    Forward-only (nothing requires grad, or grad mode is off):
    ``state["acc"]`` is updated in place (no second accumulator), one
    kernel launch per call. Differentiable (grad mode on and a scene table
    or ``state["acc"]`` requires grad): one pass only, out of place, through
    ``pathtrace_pass_diff`` with the backward of ``bwd_impl_for``;
    cotangents reach the groups of ``cfg.mega_grad_wrt``. More than one
    pass with grad raises: the in-launch multi-pass kernel has no
    backward.

    Without ``u_planes`` the draws of pass ``p`` are keyed by
    ``fold_in(PRNGKey(cfg.seed), p)``, which is ``state["key"]`` as
    ``init_state`` makes it; another key raises rather than render
    different draws than the state names.

    ``ray_offset`` (JAX's, under ``shard_map``): ``state["acc"]`` is a ray
    shard, rays ``[ray_offset, ray_offset + len(acc))`` of the film, and
    the launch keys pixel decode and draws by the global id (``ipar[1]``),
    so each ray is the whole film's. ``u_planes`` may then be the whole
    film's, (2 * n_draws, R): the shard's columns are taken after a zero
    pad (``ray_window``). A sharded accumulator runs row-major: the
    blocked layout's permutation would cross shards. ``supported`` checks
    the film's ray count, not the shard's."""
    supported(scene, cfg)
    if u_planes is None and not torch.equal(
            state["key"].to(torch.int64),
            rng.base_key(cfg.seed).to(torch.int64)):
        raise ValueError("state['key'] is not PRNGKey(cfg.seed): the kernel "
                         "keys its draws by cfg.seed")
    n_rays = state["acc"].shape[0]
    sharded = ray_offset != 0 or n_rays != cfg.total_rays
    if u_planes is not None and u_planes.shape[1] != n_rays:
        if u_planes.shape[1] != cfg.total_rays:
            raise ValueError(
                f"u_planes has {u_planes.shape[1]} columns: the shard's "
                f"{n_rays} or the film's {cfg.total_rays}")
        u_planes = ray_window(u_planes, ray_offset, n_rays, 1).contiguous()
    par, sph, tri, mat, lig = scene_tables(scene, cfg)
    ipar = torch.tensor([int(state["passes"]), ray_offset],
                        dtype=torch.int32)
    kw = dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
              two_sided=cfg.two_sided_triangles,
              normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
              russian_roulette=cfg.russian_roulette,
              rr_start_depth=cfg.rr_start_depth,
              grid=grid_tables(scene, sph, tri) if cfg.use_grid else None,
              chunks=chunk_tables(scene, cfg, sph, tri),
              block=0 if sharded else effective_block(cfg))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (par, sph, tri, mat, lig, state["acc"])):
        if n_passes != 1:
            raise ValueError(
                f"a differentiable call takes one pass, got n_passes="
                f"{n_passes}: call render_pass once per pass, or render "
                "under torch.no_grad()")
        cell = bwd_impl_for(scene, cfg) == "cell"
        # edge x grid: the primal walks the grids, the soft backward sweeps
        # the scene's own rows (scene_tables never duplicates a row), past
        # 64 triangles in Morton order
        soft_tri = (soft_tri_order(scene, tri, kw["chunks"])
                    if cfg.mega_edge_bandwidth > 0.0 else None)
        acc = MKG.pathtrace_pass_diff(
            par, ipar, sph, tri, mat, lig, state["acc"], u_planes,
            diff_wrt=cfg.mega_grad_wrt, bwd_cell=cell,
            soft_bandwidth=cfg.mega_edge_bandwidth,
            soft_tau=cfg.mega_edge_tau or cfg.mega_edge_bandwidth,
            soft_tri=soft_tri, **kw)
    else:
        acc = MK.pathtrace_pass(par, ipar, sph, tri, mat, lig, state["acc"],
                                u_planes, n_passes=n_passes, **kw)
    return {"acc": acc, "key": state["key"],
            "passes": int(state["passes"]) + n_passes}
