"""Kernel 1's grid mode over the triangle grids' cell-major copies
(``render/mega.grid_tables`` / ``grid_cells``, ``ops/megakernel.
CellCopy``) and the plain count of the kernel's cell walk
(``ops/megakernel.grid_walk_work``), on the CPU. The kernel itself is held
to the plain grid version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 17).

Scenes: the cornell box with the torus of
``tests/torch_grid_scenes.cornell_torus`` (256 triangles, its mesh grid
at n^3) and, for the walk, sphere_field(300) with the resident sphere
budget patched to 64 and its sphere grid rebuilt at n^3 (walked through
its CSR), at grid resolutions n = 1, 2, 3 and 5 (one cell of every row,
down to cells of none or one row) and leaves of 1 and 4 rows, each also
with its tables made from scene parameters that require grad (a table
being trained), whose layout must be the same; and a hand-built (4, 1,
1) grid of small triangles whose cells hold 0, 1, L and L + 1 rows.

What is held, exactly (no tolerance: the layout is integer bookkeeping and
float comparisons of the boxes the kernel reads):

* each cell's copied rows are its CSR items, in the Morton order of their
  centres, each the table's row, and ``perm`` names them; padding rows
  are zero rows with ``perm`` -1 and take part in no leaf;
* every node's box contains its children's, every leaf's box contains
  each of its rows' boxes widened by ``MK.CHUNK_PAD`` of the scene's
  scale, and a leaf with no row that has a box is empty;
* the walk, in the kernel's order (the march over the cells, each cell's
  tree nearest child first, pruned by the running champion), finds on
  every ray of a path pass b5, a pass with the roulette and a direct pass
  the plain grid version's champion and occlusion bit;
* a moved triangle and a changed radius give the current rows and boxes
  over the same cached layout;
* the wrapper raises on a missing or malformed copy.
"""
import dataclasses

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.accel.grid import build_grid, build_sphere_grid
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.models.scenes import sphere_field
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render.stages import _all_triangles
from torch_grid_scenes import cornell_torus
from torch_threads import one_thread  # noqa: F401

W, H = 16, 12
TORUS = (16, 8)
N_SPHERES = 300
RESOLUTIONS = (1, 2, 3, 5)


def _scene(kind: str, res: int, trained: bool, monkeypatch, w=W, h=H):
    """The torus scene (its mesh grid at res^3) or sphere_field(N_SPHERES)
    (its sphere grid at res^3), with the sphere centres and radii and the
    mesh's vertices requiring grad where ``trained``."""
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    if kind == "tri":
        sc = prepare_grids(cornell_torus(w, h, *TORUS), 2, mesh_slabs=res)
    else:
        sc = prepare_grids(sphere_field(N_SPHERES, cols=w, rows=h), 1)
        sc = dataclasses.replace(sc, mega_sph_grid=build_sphere_grid(
            sc.spheres, sc.sphere_bounds_min, sc.sphere_bounds_max, res))
    if not trained:
        return sc
    sp = replace(sc.spheres,
                 center=sc.spheres.center.clone().requires_grad_(True),
                 radius=sc.spheres.radius.clone().requires_grad_(True))
    meshes = tuple(replace(m, tris=replace(
        m.tris, v=m.tris.v.clone().requires_grad_(True))) for m in sc.meshes)
    return replace(sc, spheres=sp, meshes=meshes)


def _grid(res, trained, monkeypatch, leaf=None):
    """(scene, tables, the mesh grid, its copy, the triangle table) of the
    torus scene at grid resolution res (leaves of ``leaf`` rows)."""
    if leaf is not None:
        monkeypatch.setattr(MK, "GRID_LEAF", leaf)
    sc = _scene("tri", res, trained, monkeypatch)
    cfg = RenderConfig(width=W, height=H, use_megakernel=True, use_grid=True)
    tables = mega.scene_tables(sc, cfg)
    grid = mega.grid_tables(sc, tables[1], tables[2])
    g = grid.tri[0]
    assert g.n == (res,) * 3 and len(grid.copies) == 1
    cp = grid.copies[0]
    assert cp.leaf == MK.GRID_LEAF
    assert not any(t.requires_grad for t in cp[:4])
    return sc, tables, g, cp, tables[2].detach()


def _boxes(sc):
    """Each triangle's box (T, 3) twice, as grid_tables bounds it."""
    v = _all_triangles(sc).v.detach()
    return v.amin(1), v.amax(1)


@pytest.mark.parametrize("leaf", [1, 4])
@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("res", RESOLUTIONS)
def test_cell_rows_are_its_csr_items(monkeypatch, res, trained, leaf):
    """Each cell's copied rows are its CSR items (each once), in the Morton
    order of their centres against the grid's box, each the table's row
    (``perm`` names it); each cell's run is padded to whole leaves with
    zero rows whose ``perm`` is -1; a cell of more than one leaf has a
    power-of-two tree that holds its leaves, the others none."""
    sc, _, g, cp, table = _grid(res, trained, monkeypatch, leaf)
    off = g.cell_offsets.to(torch.int64)
    cen = _all_triangles(sc).v.detach().mean(1)
    code = mega._morton_codes(cen, torch.as_tensor(g.pmin),
                              torch.as_tensor(g.pmax))
    perm = cp.perm.to(torch.int64)
    taken = torch.zeros(perm.shape[0], dtype=torch.bool)
    for c in range(g.n_cells):
        row0, node0, slots, count = cp.cell[c].tolist()
        items = g.item_indices[off[c]:off[c + 1]].to(torch.int64)
        assert count == items.numel()
        leaves = -(-count // leaf)
        mine = perm[row0:row0 + count]
        assert sorted(mine.tolist()) == sorted(items.tolist())
        assert (code[mine][1:] >= code[mine][:-1]).all()
        assert torch.equal(cp.rows[row0:row0 + count], table[mine])
        pad = slice(row0 + count, row0 + leaves * leaf)
        assert (perm[pad] == -1).all() and (cp.rows[pad] == 0).all()
        taken[row0:row0 + leaves * leaf] = True
        if leaves >= 2:
            assert slots >= leaves > slots // 2 and slots & (slots - 1) == 0
            assert 0 <= node0 and node0 + 2 * slots <= cp.nodes.shape[0]
        else:
            assert slots == leaves and node0 == -1
    assert (perm[~taken] == -1).all()
    assert cp.rows.shape[0] % leaf == 0


@pytest.mark.parametrize("leaf", [1, 4])
@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("res", RESOLUTIONS)
def test_cell_boxes_contain_children_and_rows(monkeypatch, res, trained,
                                              leaf):
    """In each cell's tree every node's box contains its children's (an
    empty child, pmin +inf and pmax -inf, is contained in any box), leaf
    j's box contains the box of each of the cell's rows [j L, (j + 1) L)
    widened by the streamed tables' widening, and a leaf past the cell's
    rows (padding of the power-of-two tree) or with no row that has a box
    is empty."""
    sc, _, g, cp, _ = _grid(res, trained, monkeypatch, leaf)
    lo_n, hi_n = cp.nodes[:, 0:3], cp.nodes[:, 3:6]
    assert (cp.nodes[:, 6:] == 0).all()
    w = mega._pad_width(sc).item()
    lo_o, hi_o = _boxes(sc)
    perm = cp.perm.to(torch.int64)
    n_trees = 0
    for c in range(g.n_cells):
        row0, node0, slots, count = cp.cell[c].tolist()
        if slots < 2:
            continue
        n_trees += 1
        for k in range(1, slots):
            for ch in (2 * k, 2 * k + 1):
                a, b = node0 + k, node0 + ch
                if lo_n[b, 0] > hi_n[b, 0]:
                    continue
                assert (lo_n[a] <= lo_n[b]).all() and (hi_n[a] >= hi_n[b]).all()
        for j in range(slots):
            box_lo, box_hi = lo_n[node0 + slots + j], hi_n[node0 + slots + j]
            ids = perm[row0 + j * leaf:row0 + min((j + 1) * leaf, count)] \
                if j * leaf < count else perm[:0]
            live = ids[lo_o[ids, 0] <= hi_o[ids, 0]]
            if live.numel() == 0:
                assert box_lo[0] > box_hi[0]
                continue
            assert (box_lo <= lo_o[live] - w).all()
            assert (box_hi >= hi_o[live] + w).all()
    assert n_trees > 0


@pytest.mark.parametrize("res", RESOLUTIONS)
@pytest.mark.parametrize("mode", ["path", "roulette", "direct"])
@pytest.mark.parametrize("kind", ["tri", "sph"])
def test_cell_walk_keeps_every_champion_and_occluder(monkeypatch, kind,
                                                     mode, res):
    """The counting helper's walk (the march, each visited cell's rows
    directly or its tree nearest child first, pruned by the running
    champion; the sphere grid's cells every item through its CSR)
    against the plain grid version on every ray of one pass at 24x16
    (path b5, the roulette from depth 2, direct): the same champion on
    every live trace and the same bit on every live shadow ray; over the
    triangle grids fewer row tests than the march's over each cell's
    every item, over the sphere grid the march's raw tests."""
    sc = _scene(kind, res, False, monkeypatch, 24, 16)
    cfg = RenderConfig(width=24, height=16,
                       bounces=0 if mode == "direct" else 5,
                       use_megakernel=True, use_grid=True,
                       russian_roulette=mode == "roulette", rr_start_depth=2)
    tables = mega.scene_tables(sc, cfg)
    grid = mega.grid_tables(sc, tables[1], tables[2])
    work = {}
    out = MK.grid_walk_work(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((cfg.total_rays, 3)), None, grid=grid, spp=1, width=24,
        bounces=cfg.bounces, two_sided=False,
        normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
        russian_roulette=cfg.russian_roulette, rr_start_depth=2,
        mode="direct" if mode == "direct" else "path",
        key=rng.base_key(cfg.seed), work=work)
    key = f"{kind}_tests"
    assert out["traces"] > 0 and out["shadows"] > 0
    assert out["misses"] == 0 and out["occ_misses"] == 0
    assert out["cells"] == work["cells"]
    if kind == "tri":
        assert out["leaf_visits"] > 0 and 0 < out[key] < work[key + "_raw"]
    else:
        assert out[key] == work[key + "_raw"] and "node_tests" not in out


def _small_triangles(xs):
    """Rows (N, 32) and boxes of small triangles in the planes x = xs[i],
    around y = z = 0.5 (a ray along x at y = z = 0.5 hits each at x)."""
    from raytracing_tpu_torch.ops import intersect as I
    v = torch.tensor([[[x, 0.45, 0.45], [x, 0.55, 0.45], [x, 0.5, 0.55]]
                      for x in xs])
    tc = I.tri_constants(v)
    n = v.shape[0]
    tri = torch.cat([tc.n_geo, tc.c1, tc.c2, tc.e1, tc.e2, tc.k[:, None],
                     torch.zeros((n, 1)), torch.ones((n, 1)),
                     torch.zeros((n, 14))], -1)
    return tri, v.amin(1), v.amax(1)


@pytest.mark.parametrize("leaf", [1, 2, 4, 8])
def test_hand_built_cells_of_0_1_l_and_l_plus_1_rows(leaf):
    """A (4, 1, 1) grid whose cells hold 0, 1, L and L + 1 small
    triangles across the x axis: the cell table [first row, node 0,
    slots, items], the copy's rows, and the walk of a ray along the axis,
    of one above every triangle and of one that starts in the last cell
    (row and node tests exactly as the kernel makes them), closest hit and
    any hit."""
    n = [0, 1, leaf, leaf + 1]
    xs = [1.5] + [2.2 + 0.5 * k / leaf for k in range(n[2])]
    xs += [3.2 + 0.5 * k / (leaf + 1) for k in range(n[3])]
    tri, lo, hi = _small_triangles(xs)
    g = build_grid(lo.numpy(), hi.numpy(), np.zeros(3),
                   np.array([4.0, 1.0, 1.0]), (4, 1, 1))
    sc = sphere_field(4, cols=4, rows=4)
    cp = mega.grid_cells(sc, g, tri, lo, hi, lambda: (lo + hi) / 2, leaf)
    size = [0, leaf, leaf, 2 * leaf]
    row0 = np.cumsum([0] + size[:-1]).tolist()
    slots = [0, 1, 1, 2]
    assert cp.cell.tolist() == [[row0[k], 0 if k == 3 else -1, slots[k],
                                 n[k]] for k in range(4)]
    assert cp.perm.tolist() == ([0] + [-1] * (leaf - 1)
                                + list(range(1, 2 * leaf + 2))
                                + [-1] * (leaf - 1))
    assert torch.equal(cp.rows[cp.perm >= 0], tri[cp.perm[cp.perm >= 0]
                                                  .long()])
    o = torch.tensor([[-1.0, 0.5, 0.5], [-1.0, 0.9, 0.9], [3.05, 0.5, 0.5]])
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(3, 3).contiguous()
    mint, maxt = torch.zeros(3), torch.full((3,), 100.0)
    oxd = torch.linalg.cross(o, d)
    out = {}
    champ = (torch.full((3,), torch.inf), torch.full((3,), -1))
    bt, bo = MK._walk_cells(g, cp, o, d, oxd, mint, maxt, True, 0, True,
                            champ, out)
    # ray 0 hits the one-row cell's triangle, whose t ends its march; ray
    # 1 passes above every triangle through the 4 cells (the tree's root
    # box culls the last cell); ray 2 starts in the last cell and walks
    # its tree: the root, both leaves' boxes, the nearer leaf's rows,
    # whose first triangle culls the other leaf
    assert bo.tolist() == [0, -1, leaf + 1]
    assert bt[0].item() == pytest.approx(2.5, abs=1e-5)
    assert bt[2].item() == pytest.approx(0.15, abs=1e-5)
    assert out["cells"] == 2 + 4 + 1
    assert out["tri_tests"] == 1 + (1 + leaf) + leaf
    assert out["node_tests"] == 1 + 3
    assert out["leaf_visits"] == 1 + 2 + 1
    out = {}
    occ = MK._walk_cells(g, cp, o, d, oxd, mint, maxt, True, 0, False,
                         torch.zeros(3, dtype=torch.bool), out)
    assert occ.tolist() == [True, False, True]


@pytest.mark.parametrize("how", ["moved", "grown"])
def test_trained_table_gives_current_rows_and_boxes(monkeypatch, how):
    """A moved triangle (every vertex shifted) or a grown one (its
    vertices pushed from its centre): the copy's rows are the new table's,
    the boxes contain the new boxes, and the layout is the cached one (the
    same cell table, ``perm`` unchanged)."""
    sc, tables, g, cp, _ = _grid(3, False, monkeypatch)
    cfg = RenderConfig(width=W, height=H, use_megakernel=True, use_grid=True)
    m = sc.meshes[0]
    v = m.tris.v.clone()
    if how == "moved":
        v[5] = v[5] + torch.tensor([0.05, -0.03, 0.02])
    else:
        v[5] = v[5].mean(0) + 1.5 * (v[5] - v[5].mean(0))
    moved = replace(sc, meshes=(replace(m, tris=replace(m.tris, v=v)),))
    j = g.start + 5
    t2 = mega.scene_tables(moved, cfg)
    assert not torch.equal(t2[2][j], tables[2][j])
    cp2 = mega.grid_tables(moved, t2[1], t2[2]).copies[0]
    assert cp2.cell is cp.cell and torch.equal(cp2.perm, cp.perm)
    perm = cp2.perm.to(torch.int64)
    at = torch.nonzero(perm == j).squeeze(1)
    assert at.numel() >= 1
    assert torch.equal(cp2.rows[at], t2[2][j].expand(at.numel(), -1))
    lo, hi = _boxes(moved)
    w = mega._pad_width(moved).item()
    for pos in at.tolist():
        c = int(torch.nonzero(cp2.cell[:, 0] <= pos).max())
        row0, node0, slots, _ = cp2.cell[c].tolist()
        if slots < 2:
            continue
        box = cp2.nodes[node0 + slots + (pos - row0) // cp2.leaf]
        assert (box[0:3] <= lo[j] - w).all() and (box[3:6] >= hi[j] + w).all()


def test_wrapper_rejects_bad_copies(monkeypatch):
    """Grid mode without its cell-major copies, or with copies of the
    wrong leaf, shape or type, raises before any launch (the C side checks
    the descriptor, pathtrace.cuh grid_ok)."""
    sc, tables, _, cp, _ = _grid(2, False, monkeypatch)
    grid = mega.grid_tables(sc, tables[1], tables[2])
    acc = torch.zeros((W * H, 3))
    kw = dict(key=torch.zeros(2, dtype=torch.int32), spp=1, width=W,
              two_sided=False)
    for bad in (grid._replace(copies=None), grid._replace(copies=()),
                grid._replace(copies=(cp._replace(leaf=3),)),
                grid._replace(copies=(cp._replace(leaf=64),)),
                grid._replace(copies=(cp._replace(
                    rows=cp.rows[:, :8].contiguous()),)),
                grid._replace(copies=(cp._replace(
                    rows=cp.rows[:-1].contiguous()),)),
                grid._replace(copies=(cp._replace(perm=cp.perm.long()),)),
                grid._replace(copies=(cp._replace(
                    cell=cp.cell[:-1].contiguous()),)),
                grid._replace(copies=(cp._replace(
                    nodes=cp.nodes[:, :6].contiguous()),))):
        with pytest.raises(ValueError, match="grid"):
            MK.direct_pass(*tables, acc, None, grid=bad, **kw)
    # a cell whose rows run past the copy
    cell = cp.cell.clone()
    cell[-1, 0] = cp.rows.shape[0]
    cell[-1, 3] = 1
    with pytest.raises(ValueError, match="outside the copy"):
        MK.direct_pass(*tables, acc, None,
                       grid=grid._replace(copies=(cp._replace(cell=cell),)),
                       **kw)
    MK.direct_pass(*tables, acc, None, grid=grid, **kw)
