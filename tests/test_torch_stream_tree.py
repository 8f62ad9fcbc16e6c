"""The walk's layout over kernel 1's streamed tables
(``render/mega.chunk_tree``, ``ops/megakernel.StreamTree``) and the plain
count of the kernel's walk over it (``ops/megakernel.tree_walk_work``),
on the CPU. The kernel itself is held to the plain streamed version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 21).

Scenes, as ``tests/test_torch_stream.py`` streams them: the cornell box
with the torus of ``tests/torch_grid_scenes.cornell_torus`` (266
triangles, 3 chunks) and sphere_field(300) with the resident sphere budget
patched to 64 (3 chunks); each at every leaf size the kernel takes (each
power of two up to 128 rows), and each also with its tables made from
scene parameters that require grad (a table being trained), whose layout
must be the same.

What is held, exactly (no tolerance: the layout is integer bookkeeping and
float comparisons of the boxes the kernel reads):

* every row of the table is in exactly one leaf's mask or in the loose
  list, padding rows in none;
* every node's box contains its children's boxes, and every leaf's box
  contains each of its rows' boxes widened by ``MK.CHUNK_PAD`` of the
  scene's scale;
* the walk, in the kernel's order and pruned by its running champion,
  finds on every ray of a path pass b5, a pass with the roulette and a
  direct pass the plain streamed version's champion and occlusion bit
  (so it never culls the leaf that holds them);
* the loose rule picks cornell's 10 walls on the torus scene and no
  sphere of the field;
* the walk's per-ray counts on a hand-built three-row case;
* the wrapper raises on a missing or malformed layout.
"""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.models.scenes import sphere_field
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render.stages import _all_triangles
from torch_grid_scenes import cornell_torus

W, H = 16, 12
TORUS = (16, 8)
N_SPHERES = 300
LEAVES = (1, 2, 4, 8, 16, 32, 64, 128)


def _scene(name: str, trained: bool, monkeypatch, w=W, h=H):
    """The torus scene or sphere_field(N_SPHERES) (streamed with the
    resident budget patched), with its sphere centres and radii and the
    mesh's vertices requiring grad where ``trained``."""
    if name == "torus":
        sc = cornell_torus(w, h, *TORUS)
    else:
        monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
        sc = sphere_field(N_SPHERES, cols=w, rows=h)
    if not trained:
        return sc
    sp = replace(sc.spheres,
                 center=sc.spheres.center.clone().requires_grad_(True),
                 radius=sc.spheres.radius.clone().requires_grad_(True))
    meshes = tuple(replace(m, tris=replace(
        m.tris, v=m.tris.v.clone().requires_grad_(True))) for m in sc.meshes)
    return replace(sc, spheres=sp, meshes=meshes)


def _stream(name: str, trained: bool, monkeypatch, leaf: int):
    monkeypatch.setattr(MK, "STREAM_LEAF", leaf)
    sc = _scene(name, trained, monkeypatch)
    cfg = RenderConfig(width=W, height=H, use_megakernel=True)
    tables = mega.scene_tables(sc, cfg)
    assert tables[2 if name == "torus" else 1].requires_grad == trained
    chunks = mega.chunk_tables(sc, cfg, tables[1], tables[2])
    st = chunks.tri if name == "torus" else chunks.sph
    assert st is not None and st.tree is not None
    assert not any(t.requires_grad for t in st.tree[:3])
    return sc, tables, chunks, st


def _bits(masks: torch.Tensor, leaf: int) -> torch.Tensor:
    """(n_leaves, L) bool: the rows each leaf's mask names (a word's bits
    past a leaf of fewer than 32 rows are clear)."""
    words = masks.to(torch.int64) & 0xFFFFFFFF
    b = ((words[:, :, None] >> torch.arange(32)) & 1).reshape(
        masks.shape[0], -1).bool()
    assert not b[:, leaf:].any()
    return b[:, :leaf]


def _row_boxes(name: str, sc, st):
    """The sorted rows' boxes (N, 3) twice, as chunk_tables bounds them
    (rows without a box: +inf / -inf)."""
    perm = st.perm.to(torch.int64)
    keep = perm >= 0
    n = perm.shape[0]
    lo = torch.full((n, 3), torch.inf)
    hi = torch.full((n, 3), -torch.inf)
    if name == "torus":
        v = _all_triangles(sc).v.detach()
        lo[keep], hi[keep] = v.amin(1)[perm[keep]], v.amax(1)[perm[keep]]
    else:
        c = sc.spheres.center.detach()[perm[keep]]
        r = sc.spheres.radius.detach()[perm[keep]][:, None]
        lo[keep], hi[keep] = c - r, c + r
    return lo, hi


@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", ["torus", "spheres"])
def test_rows_in_one_leaf_or_loose(monkeypatch, name, leaf, trained):
    """Every row of the table takes part in exactly one leaf or is loose;
    padding rows (perm -1) in none; leaf j's mask names rows [j L, (j + 1)
    L) only; the tree's slots the least power of two over the leaves."""
    _, tables, _, st = _stream(name, trained, monkeypatch, leaf)
    tree = st.tree
    n_rows = st.rows.shape[0]
    assert tree.leaf == leaf
    assert tree.masks.shape == (n_rows // leaf, -(-leaf // 32))
    slots = tree.n_slots
    assert slots >= n_rows // leaf > slots // 2 or slots == 1
    in_leaf = _bits(tree.masks, leaf).reshape(-1)
    loose = tree.loose.to(torch.int64)
    is_loose = torch.zeros(n_rows, dtype=torch.long)
    is_loose.index_add_(0, loose[loose >= 0],
                        torch.ones(int((loose >= 0).sum()),
                                   dtype=torch.long))
    taken = in_leaf.long() + is_loose
    real = st.perm >= 0
    n_table = tables[2 if name == "torus" else 1].shape[0]
    assert int(real.sum()) == n_table
    assert (taken[real] == 1).all()
    assert (taken[~real] == 0).all()
    # -1 only after the last loose position
    k = int((loose >= 0).sum())
    assert (loose[:k] >= 0).all() and (loose[k:] == -1).all()


@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", ["torus", "spheres"])
def test_boxes_contain_children_and_rows(monkeypatch, name, leaf, trained):
    """Each node's box contains its children's (an empty child, pmin +inf
    and pmax -inf, is contained in any box), each leaf's box contains the
    box of each row its mask names widened by the chunks' widening, and a
    leaf whose mask is empty has the empty box."""
    sc, _, _, st = _stream(name, trained, monkeypatch, leaf)
    tree = st.tree
    slots = tree.n_slots
    lo_n, hi_n = tree.nodes[:, 0:3], tree.nodes[:, 3:6]
    assert (tree.nodes[:, 6:] == 0).all()
    for k in range(1, slots):
        for c in (2 * k, 2 * k + 1):
            if lo_n[c, 0] > hi_n[c, 0]:
                continue
            assert (lo_n[k] <= lo_n[c]).all() and (hi_n[k] >= hi_n[c]).all()
    w = mega._pad_width(sc).item()
    lo_r, hi_r = _row_boxes(name, sc, st)
    bits = _bits(tree.masks, leaf)
    for j in range(tree.masks.shape[0]):
        rows = torch.nonzero(bits[j]).squeeze(1) + j * leaf
        box_lo, box_hi = lo_n[slots + j], hi_n[slots + j]
        if rows.numel() == 0:
            assert (box_lo == torch.inf).all() and (box_hi == -torch.inf).all()
            continue
        assert (box_lo <= lo_r[rows] - w).all()
        assert (box_hi >= hi_r[rows] + w).all()
    for j in range(tree.masks.shape[0], slots):
        assert lo_n[slots + j, 0] > hi_n[slots + j, 0]


@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("mode", ["path", "roulette", "direct"])
@pytest.mark.parametrize("name", ["torus", "spheres"])
def test_walk_keeps_every_champion_and_occluder(monkeypatch, name, mode,
                                                trained):
    """The counting helper's walk (loose rows, then nearest child first,
    pruned by the running champion) against the plain streamed version on
    every ray of one pass at 24x16 (path b5, the roulette from depth 2,
    direct): the same champion on every live trace and the same bit on
    every live shadow ray; on the torus it tests fewer rows than the
    Morton chunks."""
    sc = _scene(name, trained, monkeypatch, 24, 16)
    cfg = RenderConfig(width=24, height=16,
                       bounces=0 if mode == "direct" else 5,
                       use_megakernel=True,
                       russian_roulette=mode == "roulette", rr_start_depth=2)
    tables = mega.scene_tables(sc, cfg)
    chunks = mega.chunk_tables(sc, cfg, tables[1], tables[2])
    work = {}
    out = MK.tree_walk_work(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((cfg.total_rays, 3)), None, chunks=chunks, spp=1,
        width=24, bounces=cfg.bounces, two_sided=False,
        normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
        russian_roulette=cfg.russian_roulette, rr_start_depth=2,
        mode="direct" if mode == "direct" else "path",
        key=rng.base_key(cfg.seed), work=work)
    kind = "tri_tests" if name == "torus" else "sph_tests"
    assert out["traces"] > 0 and out["shadows"] > 0
    assert out["misses"] == 0 and out["occ_misses"] == 0
    assert out["leaf_visits"] > 0 and 0 < out[kind]
    assert out["union_leaves"] <= out["leaf_visits"]
    if name == "torus":
        assert out[kind] < work[kind]
        assert out["loose_tests"] > 0
    else:
        assert "loose_tests" not in out


@pytest.mark.parametrize("trained", [False, True])
def test_loose_rule_picks_the_walls(monkeypatch, trained):
    """The loose rows are cornell's 10 walls on the torus scene (room-sized:
    each spans the scene box's longest side) and none of sphere_field's
    spheres."""
    _, _, _, st = _stream("torus", trained, monkeypatch, 32)
    loose = st.tree.loose.to(torch.int64)
    picked = st.perm[loose[loose >= 0]].tolist()
    assert sorted(picked) == list(range(10))
    _, _, _, st = _stream("spheres", trained, monkeypatch, 32)
    assert (st.tree.loose == -1).all()


def _three_rows(loose_row: int | None):
    """One chunk of three spheres on the x axis (rows 0 and 1 on the first
    ray, row 2 alone on the second; the third ray passes below the box),
    its tree built by hand: leaves of 32 rows, so 4 leaves and a tree of 4
    slots whose only non-empty leaf is leaf 0; ``loose_row`` out of the
    leaf and first in the loose list."""
    sph = torch.zeros((3, MK.SPH_COLS))
    sph[:, 0:6] = torch.tensor([[5.0, 0, 0, 1, 0, 1], [10.0, 0, 0, 1, 0, 1],
                                [15.0, 3, 0, 1, 0, 1]])
    perm = torch.full((MK.STREAM_CHUNK,), -1, dtype=torch.int32)
    perm[:3] = torch.arange(3, dtype=torch.int32)
    rows = torch.cat([sph, sph.new_zeros((MK.STREAM_CHUNK - 3, 8))])
    live = [r for r in range(3) if r != loose_row]
    lo = sph[live, 0:3] - sph[live, 3:4]
    hi = sph[live, 0:3] + sph[live, 3:4]
    empty = [np.inf] * 3 + [-np.inf] * 3 + [0, 0]
    leaf0 = torch.cat([lo.amin(0), hi.amax(0), torch.zeros(2)])
    nodes = torch.tensor([[0.0] * 8, leaf0.tolist(), leaf0.tolist(), empty,
                          leaf0.tolist(), empty, empty, empty])
    masks = torch.zeros((4, 1), dtype=torch.int32)
    masks[0, 0] = sum(1 << r for r in live)
    loose = torch.full((MK.LOOSE_MAX,), -1, dtype=torch.int32)
    if loose_row is not None:
        loose[0] = loose_row
    box = torch.tensor([[4.0, -1, -1, 16, 4, 1, 0, 0]])
    tree = MK.StreamTree(nodes=nodes, masks=masks, loose=loose, leaf=32)
    return sph, MK.Stream(rows=rows, boxes=box, perm=perm, tree=tree)


@pytest.mark.parametrize("loose_row", [None, 1])
def test_walk_counts_three_rows(loose_row):
    """The walk's counts per ray on the hand-built case: a ray in the box
    tests the root, both children of the root and of node 2 (5 slab tests:
    the empty nodes are tested and missed) and the leaf's rows, a trace
    all of them, a shadow ray those up to its first occluder; the ray
    below the box tests the root alone. A loose row is tested first by
    every live ray (so a shadow ray it occludes walks no node) and not
    again in the leaf."""
    sph, st = _three_rows(loose_row)
    o = torch.tensor([[0.0, 0, 0], [0.0, 3, 0], [0.0, -5, 0]])
    d = torch.tensor([[1.0, 0, 0]]).expand(3, 3).contiguous()
    mint, maxt = torch.zeros(3), torch.full((3,), 100.0)
    a = (d * d).sum(1)
    inv2a = 0.5 / a
    oxd = torch.linalg.cross(o, d)
    n_loose = 0 if loose_row is None else 1
    out = {}
    occ = MK._walk_tree("sph", st, o, d, a, inv2a, oxd, mint, maxt, False,
                        3, False, torch.zeros(3, dtype=torch.bool), out, 32)
    assert occ.tolist() == [True, True, False]
    if loose_row is None:
        # ray 0 stops at row 0, ray 1 tests rows 0-2, ray 2 none
        assert out == {"node_tests": 3 + 2 * 2 * 2, "leaf_visits": 2,
                       "sph_tests": 1 + 3, "union_leaves": 1,
                       "union_sph_tests": 3}
    else:
        # loose row 1 occludes ray 0 at once; rays 1 and 2 test it, miss
        assert out == {"sph_tests": 1 + 1 + 1 + 2, "loose_tests": 3,
                       "node_tests": 2 + 2 * 2, "leaf_visits": 1,
                       "union_leaves": 1, "union_sph_tests": 2}
    out = {}
    champ = (torch.full((3,), torch.inf), torch.full((3,), -1))
    bt, bo = MK._walk_tree("sph", st, o, d, a, inv2a, oxd, mint, maxt,
                           False, 3, True, champ, out, 32)
    assert bo.tolist() == [0, 2, -1]
    assert bt[:2].tolist() == [4.0, 14.0]
    assert out["sph_tests"] == 2 * 3 + n_loose
    assert out["node_tests"] == 3 + 2 * 2 * 2
    assert out["leaf_visits"] == 2


def test_wrapper_rejects_malformed_tree():
    """A stream without its tree, or with a tree of the wrong shapes or
    types, raises before any launch (the C side checks the same)."""
    sc = cornell_torus(8, 8, *TORUS)
    cfg = RenderConfig(width=8, height=8, bounces=0, use_megakernel=True)
    tables = mega.scene_tables(sc, cfg)
    chunks = mega.chunk_tables(sc, cfg, tables[1], tables[2])
    acc = torch.zeros((64, 3))
    kw = dict(key=torch.zeros(2, dtype=torch.int32), spp=1, width=8,
              two_sided=False)
    st = chunks.tri
    t = st.tree
    for bad in (st._replace(tree=None),
                st._replace(tree=t._replace(masks=t.masks[:-1].contiguous())),
                st._replace(tree=t._replace(masks=torch.zeros(
                    (t.masks.shape[0] // 2, 2), dtype=torch.int32))),
                st._replace(tree=t._replace(nodes=t.nodes[:, :6]
                                            .contiguous())),
                st._replace(tree=t._replace(nodes=torch.cat(
                    [t.nodes, t.nodes]))),
                st._replace(tree=t._replace(loose=t.loose.long()))):
        with pytest.raises(ValueError, match="stream"):
            MK.direct_pass(*tables, acc, None,
                           chunks=chunks._replace(tri=bad), **kw)
    MK.direct_pass(*tables, acc, None, chunks=chunks, **kw)
