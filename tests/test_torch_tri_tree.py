"""Kernel 5's tree instance (``ops/hit_kernels.py`` ``triangle_tree``,
``triangle_walk_reference``, ``pass_triangle_tree``,
``csrc/hit_kernels.cu`` ``triangle_tree_kernel``, the build's triangle
instance in ``csrc/sphere_tree.cu``) on the CPU, and on the card where
there is one.

Tables: "soup" (384 seeded triangles, centres in [-4, 4]^3, corners within
0.6), "ties" (a soup of 256 with three triangles copied to a higher row,
exact ties that the lower index must win, and every 9th masked off, one
original of a copy among them) and "torus" (cornell plus the 992-face
torus of ``tests/torch_grid_scenes.py``: 1,002 triangles, cornell's 10
walls the loose rows). Rays, made with numpy from seeds: uniform origins
in the table's box, half aimed at a masked-on triangle's centroid, the
rest in uniform directions; every 16th dead at INF, every 16th (offset 5)
dead at t = 1, every 7th with a short window, every 11th with a zero x
component of its direction and every 22nd also a zero y.

What is held, exactly (no tolerance) unless stated:

* (a) ``triangle_tree``'s layout at leaves of 1, 2 and 4 rows: the sorted
  rows are the table's in ``perm``'s order, every masked-on row is in
  exactly one leaf's mask or in the loose list and no other row in
  either, every leaf's box contains its rows' vertex boxes widened by
  ``MK.CHUNK_PAD`` of the table's largest |coordinate|, every node's box
  contains its children's, cornell's walls are loose, and a table built
  from vertices that require grad gives the same layout;
* (b) the plain walk (``triangle_walk_reference``: the kernel lane's
  order and culling, the brute loop's arithmetic) gives
  ``triangle_search_reference``'s (t, idx) bit for bit, single- and
  two-sided, at every leaf size, with dead rays, short windows, zero
  direction components and rays in the planes of cornell's axis-aligned
  walls;
* (c) the same on every search of a 16x12 b5 stage pass over the torus
  scene, whose one tree per pass the searches share;
* (d) the wrapper on CPU tensors, given a tree, against JAX's
  ``triangle_search_pallas(interpret=True)`` on
  ``tests/test_torch_hit_kernels.py``'s kind of table and rays (from a
  shell outside the cloud) with its tolerances (idx equal, t within rtol
  1e-6: the two packages' cross products may round the last bit of a
  row's constants apart; on rays that start inside a soup, where t = (k -
  o.n) / div cancels more, 2 of 145 hits of the brute loop and the walk
  alike differed from JAX's by 1.3e-6 relative);
* (e) the wrapper refuses a malformed tree, and a table past
  ``HK.TRIANGLE_BRUTE_MAX`` without one, with a ValueError;
* (f) on the card (marker ``cuda``): each instance bit-equal to the plain
  version, the build equal to ``triangle_tree`` element for element, the
  C entries refusing a malformed tree or bad arguments.
"""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core.types import make_triangles
from raytracing_tpu_torch.ops import hit_kernels as HK
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import pathtracer as pt
from raytracing_tpu_torch.render import stages
from torch_grid_scenes import cornell_torus
from torch_threads import one_thread  # noqa: F401

N_RAYS = 2048
LEAVES = (1, 2, 4)
TABLES = ("soup", "ties", "torus")
TIES = ((3, 100), (20, 50), (77, 110))    # (original, copy at a higher row)
TORUS = (31, 16)                          # 992 faces, as chip_smoke.py's


def _soup(n: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    return (g.uniform(-4.0, 4.0, (n, 1, 3))
            + g.uniform(-0.6, 0.6, (n, 3, 3))).astype(np.float32)


def _table(name: str, device="cpu"):
    """(v (T, 3, 3), mask (T,)) of a named table."""
    if name == "torus":
        tris = stages._all_triangles(cornell_torus(8, 8, *TORUS))
        return tris.v.to(device), tris.mask.to(device)
    v = _soup(384 if name == "soup" else 256, 17)
    mask = np.ones(v.shape[0], bool)
    if name == "ties":
        mask[::9] = False               # row 63 and 81 among them
        for src, dst in TIES:
            v[dst], mask[dst] = v[src], True
        v[118] = v[81]                  # a copy of a masked-off triangle
    tris = make_triangles(v, device=device)
    return tris.v, torch.as_tensor(mask, device=device)


def _rows(name: str, device="cpu"):
    v, mask = _table(name, device)
    return v, HK.triangle_rows(v, mask)


def _rays(v: torch.Tensor, rows: torch.Tensor, seed: int, n: int = N_RAYS):
    """(o, d, mint, maxt) float32 on the rows' device, as the module's
    docstring says."""
    g = np.random.default_rng(seed)
    vv = v.cpu().numpy()
    cen = vv.mean(1)
    on = np.flatnonzero(rows[:, 17].cpu().numpy() > 0)
    lo, hi = vv.reshape(-1, 3).min(0), vv.reshape(-1, 3).max(0)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    aim = cen[g.choice(on, n)] - o
    d[::2] = aim[::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::11, 0] = 0.0
    d[::22, 1] = 0.0
    mint = np.zeros((n,), np.float32)
    maxt = np.full((n,), np.inf, np.float32)
    mint[::7], maxt[::7] = 0.05, 1.5
    mint[::16] = maxt[::16] = np.inf
    mint[5::16] = maxt[5::16] = 1.0
    return [torch.as_tensor(x, device=rows.device).contiguous()
            for x in (o, d, mint, maxt)]


def _wall_rays(n: int = 1536):
    """Rays in the planes of cornell's walls (at +-0.99 on each axis):
    origins on a wall's plane, directions with no component along its
    axis (div exactly 0 against that wall), the rest uniform."""
    g = np.random.default_rng(23)
    o = g.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    ax = np.arange(n) % 3
    side = np.where(np.arange(n) % 2 == 0, -0.99, 0.99).astype(np.float32)
    o[np.arange(n), ax] = side
    d[np.arange(n), ax] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.zeros((n,), np.float32)
    maxt = np.full((n,), np.inf, np.float32)
    return [torch.as_tensor(x).contiguous() for x in (o, d, mint, maxt)]


def _bit_equal(got, want) -> None:
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert torch.equal(got[0].cpu(), want[0].cpu())


# ---------------------------------------------------------------------------
# (a) the layout
# ---------------------------------------------------------------------------

def _leaf_rows(tree: HK.TriangleTree) -> np.ndarray:
    """(n_leaves, leaf) bool: the rows each leaf's mask names."""
    st = tree.tree
    words = st.masks.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    lane = np.arange(st.leaf)
    return ((words[:, lane // 32] >> (lane % 32)) & 1).astype(bool)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", TABLES)
def test_triangle_tree_layout(name, leaf):
    v, rows = _rows(name)
    tree = HK.triangle_tree(v, rows, leaf)
    t, st = rows.shape[0], tree.tree
    n = -(-t // leaf) * leaf
    assert tree.rows.shape == (n, 20) and tree.perm.shape == (n,)
    perm = tree.perm.numpy()
    assert sorted(perm[perm >= 0]) == list(range(t))
    assert (perm[t:] == -1).all()
    assert torch.equal(tree.rows[:t], rows[tree.perm[:t].long()])
    assert not tree.rows[t:].any()
    # every masked-on row once, in a leaf or loose; no other row
    named = _leaf_rows(tree).reshape(-1)
    loose = st.loose.numpy()
    loose = loose[loose >= 0]
    count = named.astype(int)
    np.add.at(count, loose, 1)
    on = np.zeros(n, bool)
    on[:t] = rows[tree.perm[:t].long(), 17].numpy() > 0
    np.testing.assert_array_equal(count, on.astype(int))
    if name == "torus":
        # cornell's 10 walls span the room: loose, and only they
        assert sorted(perm[loose]) == list(range(10))
    else:
        assert loose.size == 0
    # boxes: each leaf holds its rows' widened vertex boxes, each node its
    # children's; the slots past the last leaf are empty
    nodes = st.nodes.numpy()
    slots = st.n_slots
    vs = v.numpy()[np.maximum(perm, 0)]
    live = rows[:, 17].numpy() > 0
    w = np.float32(MK.CHUNK_PAD) * np.abs(v.numpy()[live]).max()
    k = np.flatnonzero(named)
    box = nodes[slots + k // leaf]
    assert (box[:, 0:3] <= vs[k].min(1) - w * (1 - 1e-6)).all()
    assert (box[:, 3:6] >= vs[k].max(1) + w * (1 - 1e-6)).all()
    for p in range(1, slots):
        for ch in (2 * p, 2 * p + 1):
            if nodes[ch, 0] > nodes[ch, 3]:
                continue
            assert (nodes[p, 0:3] <= nodes[ch, 0:3]).all()
            assert (nodes[p, 3:6] >= nodes[ch, 3:6]).all()
    n_leaves = n // leaf
    assert (nodes[slots + n_leaves:, 0:3] == np.inf).all()
    assert (nodes[slots + n_leaves:, 3:6] == -np.inf).all()
    assert st.masks.shape == (n_leaves, 1)
    assert st.loose.shape == (min(MK.LOOSE_MAX, n),)


def test_triangle_tree_of_trained_vertices_is_the_same():
    """Rows packed from vertices that require grad give the same layout,
    none of it requiring grad."""
    v, mask = _table("ties")
    want = HK.triangle_tree(v, HK.triangle_rows(v, mask), 2)
    v = v.clone().requires_grad_(True)
    got = HK.triangle_tree(v, HK.triangle_rows(v, mask), 2)
    for a, b in zip((*got[:2], *got.tree[:3]), (*want[:2], *want.tree[:3])):
        assert not a.requires_grad and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (b) the plain walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("name", TABLES)
def test_triangle_walk_equals_reference(name, two_sided):
    v, rows = _rows(name)
    rays = _rays(v, rows, seed=3 + two_sided)
    want = HK.triangle_search_reference(*rays, rows, two_sided)
    hit = want[1].numpy()
    assert (hit >= 0).mean() > 0.2
    assert (hit[(rays[2] == rays[3]).numpy()] == -1).all()
    if name == "ties":
        assert np.isin(hit, [src for src, _ in TIES]).sum() > 5
        assert not np.isin(hit, [dst for _, dst in TIES]).any()
        assert not np.isin(hit, np.arange(0, 256, 9)).any()
        assert (hit == 118).any()       # its masked-off original never wins
    live = (rays[2] != rays[3]).sum().item()
    for leaf in LEAVES:
        work = {}
        got = HK.triangle_walk_reference(*rays, HK.triangle_tree(v, rows,
                                                                 leaf),
                                         two_sided, work)
        _bit_equal(got, want)
        # the walk tests a fraction of the brute loop's rows
        assert work["tri_tests"] < live * rows.shape[0] / 4


@pytest.mark.parametrize("two_sided", [False, True])
def test_triangle_walk_on_rays_in_the_walls_planes(two_sided):
    """Rays that lie in the planes of cornell's walls (the loose rows):
    the walk and the brute loop agree, the walls in the rays' planes are
    never hit (div is 0 exactly), and the others are."""
    v, rows = _rows("torus")
    rays = _wall_rays()
    want = HK.triangle_search_reference(*rays, rows, two_sided)
    _bit_equal(HK.triangle_walk_reference(*rays, HK.triangle_tree(v, rows),
                                          two_sided), want)
    hit = want[1].numpy()
    ax = np.arange(hit.size) % 3
    # walls 0-1 are z = -0.99, 2-3 y = -0.99, 4-5 y = 0.99, 6-7 x = -0.99,
    # 8-9 x = 0.99
    wall_axis = np.array([2, 2, 1, 1, 1, 1, 0, 0, 0, 0])
    walls = (hit >= 0) & (hit < 10)
    assert walls.mean() > 0.3
    assert (wall_axis[hit[walls]] != ax[walls]).all()


# ---------------------------------------------------------------------------
# (c) a stage pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("two_sided", [False, True])
def test_triangle_walk_on_a_stage_pass(monkeypatch, two_sided):
    """Every triangle search of a stage pass over the torus scene (16x12,
    b5: camera, shadow and bounce rays; the threshold patched low), with
    the pass's one tree, through the wrapper and the plain walk: both
    equal the plain brute version."""
    monkeypatch.setattr(HK, "TRIANGLE_BRUTE_MAX", 16)
    scene = cornell_torus(16, 12, *TORUS)
    cfg = RenderConfig(width=16, height=12, bounces=5, use_pallas=True,
                       two_sided_triangles=two_sided)
    seen = []
    search = HK.triangle_search_rows

    def spy(o, d, mint, maxt, rows, ts=False, tree=None):
        seen.append((o, d, mint, maxt, rows, ts, tree))
        return search(o, d, mint, maxt, rows, ts, tree)

    monkeypatch.setattr(HK, "triangle_search_rows", spy)
    pt.render_pass(scene, pt.init_state(cfg, "cpu"), cfg)
    assert len(seen) == 12
    assert all(s[6] is seen[0][6] and s[6] is not None for s in seen)
    for o, d, mint, maxt, rows, ts, tree in seen:
        assert ts == two_sided
        want = HK.triangle_search_reference(o, d, mint, maxt, rows, ts)
        _bit_equal(HK.triangle_walk_reference(o, d, mint, maxt, tree, ts),
                   want)


def test_pass_trees_are_built_by_size(monkeypatch):
    """``hit_tables`` builds each tree once per pass, by the table's size:
    none up to the thresholds, the torch build on the CPU past them (no
    launch counted); the wrapper's plain version takes the brute loop's
    arithmetic either way."""
    scene = cornell_torus(8, 8, *TORUS)
    cfg = RenderConfig(width=8, height=8, use_pallas=True)
    tables = stages.hit_tables(scene, cfg)
    assert tables.sph_tree is None and tables.tri is not None
    assert isinstance(tables.tri_tree, HK.TriangleTree)
    v = stages._all_triangles(scene).v
    want = HK.triangle_tree(v, tables.tri)
    for a, b in zip((*tables.tri_tree[:2], *tables.tri_tree.tree[:3]),
                    (*want[:2], *want.tree[:3])):
        assert torch.equal(a, b)
    monkeypatch.setattr(HK, "TRIANGLE_BRUTE_MAX", 1002)
    assert stages.hit_tables(scene, cfg).tri_tree is None
    counts = (HK.triangle_build_launches, HK.torch_tree_builds,
              MK.tree_build_launches)
    monkeypatch.setattr(HK, "SPHERE_BRUTE_MAX", 1)
    assert isinstance(stages.hit_tables(scene, cfg).sph_tree, MK.SphereTree)
    assert (HK.triangle_build_launches, HK.torch_tree_builds,
            MK.tree_build_launches) == counts


# ---------------------------------------------------------------------------
# (d) JAX parity
# ---------------------------------------------------------------------------

def _cloud(n: int = 160):
    """``tests/test_torch_hit_kernels.py``'s kind of table, larger: a
    seeded cloud of n triangles (corners within 1.2 of points in [-2,
    2]^3), two exact duplicates (ties to the lower index) and two rows
    masked off; and its kind of rays (from a shell above the cloud toward
    points near the origin; every 8th dead at INF, every 16th dead at a
    finite t, every 5th with a short window)."""
    g = np.random.default_rng(31)
    v = (g.uniform(-2.0, 2.0, (n, 1, 3))
         + g.uniform(-1.2, 1.2, (n, 3, 3))).astype(np.float32)
    v[90], v[130] = v[2], v[17]
    mask = np.ones((n,), bool)
    mask[[4, 25]] = False
    r = 384
    o = g.uniform(-6.0, 6.0, (r, 3)).astype(np.float32)
    o[:, 2] = np.abs(o[:, 2]) + 3.0
    d = g.uniform(-2.0, 2.0, (r, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mint = np.zeros((r,), np.float32)
    maxt = np.full((r,), 40.0, np.float32)
    mint[::5], maxt[::5] = 4.0, 9.0
    mint[::8] = maxt[::8] = np.inf
    mint[3::16] = maxt[3::16] = 2.5
    return [torch.as_tensor(x) for x in (v, mask, o, d, mint, maxt)]


@pytest.mark.parametrize("two_sided", [False, True])
def test_wrapper_with_tree_matches_pallas_interpret(monkeypatch, two_sided):
    import jax.numpy as jnp
    from raytracing_tpu.ops.pallas.hit_kernels import triangle_search_pallas
    monkeypatch.setattr(HK, "TRIANGLE_BRUTE_MAX", 32)
    v, mask, *rays = _cloud()
    rows = HK.triangle_rows(v, mask)
    want = triangle_search_pallas(*(jnp.asarray(x.numpy())
                                    for x in (*rays, v, mask)),
                                  two_sided=two_sided, interpret=True)
    before = HK.triangle_launches
    got = HK.triangle_search_rows(*rays, rows, two_sided,
                                  HK.triangle_tree(v, rows))
    assert HK.triangle_launches == before      # CPU tensors: plain version
    wt, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), wi)
    assert not np.isin(wi, [4, 25, 90, 130]).any()
    fin = np.isfinite(wt)
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()), fin)
    assert fin.sum() >= 100
    np.testing.assert_allclose(got[0].numpy()[fin], wt[fin], rtol=1e-6)
    _bit_equal(HK.triangle_walk_reference(*rays, HK.triangle_tree(v, rows, 4),
                                          two_sided), got)
    _bit_equal(HK.triangle_search(*rays, v, mask, two_sided), got)


# ---------------------------------------------------------------------------
# (e) malformed trees
# ---------------------------------------------------------------------------

def _malformed(tree: HK.TriangleTree):
    """Each way a tree can be malformed, by name."""
    st = tree.tree
    t = st._replace
    return {
        "leaf 3": tree._replace(tree=t(leaf=3)),
        "leaf 64": tree._replace(tree=t(leaf=64)),
        "rows short": tree._replace(rows=tree.rows[:-2].contiguous()),
        "rows narrow": tree._replace(rows=torch.zeros(
            (tree.rows.shape[0], 8))),
        "rows misaligned": tree._replace(rows=torch.zeros(
            tree.rows.numel() + 1)[1:].view(tree.rows.shape)),
        "perm int64": tree._replace(perm=tree.perm.long()),
        "nodes short": tree._replace(tree=t(nodes=st.nodes[:-4]
                                            .contiguous())),
        "masks short": tree._replace(tree=t(masks=st.masks[:-1]
                                            .contiguous())),
        "loose short": tree._replace(tree=t(loose=st.loose[:-1]
                                            .contiguous())),
        "nodes strided": tree._replace(tree=t(nodes=st.nodes.t()
                                              .contiguous().t())),
        "a sphere tree": MK.SphereTree(*tree),
        "a tuple": tuple(tree),
    }


def test_wrapper_refuses_malformed_tree():
    v, rows = _rows("soup")
    rays = _rays(v, rows, seed=7, n=64)
    tree = HK.triangle_tree(v, rows, 4)
    HK.triangle_search_rows(*rays, rows, False, tree)
    for what, bad in _malformed(tree).items():
        with pytest.raises(ValueError):
            HK.triangle_search_rows(*rays, rows, False, bad)
            pytest.fail(what)
    other = HK.triangle_tree(*_rows("ties"), 4)
    with pytest.raises(ValueError, match="rows"):
        HK.triangle_search_rows(*rays, rows, False, other)


def test_wrapper_refuses_a_missing_tree(monkeypatch):
    """Past ``TRIANGLE_BRUTE_MAX`` the packed rows alone cannot be
    searched: the wrapper raises on every device, naming the builder; up
    to it the brute loop needs none."""
    v, rows = _rows("soup")
    rays = _rays(v, rows, seed=9, n=64)
    with pytest.raises(ValueError, match="pass_triangle_tree"):
        HK.triangle_search_rows(*rays, rows, False)
    monkeypatch.setattr(HK, "TRIANGLE_BRUTE_MAX", rows.shape[0])
    _bit_equal(HK.triangle_search_rows(*rays, rows, False),
               HK.triangle_search_reference(*rays, rows, False))


# ---------------------------------------------------------------------------
# (f) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TABLES)
def test_tree_kernel_bit_equals_plain_version(cuda, name, monkeypatch):
    """Each instance of kernel 5 on each table, single- and two-sided: the
    brute loop (the threshold raised past the table) and the tree walk at
    every leaf size, bit for bit against the plain version."""
    v, rows = _rows(name, cuda)
    rays = _rays(v, rows, seed=11, n=8192)
    for two_sided in (False, True):
        want = HK.triangle_search_reference(*rays, rows, two_sided)
        monkeypatch.setattr(HK, "TRIANGLE_BRUTE_MAX", rows.shape[0])
        before = HK.triangle_launches, HK.triangle_tree_launches
        _bit_equal(HK.triangle_search_rows(*rays, rows, two_sided), want)
        assert (HK.triangle_launches, HK.triangle_tree_launches) == (
            before[0] + 1, before[1])
        monkeypatch.setattr(HK, "TRIANGLE_BRUTE_MAX", 0)
        for leaf in LEAVES:
            before = HK.triangle_tree_launches
            got = HK.triangle_search_rows(
                *rays, rows, two_sided, HK.triangle_tree_build(v, rows,
                                                               leaf))
            torch.cuda.synchronize()
            assert HK.triangle_tree_launches == before + 1
            _bit_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TABLES)
def test_tree_build_equals_torch_build(cuda, name):
    """The card's one-launch build against ``triangle_tree`` on the card,
    element for element, at every leaf size; one launch counted each."""
    v, rows = _rows(name, cuda)
    for leaf in LEAVES + (32,):
        before = HK.triangle_build_launches
        got = HK.triangle_tree_build(v, rows, leaf)
        torch.cuda.synchronize()
        assert HK.triangle_build_launches == before + 1
        want = HK.triangle_tree(v, rows, leaf)
        for a, b in zip((*got[:2], *got.tree[:3]),
                        (*want[:2], *want.tree[:3])):
            assert torch.equal(a, b)
        assert got.tree.leaf == want.tree.leaf


@pytest.mark.cuda
def test_tree_kernel_entry_refuses_malformed_tree(cuda):
    """The C entry checks the tree itself (pathtrace.cuh stream_ok and the
    rows it must hold): each malformed layout returns cudaErrorInvalidValue
    and writes nothing; the well-formed one launches. The build's entry
    refuses bad arguments the same way."""
    v, rows = _rows("soup", cuda)
    o, d, mint, maxt = _rays(v, rows, seed=5, n=256)
    tree = HK.triangle_tree(v, rows, 4)
    lib = HK._build.load("hit_kernels", HK._SIGNATURES)
    t = torch.full((256,), 7.0, device=cuda)
    i = torch.full((256,), 7, dtype=torch.int32, device=cuda)
    st = tree.tree
    good = dict(n_tree=tree.rows.shape[0], leaf=st.leaf, n_slots=st.n_slots,
                n_loose=st.loose.shape[0], walk=1)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    p = [x.data_ptr() for x in (o, d, mint, maxt, rows)]
    q = [x.data_ptr() for x in (tree.rows, tree.perm, st.nodes, st.masks,
                                st.loose)]

    def call(**kw):
        a = {**good, **kw}
        return lib.rt_triangle_search(
            *p, rows.shape[0], *q, a["n_tree"], a["leaf"], a["n_slots"],
            a["n_loose"], a["walk"], 0, t.data_ptr(), i.data_ptr(), 256,
            stream)

    for bad in (dict(leaf=3), dict(leaf=64), dict(n_slots=3),
                dict(n_slots=good["n_slots"] // 2), dict(n_loose=0),
                dict(n_loose=65), dict(n_tree=good["n_tree"] - 4),
                dict(n_tree=good["n_tree"] + 4), dict(walk=2)):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()
    assert (t == 7.0).all() and (i == 7).all()
    assert call() == 0
    _bit_equal((t, i), HK.triangle_search_reference(o, d, mint, maxt, rows,
                                                    False))
    build = MK._build.load("sphere_tree", MK._TREE_SIGNATURES)
    out = HK.triangle_tree_build(v, rows, 4)
    n = rows.shape[0]
    args = dict(v=v.data_ptr(), s=n, leaf=4, slots=out.tree.n_slots,
                n_loose=out.tree.loose.shape[0])
    for bad in (dict(v=None), dict(s=0), dict(s=MK.TREE_BUILD_MAX + 1),
                dict(leaf=3), dict(slots=out.tree.n_slots * 2),
                dict(n_loose=0), dict(n_loose=65)):
        a = {**args, **bad}
        assert build.rt_triangle_tree(
            rows.data_ptr(), a["v"], a["s"], a["leaf"], a["slots"],
            MK.CHUNK_PAD, MK.LOOSE_SHARE, a["n_loose"], out.rows.data_ptr(),
            out.perm.data_ptr(), out.tree.nodes.data_ptr(),
            out.tree.masks.data_ptr(), out.tree.loose.data_ptr(),
            stream) == 1, bad
