"""Kernel 4's tree instance (``ops/hit_kernels.py`` ``sphere_tree``,
``sphere_walk_reference``, ``csrc/hit_kernels.cu`` ``sphere_tree_kernel``)
on the CPU, and on the card where there is one.

Tables: sphere_field(64) and sphere_field(256), and a tie table
(sphere_field(128) with three spheres copied to a higher index, an exact
tie that the lower index must win, and every 9th sphere masked off, one
original of a copy among them). Rays, made with numpy from seeds (at most
2^12): uniform origins in [-6, 6]^3, half of them aimed at a sphere's
centre, the rest in uniform directions; every 16th dead at INF, every
16th (offset 5) dead at t = 1, every 7th with the window [0.5, 4], every
13th starting at a masked-on sphere's centre (the far root), every 11th
with a zero x component of its direction and every 22nd also a zero y.

What is held, exactly (no tolerance):

* (a) ``sphere_tree``'s layout: the sorted rows are the table's in ``perm``'s
  order, every masked-on row is in exactly one leaf's mask or in the loose
  list and no other row in either, every leaf's box contains its rows'
  boxes (centre -/+ |radius|) widened by ``MK.CHUNK_PAD`` of the rows'
  scale, every node's box contains its children's, the leaf slots past
  the last leaf are empty boxes as ``render/mega.chunk_tree``'s are, and a
  table built from parameters that require grad gives the same layout;
* (b) the plain emulation of the kernel's walk (``sphere_walk_reference``:
  the lane's order and pruning, the brute loop's arithmetic) gives
  ``sphere_search_reference``'s (t, idx) bit for bit at every leaf size,
  on the seeded rays and on every search of a small stage pass;
* (c) the wrapper on CPU tensors, given a tree, against JAX's
  ``sphere_search_pallas(interpret=True)`` on the same rows, with
  ``tests/test_torch_hit_kernels.py``'s tolerances (idx equal, t within
  rtol 1e-4: XLA's CPU build reorders the float32 arithmetic);
* (d) the wrapper refuses a malformed tree with a ValueError, and the C
  entry with cudaErrorInvalidValue (on the card);
* (e) on the card, each instance (the brute loop, and the tree walk at
  every leaf size) against the plain version bit for bit on those cases.
"""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.models.scenes import sphere_field
from raytracing_tpu_torch.ops import hit_kernels as HK
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import pathtracer as pt
from torch_threads import one_thread  # noqa: F401

N_RAYS = 2048
LEAVES = (1, 2, 4, 8, 16, 32)
TABLES = ("field64", "field256", "ties")
TIES = ((3, 100), (20, 50), (77, 110))    # (original, copy at a higher row)


def _table(name: str, device="cpu"):
    """(center, radius, mask) of a named table."""
    n = {"field64": 64, "field256": 256, "ties": 128}[name]
    sp = sphere_field(n).spheres
    c, r, m = sp.center.clone(), sp.radius.clone(), sp.mask.clone()
    if name == "ties":
        m[::9] = False                  # row 63 and 81 among them
        for src, dst in TIES:
            c[dst], r[dst], m[dst] = c[src], r[src], True
        c[118], r[118] = c[81], r[81]   # a copy of a masked-off sphere
    return c.to(device), r.to(device), m.to(device)


def _rows(name: str, device="cpu"):
    return HK.sphere_rows(*_table(name, device))


def _rays(rows: torch.Tensor, seed: int, n: int = N_RAYS):
    """(o, d, mint, maxt) float32 on the rows' device, as the module's
    docstring says."""
    g = np.random.default_rng(seed)
    c = rows[:, 0:3].cpu().numpy()
    on = np.flatnonzero(rows[:, 5].cpu().numpy() > 0)
    o = g.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    aim = c[g.choice(on, n)] - o
    d[::2] = aim[::2]
    inside = np.arange(0, n, 13)
    o[inside] = c[g.choice(on, inside.size)]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::11, 0] = 0.0
    d[::22, 1] = 0.0
    mint = np.zeros((n,), np.float32)
    maxt = np.full((n,), np.inf, np.float32)
    mint[::7], maxt[::7] = 0.5, 4.0
    mint[::16] = maxt[::16] = np.inf
    mint[5::16] = maxt[5::16] = 1.0
    return [torch.as_tensor(x, device=rows.device).contiguous()
            for x in (o, d, mint, maxt)]


def _bit_equal(got, want) -> None:
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert torch.equal(got[0].cpu(), want[0].cpu())


# ---------------------------------------------------------------------------
# (a) the layout
# ---------------------------------------------------------------------------

def _leaf_rows(tree: HK.SphereTree) -> np.ndarray:
    """(n_leaves, leaf) bool: the rows each leaf's mask names."""
    st = tree.tree
    words = st.masks.numpy().astype(np.int64) & 0xFFFFFFFF
    lane = np.arange(st.leaf)
    return ((words[:, lane // 32] >> (lane % 32)) & 1).astype(bool)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", TABLES)
def test_sphere_tree_layout(name, leaf):
    rows = _rows(name)
    tree = HK.sphere_tree(rows, leaf)
    s, st = rows.shape[0], tree.tree
    n = -(-s // leaf) * leaf
    assert tree.rows.shape == (n, 8) and tree.perm.shape == (n,)
    perm = tree.perm.numpy()
    assert sorted(perm[perm >= 0]) == list(range(s))
    assert (perm[s:] == -1).all()
    assert torch.equal(tree.rows[:s], rows[tree.perm[:s].long()])
    assert not tree.rows[s:].any()
    # every masked-on row once, in a leaf or loose; no other row
    named = _leaf_rows(tree).reshape(-1)
    loose = st.loose.numpy()
    loose = loose[loose >= 0]
    count = named.astype(int)
    np.add.at(count, loose, 1)
    on = np.zeros(n, bool)
    on[:s] = rows[tree.perm[:s].long(), 5].numpy() > 0
    np.testing.assert_array_equal(count, on.astype(int))
    assert loose.size == 0          # spheres of a field are never loose
    # boxes: each leaf holds its rows' widened boxes, each node its
    # children's; the slots past the last leaf are empty
    nodes = st.nodes.numpy()
    slots = st.n_slots
    c, r = tree.rows[:, 0:3].numpy(), np.abs(tree.rows[:, 3].numpy())
    cen, rad = rows[:, 0:3].numpy(), np.abs(rows[:, 3].numpy())
    live = rows[:, 5].numpy() > 0
    w = np.float32(MK.CHUNK_PAD) * (np.abs(cen[live]) + rad[live, None]).max()
    j = np.flatnonzero(named) // leaf
    box = nodes[slots + j]
    k = np.flatnonzero(named)
    assert (box[:, 0:3] <= c[k] - r[k, None] - w * (1 - 1e-6)).all()
    assert (box[:, 3:6] >= c[k] + r[k, None] + w * (1 - 1e-6)).all()
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


def test_sphere_tree_of_trained_rows_is_the_same():
    """Rows packed from parameters that require grad give the same layout,
    none of it requiring grad."""
    c, r, m = _table("field64")
    want = HK.sphere_tree(HK.sphere_rows(c, r, m), 4)
    c, r = c.clone().requires_grad_(True), r.clone().requires_grad_(True)
    got = HK.sphere_tree(HK.sphere_rows(c, r, m), 4)
    for a, b in zip((*got[:2], *got.tree[:3]), (*want[:2], *want.tree[:3])):
        assert not a.requires_grad and torch.equal(a, b)


def test_sphere_tree_loose_rows():
    """A sphere whose box spans at least ``MK.LOOSE_SHARE`` of the rows'
    box is loose: tested first, in no leaf and widening no box; a table
    with no masked-on row has only empty boxes."""
    c, r, m = _table("field64")
    r[5] = 20.0
    tree = HK.sphere_tree(HK.sphere_rows(c, r, m), 2)
    loose = tree.tree.loose.numpy()
    assert tree.perm[int(loose[0])].item() == 5 and (loose[1:] == -1).all()
    assert not _leaf_rows(tree).reshape(-1)[int(loose[0])]
    assert (tree.tree.nodes[1, 3:6] < 10.0).all()
    empty = HK.sphere_tree(HK.sphere_rows(c, r, torch.zeros_like(m)), 2)
    nodes = empty.tree.nodes[1:].numpy()
    assert (nodes[:, 0:3] == np.inf).all() and not empty.tree.masks.any()


# ---------------------------------------------------------------------------
# (b) the walk's plain emulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", TABLES)
def test_walk_emulation_equals_reference(name, leaf):
    rows = _rows(name)
    rays = _rays(rows, seed=leaf)
    want = HK.sphere_search_reference(*rays, rows)
    work = {}
    got = HK.sphere_walk_reference(*rays, HK.sphere_tree(rows, leaf), work)
    _bit_equal(got, want)
    hit = want[1].numpy()
    assert (hit >= 0).mean() > 0.3
    assert (hit[(rays[2] == rays[3]).numpy()] == -1).all()
    if name == "ties":
        assert np.isin(hit, [src for src, _ in TIES]).sum() > 20
        assert not np.isin(hit, [dst for _, dst in TIES]).any()
        assert not np.isin(hit, np.arange(0, 128, 9)).any()
        assert (hit == 118).any()       # its masked-off original never wins
    # the walk tests a fraction of the brute loop's rows (at most all of
    # them where a few leaves hold the table)
    live = (rays[2] != rays[3]).sum().item()
    assert work["sph_tests"] < live * rows.shape[0] / (2 if leaf <= 8 else 1)


def test_walk_emulation_on_a_stage_pass(monkeypatch):
    """Every search of a stage pass (sphere_field(64), the tree instance
    taken past 32 rows; 24x16, b2: camera, shadow and bounce rays) through
    the wrapper with the pass's tree, and the walk's emulation on the same
    rays: both equal the plain version."""
    monkeypatch.setattr(HK, "SPHERE_BRUTE_MAX", 32)
    scene = sphere_field(64, cols=24, rows=16)
    cfg = RenderConfig(width=24, height=16, bounces=2, use_pallas=True)
    seen = []
    search = HK.sphere_search_rows

    def spy(o, d, mint, maxt, rows, tree=None):
        seen.append((o, d, mint, maxt, rows, tree))
        return search(o, d, mint, maxt, rows, tree)

    monkeypatch.setattr(HK, "sphere_search_rows", spy)
    pt.render_pass(scene, pt.init_state(cfg, "cpu"), cfg)
    assert len(seen) == 6
    assert all(s[5] is seen[0][5] and s[5] is not None for s in seen)
    for o, d, mint, maxt, rows, tree in seen:
        want = HK.sphere_search_reference(o, d, mint, maxt, rows)
        _bit_equal(HK.sphere_walk_reference(o, d, mint, maxt, tree), want)


# ---------------------------------------------------------------------------
# (c) JAX parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["field64", "ties"])
def test_wrapper_with_tree_matches_pallas_interpret(name):
    import jax.numpy as jnp
    from raytracing_tpu.ops.pallas.hit_kernels import sphere_search_pallas
    c, r, m = _table(name)
    rows = HK.sphere_rows(c, r, m)
    rays = _rays(rows, seed=3, n=512)
    want = sphere_search_pallas(*(jnp.asarray(x.numpy())
                                  for x in (*rays, c, r, m)), interpret=True)
    before = HK.sphere_launches
    got = HK.sphere_search_rows(*rays, rows, HK.sphere_tree(rows))
    assert HK.sphere_launches == before      # CPU tensors: plain version
    wt, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), wi)
    fin = np.isfinite(wt)
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()), fin)
    assert fin.mean() > 0.3
    np.testing.assert_allclose(got[0].numpy()[fin], wt[fin], rtol=1e-4)
    _bit_equal(HK.sphere_walk_reference(*rays, HK.sphere_tree(rows, 8)),
               got)


# ---------------------------------------------------------------------------
# (d) malformed trees
# ---------------------------------------------------------------------------

def _malformed(tree: HK.SphereTree):
    """Each way a tree can be malformed, by name."""
    st = tree.tree
    t = st._replace
    return {
        "leaf 3": tree._replace(tree=t(leaf=3)),
        "leaf 64": tree._replace(tree=t(leaf=64)),
        "rows short": tree._replace(rows=tree.rows[:-2].contiguous()),
        "rows wide": tree._replace(rows=torch.zeros(
            (tree.rows.shape[0], 9))),
        "perm int64": tree._replace(perm=tree.perm.long()),
        "nodes short": tree._replace(tree=t(nodes=st.nodes[:-4]
                                            .contiguous())),
        "masks short": tree._replace(tree=t(masks=st.masks[:-1]
                                            .contiguous())),
        "loose short": tree._replace(tree=t(loose=st.loose[:-1]
                                            .contiguous())),
        "nodes strided": tree._replace(tree=t(nodes=st.nodes.t()
                                              .contiguous().t())),
        "a tuple": tuple(tree),
    }


def test_wrapper_refuses_malformed_tree():
    rows = _rows("field64")
    rays = _rays(rows, seed=5, n=64)
    tree = HK.sphere_tree(rows, 4)
    HK.sphere_search_rows(*rays, rows, tree)
    for what, bad in _malformed(tree).items():
        with pytest.raises(ValueError):
            HK.sphere_search_rows(*rays, rows, bad)
            pytest.fail(what)
    other = HK.sphere_tree(_rows("field256"), 4)
    with pytest.raises(ValueError, match="rows"):
        HK.sphere_search_rows(*rays, rows, other)


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TABLES)
def test_tree_kernel_bit_equals_plain_version(cuda, name, monkeypatch):
    """Each instance of kernel 4 on each table: the brute loop (the size
    threshold raised past the table) and the tree walk at every leaf size,
    bit for bit against the plain version."""
    rows = _rows(name, cuda)
    rays = _rays(rows, seed=11, n=4096)
    want = HK.sphere_search_reference(*rays, rows)
    monkeypatch.setattr(HK, "SPHERE_BRUTE_MAX", rows.shape[0])
    before = HK.sphere_launches, HK.sphere_tree_launches
    _bit_equal(HK.sphere_search_rows(*rays, rows), want)
    assert (HK.sphere_launches, HK.sphere_tree_launches) == (
        before[0] + 1, before[1])
    monkeypatch.setattr(HK, "SPHERE_BRUTE_MAX", 0)
    for leaf in LEAVES:
        before = HK.sphere_tree_launches
        got = HK.sphere_search_rows(*rays, rows, HK.sphere_tree(rows, leaf))
        torch.cuda.synchronize()
        assert HK.sphere_tree_launches == before + 1
        _bit_equal(got, want)


@pytest.mark.cuda
def test_tree_kernel_entry_refuses_malformed_tree(cuda):
    """The C entry checks the tree itself (pathtrace.cuh stream_ok and the
    rows it must hold): each malformed layout returns cudaErrorInvalidValue
    and writes nothing; the well-formed one launches."""
    rows = _rows("field64", cuda)
    o, d, mint, maxt = _rays(rows, seed=5, n=256)
    tree = HK.sphere_tree(rows, 4)
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
        return lib.rt_sphere_search(
            *p, rows.shape[0], *q, a["n_tree"], a["leaf"], a["n_slots"],
            a["n_loose"], a["walk"], t.data_ptr(), i.data_ptr(), 256,
            stream)

    for bad in (dict(leaf=3), dict(leaf=64), dict(n_slots=3),
                dict(n_slots=2), dict(n_loose=0), dict(n_loose=65),
                dict(n_tree=good["n_tree"] - 4),
                dict(n_tree=good["n_tree"] + 4), dict(walk=2)):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()
    assert (t == 7.0).all() and (i == 7).all()
    assert call() == 0
    _bit_equal((t, i), HK.sphere_search_reference(o, d, mint, maxt, rows))
