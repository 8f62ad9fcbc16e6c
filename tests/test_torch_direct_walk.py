"""Kernel 1's direct mode over a sphere tree (``MK.direct_walk_reference``,
``MK.sphere_walks``, ``MK.sphere_tree_build``; ``csrc/megakernel.cu``
``direct_kernel``'s kTree instances, ``csrc/sphere_tree.cu``) on the CPU,
and on the card where there is one.

Tables (spp 1, the ``u_planes_for_direct`` draws of a seeded key):
sphere_field(256) at 32x24 and 16x12, sphere_field(1024) at 32x24; the tie
and masked table (sphere_field(128) with three spheres copied to a higher
row, an exact tie that the lower row must win, and every 9th sphere masked
off, one original of a copy among them); the camera inside a sphere (a
sphere round the eye: every primary champion its far root); a light
behind a sphere (a sphere under the light occludes most shadow rays); and
a mixed table, cornell's room and ten wall triangles with sphere_field(
256)'s spheres shrunk into it, and one more triangle whose t on one ray
equals a sphere's exactly (the sphere, the lower id, must win).

What is held, exactly (no tolerance) unless stated:

* (a) the plain walk (``direct_walk_reference``: each trace and shadow
  ray walks the tree in the kernel's lane order and arithmetic) against
  the brute plain version (``direct_pass_reference``): ``acc``, ``ids`` and
  ``occs`` equal;
* (b) the walk's plain record against JAX's recording kernel in
  interpret mode (``pathtrace_pass_pallas(mode="direct", record=True)``) on
  the same tables and draws: every champion id equal, at most 1% of the
  occlusion bits apart and the accumulator within 2e-4
  (``tests/test_torch_direct_diff.py``'s gates for cornell; measured: no
  bit apart);
* (c) the route: the walk past ``MK.SPH_BRUTE_MAX["direct"]`` resident
  spheres and not at it or below it, never with a grid or streamed
  tables; on CPU tensors ``direct_pass`` runs the brute plain version;
* (d) the walk's counts (node and row tests, leaf visits, the warp
  unions) against what the tree and the rays allow;
* (e) the build's wrapper: its argument checks (the C entry's) as
  ValueErrors, and on CPU tensors ``MK.sphere_tree`` itself, whose loose
  list breaks ties by position; ``MK.pass_tree`` builds nothing on the
  CPU, and a differentiable direct pass asks for one tree, handed to its
  forward and to kernel 2's record;
* (f) on the card: the build kernel equals ``MK.sphere_tree``
  (``torch.equal``) on sphere_field(129, 1024, 4608), the tie and masked
  table and a table of tied loose rows, at leaves of 1, 2 and 32 rows;
  the walk instances' ``acc``, ``ids`` and ``occs`` equal the brute
  instances' (forced through ``direct_pass(sphere_walk=...)``) in the
  default build and the ``--fmad=false`` one; the in-kernel draws equal
  the u-planes; a differentiable direct pass builds one tree, which
  kernel 2's record walks; the C entries refuse malformed arguments with
  cudaErrorInvalidValue.
"""
import math

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.core.types import cross3
from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import mega
from torch_threads import one_thread  # noqa: F401

KEY_SEED = 5
EXACT_FLAGS = ("--fmad=false",)
SCENES = ("field256", "field1024", "ties", "inside", "behind", "mixed")
TIES = ((3, 100), (20, 50), (77, 110))    # (original, copy at a higher row)


def _field(n: int, w: int, h: int, device="cpu"):
    scene = sphere_field(n, cols=w, rows=h, device=device)
    cfg = RenderConfig(width=w, height=h, spp=1, bounces=0,
                       use_megakernel=True)
    return [x.contiguous() for x in mega.scene_tables(scene, cfg)]


def _tie_tables(w: int, h: int, device="cpu"):
    t = _field(128, w, h, device)
    sph = t[1].clone()
    sph[::9, 5] = 0.0
    for src, dst in TIES:
        sph[dst] = sph[src]
        sph[dst, 5] = 1.0
    t[1] = sph
    return t


def _with_sphere(t, center, radius):
    """The tables with one more sphere row (material 0), the scene's box
    (par[18:24], where the camera rays are clipped) grown to hold it."""
    t = list(t)
    row = torch.tensor([*center, radius, 0.0, 1.0, 0.0, 0.0],
                       device=t[1].device)
    t[1] = torch.cat([t[1], row[None]]).contiguous()
    par = t[0].clone()
    par[18:21] = torch.minimum(par[18:21], row[0:3] - radius)
    par[21:24] = torch.maximum(par[21:24], row[0:3] + radius)
    t[0] = par
    return t


def _camera_rays(t, w: int, u):
    return MK._camera_rays(t[0], u[0:2].t(), u.shape[1], 0, 1, w)


def _mixed_tables(w: int, h: int):
    """cornell's tables with sphere_field(256)'s spheres shrunk into the
    room beside its ten wall triangles, and one more triangle across a ray
    that hits a sphere, its constant moved by ulps until its t on that ray
    equals the sphere's exactly."""
    t = [x.contiguous() for x in mega.scene_tables(
        cornell_box(cols=w, rows=h), RenderConfig(width=w, height=h,
                                                  use_megakernel=True))]
    sph = _field(256, w, h)[1].clone()
    sph[:, 0:4] *= 0.2
    t[1] = sph
    walls = t[2]
    u = _draws(t, w, h)
    o, d, mint, maxt = _camera_rays(t, w, u)
    _, _, _, _, obj = MK._trace(o, d, mint, maxt, t[1], t[2][:0], False)
    r = int(torch.nonzero(obj >= 0)[len(torch.nonzero(obj >= 0)) // 2])
    tt = MK._trace(o[r:r + 1], d[r:r + 1], mint[r:r + 1], maxt[r:r + 1],
                   t[1], t[2][:0], False)[0]
    # a small triangle facing the ray (its geometric normal against the
    # ray: single-sided tables see it), through the ray's hit point
    from raytracing_tpu_torch.core.types import make_triangles, replace
    p = (o[r] + tt[0] * d[r]).tolist()
    v = torch.tensor([[p[0] - 0.05, p[1] - 0.05, p[2]],
                      [p[0] + 0.05, p[1] - 0.05, p[2]],
                      [p[0], p[1] + 0.07, p[2]]])
    for verts in (v, v.flip(0)):
        scene = replace(cornell_box(cols=w, rows=h),
                        triangles=make_triangles(verts[None]))
        row = mega.scene_tables(scene, RenderConfig(
            width=w, height=h, use_megakernel=True))[2].clone()
        if (row[0, 0:3] @ d[r]).item() > 0:
            break
    from raytracing_tpu_torch.ops import intersect as I
    oxd = cross3(o[r:r + 1], d[r:r + 1])

    def t_of(q):
        ok, tq, _, _ = I.triangle_hit(o[r:r + 1], d[r:r + 1], oxd,
                                      mint[r:r + 1], maxt[r:r + 1], q[0],
                                      False)
        return bool(ok[0]), float(tq[0])

    target = float(tt[0])
    for _ in range(4096):
        ok, tq = t_of(row)
        if ok and tq == target:
            break
        k = row[0, 15].item()
        row[0, 15] = float(np.nextafter(np.float32(k), np.float32(
            math.inf if (tq < target) == (row[0, 0:3] @ d[r] > 0).item()
            else -math.inf)))
    else:
        raise AssertionError("no triangle constant gives the sphere's t")
    t[2] = torch.cat([walls, row]).contiguous()
    return t, r


def _tables(name: str):
    """(tables, width) of a named case, on the CPU."""
    if name == "field256":
        return _field(256, 32, 24), 32
    if name == "field1024":
        return _field(1024, 32, 24), 32
    if name == "ties":
        return _tie_tables(32, 24), 32
    if name == "inside":
        t = _field(256, 16, 12)
        return _with_sphere(t, t[0][0:3].tolist(), 2.0), 16
    if name == "behind":
        t = _field(256, 16, 12)
        return _with_sphere(t, [0.0, 7.0, 0.0], 2.5), 16
    return _mixed_tables(16, 12)[0], 16


def _draws(t, w: int, h: int, key=None):
    key = rng.base_key(KEY_SEED) if key is None else key
    return MK.direct_draw_planes(key, w * h, t[4].shape[0], 1, t[0].device)


def _kw(w: int, **extra) -> dict:
    return dict(key=rng.base_key(KEY_SEED), spp=1, width=w,
                two_sided=False, **extra)


def _run(t, w: int, fn, **extra):
    n = w * w * 3 // 4
    u = _draws(t, w, n // w)
    acc = torch.zeros((n, 3), device=t[0].device)
    return fn(*t, acc, u, record=True, **_kw(w, **extra))


@pytest.fixture(scope="module", params=SCENES)
def case(request):
    """(name, tables, width, brute plain record, walk plain record and its
    counts)."""
    t, w = _tables(request.param)
    work: dict = {}
    return (request.param, t, w, _run(t, w, MK.direct_pass_reference),
            _run(t, w, MK.direct_walk_reference, work=work), work)


# ---------------------------------------------------------------------------
# (a) the plain walk against the brute plain version
# ---------------------------------------------------------------------------

def test_walk_reference_equals_brute_plain_version(case):
    name, t, w, want, got, _ = case
    for what, a, b in zip(("acc", "ids", "occs"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, what)
    ids, occs = want[1], want[2]
    assert (ids >= 0).any() and (ids < 0).any() or name == "inside"
    n_sph = t[1].shape[0]
    if name == "ties":
        # the rows copied to higher indices never win: their originals do
        for src, dst in TIES:
            assert not (ids == dst).any()
        assert any((ids == src).any() for src, _ in TIES)
        assert not (ids == 63).any() and not (ids == 81).any()  # masked
    if name == "inside":
        # every ray starts inside the last sphere and takes its far root
        u = _draws(t, w, ids.shape[1] // w)
        o, d, mint, maxt = _camera_rays(t, w, u)
        assert (ids == n_sph - 1).all()
        m = o - t[1][-1, 0:3]
        b = 2.0 * (m * d).sum(-1)
        near = (-b - torch.sqrt(b * b - 4.0 * (d * d).sum(-1)
                                * ((m * m).sum(-1) - 4.0))) / 2.0
        assert (near < mint).all()
    if name == "behind":
        # most shadow rays of the hits end at the sphere under the light
        assert occs[:, ids[0] >= 0].double().mean() > 0.5
    if name == "mixed":
        assert (ids >= n_sph).any()       # walls
        _, r = _mixed_tables(16, 12)
        assert 0 <= int(ids[0, r]) < n_sph  # the sphere wins the tie


@pytest.mark.parametrize("seed", [0, 7])
def test_walk_reference_equals_brute_without_record(seed):
    """Several passes from one key, no record, at 16x12."""
    t = _field(256, 16, 12)
    acc = torch.zeros((192, 3))
    kw = dict(key=rng.base_key(seed), spp=1, width=16, two_sided=False,
              n_passes=3)
    want = MK.direct_pass_reference(*t, acc, None, **kw)
    got = MK.direct_walk_reference(*t, acc, None, **kw)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (b) against JAX's recording kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 1024])
def test_walk_record_matches_jax(n):
    import jax
    from raytracing_tpu import RenderConfig as JaxConfig
    from raytracing_tpu.core import rng as jrng
    from raytracing_tpu.models.scenes import sphere_field as jax_field
    from raytracing_tpu.ops.pallas import megakernel as JMK
    from raytracing_tpu.render import mega as jmega
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        w, h = 32, 24
        js = jax_field(n, cols=w, rows=h)
        jcfg = JaxConfig(width=w, height=h, spp=1)
        tables = [np.asarray(x) for x in jmega.scene_tables(js, jcfg)]
        key = jrng.pass_key(jrng.base_key(0), 3)
        u = np.asarray(jmega.u_planes_for_direct(key, jcfg,
                                                 js.lights.count))
        jacc, jids, joccs = JMK.pathtrace_pass_pallas(
            tables[0], np.zeros(2, np.int32), *tables[1:],
            np.zeros((w * h, 3), np.float32), u, spp=1, width=w,
            bounces=0, two_sided=False, normalize_emitter=False, seed=0,
            mode="direct", interpret=True, record=True)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    t = [torch.as_tensor(np.array(x)) for x in tables]
    acc, ids, occs = MK.direct_walk_reference(
        *t, torch.zeros((w * h, 3)), torch.as_tensor(np.array(u)),
        key=rng.base_key(0), spp=1, width=w, two_sided=False, record=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (occs.numpy() != (np.asarray(joccs) > 0)).mean() <= 0.01
    assert (ids >= 0).any() and occs.any()
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# (c) the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_route_walks_past_the_brute_threshold(delta):
    n = MK.SPH_BRUTE_MAX["direct"] + delta
    sph = torch.zeros((n, 8))
    assert MK.sphere_walks(sph, mode="direct") == (delta > 0)
    fake = object()
    assert not MK.sphere_walks(sph, grid=fake, mode="direct")
    assert not MK.sphere_walks(sph, chunks=fake, mode="direct")


def test_route_keeps_cornell_brute():
    cornell = mega.scene_tables(cornell_box(cols=8, rows=6),
                                RenderConfig(width=8, height=6,
                                             use_megakernel=True))
    assert cornell[1].shape[0] == 2
    assert not MK.sphere_walks(cornell[1], mode="direct")
    assert MK.SPH_BRUTE_MAX["direct"] >= 2


def test_cpu_route_runs_the_brute_plain_version(monkeypatch):
    """On CPU tensors direct_pass runs direct_pass_reference whatever the
    table's size or the forced route, and counts no launch."""
    t = _field(256, 16, 12)
    monkeypatch.setitem(MK.SPH_BRUTE_MAX, "direct", 16)
    calls = []
    real = MK.direct_pass_reference
    monkeypatch.setattr(MK, "direct_pass_reference",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    before = (MK.direct_launches, MK.direct_walk_launches,
              MK.tree_build_launches)
    u = _draws(t, 16, 12)
    for walk in (None, True, False):
        got = MK.direct_pass(*t, torch.zeros((192, 3)), u, record=True,
                             sphere_walk=walk, **_kw(16))
        assert torch.equal(got[1], real(*t, torch.zeros((192, 3)), u,
                                        record=True, **_kw(16))[1])
    assert len(calls) == 3 and all("sph_tree" not in k for k in calls)
    assert (MK.direct_launches, MK.direct_walk_launches,
            MK.tree_build_launches) == before


def test_direct_tree_is_built_on_the_card_only():
    """pass_tree gives no tree for CPU tables, whatever their size, and
    none below the threshold or with a grid (no launch counted)."""
    before = MK.tree_build_launches
    limit = MK.SPH_BRUTE_MAX["direct"]
    for n in (limit, limit + 1, 1024):
        assert MK.pass_tree(torch.zeros((n, 8)), mode="direct") is None
    assert MK.pass_tree(torch.zeros((256, 8)), grid=object(),
                        mode="direct") is None
    assert MK.tree_build_launches == before


def test_differentiable_direct_pass_builds_one_tree(monkeypatch):
    """A differentiable direct pass on kernel 2's route (``_PassDiff``)
    asks for the sphere tree once, in its forward, and hands that tree to
    kernel 1's forward and to kernel 2's record. On CPU tensors the route
    runs its plain version, so the Function is driven here directly, with
    stand-ins for the tree and for kernel 2."""
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    t = _field(256, 8, 6)
    marker, asked, seen = object(), [], {}
    monkeypatch.setattr(MK, "pass_tree", lambda sph, grid=None,
                        chunks=None, mode="path": asked.append(
                            (sph.shape[0], mode)) or marker)
    real = MK.direct_pass

    def forward(*a, sph_tree=None, **k):
        seen["forward"] = sph_tree
        return real(*a, **k)

    def backward(par, ipar, sph, tri, mat, lig, g, u, *, sph_tree=None,
                 **k):
        seen["record"] = sph_tree
        return tuple(torch.zeros_like(x) for x in (par, sph, tri, mat, lig))

    monkeypatch.setattr(MK, "direct_pass", forward)
    monkeypatch.setattr(MKG, "pathtrace_pass_bwd", backward)
    sph = t[1].clone().requires_grad_(True)
    kw = dict(spp=1, width=8, bounces=0, two_sided=False,
              normalize_emitter=True, seed=0, russian_roulette=False,
              rr_start_depth=0)
    acc = MKG._PassDiff.apply(
        t[0], sph, t[2], t[3], t[4], torch.zeros((48, 3)),
        torch.tensor([0, 0], dtype=torch.int32), None, kw, ("sph",),
        dict(grid=None, chunks=None, block=0), "direct")
    acc.sum().backward()
    assert asked == [(256, "direct")]
    assert seen == {"forward": marker, "record": marker}
    assert sph.grad is not None


# ---------------------------------------------------------------------------
# (d) the counts
# ---------------------------------------------------------------------------

def test_walk_counts(case):
    name, t, w, want, _, work = case
    ids, occs = want[1], want[2]
    n_rays = ids.shape[1]
    shadows = int((ids >= 0).sum()) * t[4].shape[0]
    walks = n_rays + shadows
    n_sph = t[1].shape[0]
    for k in ("node_tests", "leaf_visits", "sph_tests"):
        assert work[k] > 0, (name, k)
    # leaves of one row: a visit tests its row unless masked off
    assert work["sph_tests"] <= work["leaf_visits"] + work.get(
        "loose_tests", 0)
    # every live walk tests the root: each primary ray in the scene's box
    # and each shadow ray
    u = _draws(t, w, n_rays // w)
    mint, maxt = _camera_rays(t, w, u)[2:]
    assert work["node_tests"] >= int((mint != maxt).sum()) + shadows
    # far fewer than the brute loops' tests on these fields
    assert work["sph_tests"] < walks * n_sph / 8, name
    assert 0 < work["union_leaves"] <= work["leaf_visits"]
    assert work["union_sph_tests"] <= work["sph_tests"]


def test_walk_counts_stop_at_the_first_occluder():
    """Shadow rays along -z through two spheres, both in their windows: the
    walk tests the nearer and stops (one row test per ray, not two); a
    trace tests it and culls the farther by the champion's t."""
    sph = torch.tensor([[0.0, 0.0, -6.0, 1.0, 0.0, 1.0, 0.0, 0.0],
                        [0.0, 0.0, -3.0, 1.0, 0.0, 1.0, 0.0, 0.0]])
    n = 16
    g = np.random.default_rng(3)
    o = torch.as_tensor(g.uniform(-0.1, 0.1, (n, 3)).astype(np.float32))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3).contiguous()
    mint, maxt = torch.zeros(n), torch.full((n,), 100.0)
    tree = MK.sphere_tree(sph, 1)
    work: dict = {}
    occ = MK._anyhit(o, d, mint, maxt, sph, sph.new_zeros((0, 32)),
                     False, work=work, sph_tree=tree)
    assert occ.all() and work["sph_tests"] == n
    work = {}
    obj = MK._trace(o, d, mint, maxt, sph, sph.new_zeros((0, 32)), False,
                    work=work, sph_tree=tree)[4]
    assert (obj == 1).all() and work["sph_tests"] == n


# ---------------------------------------------------------------------------
# (e) the build's wrapper
# ---------------------------------------------------------------------------

def _loose_ties_rows():
    return torch.tensor([[0, 0, 0, 5, 0, 1, 0, 0], [0, 0, 0, 5, 0, 1, 0, 0],
                         [1, 1, 1, 0.1, 0, 1, 0, 0], [3, 3, 3, 5, 0, 0, 0, 0],
                         [0, 0, 0, 5, 1, 1, 0, 0]], dtype=torch.float32)


@pytest.mark.parametrize("leaf", [1, 2, 32])
def test_build_wrapper_on_cpu_is_the_plain_tree(leaf):
    before = MK.tree_build_launches
    for rows in (_tie_tables(8, 6)[1], _loose_ties_rows()):
        a, b = MK.sphere_tree_build(rows, leaf), MK.sphere_tree(rows, leaf)
        for x, y in ((a.rows, b.rows), (a.perm, b.perm),
                     (a.tree.nodes, b.tree.nodes),
                     (a.tree.masks, b.tree.masks),
                     (a.tree.loose, b.tree.loose)):
            assert torch.equal(x, y)
    assert MK.tree_build_launches == before


def test_loose_ties_go_to_the_lower_position():
    """Three tied loose spheres (rows 0, 1 and 4: the same box) are listed
    in their sorted positions' order, ahead of -1."""
    tree = MK.sphere_tree(_loose_ties_rows(), 1)
    loose = tree.tree.loose.tolist()
    picked = [p for p in loose if p >= 0]
    assert len(picked) == 3 and picked == sorted(picked)
    assert sorted(tree.perm[picked].tolist()) == [0, 1, 4]
    assert loose[3:] == [-1] * (len(loose) - 3)


def test_build_wrapper_refuses_bad_arguments():
    rows = _field(64, 8, 6)[1]
    for bad, match in ((rows[:, :7].contiguous(), "rows"),
                       (rows.double(), "rows"), (rows.t(), "rows"),
                       (rows[:0], "at least one")):
        with pytest.raises(ValueError, match=match):
            MK.sphere_tree_build(bad, 1)
    for leaf in (0, 3, 64):
        with pytest.raises(ValueError, match="power of"):
            MK.sphere_tree_build(rows, leaf)


def test_plain_walk_refuses_grids_and_streams():
    t = _field(64, 8, 6)
    with pytest.raises(ValueError, match="resident"):
        MK.direct_pass_reference(*t, torch.zeros((48, 3)), None,
                                 sph_tree=MK.sphere_tree(t[1], 1),
                                 chunks=object(), **_kw(8))


# ---------------------------------------------------------------------------
# (f) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _tree_equal(a, b) -> bool:
    return a.tree.leaf == b.tree.leaf and all(torch.equal(x, y) for x, y in (
        (a.rows, b.rows), (a.perm, b.perm), (a.tree.nodes, b.tree.nodes),
        (a.tree.masks, b.tree.masks), (a.tree.loose, b.tree.loose)))


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", [1, 2, 32])
@pytest.mark.parametrize("name", ["129", "1024", "4608", "ties",
                                  "loose_ties"])
def test_build_kernel_equals_plain_tree(cuda, name, leaf):
    if name == "ties":
        rows = _tie_tables(8, 6, cuda)[1]
    elif name == "loose_ties":
        rows = _loose_ties_rows().to(cuda)
    else:
        rows = _field(int(name), 8, 6, cuda)[1]
    before = MK.tree_build_launches
    got = MK.sphere_tree_build(rows, leaf)
    torch.cuda.synchronize()
    assert MK.tree_build_launches == before + 1
    assert _tree_equal(got, MK.sphere_tree(rows, leaf))


def _card_tables(name: str, cuda):
    t, w = _tables(name)
    return [x.to(cuda) for x in t], w


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(), EXACT_FLAGS])
@pytest.mark.parametrize("name", SCENES + ("cornell",))
def test_walk_instance_bit_equals_brute_instance(cuda, name, flags):
    if name == "cornell":
        t = [x.contiguous() for x in mega.scene_tables(
            cornell_box(cols=32, rows=24, device=cuda),
            RenderConfig(width=32, height=24, use_megakernel=True))]
        w = 32
    else:
        t, w = _card_tables(name, cuda)
    n = w * w * 3 // 4
    u = _draws(t, w, n // w)
    kw = _kw(w, build_flags=flags)
    out = {}
    for walk in (False, True):
        before = (MK.direct_launches, MK.direct_walk_launches,
                  MK.tree_build_launches)
        rec = MK.direct_pass(*t, torch.zeros((n, 3), device=cuda), u,
                             record=True, sphere_walk=walk, **kw)
        acc = MK.direct_pass(*t, torch.zeros((n, 3), device=cuda), u,
                             sphere_walk=walk, **kw)
        prng = MK.direct_pass(*t, torch.zeros((n, 3), device=cuda), None,
                              record=True, sphere_walk=walk, **kw)
        torch.cuda.synchronize()
        assert (MK.direct_launches, MK.direct_walk_launches,
                MK.tree_build_launches) == (
            before[0] + 3, before[1] + 3 * walk, before[2] + 3 * walk)
        assert torch.equal(rec[0], acc) and torch.equal(prng[0], rec[0])
        assert torch.equal(prng[1], rec[1]) and torch.equal(prng[2], rec[2])
        out[walk] = rec
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    if flags:
        want = MK.direct_pass_reference(*t, torch.zeros((n, 3),
                                                        device=cuda), u,
                                        record=True, **_kw(w))
        for a, b in zip(out[True], want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_walk_route_by_size_on_the_card(cuda, monkeypatch):
    """Past SPH_BRUTE_MAX["direct"] the wrapper builds a tree and walks it;
    at it, the brute instance; both give the same record."""
    t = _field(256, 32, 24, cuda)
    u = _draws(t, 32, 24)
    recs = []
    for limit, walked in ((255, 1), (256, 0)):
        monkeypatch.setitem(MK.SPH_BRUTE_MAX, "direct", limit)
        before = MK.direct_walk_launches, MK.tree_build_launches
        recs.append(MK.direct_pass(*t, torch.zeros((768, 3), device=cuda),
                                   u, record=True, **_kw(32)))
        torch.cuda.synchronize()
        assert (MK.direct_walk_launches, MK.tree_build_launches) == (
            before[0] + walked, before[1] + walked)
    for a, b in zip(*recs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_direct_step_builds_one_tree_on_the_card(cuda):
    """A differentiable direct pass past the threshold on kernel 2's route
    builds one tree (the forward's), which kernel 2's record walks: that
    record equals one whose call builds its own, and a tree of another
    table is refused."""
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    t = _field(256, 32, 24, cuda)
    n = 768
    kw = dict(spp=1, width=32, bounces=0, two_sided=False,
              normalize_emitter=True, seed=0)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    sph = t[1].clone().requires_grad_(True)
    before = (MK.tree_build_launches, MK.direct_walk_launches,
              MKG.large_launches)
    acc = MKG.pathtrace_pass_diff(t[0], ipar, sph, *t[2:],
                                  torch.zeros((n, 3), device=cuda), None,
                                  mode="direct", diff_wrt=("sph",), **kw)
    torch.mean(acc ** 2).backward()
    torch.cuda.synchronize()
    assert (MK.tree_build_launches, MK.direct_walk_launches,
            MKG.large_launches) == (before[0] + 1, before[1] + 1,
                                    before[2] + 1)
    assert torch.isfinite(sph.grad).all() and sph.grad.any()
    g = torch.ones((n, 3), device=cuda)
    rec = dict(kw, russian_roulette=False, rr_start_depth=0, mode="direct",
               grid=None, chunks=None, block=0)
    tree = MK.pass_tree(t[1], mode="direct")
    a = MKG._record(t[0], ipar, *t[1:], g, None, sph_tree=tree, **rec)
    b = MKG._record(t[0], ipar, *t[1:], g, None, **rec)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="pass_tree"):
        MK.direct_pass(*t, torch.zeros((n, 3), device=cuda), None,
                       sph_tree=MK.pass_tree(t[1][:200].contiguous(),
                                             mode="direct"),
                       **_kw(32))


@pytest.mark.cuda
def test_entries_refuse_malformed_arguments(cuda):
    """rt_sphere_tree and rt_direct_pass's tree argument: each malformed
    one returns cudaErrorInvalidValue and writes nothing."""
    t = _field(256, 16, 12, cuda)
    rows = t[1]
    lib = MK._build.load("sphere_tree", MK._TREE_SIGNATURES)
    tree = MK.sphere_tree(rows, 1)
    st = tree.tree
    outs = [tree.rows.clone().fill_(7.0), tree.perm.clone().fill_(7),
            st.nodes.clone().fill_(7.0), st.masks.clone().fill_(7),
            st.loose.clone().fill_(7)]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    good = dict(s=256, leaf=1, slots=st.n_slots, n_loose=64)

    def build(**kw):
        a = {**good, **kw}
        return lib.rt_sphere_tree(rows.data_ptr(), a["s"], a["leaf"],
                                  a["slots"], MK.CHUNK_PAD, MK.LOOSE_SHARE,
                                  a["n_loose"],
                                  *(x.data_ptr() for x in outs), stream)

    for bad in (dict(s=0), dict(s=8193), dict(leaf=3), dict(leaf=64),
                dict(slots=128), dict(slots=512), dict(n_loose=0),
                dict(n_loose=65)):
        assert build(**bad) == 1, bad
    torch.cuda.synchronize()
    assert all((x == 7).all() for x in outs)
    assert build() == 0
    torch.cuda.synchronize()
    assert _tree_equal(MK.SphereTree(outs[0], outs[1], MK.StreamTree(
        outs[2], outs[3], outs[4], 1)), tree)

    mk = MK._lib(None, None, ())
    acc = torch.full((192, 3), 7.0, device=cuda)
    gargs, _ = MK._grid_args(None, None, rows.shape[0], 0)
    k0, k1 = rng.key_words(rng.base_key(1))

    def direct(desc, n_sph=256):
        import ctypes
        return mk.rt_direct_pass(
            t[0].data_ptr(), rows.data_ptr(), n_sph, None, 0,
            t[3].data_ptr(), t[3].shape[0], t[4].data_ptr(), t[4].shape[0],
            acc.data_ptr(), 192, 0, None, k0, k1, 0, 0, 1, 1, 16, 0, None,
            None, None, *gargs, ctypes.addressof(desc), 0, stream)

    def desc(**kw):
        d = MK._tree_desc(tree)
        for k, v in kw.items():
            setattr(d, k, v)
        return d

    for bad in (desc(n=255), desc(n=300), desc(leaf=3), desc(leaf=64),
                desc(n_slots=3), desc(n_loose=0), desc(n_loose=65),
                desc(node=None), desc(perm=None)):
        assert direct(bad) == 1
    assert direct(desc(), n_sph=0) == 1
    torch.cuda.synchronize()
    assert (acc == 7.0).all()
    assert direct(desc()) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all() and not (acc == 7.0).all()
