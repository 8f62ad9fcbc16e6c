"""Kernel 1's path mode over a sphere tree (``MK.pathtrace_walk_reference``,
``MK.sphere_walks``, ``MK.pass_tree``; ``csrc/megakernel.cu``
``pathtrace_kernel``'s kTree instances) on the CPU, and on the card where
there is one.

Tables (``tests/test_torch_direct_walk.py``'s, spp 1, b5, the u-planes of
pass 2): sphere_field(256) and sphere_field(1024) at 32x24; the tie and
masked table (sphere_field(128), three spheres copied to a higher row, an
exact tie that the lower row must win, every 9th sphere masked off); the
camera inside a sphere (every primary champion its far root); a light
behind a sphere (the sphere under the light occludes the shadow rays of
the hits); and cornell's room with sphere_field(256)'s spheres shrunk into
it and one more triangle whose t on one camera ray equals a sphere's
exactly (the sphere, the lower id, must win). Each with and without
Russian roulette (from depth 1).

What is held, exactly (no tolerance) unless stated:

* (a) the plain walk (``pathtrace_walk_reference``: each trace and shadow
  ray of every segment walks the tree in the kernel's lane order and
  arithmetic) against the brute plain version (``pathtrace_pass_reference``):
  ``acc``, ``ids`` and ``occs`` equal, recording and not;
* (b) the walk's plain record against JAX's recording kernel in interpret
  mode (``pathtrace_pass_pallas(record=True)``) on sphere_field(256) at
  32x24 b5, the same tables and u-planes: every primary champion equal,
  at most 1% of all id slots apart, and of the occlusion bits of the
  segments whose champion both name, and the accumulator within
  ``chip_smoke.py``'s SPHERE_GATES (at most 5% of rays beyond 2e-4, the
  mean within 5e-3). JAX's interpret-mode loop rounds otherwise at
  silhouettes, and a bounce ray that leaves one by another champion
  differs from there on: measured, the brute plain version and the walk
  alike, 2 of 4,608 id slots apart, both past the third bounce, and 1.4%
  of rays beyond 2e-4;
* (c) the route: the walk past ``MK.SPH_BRUTE_MAX["path"]`` resident
  spheres and not at it or below it (threshold -1, 0, +1), cornell brute,
  never with a grid or streamed tables; on CPU tensors ``pathtrace_pass``
  runs the brute plain version whatever the route;
* (d) one tree per differentiable pass: on kernel 2's route
  (``_PassDiff``) the forward asks for one tree (``MK.pass_tree``, path
  mode) and hands it to kernel 1 and to kernel 2's record; on the cell
  route (``_PassDiffCell``) one call of kernel 1, which builds its own;
* (e) the walk's counts (node and row tests, leaf visits, the warp
  unions) against what the tree and the rays allow, and a shadow ray of
  a pass's NEE stopping at its first occluder;
* (f) on the card: the tree instances' ``acc``, ``ids`` and ``occs`` equal
  the brute instances' (forced through ``pathtrace_pass(sphere_walk=...)``)
  in the default build and the ``--fmad=false`` one, path and the
  roulette, recording and not, u-planes and the in-kernel draws, on
  sphere_field(256) and (1024); the ``--fmad=false`` tree record equals
  the plain walk on every id and bit, its accumulator within 2e-4; the
  route by size; one tree build per differentiable
  pass on both routes and per render call of 16 passes; the C entry
  refuses a malformed tree with cudaErrorInvalidValue.
"""
import ctypes

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from test_torch_direct_walk import TIES, _field, _mixed_tables, _tables
from torch_threads import one_thread  # noqa: F401

B = 5
RR_START = 1
PASS = 2
EXACT_FLAGS = ("--fmad=false",)
SCENES = ("field256", "field1024", "ties", "inside", "behind", "mixed")


def _kw(w: int, rr: bool, **extra) -> dict:
    return dict(spp=1, width=w, bounces=B, two_sided=False,
                normalize_emitter=True, seed=0, russian_roulette=rr,
                rr_start_depth=RR_START if rr else 0, **extra)


def _ipar():
    return torch.tensor([PASS, 0], dtype=torch.int32)


def _draws(t, n: int, rr: bool):
    return MK.pass_draws(_ipar(), None, n, t[4].shape[0], B, 0, 0,
                         t[0].device, rr).contiguous()


def _run(t, w: int, rr: bool, fn, **extra):
    n = w * w * 3 // 4
    acc = torch.zeros((n, 3), device=t[0].device)
    return fn(t[0], _ipar(), *t[1:], acc, _draws(t, n, rr), record=True,
              **_kw(w, rr, **extra))


@pytest.fixture(scope="module",
                params=[(s, rr) for s in SCENES for rr in (False, True)],
                ids=lambda p: f"{p[0]}-{'rr' if p[1] else 'path'}")
def case(request):
    """(name, rr, tables, width, brute plain record, walk plain record and
    its counts)."""
    name, rr = request.param
    t, w = _tables(name)
    work: dict = {}
    return (name, rr, t, w, _run(t, w, rr, MK.pathtrace_pass_reference),
            _run(t, w, rr, MK.pathtrace_walk_reference, work=work), work)


# ---------------------------------------------------------------------------
# (a) the plain walk against the brute plain version
# ---------------------------------------------------------------------------

def test_path_walk_reference_equals_brute_plain_version(case):
    name, rr, t, w, want, got, _ = case
    for what, a, b in zip(("acc", "ids", "occs"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, rr, what)
    ids, occs = want[1], want[2]
    assert ids.shape == (1 + B, w * w * 3 // 4)
    assert (ids >= 0).any() and (ids < 0).any()
    n_sph = t[1].shape[0]
    if name == "ties":
        for src, dst in TIES:
            assert not (ids == dst).any()
        assert not (ids == 63).any() and not (ids == 81).any()  # masked
    if name == "inside":
        assert (ids[0] == n_sph - 1).all()
    if name == "behind":
        n_l = t[4].shape[0]
        live = (ids >= 0).repeat_interleave(n_l, 0)
        assert occs[live].double().mean() > 0.5
    if name == "mixed":
        assert (ids >= n_sph).any()       # walls
        _, r = _mixed_tables(16, 12)
        assert 0 <= int(ids[0, r]) < n_sph  # the sphere wins the tie


@pytest.mark.parametrize("rr", [False, True])
def test_path_walk_reference_equals_brute_over_passes(rr):
    """Two passes from the PRNG, no record, at 16x12."""
    t = _field(256, 16, 12)
    acc = torch.full((192, 3), 0.25)
    kw = _kw(16, rr, n_passes=2)
    want = MK.pathtrace_pass_reference(t[0], _ipar(), *t[1:], acc, None,
                                       **kw)
    got = MK.pathtrace_walk_reference(t[0], _ipar(), *t[1:], acc, None,
                                      **kw)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (b) against JAX's recording kernel
# ---------------------------------------------------------------------------

def test_path_walk_record_matches_jax():
    import jax
    import jax.numpy as jnp
    from raytracing_tpu import RenderConfig as JaxConfig
    from raytracing_tpu.models.scenes import sphere_field as jax_field
    from raytracing_tpu.ops.pallas import megakernel as JMK
    from raytracing_tpu.render import mega as jmega
    from raytracing_tpu.render import pathtracer as jpt
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        w, h = 32, 24
        js = jax_field(256, cols=w, rows=h)
        jcfg = JaxConfig(width=w, height=h, bounces=B)
        tables = jmega.scene_tables(js, jcfg)
        u = jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], PASS, jcfg,
                                    js.lights.count)
        jacc, jids, joccs = (np.asarray(x) for x in JMK.pathtrace_pass_pallas(
            tables[0], jnp.zeros((2,), jnp.int32), *tables[1:],
            jnp.zeros((w * h, 3)), u, record=True, interpret=True, spp=1,
            width=w, bounces=B, two_sided=False,
            normalize_emitter=jcfg.normalize_emitter, seed=jcfg.seed))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    t = [torch.as_tensor(np.array(x)) for x in tables]
    work: dict = {}
    acc, ids, occs = MK.pathtrace_walk_reference(
        t[0], torch.zeros(2, dtype=torch.int32), *t[1:],
        torch.zeros((w * h, 3)), torch.as_tensor(np.array(u)), spp=1,
        width=w, bounces=B, two_sided=False,
        normalize_emitter=jcfg.normalize_emitter, seed=jcfg.seed,
        record=True, work=work)
    ids, jids = ids.numpy(), jids.astype(np.int32)
    np.testing.assert_array_equal(ids[0], jids[0])
    assert (ids != jids).mean() <= 0.01
    same = np.repeat((jids >= 0) & (ids == jids), t[4].shape[0], axis=0)
    assert same.any() and (~same).any() and work["sph_tests"] > 0
    assert (occs.numpy()[same] != (joccs[same] > 0.5)).mean() <= 0.01
    # chip_smoke.py's SPHERE_GATES for two float32 versions of the pass
    err = np.abs(acc.numpy() - jacc)
    assert (err > 2e-4 + 2e-4 * np.abs(jacc)).any(-1).mean() <= 0.05
    mean, jmean = acc.double().mean().item(), jacc.astype(np.float64).mean()
    assert abs(mean - jmean) <= 5e-3 * abs(jmean)


# ---------------------------------------------------------------------------
# (c) the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_path_route_walks_past_the_brute_threshold(delta):
    n = MK.SPH_BRUTE_MAX["path"] + delta
    sph = torch.zeros((n, 8))
    assert MK.sphere_walks(sph) == (delta > 0)
    assert MK.sphere_walks(sph, mode="path") == (delta > 0)
    fake = object()
    assert not MK.sphere_walks(sph, grid=fake)
    assert not MK.sphere_walks(sph, chunks=fake)


def test_path_route_keeps_cornell_brute():
    cornell = mega.scene_tables(cornell_box(cols=8, rows=6),
                                RenderConfig(width=8, height=6,
                                             use_megakernel=True))
    assert cornell[1].shape[0] == 2 and not MK.sphere_walks(cornell[1])
    assert MK.SPH_BRUTE_MAX["path"] >= 2


def test_path_cpu_route_runs_the_brute_plain_version(monkeypatch):
    """On CPU tensors pathtrace_pass runs pathtrace_pass_reference, without
    a tree, whatever the table's size or the forced route, and counts no
    launch and no build."""
    t = _field(160, 16, 12)
    monkeypatch.setitem(MK.SPH_BRUTE_MAX, "path", 16)
    calls = []
    real = MK.pathtrace_pass_reference
    monkeypatch.setattr(MK, "pathtrace_pass_reference",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    before = (MK.launches, MK.path_walk_launches, MK.tree_build_launches)
    u = _draws(t, 192, False)
    want = real(t[0], _ipar(), *t[1:], torch.zeros((192, 3)), u,
                record=True, **_kw(16, False))
    for walk in (None, True, False):
        got = MK.pathtrace_pass(t[0], _ipar(), *t[1:], torch.zeros((192, 3)),
                                u, record=True, sphere_walk=walk,
                                **_kw(16, False))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(calls) == 3 and all(k.get("sph_tree") is None for k in calls)
    assert (MK.launches, MK.path_walk_launches,
            MK.tree_build_launches) == before


def test_path_plain_walk_refuses_grids_and_streams():
    t = _field(64, 8, 6)
    with pytest.raises(ValueError, match="resident"):
        MK.pathtrace_pass_reference(t[0], _ipar(), *t[1:],
                                    torch.zeros((48, 3)), None,
                                    sph_tree=MK.sphere_tree(t[1], 1),
                                    chunks=object(), **_kw(8, False))


def test_pass_tree_is_built_on_the_card_only():
    """pass_tree gives no tree for CPU tables in either mode, whatever
    their size, and none with a grid (no launch counted)."""
    before = MK.tree_build_launches
    for mode in ("path", "direct"):
        limit = MK.SPH_BRUTE_MAX[mode]
        for n in (limit, limit + 1, 1024):
            assert MK.pass_tree(torch.zeros((n, 8)), mode=mode) is None
        assert MK.pass_tree(torch.zeros((256, 8)), chunks=object(),
                            mode=mode) is None
    assert MK.tree_build_launches == before


# ---------------------------------------------------------------------------
# (d) one tree per differentiable pass
# ---------------------------------------------------------------------------

def _diff_args(t, sph, n: int):
    kw = _kw(8, False)
    return (t[0], sph, t[2], t[3], t[4], torch.zeros((n, 3)), _ipar(), None,
            kw, ("sph",), dict(grid=None, chunks=None, block=0), "path")


def test_pallas_pass_hands_one_tree_to_kernels_1_and_2(monkeypatch):
    """A differentiable path pass on kernel 2's route (``_PassDiff``, the
    "pallas" step) asks for the sphere tree once, in its forward, and hands
    that tree to kernel 1's forward and to kernel 2 (whose record walks it
    past 64 objects). On CPU tensors the route runs its plain version, so
    the Function is driven here directly, with stand-ins for the tree and
    for kernel 2."""
    t = _field(256, 8, 6)
    marker, asked, seen = object(), [], {}
    monkeypatch.setattr(MK, "pass_tree", lambda sph, grid=None, chunks=None,
                        mode="path": asked.append((sph.shape[0], mode))
                        or marker)
    real = MK.pathtrace_pass

    def forward(*a, sph_tree=None, **k):
        seen["forward"] = sph_tree
        return real(*a, **k)

    def backward(par, ipar, sph, tri, mat, lig, g, u, *, sph_tree=None,
                 **k):
        seen["record"] = sph_tree
        return tuple(torch.zeros_like(x) for x in (par, sph, tri, mat, lig))

    monkeypatch.setattr(MK, "pathtrace_pass", forward)
    monkeypatch.setattr(MKG, "pathtrace_pass_bwd", backward)
    sph = t[1].clone().requires_grad_(True)
    acc = MKG._PassDiff.apply(*_diff_args(t, sph, 48))
    acc.sum().backward()
    assert asked == [(256, "path")]
    assert seen == {"forward": marker, "record": marker}
    assert sph.grad is not None


def test_cell_pass_calls_kernel_1_once(monkeypatch):
    """The cell route (``_PassDiffCell``) records with one call of kernel 1,
    which builds its own tree (one per pass), and asks for no other."""
    t = _field(256, 8, 6)
    calls, asked = [], []
    monkeypatch.setattr(MK, "pass_tree", lambda *a, **k: asked.append(a))
    real = MK.pathtrace_pass

    def forward(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(MK, "pathtrace_pass", forward)
    sph = t[1].clone().requires_grad_(True)
    acc = MKG._PassDiffCell.apply(*_diff_args(t, sph, 48))
    acc.sum().backward()
    assert len(calls) == 1 and calls[0]["record"] and not asked
    assert "sph_tree" not in calls[0] and sph.grad is not None


# ---------------------------------------------------------------------------
# (e) the counts
# ---------------------------------------------------------------------------

def test_path_walk_counts(case):
    name, rr, t, w, want, _, work = case
    ids = want[1]
    n_rays = ids.shape[1]
    n_sph = t[1].shape[0]
    # traces: the primary segment of every ray, then each live segment's
    # bounce; shadow rays: one per light of each segment with a hit
    traces = n_rays + int((ids[:-1] >= 0).sum())
    shadows = int((ids >= 0).sum()) * t[4].shape[0]
    for k in ("node_tests", "leaf_visits", "sph_tests"):
        assert work[k] > 0, (name, k)
    # leaves of one row: a visit tests its row unless masked off
    assert work["sph_tests"] <= work["leaf_visits"] + work.get(
        "loose_tests", 0)
    # far fewer than the brute loops' tests on these fields
    assert work["sph_tests"] < (traces + shadows) * n_sph / 8, name
    assert work["node_tests"] <= 2 * (traces + shadows) * (
        2 * MK.tree_slots(n_sph))
    assert 0 < work["union_leaves"] <= work["leaf_visits"]
    assert work["union_sph_tests"] <= work["sph_tests"]


def test_path_shadow_walk_stops_at_the_first_occluder():
    """A path pass's NEE: hits on a floor under a light with two spheres
    stacked between, both in every shadow ray's window. Each shadow ray's
    walk tests one sphere and stops (one row test per ray, not two)."""
    t = _field(64, 4, 4)
    lig = t[4][:1].clone()
    lig[0, 0:3] = torch.tensor([0.0, 0.0, 10.0])
    lig[0, 3:6] = torch.tensor([0.0, 0.0, -1.0])
    lig[0, 12] = 0.01
    sph = torch.tensor([[0.0, 0.0, 3.0, 1.0, 0.0, 1.0, 0.0, 0.0],
                        [0.0, 0.0, 6.0, 1.0, 0.0, 1.0, 0.0, 0.0]])
    tri = t[2][:0]
    n = 16
    g = np.random.default_rng(3)
    hp = torch.as_tensor(np.concatenate(
        [g.uniform(-0.05, 0.05, (n, 2)), np.zeros((n, 1))], 1).astype(
            np.float32))
    hn = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    tree = MK.sphere_tree(sph, 1)
    work: dict = {}

    def trace(o, d, mint, maxt):
        return (maxt, hp, hn, torch.zeros(n), torch.full((n,), -1))

    def anyhit(o, d, mint, maxt):
        occ = MK._anyhit(o, d, mint, maxt, sph, tri, False, work=work,
                         sph_tree=tree)
        work["shadows"] = work.get("shadows", 0) + int(occ.sum())
        return occ

    u = MK.pass_draws(_ipar(), None, n, 1, 0, 0, 0, None, False)
    MK._pass_reference(t[0], sph, tri, t[3], lig, torch.zeros((n, 3)), u, 0,
                       spp=1, width=4, bounces=0, two_sided=False,
                       normalize_emitter=True, trace=trace, anyhit=anyhit)
    assert work["shadows"] == n and work["sph_tests"] == n


# ---------------------------------------------------------------------------
# (f) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(), EXACT_FLAGS])
@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("n", [256, 1024])
def test_path_walk_instance_bit_equals_brute_instance(cuda, n, rr, flags):
    t = _field(n, 32, 24, cuda)
    w, r = 32, 768
    u = _draws(t, r, rr)
    kw = _kw(w, rr, build_flags=flags)
    out = {}
    for walk in (False, True):
        before = (MK.launches, MK.path_walk_launches,
                  MK.tree_build_launches)
        rec = MK.pathtrace_pass(t[0], _ipar(), *t[1:],
                                torch.zeros((r, 3), device=cuda), u,
                                record=True, sphere_walk=walk, **kw)
        acc = MK.pathtrace_pass(t[0], _ipar(), *t[1:],
                                torch.zeros((r, 3), device=cuda), u,
                                sphere_walk=walk, **kw)
        prng = MK.pathtrace_pass(t[0], _ipar(), *t[1:],
                                 torch.zeros((r, 3), device=cuda), None,
                                 record=True, sphere_walk=walk, **kw)
        many = MK.pathtrace_pass(t[0], _ipar(), *t[1:],
                                 torch.zeros((r, 3), device=cuda), None,
                                 n_passes=3, sphere_walk=walk, **kw)
        torch.cuda.synchronize()
        assert (MK.launches, MK.path_walk_launches,
                MK.tree_build_launches) == (
            before[0] + 4, before[1] + 4 * walk, before[2] + 4 * walk)
        assert torch.equal(rec[0], acc) and torch.equal(prng[0], rec[0])
        assert torch.equal(prng[1], rec[1]) and torch.equal(prng[2], rec[2])
        out[walk] = (rec, many)
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[True][1], out[False][1])
    if flags:
        # ids and bits equal, acc within 2e-4 (float32 sums and square
        # roots of the plain version on the card; chip_smoke.py phase 11)
        acc, ids, occs = out[True][0]
        want = MK.pathtrace_walk_reference(
            t[0], _ipar(), *t[1:], torch.zeros((r, 3), device=cuda), u,
            record=True, **_kw(w, rr))
        assert torch.equal(ids, want[1]) and torch.equal(occs, want[2])
        assert not ((acc - want[0]).abs()
                    > 2e-4 + 2e-4 * want[0].abs()).any()


@pytest.mark.cuda
def test_path_walk_route_by_size_on_the_card(cuda, monkeypatch):
    """Past SPH_BRUTE_MAX["path"] the wrapper builds a tree and walks it;
    at it, the brute instance; both give the same record."""
    t = _field(256, 32, 24, cuda)
    u = _draws(t, 768, False)
    recs = []
    for limit, walked in ((255, 1), (256, 0)):
        monkeypatch.setitem(MK.SPH_BRUTE_MAX, "path", limit)
        before = MK.path_walk_launches, MK.tree_build_launches
        recs.append(MK.pathtrace_pass(t[0], _ipar(), *t[1:],
                                      torch.zeros((768, 3), device=cuda), u,
                                      record=True, **_kw(32, False)))
        torch.cuda.synchronize()
        assert (MK.path_walk_launches, MK.tree_build_launches) == (
            before[0] + walked, before[1] + walked)
    for a, b in zip(*recs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_render_call_builds_one_tree_on_the_card(cuda):
    """A forward render call of 16 passes past the threshold
    (sphere_field(1024)): one tree build, one launch walking it; cornell:
    brute, no build."""
    from raytracing_tpu_torch.render import pathtracer as pt
    for scene, walks in ((sphere_field(1024, cols=32, rows=24,
                                       device=cuda), 1),
                         (cornell_box(cols=32, rows=24, device=cuda), 0)):
        cfg = RenderConfig(width=32, height=24, bounces=B,
                           use_megakernel=True)
        before = (MK.launches, MK.path_walk_launches,
                  MK.tree_build_launches)
        with torch.no_grad():
            state = pt.render_passes(scene, pt.init_state(cfg, cuda), cfg,
                                     16)
        torch.cuda.synchronize()
        assert torch.isfinite(state["acc"]).all()
        assert (MK.launches, MK.path_walk_launches,
                MK.tree_build_launches) == (before[0] + 1, before[1] + walks,
                                            before[2] + walks)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [False, True])
def test_path_step_builds_one_tree_on_the_card(cuda, cell):
    """A differentiable path pass past the threshold builds one tree on
    either route: the "pallas" route's forward builds it and kernel 2's
    record walks it; the cell route's recording forward builds its own.
    The record walking the forward's tree equals one whose call builds its
    own, and a tree of another table is refused."""
    t = _field(1024, 32, 24, cuda)
    assert MK.sphere_walks(t[1])
    n = 768
    kw = dict(_kw(32, False), diff_wrt=("sph",), bwd_cell=cell)
    sph = t[1].clone().requires_grad_(True)
    before = (MK.tree_build_launches, MK.path_walk_launches,
              MKG.large_launches, MKG.champ_launches)
    acc = MKG.pathtrace_pass_diff(t[0], _ipar(), sph, *t[2:],
                                  torch.zeros((n, 3), device=cuda), None,
                                  **kw)
    torch.mean(acc ** 2).backward()
    torch.cuda.synchronize()
    assert (MK.tree_build_launches, MK.path_walk_launches,
            MKG.large_launches, MKG.champ_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (not cell),
        before[3] + cell)
    assert torch.isfinite(sph.grad).all() and sph.grad.any()
    if cell:
        return
    g = torch.ones((n, 3), device=cuda)
    rec = dict(_kw(32, False), mode="path", grid=None, chunks=None, block=0)
    tree = MK.pass_tree(t[1])
    a = MKG._record(t[0], _ipar(), *t[1:], g, None, sph_tree=tree, **rec)
    b = MKG._record(t[0], _ipar(), *t[1:], g, None, **rec)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="pass_tree"):
        MK.pathtrace_pass(t[0], _ipar(), *t[1:],
                          torch.zeros((n, 3), device=cuda), None,
                          sph_tree=MK.sphere_tree_build(
                              t[1][:500].contiguous(), MK.SPH_TREE_LEAF),
                          **_kw(32, False))


@pytest.mark.cuda
def test_path_entry_refuses_a_malformed_tree(cuda):
    """rt_pathtrace_pass's tree argument: each malformed one returns
    cudaErrorInvalidValue and writes nothing; the well-formed one runs."""
    t = _field(256, 16, 12, cuda)
    rows = t[1]
    tree = MK.sphere_tree(rows, 1)
    mk = MK._lib(None, None, ())
    acc = torch.full((192, 3), 7.0, device=cuda)
    gargs, _ = MK._grid_args(None, None, rows.shape[0], 0)
    keys = (ctypes.c_uint32 * 2)(*rng.pass_key_words(0, PASS))
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(desc, n_sph=256):
        return mk.rt_pathtrace_pass(
            t[0].data_ptr(), rows.data_ptr(), n_sph, None, 0,
            t[3].data_ptr(), t[3].shape[0], t[4].data_ptr(), t[4].shape[0],
            acc.data_ptr(), 192, 0, None, ctypes.addressof(keys), 1, 1, 16,
            B, 0, 0, 0, 1, None, None, None, *gargs, ctypes.addressof(desc),
            0, stream)

    def desc(**kw):
        d = MK._tree_desc(tree)
        for k, v in kw.items():
            setattr(d, k, v)
        return d

    for bad in (desc(n=255), desc(n=300), desc(leaf=3), desc(leaf=64),
                desc(n_slots=3), desc(n_loose=0), desc(n_loose=65),
                desc(node=None), desc(perm=None)):
        assert launch(bad) == 1
    assert launch(desc(), n_sph=0) == 1
    torch.cuda.synchronize()
    assert (acc == 7.0).all()
    assert launch(desc()) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all() and not (acc == 7.0).all()
