"""Kernel 3's ray order and its count of the warps' work, on the CPU (no
JAX, no kernel): the plain version of the order
(``MKG.champ_order_reference``: the rays with g != 0, the longest key
first, rays of one key in ray order; a ray's key is its leading recorded
ids inside the tables) and the plain count of the segments the sweep's
warps walk (``MKG.champ_warp_work``) that ``chip_smoke.py`` prints beside
kernel 3's time, on hand-made records and on kernel 1's plain record of
sphere_field(1024) and cornell. The kernels that build the order and
sweep in it run on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from raytracing_tpu_torch.core.config import RenderConfig
from raytracing_tpu_torch.models.scenes import sphere_field
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from torch_threads import one_thread  # noqa: F401


def _ids(rows):
    return torch.tensor(rows, dtype=torch.int32)


def _g(n, dead=()):
    g = torch.ones((n, 3))
    g[list(dead)] = 0.0
    return g


def _order(ids, g, **kw):
    order, n_live = MKG.champ_order_reference(ids, g, **kw)
    assert order.dtype == torch.int32 and order.numel() == n_live
    return order.tolist()


def _brute_order(ids, g, n_obj=None):
    """The order by its definition, ray by ray in Python."""
    keys = []
    for r in range(ids.shape[1]):
        k = 0
        while (k < ids.shape[0] and ids[k, r] >= 0
               and (n_obj is None or ids[k, r] < n_obj)):
            k += 1
        keys.append(k)
    live = [r for r in range(ids.shape[1]) if bool(g[r].any())]
    return sorted(live, key=lambda r: (-keys[r], r))


# five rays, three segments: keys 1, 3, 0, 2, 3
HAND = [[4, 0, -1, 2, 1],
        [-1, 1, 3, 2, 0],
        [0, 2, 0, -1, 4]]


def test_longest_key_first():
    assert _order(_ids(HAND), _g(5)) == [1, 4, 3, 0, 2]


def test_rays_of_one_key_keep_ray_order():
    ids = _ids([[1, 0, -1, 2, 1, 0, -1, 3],
                [0, 1, -1, -1, 2, 3, -1, 1]])
    # keys 2, 2, 0, 1, 2, 2, 0, 2
    assert _order(ids, _g(8)) == [0, 1, 4, 5, 7, 3, 2, 6]


@pytest.mark.parametrize("dead, want", [
    ((1,), [4, 3, 0, 2]),
    ((1, 4), [3, 0, 2]),
    ((0, 3), [1, 4, 2]),
])
def test_zero_cotangent_rays_are_dropped(dead, want):
    """A ray with g = 0 leaves the order; one of key 0 with g != 0 (ray 2:
    its primary id misses, it may meet the emitter) stays, last."""
    assert _order(_ids(HAND), _g(5, dead)) == want


def test_one_zero_component_keeps_the_ray():
    g = torch.zeros((5, 3))
    g[3, 1] = -1e-30
    assert _order(_ids(HAND), g) == [3]


@pytest.mark.parametrize("n_seg", [1, 6])
def test_all_miss_record(n_seg):
    ids = torch.full((n_seg, 70), -1, dtype=torch.int32)
    assert _order(ids, _g(70)) == list(range(70))
    w = MKG.champ_warp_work(ids, _g(70))
    assert w == {"warps": 3, "walked": 0, "needed": 0, "ratio": 0.0}


def test_every_cotangent_zero():
    order, n_live = MKG.champ_order_reference(_ids(HAND), torch.zeros(5, 3))
    assert n_live == 0 and order.numel() == 0
    assert MKG.champ_warp_work(_ids(HAND), torch.zeros(5, 3))["walked"] == 0


@pytest.mark.parametrize("n_rays", [1, 31, 33, 1000, 1024 + 37])
def test_ray_counts_off_the_warp_and_tile(n_rays):
    """Random records of ray counts that no warp (32) or tile of the
    card's sort (1024 rays) divides, every fifth ray with g = 0: the order
    by its definition."""
    gen = torch.Generator().manual_seed(n_rays)
    ids = torch.randint(-1, 9, (6, n_rays), generator=gen).to(torch.int32)
    g = torch.randn((n_rays, 3), generator=gen)
    g[::5] = 0.0
    assert _order(ids, g, n_obj=7) == _brute_order(ids, g, n_obj=7)


def test_direct_mode_key_is_the_primary_hit():
    ids = _ids([[3, -1, 0, 9, -1, 2]])
    assert _order(ids, _g(6), mode="direct", n_obj=5) == [0, 2, 5, 1, 3, 4]
    assert MKG.champ_keys(ids, 5).tolist() == [1, 0, 1, 0, 0, 1]
    with pytest.raises(ValueError):
        MKG.champ_order_reference(_ids(HAND), _g(5), mode="direct")


def test_key_stops_at_the_first_miss():
    """A record whose path ends at a miss and resumes (the roulette's
    misses after a path it ended, then ids again): the key counts only the
    leading run; an id past the tables is a miss."""
    ids = _ids([[2, 2, 2, 2],
                [-1, 2, 7, 2],
                [3, -1, 3, 2],
                [3, 3, 3, 5]])
    assert MKG.champ_keys(ids, 5).tolist() == [1, 2, 1, 3]
    assert MKG.champ_keys(ids).tolist() == [1, 2, 4, 4]
    assert _order(ids, _g(4), n_obj=5) == [3, 1, 0, 2]


def test_warp_work_on_a_hand_made_record():
    """Two warps of 32 rays: the first holds one ray of key 3 and 31 of
    key 1, the second 32 of key 2; in ray order the first warp walks 3 x
    32, in the order the keys sort into [3, 2 x 31], [2, 1 x 31]."""
    seg = [[0] * 64, [-1] * 64, [-1] * 64]
    for r in range(32, 64):
        seg[1][r] = 0
    seg[1][5] = seg[2][5] = 0
    ids = _ids(seg)
    g = _g(64)
    w = MKG.champ_warp_work(ids, g)
    assert (w["warps"], w["walked"], w["needed"]) == (2, 32 * 5, 3 + 31 + 64)
    order, _ = MKG.champ_order_reference(ids, g)
    w2 = MKG.champ_warp_work(ids, g, order)
    assert (w2["walked"], w2["needed"]) == (32 * 5, 98)
    # g = 0 on the long ray: ray order walks what its warp's others need
    g[5] = 0.0
    w3 = MKG.champ_warp_work(ids, g)
    assert (w3["walked"], w3["needed"]) == (32 + 64, 95)
    assert w3["ratio"] == pytest.approx(96 / 95)


def test_order_on_cpu_is_the_plain_version():
    ids = torch.randint(-1, 40, (6, 300), generator=torch.Generator()
                        .manual_seed(3)).to(torch.int32)
    g = torch.randn(300, 3)
    got = MKG.champ_order(ids, g, 33)
    want = MKG.champ_order_reference(ids, g, n_obj=33)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]


def test_add_count_in_the_order():
    """The row adds counted over the order's warps: the warp of key-2 rays
    names rows the ray-order warps split."""
    seg0 = [0, 1] * 32
    seg1 = [1, -1] * 32
    ids = _ids([seg0, seg1])
    slot = torch.full((0,), -1, dtype=torch.int32)
    order, _ = MKG.champ_order_reference(ids, _g(64))
    c = MKG.champ_add_count(ids, 2, 0, slot, ("sph",))
    co = MKG.champ_add_count(ids, 2, 0, slot, ("sph",), order=order)
    # ray order: each warp names rows 0 and 1 at segment 0 and row 1 at 1
    assert c["sph_groups"] == 2 * 3
    # the order: warp 0 the even rays (row 0, then 1), warp 1 the odd ones
    assert co["sph_groups"] == 3 and co["rays"] == 64


@pytest.fixture(scope="module")
def field_record():
    """Kernel 1's plain record of sphere_field(1024) at 128x96 b5 and a
    seeded random cotangent."""
    w, h = 128, 96
    scene = sphere_field(1024, cols=w, rows=h, device="cpu")
    cfg = RenderConfig(width=w, height=h, bounces=5, use_megakernel=True)
    t = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    _, ids, occs = MK.pathtrace_pass(
        t[0], ipar, *t[1:], torch.zeros((w * h, 3)), None, record=True,
        spp=1, width=w, bounces=5, two_sided=False, normalize_emitter=True,
        seed=cfg.seed)
    g = torch.randn((w * h, 3), generator=torch.Generator().manual_seed(2))
    return t, ipar, ids, occs, g, cfg


def test_order_evens_the_warps_on_sphere_field(field_record):
    """Ray order walks more than twice the segments the lanes need; the
    order less than 5% over."""
    t, _, ids, _, g, _ = field_record
    n_obj = t[1].shape[0] + t[2].shape[0]
    before = MKG.champ_warp_work(ids, g, n_obj=n_obj)
    order, n_live = MKG.champ_order_reference(ids, g, n_obj=n_obj)
    after = MKG.champ_warp_work(ids, g, order, n_obj=n_obj)
    assert n_live == ids.shape[1]
    assert before["ratio"] > 2 and after["ratio"] < 1.05
    assert before["needed"] == after["needed"]


def test_key_bounds_the_plain_sweeps_segments(field_record, monkeypatch):
    """Every ray's key is at least the segments the plain champion
    backward sweeps (recounted from its any-hit calls: a segment is swept
    where its shadow rays start, at mint 0)."""
    t, ipar, ids, occs, g, cfg = field_record
    n_lig = t[4].shape[0]
    valid = []
    hooks = MKG._champ_hooks

    def counting(*args):
        trace, anyhit = hooks(*args)

        def counted(o, d, mint, maxt):
            valid.append((mint == 0.0).detach())
            return anyhit(o, d, mint, maxt)
        return trace, counted

    monkeypatch.setattr(MKG, "_champ_hooks", counting)
    MKG.pathtrace_pass_bwd_champ_reference(
        t[0], ipar, *t[1:], g, None, ids, occs, spp=1, width=cfg.width,
        bounces=5, two_sided=False, normalize_emitter=True, seed=cfg.seed,
        diff_wrt=("sph",))
    assert len(valid) == 6 * n_lig
    nseg = torch.stack(valid[::n_lig]).to(torch.int64).sum(0)
    key = MKG.champ_keys(ids, t[1].shape[0] + t[2].shape[0])
    assert bool((key >= nseg).all())
    # the bound is tight but where a path meets the emitter or ends
    assert (key == nseg).double().mean().item() > 0.9


@pytest.mark.parametrize("rr, lo, hi", [(False, 2.0, 2.2), (True, 2.35, 2.55)])
def test_warp_work_on_cornell(rr, lo, hi):
    """Kernel 1's plain record of cornell at 128x96 b5 (the roulette from
    depth 2 with ``rr``), every g nonzero: in ray order the warps walk
    2.10x (2.45x) the lane-segments their lanes need, in the order less
    than 1% over. Kernels 1 and 2 diverge the same way but learn each
    path's length only while tracing."""
    from raytracing_tpu_torch.models.scenes import cornell_box
    w, h = 128, 96
    scene = cornell_box(cols=w, rows=h, device="cpu")
    cfg = RenderConfig(width=w, height=h, bounces=5, use_megakernel=True)
    t = mega.scene_tables(scene, cfg)
    _, ids, _ = MK.pathtrace_pass(
        t[0], torch.tensor([0, 0], dtype=torch.int32), *t[1:],
        torch.zeros((w * h, 3)), None, record=True, spp=1, width=w,
        bounces=5, two_sided=False, normalize_emitter=True, seed=cfg.seed,
        russian_roulette=rr, rr_start_depth=2)
    g = torch.ones((w * h, 3))
    n_obj = t[1].shape[0] + t[2].shape[0]
    order, _ = MKG.champ_order_reference(ids, g, n_obj=n_obj)
    assert lo < MKG.champ_warp_work(ids, g, n_obj=n_obj)["ratio"] < hi
    assert MKG.champ_warp_work(ids, g, order, n_obj=n_obj)["ratio"] < 1.01
