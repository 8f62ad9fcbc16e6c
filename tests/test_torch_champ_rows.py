"""Kernel 3's hot rows and its count of row adds, on the CPU (no JAX, no
kernel): the plain version of the slot map (``MKG.hot_rows_reference``,
the K triangle rows that the record names most, ties to the lower index,
-1 for every other row) and the plain count of the sweep's sphere and
triangle row adds (``MKG.champ_add_count``) that ``chip_smoke.py`` prints
beside kernel 3's time, on hand-made records and on the torus scene's
record. The kernels that build the map and add the rows run on the card
(``tests/test_torch_cuda.py``)."""
import sys
from pathlib import Path

import pytest
import torch

from raytracing_tpu_torch.core.config import RenderConfig
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from torch_threads import one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _ids(rows):
    return torch.tensor(rows, dtype=torch.int32)


def _slots(ids, n_sph, n_tri, k):
    return MKG.hot_rows_reference(_ids(ids), n_sph, n_tri, k)[0].tolist()


def test_slots_rank_rows_by_count():
    # 2 spheres, 5 triangles (ids 2-6): triangle 3 named 4 times, 0 and 1
    # three times each, 4 twice, 2 never
    ids = [[5, 3, 5, 3, 1, 1, 2, 6],
           [5, 5, 3, 1, 2, 2, 6, -1]]
    assert _slots(ids, 2, 5, 3) == [1, 2, -1, 0, -1]
    assert _slots(ids, 2, 5, 4) == [1, 2, -1, 0, 3]
    hot = MKG.hot_rows_reference(_ids(ids), 2, 5, 3)[1]
    assert hot.tolist() == [3, 0, 1]


def test_slot_ties_go_to_the_lower_index():
    ids = [[6, 4, 2, 6, 4, 2, 5]]
    # triangles 0, 2 and 4 named twice each, 3 once: K = 2 takes 0 and 2
    assert _slots(ids, 2, 5, 2) == [0, -1, 1, -1, -1]
    assert _slots(ids, 2, 5, 3) == [0, -1, 1, -1, 2]


@pytest.mark.parametrize("k", [3, 8, 64])
def test_slots_when_k_exceeds_the_table(k):
    """K at or past the table's rows: every named row gets a slot, in rank
    order, a row the record never names none, and the unused slots -1."""
    ids = [[2, 3, 3, 0, 4, 4, 4]]
    slot, hot = MKG.hot_rows_reference(_ids(ids), 2, 3, k)
    assert slot.tolist() == [2, 1, 0]
    assert hot.tolist() == [2, 1, 0] + [-1] * (k - 3)
    ids = [[2, 2, 0, -1]]
    assert _slots(ids, 2, 3, k) == [0, -1, -1]


@pytest.mark.parametrize("k", [0, 1, 16])
def test_all_miss_record_has_no_hot_row(k):
    ids = [[-1] * 64] * 6
    slot, hot = MKG.hot_rows_reference(_ids(ids), 4, 9, k)
    assert slot.tolist() == [-1] * 9 and hot.tolist() == [-1] * k


def test_direct_record_of_one_segment():
    """A direct record (1, R) and ids outside the tables (misses)."""
    ids = [[3, 3, 0, 7, 99, -5, 3, 0, 1]]
    assert _slots(ids, 2, 6, 2) == [-1, 0, -1, -1, -1, 1]


def test_rows_never_named_get_no_slot():
    ids = [[10, 10, 11], [12, -1, -1]]
    slot = _slots(ids, 10, 20, 16)
    assert [i for i, s in enumerate(slot) if s >= 0] == [0, 1, 2]
    assert slot[0] == 0


def test_sphere_ids_are_not_counted():
    """Only triangle rows get slots: a record that names a sphere most
    ranks its triangles alone, and one of spheres alone has no hot row."""
    ids = [[1, 1, 1, 1, 0, 0, 3, 2, 3]]
    slot, hot = MKG.hot_rows_reference(_ids(ids), 2, 3, 2)
    assert slot.tolist() == [1, 0, -1] and hot.tolist() == [1, 0]
    assert _slots([[0, 1, 1, 0]], 2, 3, 2) == [-1, -1, -1]


def test_hot_list_inverts_the_slots():
    """hot[slot[j]] == j for every row with a slot, on a random record."""
    ids = torch.randint(-1, 300, (6, 4096), generator=torch.Generator()
                        .manual_seed(5)).to(torch.int32)
    slot, hot = MKG.hot_rows_reference(ids, 40, 260, 16)
    rows = (slot >= 0).nonzero().ravel()
    assert rows.numel() == 16
    assert torch.equal(hot[slot[rows].long()].long(), rows)
    assert sorted(slot[rows].tolist()) == list(range(16))


def test_hot_rows_on_cpu_is_the_plain_version_at_the_built_size():
    ids = torch.randint(-1, 40, (6, 256), generator=torch.Generator()
                        .manual_seed(3)).to(torch.int32)
    got = MKG.hot_rows(ids, 8, 32)
    want = MKG.hot_rows_reference(ids, 8, 32, MKG.HOT_TRI)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_add_count_on_a_hand_made_record():
    """Two warps of 32 rays, two segments; 1 sphere (id 0), 4 triangles
    (ids 1-4); triangle 0 hot."""
    seg0 = [0] * 8 + [1] * 8 + [2] * 8 + [-1] * 8 + [1] * 32
    seg1 = [3] * 16 + [4] * 16 + [0] * 32
    ids = _ids([seg0, seg1])
    slot = torch.tensor([0, -1, -1, -1], dtype=torch.int32)
    c = MKG.champ_add_count(ids, 1, 4, slot, ("sph", "tri"), blocks=1,
                            block=128)
    # groups: warp 0 seg 0 {s0, t0, t1}, warp 1 seg 0 {t0}, warp 0 seg 1
    # {t2, t3}, warp 1 seg 1 {s0}
    assert c["sph_groups"] == 2
    assert c["tri_groups"] == 5 and c["tri_hot_groups"] == 2
    assert c["atomics_parent"] == 4 * 2 + 25 * 5
    assert c["slab_adds"] == 2
    # a float4 per sphere group, 9 per cold triangle group
    assert c["vector_reds"] == 2 + 27
    # one block: one flush of the hot row
    assert c["flush_reds"] == 9
    assert c["tri_champions"] == 8 + 8 + 32 + 32
    assert c["adds_new"] == 2 + 29 + 9
    # in two blocks of 32 rays each warp flushes its own hot row
    c2 = MKG.champ_add_count(ids, 1, 4, slot, ("sph", "tri"), blocks=2,
                             block=32)
    assert c2["flush_reds"] == 18
    # groups outside wrt add nothing; dead rays name nothing
    c3 = MKG.champ_add_count(ids, 1, 4, slot, ("sph",),
                             live=torch.arange(64) < 32)
    assert c3["tri_groups"] == 0 and c3["flush_reds"] == 0
    assert c3["sph_groups"] == 1 and c3["rays"] == 32
    assert c3["atomics_parent"] == 4


@pytest.fixture(scope="module")
def torus_record():
    """Kernel 1's plain record of the streamed cornell + 992-triangle
    torus (chip_smoke.py's phase 21 scene) at 64x48 b5."""
    from torch_grid_scenes import cornell_torus
    w, h = 64, 48
    scene = cornell_torus(w, h, 31, 16)
    cfg = RenderConfig(width=w, height=h, bounces=5, use_megakernel=True)
    t = mega.scene_tables(scene, cfg)
    chunks = mega.chunk_tables(scene, cfg, t[1], t[2])
    assert chunks is not None
    _, ids, _ = MK.pathtrace_pass(
        t[0], torch.tensor([0, 0], dtype=torch.int32), *t[1:],
        torch.zeros((w * h, 3)), None, record=True, chunks=chunks, spp=1,
        width=w, bounces=5, two_sided=False, normalize_emitter=True,
        seed=cfg.seed)
    return ids, t[1].shape[0], t[2].shape[0]


@pytest.mark.parametrize("k_tri", [10, 16, 32])
def test_add_count_on_the_torus_record(torus_record, k_tri):
    """The torus's record: 2.3-2.5 triangle champions per ray, and with K_t
    >= 10 the hot rows (cornell's ten walls first) take more than 75% of
    the warps' triangle row groups; the new design sends far fewer adds
    than the parent's scalar atomics."""
    ids, n_s, n_t = torus_record
    slot, _ = MKG.hot_rows_reference(ids, n_s, n_t, k_tri)
    assert sorted((slot >= 0).nonzero().ravel().tolist())[:10] == list(
        range(10))
    c = MKG.champ_add_count(ids, n_s, n_t, slot, ("sph", "mat", "tri"))
    assert 2.3 <= c["tri_champions_per_ray"] <= 2.5
    assert c["tri_hot_groups"] > 0.75 * c["tri_groups"]
    assert c["adds_new"] < 0.2 * c["atomics_parent"]
