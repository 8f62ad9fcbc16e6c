"""The CUDA kernels (the pass with and without Russian roulette, its
recording, direct, grid and streamed modes and its blocked layout, its two
adjoints with and without the roulette, the edge-aware adjoint kernel 2s,
kernel 2 past 64 objects per type (an uncontracted record by kernel 1 and
kernel 3's sweep of it) and kernel 2s's large-table instance,
the differentiable direct pass through kernels 1 (recording), 2, 3 and 2s,
and the stage pipeline's hit searches) against their plain PyTorch
versions on the card.

Runs only where there is a CUDA device; elsewhere each test skips. Imports
no jax, so it runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
from raytracing_tpu_torch.core.types import (Camera, Lights, build_scene,
                                             make_spheres, make_triangles)
from raytracing_tpu_torch.ops import hit_kernels as HK
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.ops import megakernel_soft as MKS
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda
TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def test_kernel_matches_plain_version(cuda):
    """Same u-planes into the kernel and the plain version: at most 1% of
    rays beyond 2e-4 (contracted FMAs move silhouette and grazing rays)."""
    cfg = RenderConfig(width=64, height=48, bounces=5,
                       use_megakernel=True)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    before = MK.launches
    got = mega.render_pass_mega(scene, pt.init_state(cfg, cuda), cfg,
                                u_planes=u)["acc"]
    torch.cuda.synchronize()
    assert MK.launches == before + 1
    tables = mega.scene_tables(scene, cfg)
    want = MK.pathtrace_pass_reference(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        torch.zeros_like(got), u, spp=1, width=64, bounces=5,
        two_sided=False, normalize_emitter=True, seed=cfg.seed)
    beyond = ((got - want).abs() > TOL + TOL * want.abs()).any(-1)
    assert torch.isfinite(got).all()
    assert beyond.float().mean().item() <= 0.01


def test_prng_route_bit_equals_u_planes_route(cuda):
    cfg = RenderConfig(width=64, height=48, bounces=5, seed=3,
                       use_megakernel=True)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    st = pt.init_state(cfg, cuda)
    u = mega.u_planes_for_pass(st["key"], 0, cfg, 1, cuda)
    a = mega.render_pass_mega(scene, st, cfg, u_planes=u)["acc"]
    b = pt.render_pass(scene, pt.init_state(cfg, cuda), cfg)["acc"]
    assert torch.equal(a, b)


def _gates(want, got, names=MKG.DIFF_ALL):
    """chip_smoke's phase-6 gates: cosine >= 0.999, norm ratio within 1%,
    max |got - want| <= 5e-3 x the group's largest entry (float atomics
    sum in another order than autograd)."""
    for name, a, b in zip(names, want, got):
        a, b = a.double().ravel(), b.double().ravel()
        assert torch.isfinite(b).all(), name
        na, nb = a.norm().item(), b.norm().item()
        assert na > 0, name
        assert (a @ b).item() / (na * nb) >= 0.999, name
        assert abs(nb / na - 1.0) <= 0.01, name
        assert (a - b).abs().max().item() <= 5e-3 * a.abs().max().item(), \
            name


def test_adjoint_kernel_matches_plain_version(cuda):
    """Kernel 2 (u-planes and PRNG routes) vs autograd through the plain
    forward, cornell 64x48 b2, all five groups, seeded random g."""
    cfg = RenderConfig(width=64, height=48, bounces=2,
                       use_megakernel=True)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    g = torch.as_tensor(np.random.default_rng(1).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=64, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    want = MKG.pathtrace_pass_bwd_reference(tables[0], ipar, *tables[1:], g,
                                            u, **kw)
    before = MKG.launches
    for planes in (u, None):
        got = MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, planes,
                                     **kw)
        torch.cuda.synchronize()
        _gates(want, got)
    assert MKG.launches == before + 2


def test_render_pass_trains_through_both_kernels(cuda):
    """A requires-grad render_pass on the card: one launch of each kernel,
    and the sphere and material gradients of the plain route on the CPU."""
    cfg = RenderConfig(width=64, height=48, bounces=2,
                       mega_grad_wrt=("sph", "mat"), use_megakernel=True)

    def grads(device):
        scene = cornell_box(cols=64, rows=48, device=device)
        c = scene.spheres.center.clone().requires_grad_(True)
        m = scene.materials.clone().requires_grad_(True)
        sc = replace(scene, spheres=replace(scene.spheres, center=c),
                     materials=m)
        st = pt.render_pass(sc, pt.init_state(cfg, device), cfg)
        (pt.image(st, cfg) ** 2).mean().backward()
        return c.grad.cpu(), m.grad.cpu()

    k1, k2 = MK.launches, MKG.launches
    got = grads(cuda)
    assert (MK.launches, MKG.launches) == (k1 + 1, k2 + 1)
    for a, b in zip(grads("cpu"), got):
        assert torch.isfinite(b).all() and b.abs().max() > 0
        cos = (a * b).sum() / (a.norm() * b.norm())
        assert cos >= 0.999 and abs(b.norm() / a.norm() - 1) <= 0.01


def _rays(device, n=64 * 48, seed=0):
    """Seeded rays from uniform origins in uniform directions, every 16th
    dead (mint == maxt)."""
    g = np.random.default_rng(seed)
    o = g.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.zeros((n,), np.float32)
    maxt = np.full((n,), np.inf, np.float32)
    mint[::16] = maxt[::16] = np.inf
    return [torch.as_tensor(x, device=device) for x in (o, d, mint, maxt)]


def _bit_equal(got, want):
    """Same champion and the same bits of t on every ray: neither side
    contracts FMAs, and both take IEEE sqrt and division."""
    assert torch.equal(got[1], want[1])
    fin = torch.isfinite(want[0])
    assert torch.equal(torch.isfinite(got[0]), fin) and fin.any()
    assert torch.equal(got[0][fin], want[0][fin])


def test_sphere_kernel_matches_plain_version(cuda):
    sp = sphere_field(1024, device=cuda).spheres
    rows = HK.sphere_rows(sp.center, sp.radius, sp.mask)
    rays = _rays(cuda)
    before = HK.sphere_launches
    got = HK.sphere_search_rows(*rays, rows)
    torch.cuda.synchronize()
    assert HK.sphere_launches == before + 1
    _bit_equal(got, HK.sphere_search_reference(*rays, rows))


@pytest.mark.parametrize("two_sided", [False, True])
def test_triangle_kernel_matches_plain_version(cuda, two_sided, monkeypatch):
    """Kernel 5's brute loop on 600 triangles (the threshold raised past
    them; the tree instance: tests/test_torch_tri_tree.py)."""
    g = np.random.default_rng(1)
    tris = make_triangles((g.uniform(-4, 4, (600, 1, 3))
                           + g.uniform(-0.6, 0.6, (600, 3, 3)))
                          .astype(np.float32), device=cuda)
    rows = HK.triangle_rows(tris.v, tris.mask)
    monkeypatch.setattr(HK, "TRIANGLE_BRUTE_MAX", rows.shape[0])
    rays = _rays(cuda, seed=2)
    before = HK.triangle_launches
    got = HK.triangle_search_rows(*rays, rows, two_sided)
    torch.cuda.synchronize()
    assert HK.triangle_launches == before + 1
    _bit_equal(got, HK.triangle_search_reference(*rays, rows, two_sided))


def test_stage_pass_matches_kernel_1(cuda):
    """The stage route through kernels 4 and 5 against kernel 1, cornell
    64x48 b2, same pass key, with chip_smoke phase 10's gates."""
    cfg = RenderConfig(width=64, height=48, bounces=2, use_pallas=True)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    k4, k5 = HK.sphere_launches, HK.triangle_launches
    got = pt.render_pass(scene, pt.init_state(cfg, cuda), cfg)["acc"]
    torch.cuda.synchronize()
    # 3 closest-hit and 3 any-hit searches per type at b2
    assert (HK.sphere_launches - k4, HK.triangle_launches - k5) == (6, 6)
    mcfg = replace(cfg, use_megakernel=True)
    want = pt.render_pass(scene, pt.init_state(mcfg, cuda), mcfg)["acc"]
    beyond = ((got - want).abs() > TOL + TOL * want.abs()).any(-1)
    assert torch.isfinite(got).all()
    assert beyond.float().mean().item() <= 0.01
    gm, wm = got.double().mean().item(), want.double().mean().item()
    assert abs(gm - wm) <= 1e-5 * abs(wm)


def _record(tables, acc, u, cfg):
    return MK.pathtrace_pass(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:], acc,
        u, spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
        two_sided=False, normalize_emitter=True, seed=cfg.seed, record=True)


def test_recording_kernel_1_bit_equals_its_plain_launch(cuda):
    """Recording changes no arithmetic: the accumulator equals the
    non-recording launch's bit for bit; every slot of the record is written
    (a dead path's too) and agrees with the plain version's record on
    nearly every ray (kernel 1 contracts FMAs)."""
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True)
    scene = sphere_field(200, cols=64, rows=48, device=cuda)
    tables = mega.scene_tables(scene, cfg)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    before = MK.launches
    acc, ids, occs = _record(tables, zeros.clone(), u, cfg)
    plain_launch = MK.pathtrace_pass(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        zeros.clone(), u, spp=1, width=64, bounces=3, two_sided=False,
        normalize_emitter=True, seed=cfg.seed)
    torch.cuda.synchronize()
    assert MK.launches == before + 2
    assert torch.equal(acc, plain_launch)
    want_acc, want_ids, want_occs = MK.pathtrace_pass_reference(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        zeros, u, spp=1, width=64, bounces=3, two_sided=False,
        normalize_emitter=True, seed=cfg.seed, record=True)
    assert ids.shape == want_ids.shape and occs.shape == want_occs.shape
    assert ((ids >= -1) & (ids < 200)).all()
    assert (ids == want_ids).double().mean().item() >= 0.99
    assert (occs == want_occs).double().mean().item() >= 0.99
    assert (ids[-1] == -1).any()


def test_champion_kernel_matches_plain_version(cuda):
    """Kernel 3 (u-planes and PRNG routes) vs its plain version on kernel
    1's own record, so both differentiate the same champions: sphere_field
    past the unroll budget and cornell (triangle champions), 64x48 b2, all
    five groups, seeded random g; phase 6's gates."""
    cfg = RenderConfig(width=64, height=48, bounces=2, use_megakernel=True)
    for scene in (sphere_field(200, cols=64, rows=48, device=cuda),
                  cornell_box(cols=64, rows=48, device=cuda)):
        tables = mega.scene_tables(scene, cfg)
        ipar = torch.tensor([0, 0], dtype=torch.int32)
        u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                                   scene.lights.count, cuda)
        _, ids, occs = _record(tables, torch.zeros(
            (cfg.total_rays, 3), device=cuda), None, cfg)
        g = torch.as_tensor(np.random.default_rng(3).normal(
            size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
        kw = dict(spp=1, width=64, bounces=2, two_sided=False,
                  normalize_emitter=True, seed=cfg.seed)
        want = MKG.pathtrace_pass_bwd_champ_reference(
            tables[0], ipar, *tables[1:], g, u, ids, occs, **kw)
        before = MKG.champ_launches
        for planes in (u, None):
            got = MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:],
                                               g, planes, ids, occs, **kw)
            torch.cuda.synchronize()
            _gates([a for a in want if a.numel()],
                   [b for b in got if b.numel()], names=[
                       n for n, a in zip(MKG.DIFF_ALL, want) if a.numel()])
        assert MKG.champ_launches == before + 2


def test_cell_route_trains_through_kernels_1_and_3(cuda):
    """A requires-grad render_pass past 64 spheres on the card: one launch
    each of kernels 1 and 3, none of kernel 2, and the sphere and material
    gradients of the same route on the CPU (plain versions)."""
    cfg = RenderConfig(width=64, height=48, bounces=2,
                       mega_grad_wrt=("sph", "mat"), use_megakernel=True)

    def grads(device):
        scene = sphere_field(100, cols=64, rows=48, device=device)
        assert mega.bwd_impl_for(scene, cfg) == "cell"
        c = scene.spheres.center.clone().requires_grad_(True)
        m = scene.materials.clone().requires_grad_(True)
        sc = replace(scene, spheres=replace(scene.spheres, center=c),
                     materials=m)
        st = pt.render_pass(sc, pt.init_state(cfg, device), cfg)
        (pt.image(st, cfg) ** 2).mean().backward()
        return c.grad.cpu(), m.grad.cpu()

    counts = MK.launches, MKG.launches, MKG.champ_launches
    got = grads(cuda)
    assert (MK.launches, MKG.launches, MKG.champ_launches) == (
        counts[0] + 1, counts[1], counts[2] + 1)
    for a, b in zip(grads("cpu"), got):
        assert torch.isfinite(b).all() and b.abs().max() > 0
        cos = (a * b).sum() / (a.norm() * b.norm())
        assert cos >= 0.999 and abs(b.norm() / a.norm() - 1) <= 0.01


def _one_sphere(w, h, device):
    """One sphere filling the whole view, lit from behind the camera: every
    ray's champion is sphere 0, the worst case for kernel 2's row
    reductions."""
    return build_scene(
        camera=Camera.look_at([0.0, 0.0, 12.0], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0], 60.0, w, h),
        spheres=make_spheres([[0.0, 0.0, 0.0]], [9.0], [0]),
        lights=Lights.make([[0.0, 6.0, 30.0]], [[0.0, 0.0, -1.0]],
                           [[25.0, 25.0, 25.0]], [2.0]),
        materials=np.array([[0.9, 0.8, 0.7, 1.0]], np.float32),
        focal_length=12.0, lens_diameter=0.0).to(device)


@pytest.mark.parametrize("scene_name", ["one_sphere", "sphere_field(64)"])
def test_adjoint_kernel_under_row_contention(cuda, scene_name):
    """Kernel 2 vs its plain version where every lane of a warp adds into
    the same sphere row (one sphere fills the view), and spread over the 64
    rows of sphere_field(64): all five groups, b5, phase 6's gates, both
    draw routes."""
    w, h = 64, 48
    cfg = RenderConfig(width=w, height=h, bounces=5, use_megakernel=True)
    scene = (_one_sphere(w, h, cuda) if scene_name == "one_sphere"
             else sphere_field(64, cols=w, rows=h, device=cuda))
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    kw = dict(spp=1, width=w, bounces=5, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    if scene_name == "one_sphere":
        _, ids, _ = _record(tables, torch.zeros((cfg.total_rays, 3),
                                                device=cuda), u, cfg)
        assert (ids[0] == 0).all()
    g = torch.as_tensor(np.random.default_rng(4).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    want = MKG.pathtrace_pass_bwd_reference(tables[0], ipar, *tables[1:], g,
                                            u, **kw)
    names = [n for n, a in zip(MKG.DIFF_ALL, want) if a.numel()]
    for planes in (u, None):
        got = MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, planes,
                                     **kw)
        torch.cuda.synchronize()
        _gates([a for a in want if a.numel()], [b for b in got if b.numel()],
               names=names)


# the fewest spheres for which kernel 1 runs its 8-row sphere loop
# (csrc/megakernel.cu kWideSpheres)
WIDE_SPHERES = 512


def _masked(scene, masked):
    """``scene`` with the spheres where ``masked`` is true masked out."""
    sp = scene.spheres
    return replace(scene, spheres=replace(sp, mask=sp.mask & ~masked))


@pytest.mark.parametrize("scene_name", ["cornell", "sphere_field(512)"])
def test_exact_kernel_1_skips_a_masked_sphere_in_front(cuda, scene_name):
    """Kernel 1 reads a sphere's mask only for a candidate that beats the
    champion. On cornell a masked sphere in front of the first sphere (the
    2-row sphere loop); on sphere_field(512) every third sphere masked (the
    8-row loop). Its --fmad=false build equals the plain version on every
    ray, champion and occlusion bit (chip_smoke phase 11's check), and no
    masked sphere is recorded, though some would be champions unmasked."""
    cfg = RenderConfig(width=64, height=48, bounces=5, use_megakernel=True)
    if scene_name == "cornell":
        scene = cornell_box(cols=64, rows=48, device=cuda)
        sp = scene.spheres
        scene = replace(scene, spheres=replace(
            sp, center=torch.cat([sp.center, torch.tensor(
                [[-0.4, -0.55, 0.9]], device=cuda)]),
            radius=torch.cat([sp.radius, torch.tensor([0.3], device=cuda)]),
            mat_id=torch.cat([sp.mat_id, torch.tensor(
                [4], dtype=torch.int32, device=cuda)]),
            mask=torch.cat([sp.mask, torch.tensor([True], device=cuda)])))
        masked = torch.tensor([False, False, True], device=cuda)
    else:
        scene = sphere_field(WIDE_SPHERES, cols=64, rows=48, device=cuda)
        masked = torch.arange(WIDE_SPHERES, device=cuda) % 3 == 0
    kw = dict(spp=1, width=64, bounces=5, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    tables = mega.scene_tables(scene, cfg)
    _, unmasked_ids, _ = MK.pathtrace_pass_reference(
        tables[0], ipar, *tables[1:], zeros, u, record=True, **kw)
    masked_ids = masked.nonzero().flatten()
    assert torch.isin(unmasked_ids[0], masked_ids).any()
    scene = _masked(scene, masked)
    tables = mega.scene_tables(scene, cfg)
    acc, ids, occs = MK.pathtrace_pass(tables[0], ipar, *tables[1:],
                                       zeros.clone(), u, record=True,
                                       build_flags=("--fmad=false",), **kw)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], zeros,
                                       u, record=True, **kw)
    torch.cuda.synchronize()
    assert not torch.isin(ids, masked_ids).any()
    assert torch.equal(ids, want[1]) and torch.equal(occs, want[2])
    beyond = ((acc - want[0]).abs() > TOL + TOL * want[0].abs()).any(-1)
    assert not beyond.any()


def test_kernel_1_keeps_4608_spheres_resident(cuda):
    """The largest resident table (147 KB of shared memory, above the 48 KB
    a launch gets without opting in) against the plain version."""
    cfg = RenderConfig(width=32, height=24, bounces=1, use_megakernel=True)
    scene = sphere_field(4608, cols=32, rows=24, device=cuda)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    got = mega.render_pass_mega(scene, pt.init_state(cfg, cuda), cfg,
                                u_planes=u)["acc"]
    tables = mega.scene_tables(scene, cfg)
    want = MK.pathtrace_pass_reference(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        torch.zeros_like(got), u, spp=1, width=32, bounces=1,
        two_sided=False, normalize_emitter=True, seed=cfg.seed)
    beyond = ((got - want).abs() > TOL + TOL * want.abs()).any(-1)
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert beyond.float().mean().item() <= 0.01


def _rr_setup(device, w=64, h=48, bounces=4, start=0, white=(1.0, 1.0, 1.0)):
    """Cornell with the roulette from depth ``start``; ``white`` is the
    white walls' albedo (cornell's exact 1.0 ties the throughput's channels
    on the clip bound)."""
    cfg = RenderConfig(width=w, height=h, bounces=bounces,
                       russian_roulette=True, rr_start_depth=start,
                       use_megakernel=True)
    scene = cornell_box(cols=w, rows=h, device=device)
    mat = scene.materials.clone()
    mat[0, :3] = torch.tensor(white, device=device)
    scene = replace(scene, materials=mat)
    tables = mega.scene_tables(scene, cfg)
    u = mega.u_planes_for_pass(pt.init_state(cfg, device)["key"], 0, cfg,
                               scene.lights.count, device)
    kw = dict(spp=1, width=w, bounces=bounces, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, russian_roulette=True,
              rr_start_depth=start)
    return cfg, tables, u, kw


@pytest.mark.parametrize("start", [0, 2])
def test_roulette_kernel_1_matches_plain_version(cuda, start):
    """Kernel 1 with Russian roulette: the default build within phase 3's
    gates of the plain version on the same u-planes, the --fmad=false build
    equal to it on every ray, id and bit, and the PRNG route equal to the
    u-planes route."""
    cfg, tables, u, kw = _rr_setup(cuda, bounces=5, start=start)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    z = torch.zeros((cfg.total_rays, 3), device=cuda)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], z, u,
                                       record=True, **kw)
    before = MK.launches
    got = MK.pathtrace_pass(tables[0], ipar, *tables[1:], z.clone(), u, **kw)
    exact = MK.pathtrace_pass(tables[0], ipar, *tables[1:], z.clone(), u,
                              record=True, build_flags=("--fmad=false",),
                              **kw)
    prng = MK.pathtrace_pass(tables[0], ipar, *tables[1:], z.clone(), None,
                             **kw)
    torch.cuda.synchronize()
    assert MK.launches == before + 3
    beyond = ((got - want[0]).abs() > TOL + TOL * want[0].abs()).any(-1)
    assert torch.isfinite(got).all()
    assert beyond.float().mean().item() <= 0.01
    for a, b in zip(exact, want):
        assert torch.equal(a, b)
    assert torch.equal(prng, got)
    # the roulette ended paths before the last segment
    assert ((want[1][2] >= 0) & (want[1][3] < 0)).any()


@pytest.mark.parametrize("white", [(1.0, 1.0, 1.0), (0.8, 0.8, 0.8)])
def test_roulette_adjoint_kernels_match_plain_versions(cuda, white):
    """Kernels 2 and 3 with Russian roulette from depth 0 against their
    plain versions (phase 6's gates), all five groups, both draw routes;
    with white walls of (1, 1, 1) the throughput's channels tie on the
    clip bound, with (0.8, 0.8, 0.8) they tie inside it."""
    cfg, tables, u, kw = _rr_setup(cuda, white=white)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    want = MKG.pathtrace_pass_bwd_reference(tables[0], ipar, *tables[1:], g,
                                            u, **kw)
    _, ids, occs = MK.pathtrace_pass(
        tables[0], ipar, *tables[1:], torch.zeros_like(g), u, record=True,
        **kw)
    want3 = MKG.pathtrace_pass_bwd_champ_reference(
        tables[0], ipar, *tables[1:], g, u, ids, occs, **kw)
    for planes in (u, None):
        _gates(want, MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g,
                                            planes, **kw))
        _gates(want3, MKG.pathtrace_pass_bwd_champ(
            tables[0], ipar, *tables[1:], g, planes, ids, occs, **kw))
    torch.cuda.synchronize()


def test_roulette_on_the_8_row_sphere_loop(cuda):
    """sphere_field(512), kernel 1's 8-row loop, with the roulette from
    depth 0: kernel 1's --fmad=false build equals its plain version on
    every ray, id and bit, its PRNG route equals its u-planes route, and
    kernel 3 on that record meets phase 6's gates against its plain
    version for the training groups ("sph", "mat")."""
    wrt = ("sph", "mat")
    cfg = RenderConfig(width=64, height=48, bounces=5, russian_roulette=True,
                       rr_start_depth=0, use_megakernel=True)
    scene = sphere_field(WIDE_SPHERES, cols=64, rows=48, device=cuda)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    kw = dict(spp=1, width=64, bounces=5, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, russian_roulette=True,
              rr_start_depth=0)
    z = torch.zeros((cfg.total_rays, 3), device=cuda)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], z, u,
                                       record=True, **kw)
    exact = MK.pathtrace_pass(tables[0], ipar, *tables[1:], z.clone(), u,
                              record=True, build_flags=("--fmad=false",),
                              **kw)
    got = MK.pathtrace_pass(tables[0], ipar, *tables[1:], z.clone(), u, **kw)
    prng = MK.pathtrace_pass(tables[0], ipar, *tables[1:], z.clone(), None,
                             **kw)
    for a, b in zip(exact, want):
        assert torch.equal(a, b)
    assert torch.equal(prng, got)
    _, ids, occs = exact
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    want3 = MKG.pathtrace_pass_bwd_champ_reference(
        tables[0], ipar, *tables[1:], g, u, ids, occs, diff_wrt=wrt, **kw)
    got3 = MKG.pathtrace_pass_bwd_champ(
        tables[0], ipar, *tables[1:], g, u, ids, occs, diff_wrt=wrt, **kw)
    torch.cuda.synchronize()
    pick = [MKG.DIFF_ALL.index(n) for n in wrt]
    _gates([want3[i] for i in pick], [got3[i] for i in pick], wrt)


@pytest.mark.parametrize("spp,lens", [(1, 0.0), (4, 0.25)])
def test_direct_mode_kernel_matches_plain_version(cuda, spp, lens):
    """Kernel 1's direct mode on u_planes_for_direct: within phase 3's gates
    of the plain version, its --fmad=false build equal on every ray; its
    PRNG route equal to the u-planes route, and over three passes (pass p
    keyed by pass_key(key, p)) to the plain version's own draws."""
    from raytracing_tpu_torch.core import rng
    cfg = RenderConfig(width=64, height=48, spp=spp, bounces=0,
                       use_megakernel=True)
    scene = cornell_box(cols=64, rows=48, lens_diameter=lens, device=cuda)
    tables = mega.scene_tables(scene, cfg)
    key = rng.base_key(9)
    u = mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
    z = torch.zeros((cfg.total_rays, 3), device=cuda)
    kw = dict(key=key, spp=spp, width=64, two_sided=False)
    want = MK.direct_pass_reference(tables[0], *tables[1:], z, u, **kw)
    before = MK.direct_launches
    got = MK.direct_pass(tables[0], *tables[1:], z.clone(), u, **kw)
    exact = MK.direct_pass(tables[0], *tables[1:], z.clone(), u,
                           build_flags=("--fmad=false",), **kw)
    prng = MK.direct_pass(tables[0], *tables[1:], z.clone(), None, **kw)
    three = MK.direct_pass(tables[0], *tables[1:], z.clone(), None,
                           n_passes=3, build_flags=("--fmad=false",), **kw)
    torch.cuda.synchronize()
    assert MK.direct_launches == before + 4
    beyond = ((got - want).abs() > TOL + TOL * want.abs()).any(-1)
    assert beyond.float().mean().item() <= 0.01 and got.max() > 0
    assert torch.equal(exact, want) and torch.equal(prng, got)
    assert torch.equal(three, MK.direct_pass_reference(
        tables[0], *tables[1:], z, None, n_passes=3, **kw))


def test_exact_kernel_1_without_roulette_still_equals_plain(cuda):
    """The non-roulette instance of the --fmad=false kernel 1 (the build
    beside the roulette one) equals its plain version on every ray, id and
    bit on cornell b5."""
    cfg = RenderConfig(width=64, height=48, bounces=5, use_megakernel=True)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    kw = dict(spp=1, width=64, bounces=5, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    z = torch.zeros((cfg.total_rays, 3), device=cuda)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], z, u,
                                       record=True, **kw)
    got = MK.pathtrace_pass(tables[0], ipar, *tables[1:], z.clone(), u,
                            record=True, build_flags=("--fmad=false",), **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _torus_scene(device, w=64, h=48):
    """cornell plus the 992-triangle torus mesh of the grid tests, its
    kernel grid at auto_slabs(992) = 3."""
    from raytracing_tpu_torch.accel import prepare_grids
    from torch_grid_scenes import cornell_torus
    return prepare_grids(cornell_torus(w, h, 31, 16, device=device), 3,
                         mesh_slabs="auto")


@pytest.mark.parametrize("mode", ["direct", "path", "roulette"])
def test_grid_kernel_matches_plain_version(cuda, mode):
    """Kernel 1's grid mode on cornell + torus: its --fmad=false build
    equals the plain grid version on every ray, id and bit (and that the
    brute plain version); the default build within phase 3's gates."""
    scene = _torus_scene(cuda)
    cfg = RenderConfig(width=64, height=48, use_megakernel=True,
                       use_grid=True, bounces=0 if mode == "direct" else 4,
                       russian_roulette=mode == "roulette", rr_start_depth=1)
    tables = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    if mode == "direct":
        key = torch.as_tensor(np.array([0, 5], np.uint32))
        u = mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
        kw = dict(key=key, spp=1, width=64, two_sided=False)
        want = (MK.direct_pass_reference(*tables, zeros, u, grid=grid, **kw),)
        brute = (MK.direct_pass_reference(*tables, zeros, u, **kw),)
        got = (MK.direct_pass(*tables, zeros.clone(), u, grid=grid, **kw),)
        exact = (MK.direct_pass(*tables, zeros.clone(), u, grid=grid,
                                build_flags=("--fmad=false",), **kw),)
    else:
        ipar = torch.tensor([0, 0], dtype=torch.int32)
        u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                                   scene.lights.count, cuda)
        kw = dict(spp=1, width=64, bounces=cfg.bounces, two_sided=False,
                  normalize_emitter=True, seed=cfg.seed, record=True,
                  russian_roulette=cfg.russian_roulette, rr_start_depth=1)
        want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:],
                                           zeros, u, grid=grid, **kw)
        brute = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:],
                                            zeros, u, **kw)
        got = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(),
                                u, grid=grid, **kw)
        exact = MK.pathtrace_pass(tables[0], ipar, *tables[1:],
                                  zeros.clone(), u, grid=grid,
                                  build_flags=("--fmad=false",), **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(exact, want, brute):
        assert torch.equal(a, b)
        if a.dtype != torch.float32:
            assert torch.equal(b, c)
    assert (want[0] - brute[0]).abs().max().item() <= 1e-6
    beyond = ((got[0] - want[0]).abs() > TOL + TOL * want[0].abs()).any(-1)
    assert torch.isfinite(got[0]).all() and got[0].max() > 0
    assert beyond.float().mean().item() <= 0.01


def test_grid_blocked_layout_is_bit_equal(cuda):
    """mega_block only maps threads to pixels: 16 x 16 blocks give the
    row-major image, accumulator and record bit for bit."""
    scene = _torus_scene(cuda)
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True,
                       use_grid=True)
    tables = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    kw = dict(spp=1, width=64, bounces=3, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, record=True, grid=grid)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    a = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(), None,
                          **kw)
    b = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(), None,
                          block=16, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    dcfg = replace(cfg, bounces=0)
    img0 = mega.render_direct_mega(scene, dcfg, n_passes=3)
    img16 = mega.render_direct_mega(scene, replace(dcfg, mega_block=16),
                                    n_passes=3)
    assert torch.equal(img0, img16)


def test_sphere_grid_kernel_matches_brute(cuda, monkeypatch):
    """The kernel's sphere grid (sphere_field(600), the resident budget
    patched to 64): its --fmad=false build equals the brute plain version
    on every ray, id and bit."""
    from raytracing_tpu_torch.accel import prepare_grids
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    scene = prepare_grids(sphere_field(600, cols=64, rows=48, device=cuda),
                          1)
    assert scene.mega_sph_grid is not None
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True,
                       use_grid=True)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    kw = dict(spp=1, width=64, bounces=3, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, record=True)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    exact = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(), u,
                              grid=mega.grid_tables(scene, tables[1],
                                                    tables[2]),
                              build_flags=("--fmad=false",), **kw)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], zeros,
                                       u, **kw)
    torch.cuda.synchronize()
    for a, b in zip(exact, want):
        assert torch.equal(a, b)


def test_grid_cell_route_trains_through_kernels_1_and_3(cuda):
    """render_pass on the torus scene in grid mode with ("sph", "mat",
    "tri") requiring grad: one kernel-1 (grid recording) and one kernel-3
    launch, no kernel 2, finite gradients that reach the mesh."""
    scene = _torus_scene(cuda)
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True,
                       use_grid=True, mega_grad_wrt=("sph", "mat", "tri"))
    m = scene.meshes[0]
    tv = m.tris.v.clone().requires_grad_(True)
    mat = scene.materials.clone().requires_grad_(True)
    sc = replace(scene, materials=mat,
                 meshes=(replace(m, tris=replace(m.tris, v=tv)),))
    k1, k2, k3 = MK.launches, MKG.launches, MKG.champ_launches
    st = pt.render_pass(sc, pt.init_state(cfg, cuda), cfg)
    torch.mean(pt.image(st, cfg) ** 2).backward()
    torch.cuda.synchronize()
    assert (MK.launches - k1, MKG.launches - k2,
            MKG.champ_launches - k3) == (1, 0, 1)
    assert torch.isfinite(tv.grad).all() and tv.grad.abs().max() > 0
    assert torch.isfinite(mat.grad).all() and mat.grad.abs().max() > 0


def _cell_scene(kind, res, device, w=64, h=48, segments=(31, 16)):
    """A grid scene whose cells hold 0, 1, a leaf's and a leaf and one
    rows at grid resolution ``res``: the torus scene (992 triangles at the
    default ``segments``) with its mesh grid at res^3, or sphere_field(600)
    (the resident budget patched to 64 by the caller) with its sphere grid
    rebuilt at res^3."""
    import dataclasses
    from raytracing_tpu_torch.accel import prepare_grids
    from raytracing_tpu_torch.accel.grid import build_sphere_grid
    from torch_grid_scenes import cornell_torus
    if kind == "tri":
        return prepare_grids(cornell_torus(w, h, *segments, device=device),
                             3, mesh_slabs=res)
    sc = prepare_grids(sphere_field(600, cols=w, rows=h, device=device), 1)
    g = build_sphere_grid(sc.spheres, sc.sphere_bounds_min,
                          sc.sphere_bounds_max, res)
    return dataclasses.replace(sc, mega_sph_grid=g)


@pytest.mark.parametrize("res,leaf", [(1, 2), (2, 1), (3, 1), (3, 2),
                                      (3, 4), (3, 8), (5, 4)])
@pytest.mark.parametrize("kind", ["tri", "sph"])
def test_grid_cell_walk_equals_plain_version(cuda, monkeypatch, kind, res,
                                             leaf):
    """The mesh grid's cell trees at grid resolutions 1 to 5 (one cell of
    every row down to cells of none, one, a leaf's and a leaf and one
    rows) and at each leaf size, and the sphere grid (walked through its
    CSR) beside the same: the --fmad=false build equals the plain grid
    version (the march over every item of each cell) on every ray, id and
    bit, path b3 and direct; the record names original rows."""
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    monkeypatch.setattr(MK, "GRID_LEAF", leaf)
    scene = _cell_scene(kind, res, cuda)
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True,
                       use_grid=True)
    tables = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    assert [cp.leaf for cp in grid.copies] == ([leaf] if kind == "tri"
                                               else [])
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    kw = dict(spp=1, width=64, bounces=3, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, record=True, grid=grid)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    exact = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(), u,
                              build_flags=("--fmad=false",), **kw)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], zeros,
                                       u, **kw)
    key = torch.as_tensor(np.array([0, 5], np.uint32))
    du = mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
    dkw = dict(key=key, spp=1, width=64, two_sided=False, grid=grid,
               record=True)
    dexact = MK.direct_pass(*tables, zeros.clone(), du,
                            build_flags=("--fmad=false",), **dkw)
    dwant = MK.direct_pass_reference(*tables, zeros, du, **dkw)
    torch.cuda.synchronize()
    n_sph = tables[1].shape[0]
    hit = want[1][want[1] >= 0]
    assert ((hit >= n_sph) if kind == "tri" else (hit < n_sph)).any()
    assert int(want[1].max()) < n_sph + tables[2].shape[0]
    for a, b in zip(tuple(exact) + tuple(dexact), tuple(want) + tuple(dwant)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["tri", "sph"])
def test_grid_kernel_3_on_the_cell_walk_record(cuda, monkeypatch, kind):
    """Kernel 1's record over the cell walk names original rows (its ids
    and bits equal the plain grid version's, --fmad=false) and kernel 3 on
    it matches its plain version under phase 6's gates."""
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    scene = _cell_scene(kind, 3, cuda)
    cfg = RenderConfig(width=64, height=48, bounces=2, use_megakernel=True,
                       use_grid=True)
    tables = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    kw = dict(spp=1, width=64, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    _, ids, occs = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros,
                                     None, record=True, grid=grid,
                                     build_flags=("--fmad=false",), **kw)
    _, wids, woccs = MK.pathtrace_pass_reference(
        tables[0], ipar, *tables[1:], zeros, None, record=True, grid=grid,
        **kw)
    torch.cuda.synchronize()
    assert torch.equal(ids, wids) and torch.equal(occs, woccs)
    g = torch.as_tensor(np.random.default_rng(3).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    wrt = MKG.DIFF_ALL
    want = MKG.pathtrace_pass_bwd_champ_reference(
        tables[0], ipar, *tables[1:], g, None, ids, occs, diff_wrt=wrt, **kw)
    got = MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:], g, None,
                                       ids, occs, diff_wrt=wrt, **kw)
    torch.cuda.synchronize()
    _gates(*zip(*[(a, b) for a, b in zip(want, got) if a.numel()]),
           names=[n for n, a in zip(MKG.DIFF_ALL, want) if a.numel()])


@pytest.mark.parametrize("kind", ["tri", "sph"])
def test_grid_pallas_backward_through_the_large_entry(cuda, monkeypatch,
                                                      kind):
    """mega_bwd_impl="pallas" on a grid scene (the mesh grid, the sphere
    grid) runs kernel 1 and kernel 2's large-table route, whose record
    walks the same cells; its cotangents match the plain
    backward's (phase 6's gates; the torus of 256 triangles, whose brute
    plain backward runs per object)."""
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    scene = _cell_scene(kind, 3, cuda, 32, 24, (16, 8))
    cfg = RenderConfig(width=32, height=24, bounces=2, use_megakernel=True,
                       use_grid=True, mega_bwd_impl="pallas",
                       mega_grad_wrt=MKG.DIFF_ALL)
    assert mega.bwd_impl_for(scene, cfg) == "pallas"
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=32, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    want = MKG.pathtrace_pass_bwd_reference(tables[0], ipar, *tables[1:], g,
                                            None, **kw)
    large = MKG.large_launches
    got = MKG.pathtrace_pass_bwd(
        tables[0], ipar, *tables[1:], g, None,
        grid=mega.grid_tables(scene, tables[1], tables[2]), **kw)
    torch.cuda.synchronize()
    assert MKG.large_launches == large + 1
    _gates(*zip(*[(a, b) for a, b in zip(want, got) if a.numel()]),
           names=[n for n, a in zip(MKG.DIFF_ALL, want) if a.numel()])
    # and through render_pass: one kernel-1 and one large kernel-2 launch
    m = scene.materials.clone().requires_grad_(True)
    k1, large = MK.launches, MKG.large_launches
    st = pt.render_pass(replace(scene, materials=m), pt.init_state(cfg, cuda),
                        cfg)
    torch.mean(pt.image(st, cfg) ** 2).backward()
    torch.cuda.synchronize()
    assert (MK.launches - k1, MKG.large_launches - large) == (1, 1)
    assert torch.isfinite(m.grad).all() and m.grad.abs().max() > 0


def test_grid_kernel_rejects_a_bad_copy(cuda):
    """A grid without its cell-major copies, or with copies of the wrong
    shapes or leaves, raises in the wrapper; the C entry checks the
    descriptor itself (pathtrace.cuh grid_ok): a leaf of 3 or 64 rows or a
    missing node table returns cudaErrorInvalidValue and launches
    nothing."""
    scene = _torus_scene(cuda, 16, 16)
    cfg = RenderConfig(width=16, height=16, bounces=0, use_megakernel=True,
                       use_grid=True)
    par, sph, tri, mat, lig = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, sph, tri)
    acc = torch.zeros((cfg.total_rays, 3), device=cuda)
    kw = dict(key=torch.zeros(2, dtype=torch.int32), spp=1, width=16,
              two_sided=False)
    cp = grid.copies[0]
    for bad in (grid._replace(copies=None),
                grid._replace(copies=(cp._replace(leaf=3),)),
                grid._replace(copies=(cp._replace(leaf=64),)),
                grid._replace(copies=(cp._replace(
                    rows=cp.rows[:, :8].contiguous()),)),
                grid._replace(copies=(cp._replace(perm=cp.perm.long()),)),
                grid._replace(copies=(cp._replace(
                    cell=cp.cell[:-1].contiguous()),)),
                grid._replace(copies=(cp._replace(
                    nodes=cp.nodes[:, :6].contiguous()),))):
        with pytest.raises(ValueError, match="grid"):
            MK.direct_pass(par, sph, tri, mat, lig, acc, None, grid=bad, **kw)
    lib = MK._lib(grid, None, ())
    p = MK._ptr
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for field, value in (("leaf", 3), ("leaf", 64), ("node", None)):
        gargs, (desc, _) = MK._grid_args(grid, None, sph.shape[0],
                                         tri.shape[0])
        setattr(desc[0], field, value)
        err = lib.rt_direct_pass(
            p(par), p(sph), sph.shape[0], p(tri), tri.shape[0], p(mat),
            mat.shape[0], p(lig), lig.shape[0], p(acc), acc.shape[0], 0,
            None, 0, 7, 0, 0, 1, 1, 16, 0, None, None, None, *gargs, None,
            0, stream)
        assert err == 1, (field, value, err)
    gargs, _desc = MK._grid_args(grid, None, sph.shape[0], tri.shape[0])
    err = lib.rt_direct_pass(
        p(par), p(sph), sph.shape[0], p(tri), tri.shape[0], p(mat),
        mat.shape[0], p(lig), lig.shape[0], p(acc), acc.shape[0], 0, None,
        0, 7, 0, 0, 1, 1, 16, 0, None, None, None, *gargs, None, 0,
        stream)
    torch.cuda.synchronize()
    assert err == 0 and acc.max() > 0


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("wrt", [MKG.DIFF_ALL, ("sph", "mat")],
                         ids=["all", "sph-mat"])
def test_soft_adjoint_kernel_matches_plain_version(cuda, rr, wrt):
    """Kernel 2s (u-planes and PRNG routes) vs its plain version (autograd
    of the soft program), cornell 64x48 b2, seeded random g, bandwidth and
    tau 2e-2, with and without the roulette (from depth 1); the groups
    outside diff_wrt stay zero."""
    cfg = RenderConfig(width=64, height=48, bounces=2, russian_roulette=rr,
                       rr_start_depth=1, use_megakernel=True)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    g = torch.as_tensor(np.random.default_rng(4).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=64, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, russian_roulette=rr,
              rr_start_depth=1, diff_wrt=wrt, soft_bandwidth=2e-2,
              soft_tau=2e-2)
    want = MKS.pathtrace_pass_bwd_soft_reference(tables[0], ipar,
                                                 *tables[1:], g, u, **kw)
    before = MKS.soft_launches
    for planes in (u, None):
        got = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g,
                                          planes, **kw)
        torch.cuda.synchronize()
        _gates([a for n, a in zip(MKG.DIFF_ALL, want) if n in wrt],
               [b for n, b in zip(MKG.DIFF_ALL, got) if n in wrt], wrt)
        for n, b in zip(MKG.DIFF_ALL, got):
            assert n in wrt or not b.any(), n
    assert MKS.soft_launches == before + 2


def test_soft_adjoint_kernel_on_66_objects(cuda):
    """Kernel 2s's full scratch and two-level composite (6 spheres and 60
    triangles: more than 64 hypotheses, at most 64 of each type) vs its
    plain version, 32x24 b2, all five groups."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_edge_scenes import split_tables

    cfg = RenderConfig(width=32, height=24, bounces=2, use_megakernel=True)
    scene = cornell_box(cols=32, rows=24)
    tables = [torch.as_tensor(t, device=cuda) for t in split_tables(
        [t.numpy() for t in mega.scene_tables(scene, cfg)],
        scene.triangles.v.numpy(), scene.triangles.vn.numpy())]
    assert tables[1].shape[0] + tables[2].shape[0] > 64
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=32, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, soft_bandwidth=2e-2,
              soft_tau=2e-2)
    want = MKS.pathtrace_pass_bwd_soft_reference(tables[0], ipar,
                                                 *tables[1:], g, None, **kw)
    got = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, None,
                                      **kw)
    torch.cuda.synchronize()
    _gates(want, got)


def test_edge_route_trains_through_kernels_1_and_2s(cuda):
    """A requires-grad render_pass in edge mode on the card: one launch of
    kernel 1 and one of kernel 2s (none of kernel 2), the hard forward, and
    the gradients of the same route on the CPU (the plain versions)."""
    cfg = RenderConfig(width=64, height=48, bounces=2,
                       mega_edge_bandwidth=2e-2, use_megakernel=True)

    def run(device):
        scene = cornell_box(cols=64, rows=48, device=device)
        c = scene.spheres.center.clone().requires_grad_(True)
        v = scene.triangles.v.clone().requires_grad_(True)
        m = scene.materials.clone().requires_grad_(True)
        sc = replace(scene, spheres=replace(scene.spheres, center=c),
                     triangles=replace(scene.triangles, v=v), materials=m)
        st = pt.render_pass(sc, pt.init_state(cfg, device), cfg)
        (pt.image(st, cfg) ** 2).mean().backward()
        return st["acc"].detach().cpu(), [x.grad.cpu() for x in (c, v, m)]

    k1, k2, k2s = MK.launches, MKG.launches, MKS.soft_launches
    acc, got = run(cuda)
    assert (MK.launches, MKG.launches, MKS.soft_launches) == (
        k1 + 1, k2, k2s + 1)
    with torch.no_grad():
        hard = pt.render_pass(cornell_box(cols=64, rows=48, device=cuda),
                              pt.init_state(cfg, cuda), cfg)["acc"].cpu()
    assert torch.equal(acc, hard)
    _, want = run("cpu")
    for a, b in zip(want, got):
        assert torch.isfinite(b).all() and b.abs().max() > 0
        cos = (a * b).sum() / (a.norm() * b.norm())
        assert cos >= 0.999 and abs(b.norm() / a.norm() - 1) <= 0.01


def test_soft_adjoint_kernel_finite_at_tiny_bandwidth(cuda):
    """Bandwidth and tau 1e-4 on cornell 64x48 b2 with a wide field of view
    (rays that leave the open box, cov ~ 0): every cotangent finite, and
    the plain version's too."""
    cfg = RenderConfig(width=64, height=48, bounces=2, use_megakernel=True)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    scene = replace(scene, camera=Camera.look_at(
        [0.0, 0.0, 2.6], [0.0, -0.1, 0.0], [0.0, 1.0, 0.0], 110.0, 64, 48,
        device=cuda))
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=64, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, soft_bandwidth=1e-4,
              soft_tau=1e-4)
    got = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, None,
                                      **kw)
    want = MKS.pathtrace_pass_bwd_soft_reference(tables[0], ipar,
                                                 *tables[1:], g, None, **kw)
    for name, a, b in zip(MKG.DIFF_ALL, want, got):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name


@pytest.mark.parametrize("mode", ["direct", "path", "roulette"])
def test_streamed_kernel_matches_plain_version(cuda, mode):
    """Kernel 1 over the streamed torus scene (cornell plus 992 triangles,
    8 Morton chunks, no grid): its --fmad=false build equals the plain
    streamed version on every ray, id and bit; the default build is within
    1% of rays beyond 2e-4 and names original rows."""
    from torch_grid_scenes import cornell_torus
    scene = cornell_torus(64, 48, 31, 16, device=cuda)
    cfg = RenderConfig(width=64, height=48,
                       bounces=0 if mode == "direct" else 3,
                       use_megakernel=True,
                       russian_roulette=mode == "roulette", rr_start_depth=1)
    tables = mega.scene_tables(scene, cfg)
    chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
    assert chunks.tri.n_chunks == 8 and chunks.sph is None
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    before = MK.stream_launches
    if mode == "direct":
        key = torch.as_tensor(np.array([0, 5], np.uint32))
        u = mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
        kw = dict(key=key, spp=1, width=64, two_sided=False, chunks=chunks)
        want = (MK.direct_pass_reference(*tables, zeros, u, **kw),)
        got = (MK.direct_pass(*tables, zeros.clone(), u, **kw),)
        exact = (MK.direct_pass(*tables, zeros.clone(), u,
                                build_flags=("--fmad=false",), **kw),)
    else:
        ipar = torch.tensor([0, 0], dtype=torch.int32)
        u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                                   scene.lights.count, cuda)
        kw = dict(spp=1, width=64, bounces=3, two_sided=False,
                  normalize_emitter=True, seed=cfg.seed, record=True,
                  russian_roulette=cfg.russian_roulette, rr_start_depth=1,
                  chunks=chunks)
        want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:],
                                           zeros, u, **kw)
        got = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(),
                                u, **kw)
        exact = MK.pathtrace_pass(tables[0], ipar, *tables[1:],
                                  zeros.clone(), u,
                                  build_flags=("--fmad=false",), **kw)
        assert (got[1] >= tables[1].shape[0]).any()
        assert int(got[1].max()) < tables[1].shape[0] + tables[2].shape[0]
    torch.cuda.synchronize()
    assert MK.stream_launches == before + 2
    for a, b in zip(exact, want):
        assert torch.equal(a, b)
    beyond = ((got[0] - want[0]).abs()
              > TOL + TOL * want[0].abs()).any(-1).float().mean().item()
    assert torch.isfinite(got[0]).all() and beyond <= 0.01


def test_streamed_spheres_kernel_matches_brute(cuda, monkeypatch):
    """sphere_field(600) streamed (the resident budget patched to 64, 5
    chunks): the --fmad=false build equals the brute plain version on every
    ray, id and bit."""
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    scene = sphere_field(600, cols=64, rows=48, device=cuda)
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True)
    assert mega.streamed(scene, cfg) == (False, True)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    kw = dict(spp=1, width=64, bounces=3, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, record=True)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    exact = MK.pathtrace_pass(
        tables[0], ipar, *tables[1:], zeros.clone(), u,
        chunks=mega.chunk_tables(scene, cfg, tables[1], tables[2]),
        build_flags=("--fmad=false",), **kw)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], zeros,
                                       u, **kw)
    torch.cuda.synchronize()
    for a, b in zip(exact, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("leaf", [1, 2, 4, 8, 16, 32, 64, 128])
def test_streamed_kernel_every_leaf_size(cuda, monkeypatch, leaf):
    """The tree walk at each leaf size the kernel takes (MK.STREAM_LEAF),
    on the house-size torus (5,322 triangles: 5,376 leaves of 1 row down
    to 42 of 128, trees 13 to 6 levels deep) at 64x48 b3: the --fmad=false
    build equals the plain streamed version on every ray, id and bit."""
    from torch_grid_scenes import cornell_torus
    monkeypatch.setattr(MK, "STREAM_LEAF", leaf)
    scene = cornell_torus(64, 48, 83, 32, device=cuda)
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True)
    tables = mega.scene_tables(scene, cfg)
    chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
    assert chunks.tri.tree.leaf == leaf
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    kw = dict(spp=1, width=64, bounces=3, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, record=True,
              chunks=chunks)
    zeros = torch.zeros((cfg.total_rays, 3), device=cuda)
    exact = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(),
                              u, build_flags=("--fmad=false",), **kw)
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], zeros,
                                       u, **kw)
    torch.cuda.synchronize()
    assert (want[1] >= tables[1].shape[0]).any()
    for a, b in zip(exact, want):
        assert torch.equal(a, b)


def test_streamed_kernel_rejects_malformed_tree(cuda):
    """The C entry checks the walk's layout itself (pathtrace.cuh
    stream_ok): a leaf of 48 rows, a tree with too few leaf slots or with
    a count that is not a power of two, or no loose list returns
    cudaErrorInvalidValue and launches nothing."""
    from torch_grid_scenes import cornell_torus
    scene = cornell_torus(16, 16, 31, 16, device=cuda)
    cfg = RenderConfig(width=16, height=16, bounces=0, use_megakernel=True)
    par, sph, tri, mat, lig = mega.scene_tables(scene, cfg)
    chunks = mega.chunk_tables(scene, cfg, sph, tri)
    lib = MK._lib(None, chunks, ())
    acc = torch.zeros((cfg.total_rays, 3), device=cuda)
    p = MK._ptr
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for field, value in (("leaf", 48), ("n_slots", 2), ("n_slots", 24),
                         ("n_loose", 0)):
        gargs, streams = MK._grid_args(None, chunks, sph.shape[0],
                                       tri.shape[0])
        setattr(streams[0], field, value)
        err = lib.rt_direct_pass(
            p(par), p(sph), sph.shape[0], p(tri), tri.shape[0], p(mat),
            mat.shape[0], p(lig), lig.shape[0], p(acc), acc.shape[0], 0,
            None, 0, 7, 0, 0, 1, 1, 16, 0, None, None, None, *gargs, None,
            0, stream)
        assert err == 1, (field, value, err)
    gargs, streams = MK._grid_args(None, chunks, sph.shape[0], tri.shape[0])
    err = lib.rt_direct_pass(
        p(par), p(sph), sph.shape[0], p(tri), tri.shape[0], p(mat),
        mat.shape[0], p(lig), lig.shape[0], p(acc), acc.shape[0], 0, None,
        0, 7, 0, 0, 1, 1, 16, 0, None, None, None, *gargs, None, 0,
        stream)
    torch.cuda.synchronize()
    assert err == 0 and acc.max() > 0


def test_streamed_blocked_layout_is_bit_equal(cuda):
    """The blocked layout over streamed tables: B = 16 renders B = 0's
    image bit for bit."""
    from torch_grid_scenes import cornell_torus
    scene = cornell_torus(64, 48, 31, 16, device=cuda)
    cfg = RenderConfig(width=64, height=48, bounces=0, use_megakernel=True)
    img0 = mega.render_direct_mega(scene, cfg, n_passes=3)
    img16 = mega.render_direct_mega(scene, replace(cfg, mega_block=16),
                                    n_passes=3)
    assert torch.equal(img0, img16)


def test_streamed_cell_route_trains_through_kernels_1_and_3(cuda):
    """render_pass on the streamed torus scene with ("sph", "mat", "tri")
    requiring grad: one streamed kernel-1 (recording) and one kernel-3
    launch, no kernel 2, finite gradients that reach the mesh."""
    from torch_grid_scenes import cornell_torus
    scene = cornell_torus(64, 48, 31, 16, device=cuda)
    cfg = RenderConfig(width=64, height=48, bounces=3, use_megakernel=True,
                       mega_grad_wrt=("sph", "mat", "tri"))
    m = scene.meshes[0]
    tv = m.tris.v.clone().requires_grad_(True)
    mat = scene.materials.clone().requires_grad_(True)
    sc = replace(scene, materials=mat,
                 meshes=(replace(m, tris=replace(m.tris, v=tv)),))
    k1, k2, k3 = MK.launches, MKG.launches, MKG.champ_launches
    s1 = MK.stream_launches
    st = pt.render_pass(sc, pt.init_state(cfg, cuda), cfg)
    torch.mean(pt.image(st, cfg) ** 2).backward()
    torch.cuda.synchronize()
    assert (MK.launches - k1, MKG.launches - k2,
            MKG.champ_launches - k3, MK.stream_launches - s1) == (1, 0, 1, 1)
    assert torch.isfinite(tv.grad).all() and tv.grad.abs().max() > 0
    assert torch.isfinite(mat.grad).all() and mat.grad.abs().max() > 0


def _large_case(name, device, rr=False, w=32, h=24):
    """(scene, cfg, tables, replay kwargs) of a scene past 64 objects:
    sphere_field(100) (resident spheres), the torus scene streamed, or the
    torus scene over its grids."""
    from torch_grid_scenes import cornell_torus
    from raytracing_tpu_torch.accel import prepare_grids
    grid = name == "torus-grid"
    scene = (sphere_field(100, cols=w, rows=h, device=device)
             if name == "spheres" else cornell_torus(w, h, 16, 8,
                                                     device=device))
    if grid:
        scene = prepare_grids(scene, 2)
    cfg = RenderConfig(width=w, height=h, bounces=2, use_megakernel=True,
                       russian_roulette=rr, rr_start_depth=1, use_grid=grid)
    tables = mega.scene_tables(scene, cfg)
    replay = dict(grid=mega.grid_tables(scene, tables[1], tables[2])
                  if grid else None,
                  chunks=mega.chunk_tables(scene, cfg, tables[1], tables[2]))
    return scene, cfg, tables, replay


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("name", ["spheres", "torus", "torus-grid"])
def test_large_adjoint_kernel_matches_plain_version(cuda, name, rr):
    """Kernel 2 past 64 objects (the record and kernel 3's sweep; resident
    spheres, streamed chunks, grids) vs autograd through the plain forward,
    32x24 b2, all five groups, seeded random g, the u-planes and PRNG
    routes; one count of the large-table route each, none of the small
    one."""
    scene, cfg, tables, replay = _large_case(name, cuda, rr)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    g = torch.as_tensor(np.random.default_rng(7).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=cfg.width, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, russian_roulette=rr,
              rr_start_depth=1)
    want = MKG.pathtrace_pass_bwd_reference(tables[0], ipar, *tables[1:], g,
                                            u, **kw)
    small, large = MKG.launches, MKG.large_launches
    for planes in (u, None):
        got = MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, planes,
                                     **kw, **replay)
        torch.cuda.synchronize()
        _gates(*zip(*[(a, b) for a, b in zip(want, got) if a.numel()]),
               names=[n for n, a in zip(MKG.DIFF_ALL, want) if a.numel()])
    assert (MKG.launches, MKG.large_launches) == (small, large + 2)


@pytest.mark.parametrize("mode", ["path", "rr", "direct"])
@pytest.mark.parametrize("name", ["torus", "torus-grid", "spheres1024"])
def test_split_record_equals_uncontracted_kernel1(cuda, name, mode):
    """Kernel 2's first launch past 64 objects (``MKG._record``, the
    record that kernel 3 then sweeps) against kernel 1's --fmad=false
    recording build, ``MK.pathtrace_pass(record=True)`` /
    ``MK.direct_pass(record=True)``, on the same draws (u-planes and PRNG):
    on a cotangent without a zero row ids equal id for id and occs bit for
    bit; on one whose rows are zero on every third ray the live rays'
    record is the same and the others are recorded as misses (-1, no
    occluder), which kernel 3 never reads. The streamed 992-triangle
    torus, the same torus over its grids and sphere_field(1024) (kernel
    1's 8-row loop), 64x48 b5; the record counts no kernel-1 launch."""
    from torch_grid_scenes import cornell_torus
    from raytracing_tpu_torch.accel import prepare_grids
    w, h = 64, 48
    direct = mode == "direct"
    scene = (sphere_field(1024, cols=w, rows=h, device=cuda)
             if name == "spheres1024"
             else cornell_torus(w, h, 31, 16, device=cuda))
    if name == "torus-grid":
        scene = prepare_grids(scene, 3, mesh_slabs="auto")
    cfg = RenderConfig(width=w, height=h, bounces=0 if direct else 5,
                       russian_roulette=mode == "rr", rr_start_depth=2,
                       use_megakernel=True, use_grid=name == "torus-grid")
    t = mega.scene_tables(scene, cfg)
    fwd = dict(grid=mega.grid_tables(scene, t[1], t[2])
               if cfg.use_grid else None,
               chunks=mega.chunk_tables(scene, cfg, t[1], t[2]))
    assert MKG.large_route(t[1], t[2], **fwd)
    assert (fwd["chunks"] is not None) == (name == "torus")
    ipar = torch.tensor([3, 0], dtype=torch.int32)
    key = MK.pass_key_of(ipar, cfg.seed)
    u = (mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
         if direct else
         mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 3, cfg,
                                scene.lights.count, cuda))
    kw = dict(spp=1, width=w, bounces=cfg.bounces, two_sided=False,
              normalize_emitter=True, seed=cfg.seed,
              russian_roulette=mode == "rr", rr_start_depth=2)
    z = torch.zeros((cfg.total_rays, 3), device=cuda)
    g = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.0, size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    dead = torch.arange(cfg.total_rays, device=cuda) % 3 == 0
    exact = ("--fmad=false",)
    for planes, live in ((u, g), (None, g),
                         (u, torch.where(dead[:, None], 0.0, g))):
        if direct:
            _, ids, occs = MK.direct_pass(*t, z.clone(), planes, key=key,
                                          spp=1, width=w, two_sided=False,
                                          record=True, build_flags=exact,
                                          **fwd)
        else:
            _, ids, occs = MK.pathtrace_pass(t[0], ipar, *t[1:], z.clone(),
                                             planes, record=True,
                                             build_flags=exact, **kw, **fwd)
        counts = (MK.launches, MK.direct_launches, MK.stream_launches)
        rids, roccs = MKG._record(t[0], ipar, *t[1:], live, planes,
                                  block=0, mode="direct" if direct
                                  else "path", **kw, **fwd)
        torch.cuda.synchronize()
        assert (MK.launches, MK.direct_launches, MK.stream_launches) == counts
        assert rids.dtype == torch.int32 and roccs.dtype == torch.bool
        keep = (live != 0).any(-1)
        assert torch.equal(rids[:, keep], ids[:, keep])
        assert torch.equal(roccs[:, keep], occs[:, keep])
        assert bool((rids[:, ~keep] == -1).all())
        assert not bool(roccs[:, ~keep].any())
        assert bool((ids[:, keep] >= 0).any())


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("name", ["spheres", "torus"])
def test_large_soft_kernel_matches_plain_version(cuda, name, rr):
    """Kernel 2s's large-table instance (the two-level composite over every
    span; the torus scene's triangles in Morton order, padded) vs its plain
    version, 32x24 b2, all five groups, bandwidth and tau 2e-2."""
    scene, cfg, tables, replay = _large_case(name, cuda, rr)
    st = mega.soft_tri_order(scene, tables[2], replay["chunks"])
    tables = list(tables)
    if st is not None:
        tables[2] = st.rows
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    g = torch.as_tensor(np.random.default_rng(8).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=cfg.width, bounces=2, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, russian_roulette=rr,
              rr_start_depth=1, soft_bandwidth=2e-2, soft_tau=2e-2)
    want = MKS.pathtrace_pass_bwd_soft_reference(tables[0], ipar,
                                                 *tables[1:], g, None, **kw)
    before = MKS.soft_large_launches
    got = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, None,
                                      **kw)
    torch.cuda.synchronize()
    assert MKS.soft_large_launches == before + 1
    _gates(*zip(*[(a, b) for a, b in zip(want, got) if a.numel()]),
           names=[n for n, a in zip(MKG.DIFF_ALL, want) if a.numel()])


def _soft_scene(n_sph, n_tri, device, shared=False, w=32, h=24, seed=11):
    """Cornell's camera, light and materials around n_sph seeded spheres
    and n_tri seeded triangles inside the box (with ``shared`` every
    object takes material 3, whose channels differ: a white albedo of 1
    puts throughputs on the roulette's clip bound, where float32 rounding
    picks the branch; tests/test_torch_edge_parity.py): kernel 2s at a
    given hypothesis count."""
    c = cornell_box(cols=w, rows=h, device=device)
    r = np.random.default_rng(seed)

    def mats(n):
        return (np.full(n, 3, np.int32) if shared
                else r.integers(0, 5, n).astype(np.int32))
    sph = tri = None
    if n_sph:
        sph = make_spheres(r.uniform(-0.7, 0.7, (n_sph, 3)),
                           r.uniform(0.05, 0.2, n_sph), mats(n_sph),
                           device=device)
    if n_tri:
        v = (r.uniform(-0.7, 0.7, (n_tri, 1, 3))
             + r.uniform(-0.25, 0.25, (n_tri, 3, 3))).astype(np.float32)
        tri = make_triangles(v, mat_ids=mats(n_tri), device=device)
    return build_scene(camera=c.camera, lights=c.lights,
                       materials=c.materials, spheres=sph, triangles=tri)


def _soft_vs_plain(scene, rr, wrt=MKG.DIFF_ALL, bounces=2, seed=12,
                   direct=False, live=None, empty=False):
    """Kernel 2s (the entry the table sizes pick; past 64 triangles in
    Morton order) vs its plain version on ``scene`` at its film, seeded
    random g, bandwidth and tau 2e-2, PRNG draws, under phase 6's gates on
    the non-empty groups in ``wrt`` (``direct``: direct mode); with
    ``live`` a list, MKS.live_stats of the pass is appended to it; with
    ``empty`` every word of both sides must be exactly 0 instead. Returns
    what the launch took (MKS.last_launch)."""
    cam = scene.camera
    w, h = int(cam.cols), int(cam.rows)
    if direct:
        bounces = 0
    cfg = RenderConfig(width=w, height=h, bounces=bounces,
                       russian_roulette=rr, rr_start_depth=1,
                       use_megakernel=True)
    tables = list(mega.scene_tables(scene, cfg))
    chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
    st = mega.soft_tri_order(scene, tables[2], chunks)
    if st is not None:
        tables[2] = st.rows
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    g = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(cfg.total_rays, 3)).astype(np.float32),
        device=scene.camera.eye.device)
    kw = dict(spp=1, width=w, bounces=bounces, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, russian_roulette=rr,
              rr_start_depth=1, diff_wrt=wrt, soft_bandwidth=2e-2,
              soft_tau=2e-2, mode="direct" if direct else "path")
    if live is not None:
        live.append(MKS.live_stats(
            tables[0], ipar, *tables[1:], None, blocks=[(0, g.shape[0])],
            **{k: v for k, v in kw.items() if k != "diff_wrt"}))
    want = MKS.pathtrace_pass_bwd_soft_reference(tables[0], ipar,
                                                 *tables[1:], g, None, **kw)
    before = MKS.soft_launches + MKS.soft_large_launches
    got = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, None,
                                      **kw)
    torch.cuda.synchronize()
    assert MKS.soft_launches + MKS.soft_large_launches == before + 1
    if empty:
        assert not any(a.any() for a in want)
        assert not any(b.any() for b in got)
        return MKS.last_launch()
    held = [i for i, (n, a) in enumerate(zip(MKG.DIFF_ALL, want))
            if n in wrt and a.numel()]
    _gates([want[i] for i in held], [got[i] for i in held],
           [MKG.DIFF_ALL[i] for i in held])
    for n, b in zip(MKG.DIFF_ALL, got):
        assert n in wrt or not b.any(), n
    return MKS.last_launch()


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("n_sph,n_tri,group", [
    (1, 0, 4), (4, 4, 4), (5, 4, 4), (15, 16, 8), (17, 16, 32),
    (64, 64, 32)], ids=["1", "8", "9", "31", "33", "128"])
def test_soft_kernel_at_hypothesis_counts(cuda, n_sph, n_tri, group, rr):
    """Kernel 2s's 64-object entry at hypothesis counts on both sides of
    its group sizes (4 lanes per ray up to 16 hypotheses, 8 up to 32, 32
    past that; 128 = 64 + 64 is its two-level composite), with and without
    the roulette, against its plain version."""
    before = MKS.soft_launches
    last = _soft_vs_plain(_soft_scene(n_sph, n_tri, cuda), rr)
    assert MKS.soft_launches == before + 1
    assert last["group"] == group


@pytest.mark.parametrize("rr", [False, True])
def test_large_soft_kernel_one_row_last_span(cuda, rr):
    """Kernel 2s past 64 objects on 65 triangles and 3 spheres: the
    triangles' spans hold 64 rows and 1 (Morton order, no padding row),
    with and without the roulette."""
    before = MKS.soft_large_launches
    _soft_vs_plain(_soft_scene(3, 65, cuda), rr)
    assert MKS.soft_large_launches == before + 1


SOFT_MODES = ["path", "roulette", "direct"]


def _mode(mode: str) -> dict:
    return dict(rr=mode == "roulette", direct=mode == "direct")


@pytest.mark.parametrize("mode", SOFT_MODES)
def test_large_soft_kernel_when_every_ray_misses(cuda, mode):
    """Kernel 2s past 64 objects on a film whose rays all miss
    (tests/torch_grid_scenes.py miss_field: the live rays' hypotheses all
    have a factor exactly 0, so every span mask of every warp is empty, as
    MKS.live_stats counts): the kernel adds no word, as its plain version
    gives exactly 0 everywhere."""
    from torch_grid_scenes import miss_field
    live = []
    _soft_vs_plain(miss_field(1024, 32, 24, cuda), wrt=MKG.DIFF_ALL,
                   live=live, empty=True, **_mode(mode))
    for kind in ("surface", "shadow"):
        assert live[0][kind]["warp_segments"] > 0
        assert live[0][kind]["max_union"] == 0


@pytest.mark.parametrize("mode", SOFT_MODES)
def test_large_soft_kernel_when_live_rows_fill_spans(cuda, mode):
    """Kernel 2s past 64 objects on sphere_field(128) packed within 0.5:
    every warp's live rows fill both 64-row spans (MKS.live_stats), so the
    slot loops run the dense composite; all five groups."""
    live = []
    _soft_vs_plain(sphere_field(128, cols=32, rows=24, spread=0.5,
                                device=cuda), live=live, **_mode(mode))
    for kind in ("surface", "shadow"):
        assert live[0][kind]["union_rows_per_span"] == 64.0


@pytest.mark.parametrize("mode", SOFT_MODES)
def test_large_soft_kernel_on_sphere_field_1024(cuda, mode):
    """Kernel 2s past 64 objects on sphere_field(1024) (16 resident
    spans), ("sph", "mat"), 24x16."""
    before = MKS.soft_large_launches
    _soft_vs_plain(sphere_field(1024, cols=24, rows=16, device=cuda),
                   wrt=("sph", "mat"), **_mode(mode))
    assert MKS.soft_large_launches == before + 1


@pytest.mark.parametrize("rr", [False, True])
def test_large_soft_kernel_rows_in_global_memory(cuda, rr):
    """Kernel 2s past 64 objects with "tri" in wrt on 2,048 triangles: the
    triangle table and its gradient buffer pass the shared-memory limit,
    so the rows are read from global memory and their cotangents added
    there, summed over each warp (rows_global); 16x12 b1."""
    last = _soft_vs_plain(_soft_scene(2, 2048, cuda, w=16, h=12), rr,
                          wrt=("mat", "tri"), bounces=1)
    assert last["rows_global"] == 1 and last["resident"] == 0


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("n_sph,n_tri", [(20, 30), (8, 100)],
                         ids=["64-entry", "large"])
def test_soft_kernel_one_shared_material(cuda, n_sph, n_tri, rr):
    """Kernel 2s where every object shares one material: every lane of every
    group adds into one material row (summed over the group's lanes, then
    one add), on both entries, with and without the roulette."""
    _soft_vs_plain(_soft_scene(n_sph, n_tri, cuda, shared=True), rr)


@pytest.mark.parametrize("edge", [False, True])
def test_routes_past_64_train_through_their_kernels(cuda, edge):
    """render_pass on the streamed torus scene with mega_bwd_impl="pallas"
    (one streamed kernel-1 launch and one of kernel 2's large-table
    instance, no kernel 3) or in edge mode (one of kernel 2s's large-table
    instance), and the same route's gradients on the CPU."""
    from torch_grid_scenes import cornell_torus
    cfg = RenderConfig(width=32, height=24, bounces=2, use_megakernel=True,
                       mega_bwd_impl="pallas",
                       mega_edge_bandwidth=2e-2 if edge else 0.0,
                       mega_grad_wrt=("sph", "mat", "tri"))

    def run(device):
        scene = cornell_torus(32, 24, 16, 8, device=device)
        m = scene.meshes[0]
        tv = m.tris.v.clone().requires_grad_(True)
        mat = scene.materials.clone().requires_grad_(True)
        sc = replace(scene, materials=mat,
                     meshes=(replace(m, tris=replace(m.tris, v=tv)),))
        st = pt.render_pass(sc, pt.init_state(cfg, device), cfg)
        torch.mean(pt.image(st, cfg) ** 2).backward()
        return [x.grad.cpu() for x in (tv, mat)]

    counts = (MK.stream_launches, MKG.large_launches, MKG.champ_launches,
              MKS.soft_large_launches)
    got = run(cuda)
    torch.cuda.synchronize()
    moved = tuple(b - a for a, b in zip(counts, (
        MK.stream_launches, MKG.large_launches, MKG.champ_launches,
        MKS.soft_large_launches)))
    assert moved == ((1, 0, 0, 1) if edge else (1, 1, 0, 0))
    want = run("cpu")
    for a, b in zip(want, got):
        assert torch.isfinite(b).all() and b.abs().max() > 0
        cos = (a * b).sum() / (a.norm() * b.norm())
        assert cos >= 0.999 and abs(b.norm() / a.norm() - 1) <= 0.01


def _direct_inputs(cuda, name: str, w: int = 64, h: int = 48, spp: int = 1,
                   lens: float = 0.0):
    """(scene, tables, u_planes_for_direct, seeded g, kw) of direct mode:
    cornell, sphere_field(80) (past 64 spheres) or the torus scene (138
    triangles, streamed)."""
    from torch_grid_scenes import cornell_torus
    if name == "cornell":
        scene = cornell_box(cols=w, rows=h, lens_diameter=lens, device=cuda)
    elif name == "spheres":
        scene = sphere_field(80, cols=w, rows=h, device=cuda)
    else:
        scene = cornell_torus(w, h, device=cuda)
    cfg = RenderConfig(width=w, height=h, spp=spp, use_megakernel=True)
    tables = list(mega.scene_tables(scene, cfg))
    key = MK.pass_key_of(torch.tensor([4, 0]), 0)
    u = mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
    g = torch.as_tensor(np.random.default_rng(2).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=spp, width=w, bounces=5, two_sided=False,
              normalize_emitter=False, seed=0, mode="direct")
    return scene, cfg, tables, u, g, kw


def test_direct_recording_matches_plain_record(cuda):
    """Kernel 1's direct mode recording (piece a): its accumulator
    bit-equal to the launch that does not record, its --fmad=false build's
    record equal to the plain record on every id and bit, the PRNG route's
    record equal to the u-planes route's."""
    _, cfg, t, u, _, _ = _direct_inputs(cuda, "cornell")
    z = torch.zeros((cfg.total_rays, 3), device=cuda)
    kw = dict(key=MK.pass_key_of(torch.tensor([4, 0]), 0), spp=1, width=64,
              two_sided=False)
    acc, ids, occs = MK.direct_pass(*t, z.clone(), u, record=True, **kw)
    plain = MK.direct_pass(*t, z.clone(), u, **kw)
    exact = MK.direct_pass(*t, z.clone(), u, record=True,
                           build_flags=("--fmad=false",), **kw)
    prng = MK.direct_pass(*t, z.clone(), None, record=True, **kw)
    want = MK.direct_pass_reference(*t, z, u, record=True, **kw)
    assert torch.equal(acc, plain)
    assert torch.equal(exact[1], want[1]) and torch.equal(exact[2], want[2])
    assert torch.equal(prng[1], ids) and torch.equal(prng[2], occs)
    assert occs.any() and (ids < 0).any() and (ids >= 0).any()


@pytest.mark.parametrize("spp,lens", [(1, 0.0), (4, 0.25)])
@pytest.mark.parametrize("kernel", ["2", "3", "2s"])
def test_direct_adjoint_kernels_match_plain_versions(cuda, kernel, spp,
                                                     lens):
    """Kernels 2, 3 and 2s in direct mode (pieces b, c, d) against their
    plain versions, cornell 64x48 (spp 4: 32x24 through a 0.25 lens), all
    five groups, the u-planes and PRNG routes, phase 6's gates; kernel 3
    on kernel 1's own record (its --fmad=false build, the plain record)."""
    w, h = (64, 48) if spp == 1 else (32, 24)
    _, cfg, t, u, g, kw = _direct_inputs(cuda, "cornell", w, h, spp, lens)
    ipar = torch.tensor([4, 0], dtype=torch.int32)
    soft = dict(soft_bandwidth=2e-2, soft_tau=2e-2)
    if kernel == "2":
        want = MKG.pathtrace_pass_bwd_reference(t[0], ipar, *t[1:], g, u,
                                                **kw)
        before = MKG.launches
        got = [MKG.pathtrace_pass_bwd(t[0], ipar, *t[1:], g, p, **kw)
               for p in (u, None)]
        assert MKG.launches == before + 2
    elif kernel == "3":
        _, ids, occs = MK.direct_pass(
            *t, torch.zeros_like(g), u, key=MK.pass_key_of(ipar, 0),
            spp=spp, width=w, two_sided=False, record=True,
            build_flags=("--fmad=false",))
        want = MKG.pathtrace_pass_bwd_champ_reference(
            t[0], ipar, *t[1:], g, u, ids, occs, **kw)
        before = MKG.champ_launches
        got = [MKG.pathtrace_pass_bwd_champ(t[0], ipar, *t[1:], g, p, ids,
                                            occs, **kw) for p in (u, None)]
        assert MKG.champ_launches == before + 2
    else:
        want = MKS.pathtrace_pass_bwd_soft_reference(t[0], ipar, *t[1:], g,
                                                     u, **soft, **kw)
        before = MKS.soft_launches
        got = [MKS.pathtrace_pass_bwd_soft(t[0], ipar, *t[1:], g, p,
                                           **soft, **kw) for p in (u, None)]
        assert MKS.soft_launches == before + 2
    for outs in got:
        _gates(want, outs)


@pytest.mark.parametrize("name", ["spheres", "torus"])
def test_direct_large_adjoint_kernels_match_plain_versions(cuda, name):
    """Kernels 2 and 2s in direct mode past 64 objects (their large-table
    instances): sphere_field(80) resident, the torus scene over its
    streamed chunks (kernel 2s on the Morton-sorted rows), 32x24, all five
    groups, phase 6's gates."""
    scene, cfg, t, u, g, kw = _direct_inputs(cuda, name, 32, 24)
    ipar = torch.tensor([4, 0], dtype=torch.int32)
    chunks = mega.chunk_tables(scene, cfg, t[1], t[2])
    want = MKG.pathtrace_pass_bwd_reference(t[0], ipar, *t[1:], g, u,
                                            chunks=chunks, **kw)
    def held(want, got):
        # sphere_field has no triangles: an empty group is not held
        keep = [i for i, a in enumerate(want) if a.numel()]
        _gates([want[i] for i in keep], [got[i] for i in keep],
               [MKG.DIFF_ALL[i] for i in keep])

    before = (MKG.large_launches, MKS.soft_large_launches)
    held(want, MKG.pathtrace_pass_bwd(t[0], ipar, *t[1:], g, None,
                                      chunks=chunks, **kw))
    st = mega.soft_tri_order(scene, t[2], chunks)
    ts = list(t)
    if st is not None:
        ts[2] = st.rows
    soft = dict(soft_bandwidth=2e-2, soft_tau=2e-2)
    held(MKS.pathtrace_pass_bwd_soft_reference(ts[0], ipar, *ts[1:], g, u,
                                               **soft, **kw),
         MKS.pathtrace_pass_bwd_soft(ts[0], ipar, *ts[1:], g, None, **soft,
                                     **kw))
    assert (MKG.large_launches, MKS.soft_large_launches) == (
        before[0] + 1, before[1] + 1)


def test_direct_wide_sphere_loop_matches_plain_versions(cuda):
    """The instances sphere_field(1024) runs (the 8-row sphere loop from
    kWideSpheres = 512 spheres): kernel 1's direct recording (its
    --fmad=false build equal to the plain record on every id and bit),
    kernel 2 past 64 objects and kernel 3 on that record against
    their plain versions, 32x24, ("sph", "mat"), phase 6's gates."""
    w, h = 32, 24
    scene = sphere_field(1024, cols=w, rows=h, device=cuda)
    cfg = RenderConfig(width=w, height=h, use_megakernel=True)
    t = list(mega.scene_tables(scene, cfg))
    ipar = torch.tensor([4, 0], dtype=torch.int32)
    key = MK.pass_key_of(ipar, 0)
    u = mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
    g = torch.as_tensor(np.random.default_rng(2).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    z = torch.zeros_like(g)
    fkw = dict(key=key, spp=1, width=w, two_sided=False)
    acc, _, _ = MK.direct_pass(*t, z.clone(), u, record=True, **fkw)
    assert torch.equal(acc, MK.direct_pass(*t, z.clone(), u, **fkw))
    _, ids, occs = MK.direct_pass(*t, z.clone(), u, record=True,
                                  build_flags=("--fmad=false",), **fkw)
    want = MK.direct_pass_reference(*t, z, u, record=True, **fkw)
    assert torch.equal(ids, want[1]) and torch.equal(occs, want[2])
    assert (ids >= 0).any() and occs.any()
    kw = dict(spp=1, width=w, bounces=0, two_sided=False,
              normalize_emitter=False, seed=0, mode="direct",
              diff_wrt=("sph", "mat"))
    chunks = MK.KernelChunks(tri=None,
                             sph=mega.sph_chunk_tables(scene, t[1]))
    names = ("sph", "mat")
    pick = [MKG.DIFF_ALL.index(n) for n in names]
    want = MKG.pathtrace_pass_bwd_reference(t[0], ipar, *t[1:], g, u,
                                            chunks=chunks, **kw)
    before = (MKG.large_launches, MKG.champ_launches)
    got = MKG.pathtrace_pass_bwd(t[0], ipar, *t[1:], g, u, **kw)
    _gates([want[i] for i in pick], [got[i] for i in pick], names)
    want = MKG.pathtrace_pass_bwd_champ_reference(t[0], ipar, *t[1:], g, u,
                                                  ids, occs, **kw)
    got = MKG.pathtrace_pass_bwd_champ(t[0], ipar, *t[1:], g, u, ids, occs,
                                       **kw)
    _gates([want[i] for i in pick], [got[i] for i in pick], names)
    assert (MKG.large_launches, MKG.champ_launches) == (before[0] + 1,
                                                        before[1] + 1)


@pytest.mark.parametrize("route", ["kernel2", "cell", "soft"])
def test_direct_diff_pass_trains_through_its_kernels(cuda, route):
    """pathtrace_pass_diff(mode="direct") on the card: one direct launch
    and one launch of the route's backward (kernel 2, kernel 1 recording
    and kernel 3, or kernel 2s) per step, the value bit-equal to
    direct_pass, ("sph", "mat") cotangents as on the CPU."""
    _, cfg, t, u, _, kw = _direct_inputs(cuda, "cornell")
    kw.pop("mode")
    ipar = torch.tensor([4, 0], dtype=torch.int32)
    soft = (dict(soft_bandwidth=2e-2, soft_tau=2e-2) if route == "soft"
            else {})

    def step(device):
        tt = [x.to(device).clone().requires_grad_(n in ("sph", "mat"))
              for n, x in zip(MKG.DIFF_ALL, t)]
        acc = MKG.pathtrace_pass_diff(
            tt[0], ipar, *tt[1:], torch.zeros((cfg.total_rays, 3),
                                              device=device), None,
            mode="direct", diff_wrt=("sph", "mat"),
            bwd_cell=route == "cell", **soft, **kw)
        torch.mean(acc ** 2).backward()
        return acc.detach().cpu(), [tt[1].grad.cpu(), tt[3].grad.cpu()]

    counts = lambda: (MK.direct_launches, MKG.launches,  # noqa: E731
                      MKG.champ_launches, MKS.soft_launches)
    before = counts()
    acc, got = step(cuda)
    torch.cuda.synchronize()
    moved = tuple(b - a for a, b in zip(before, counts()))
    assert moved == {"kernel2": (1, 1, 0, 0), "cell": (1, 0, 1, 0),
                     "soft": (1, 0, 0, 1)}[route]
    assert torch.equal(acc, MK.direct_pass(
        *t, torch.zeros((cfg.total_rays, 3), device=cuda), None,
        key=MK.pass_key_of(ipar, 0), spp=1, width=64,
        two_sided=False).cpu())
    _, want = step("cpu")
    for a, b in zip(want, got):
        assert torch.isfinite(b).all() and b.abs().max() > 0
        cos = (a * b).sum() / (a.norm() * b.norm())
        assert cos >= 0.999 and abs(b.norm() / a.norm() - 1) <= 0.01


def test_direct_ray_offset_and_blocked_brute_tables(cuda):
    """Kernel 1's direct mode at a ray offset: two half-film launches equal
    one full launch (PRNG route); mega_block on cornell's brute tables
    (which raised before) renders the same image and trains to the
    unblocked gradients."""
    _, cfg, t, _, _, _ = _direct_inputs(cuda, "cornell")
    n = cfg.total_rays
    kw = dict(key=MK.pass_key_of(torch.tensor([4, 0]), 0), spp=1, width=64,
              two_sided=False)
    full = MK.direct_pass(*t, torch.zeros((n, 3), device=cuda), None, **kw)
    half = [MK.direct_pass(*t, torch.zeros((n // 2, 3), device=cuda), None,
                           ray_offset=o, **kw) for o in (0, n // 2)]
    assert torch.equal(torch.cat(half), full)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    base = RenderConfig(width=64, height=48, bounces=2, use_megakernel=True,
                        mega_grad_wrt=("sph", "mat"))

    def grads(c):
        center = scene.spheres.center.clone().requires_grad_(True)
        sc = replace(scene, spheres=replace(scene.spheres, center=center))
        st = pt.render_pass(sc, pt.init_state(c, cuda), c)
        torch.mean(pt.image(st, c) ** 2).backward()
        return st["acc"].detach(), center.grad

    a0, g0 = grads(base)
    a8, g8 = grads(replace(base, mega_block=8))
    assert torch.equal(a0, a8)
    torch.testing.assert_close(g8, g0, rtol=1e-5, atol=1e-6)
    assert torch.equal(mega.render_direct_mega(scene, base),
                       mega.render_direct_mega(scene, replace(base,
                                                              mega_block=4)))


# ---------------------------------------------------------------------------
# kernel 3's row adds: the hot rows in a slab per warp, the others as
# vector reductions (csrc/megakernel_champ.cu HotAdds)
# ---------------------------------------------------------------------------

def _torus_record(cuda, mode="path", w=64, h=48):
    """The streamed cornell + 992-triangle torus at w x h (b5; the roulette
    from depth 2 with mode "rr"; one segment in direct mode): tables,
    kernel 1's record of the pass, u-planes, a seeded random g and the
    backward's keyword arguments."""
    from torch_grid_scenes import cornell_torus
    direct = mode == "direct"
    scene = cornell_torus(w, h, 31, 16, device=cuda)
    cfg = RenderConfig(width=w, height=h, bounces=0 if direct else 5,
                       russian_roulette=mode == "rr", rr_start_depth=2,
                       use_megakernel=True)
    t = mega.scene_tables(scene, cfg)
    chunks = mega.chunk_tables(scene, cfg, t[1], t[2])
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    z = torch.zeros((cfg.total_rays, 3), device=cuda)
    g = torch.as_tensor(np.random.default_rng(11).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
    if direct:
        key = MK.pass_key_of(ipar, cfg.seed)
        u = mega.u_planes_for_direct(key, cfg, scene.lights.count, cuda)
        _, ids, occs = MK.direct_pass(*t, z, u, key=key, spp=1, width=w,
                                      two_sided=False, record=True,
                                      chunks=chunks)
        kw = dict(spp=1, width=w, bounces=0, two_sided=False,
                  normalize_emitter=True, seed=cfg.seed, mode="direct")
    else:
        u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                                   scene.lights.count, cuda)
        kw = dict(spp=1, width=w, bounces=5, two_sided=False,
                  normalize_emitter=True, seed=cfg.seed,
                  russian_roulette=mode == "rr", rr_start_depth=2)
        _, ids, occs = MK.pathtrace_pass(t[0], ipar, *t[1:], z, u,
                                         record=True, chunks=chunks, **kw)
    return t, ipar, ids, occs, u, g, kw, chunks


def _hold_champ(t, ipar, ids, occs, u, g, kw, wrt=MKG.DIFF_ALL):
    """Kernel 3 (u-planes and PRNG routes) vs its plain version on one
    record: phase 6's gates on every group the plain version gives a
    nonzero cotangent, exact zeros where it gives none."""
    want = MKG.pathtrace_pass_bwd_champ_reference(t[0], ipar, *t[1:], g, u,
                                                  ids, occs, diff_wrt=wrt,
                                                  **kw)
    before = MKG.champ_launches
    for planes in (u, None):
        got = MKG.pathtrace_pass_bwd_champ(t[0], ipar, *t[1:], g, planes,
                                           ids, occs, diff_wrt=wrt, **kw)
        torch.cuda.synchronize()
        held = [(n, a, b) for n, a, b in zip(MKG.DIFF_ALL, want, got)
                if a.numel() and n in wrt and a.abs().max() > 0]
        for n, a, b in zip(MKG.DIFF_ALL, want, got):
            if a.numel() and not a.abs().max() > 0:
                assert torch.equal(b, torch.zeros_like(b)), n
        if held:
            names, a, b = zip(*held)
            _gates(a, b, names=names)
    assert MKG.champ_launches == before + 2


def _champ_lib():
    from raytracing_tpu_torch.ops import _build
    return _build.load("megakernel_champ", MKG._CHAMP_SIGNATURES,
                       MKG.ADJ_FLAGS)


def test_hot_rows_equal_plain_version_on_the_card(cuda):
    """The hot rows built on the card (a memset and two launches) equal the
    plain version's for HOT_TRI rows on the torus's record, a
    sphere_field(200) record, a record naming one row and an all-miss
    record."""
    t, _, ids, *_ = _torus_record(cuda)
    n_s, n_t = t[1].shape[0], t[2].shape[0]
    cfg = RenderConfig(width=64, height=48, bounces=2, use_megakernel=True)
    sf = mega.scene_tables(sphere_field(200, cols=64, rows=48, device=cuda),
                           cfg)
    _, sf_ids, _ = _record(sf, torch.zeros((cfg.total_rays, 3),
                                           device=cuda), None, cfg)
    one = torch.where(ids >= 0, n_s + 3, -1).to(torch.int32)
    miss = torch.full_like(ids, -1)
    for rec, ns, nt in ((ids, n_s, n_t), (sf_ids, 200, 0), (one, n_s, n_t),
                        (miss, n_s, n_t), (ids[:1], n_s, n_t)):
        got = MKG.hot_rows(rec, ns, nt)
        want = MKG.hot_rows_reference(rec.cpu(), ns, nt, MKG.HOT_TRI)
        for a, b in zip(want, got):
            assert torch.equal(a, b.cpu())
    assert int((MKG.hot_rows(ids, n_s, n_t)[0] >= 0).sum()) == MKG.HOT_TRI


def test_champion_kernel_hot_and_cold_rows_on_the_torus(cuda):
    """Kernel 3 on the streamed torus's record (64x48 b5, all five groups):
    the record names more triangle rows than the slab holds, so hot rows
    go through the warps' slabs and the others through vector reductions;
    phase 6's gates."""
    t, ipar, ids, occs, u, g, kw, _ = _torus_record(cuda)
    n_s, n_t = t[1].shape[0], t[2].shape[0]
    named = torch.unique(ids[(ids >= n_s) & (ids < n_s + n_t)]).numel()
    assert named > MKG.HOT_TRI
    _hold_champ(t, ipar, ids, occs, u, g, kw)


def test_champion_kernel_when_every_champion_is_one_row(cuda):
    """Every recorded champion the same triangle row (the torus's record
    with each id replaced by the back wall's): the worst contention, all of
    it in the slab; phase 6's gates."""
    t, ipar, ids, occs, u, g, kw, _ = _torus_record(cuda)
    n_s = t[1].shape[0]
    tri = ids[ids >= n_s]
    row = int(torch.bincount(tri.long() - n_s).argmax())
    one = torch.where(ids >= 0, n_s + row, -1).to(torch.int32).contiguous()
    _hold_champ(t, ipar, one, occs, u, g, kw)


def test_champion_kernel_when_every_ray_misses(cuda):
    """An all-miss record: no hot row; the only cotangents are the
    emitter's, as the plain version gives them, and zeros elsewhere."""
    t, ipar, ids, occs, u, g, kw, _ = _torus_record(cuda)
    miss = torch.full_like(ids, -1)
    _hold_champ(t, ipar, miss, torch.zeros_like(occs), u, g, kw)


@pytest.mark.parametrize("mode", ["rr", "direct"])
def test_champion_kernel_hot_rows_rr_and_direct(cuda, mode):
    """Kernel 3's roulette and direct instances on the streamed torus's
    record, all five groups, phase 6's gates."""
    t, ipar, ids, occs, u, g, kw, _ = _torus_record(cuda, mode)
    _hold_champ(t, ipar, ids, occs, u, g, kw)


def test_split_sweep_hot_rows_on_the_torus(cuda):
    """Row 2′ on the streamed torus (64x48 b5, all five groups): kernel 2
    past 64 objects (its record, then kernel 3's sweep with the hot rows)
    against the plain champion backward on the split's own record."""
    t, ipar, _, _, u, g, kw, chunks = _torus_record(cuda)
    rec_kw = dict(kw, mode="path")
    ids, occs = MKG._record(t[0], ipar, *t[1:], g, u, grid=None,
                            chunks=chunks, block=0, **rec_kw)
    want = MKG.pathtrace_pass_bwd_champ_reference(t[0], ipar, *t[1:], g, u,
                                                  ids, occs, **kw)
    before = MKG.large_launches
    got = MKG.pathtrace_pass_bwd(t[0], ipar, *t[1:], g, u, chunks=chunks,
                                 **kw)
    torch.cuda.synchronize()
    assert MKG.large_launches == before + 1
    _gates(want, got)


def test_champion_hot_rows_without_host_sync(cuda):
    """The hot rows and kernel 3 launch with no host synchronisation (any
    sync raises under sync debug mode "error")."""
    t, ipar, ids, occs, _, g, kw, _ = _torus_record(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slot, _ = MKG.hot_rows(ids, t[1].shape[0], t[2].shape[0])
        got = MKG.pathtrace_pass_bwd_champ(t[0], ipar, *t[1:], g, None, ids,
                                           occs, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int((slot >= 0).sum()) == MKG.HOT_TRI
    assert all(torch.isfinite(x).all() for x in got)


def test_champion_kernel_refuses_misaligned_outputs(cuda):
    """dsph or dtri off a 16-byte boundary, or a hot-row list of another
    length than the kernel's: the C entries return cudaErrorInvalidValue
    (1) and launch nothing; no scalar fallback."""
    t, ipar, ids, occs, _, g, kw, _ = _torus_record(cuda)
    lib = _champ_lib()
    slot, hot = MKG._hot_map(lib, ids, t[1].shape[0], t[2].shape[0])
    order = MKG._order_map(lib, ids, g, t[1].shape[0] + t[2].shape[0])
    outs = [torch.zeros_like(x) for x in t]
    ptr = MK._ptr
    stream = torch.cuda.current_stream().cuda_stream

    def launch(args, n_hot=MKG.HOT_TRI):
        return lib.rt_pathtrace_bwd_champ(
            ptr(t[0]), ptr(t[1]), t[1].shape[0], ptr(t[2]), t[2].shape[0],
            ptr(t[3]), t[3].shape[0], ptr(t[4]), t[4].shape[0], ptr(g),
            ptr(ids), ptr(occs), ptr(slot), ptr(hot), n_hot, ptr(order),
            g.shape[0], 0, None, 1, 2, 1, 64, 5, 0, 0, 0, 0, 1, 31, *args,
            stream)

    for bad in (1, 2):
        shifted = torch.zeros(outs[bad].numel() + 1, device=cuda)[1:]
        args = [ptr(x) for x in outs]
        args[bad] = shifted.data_ptr()
        assert launch(args) == 1
        torch.cuda.synchronize()
        assert not shifted.any()
    assert launch([ptr(x) for x in outs], MKG.HOT_TRI + 1) == 1
    counts = torch.empty_like(slot)
    assert lib.rt_champ_hot_rows(
        ptr(ids), ids.numel(), t[1].shape[0], t[2].shape[0], ptr(counts),
        ptr(slot), ptr(hot), MKG.HOT_TRI - 1, stream) == 1
    torch.cuda.synchronize()
    assert not any(x.any() for x in outs)


def _order_records(cuda):
    """name -> (ids, g, n_obj, mode) for kernel 3's ray order: kernel 1's
    records of sphere_field(1024), cornell and the streamed torus at 64x48
    b5 (the torus also with the roulette and in direct mode), each with a
    seeded random g whose every fifth row is zero, and hand-made records:
    every ray missing, every g zero, a ray count past a tile (1024) that
    no warp divides with ids past the tables and misses between hits, one
    partial warp, the most segments over more rays than one chunk of the
    scan holds, a direct record."""
    cfg = RenderConfig(width=64, height=48, bounces=5, use_megakernel=True)
    gen = np.random.default_rng(5)

    def cot(n):
        g = gen.normal(size=(n, 3)).astype(np.float32)
        g[::5] = 0.0
        return torch.as_tensor(g, device=cuda)

    out = {}
    for name, scene in (
            ("sphere_field(1024)", sphere_field(1024, cols=64, rows=48,
                                                device=cuda)),
            ("cornell", cornell_box(cols=64, rows=48, device=cuda))):
        t = mega.scene_tables(scene, cfg)
        _, ids, _ = _record(t, torch.zeros((cfg.total_rays, 3), device=cuda),
                            None, cfg)
        out[name] = (ids, cot(ids.shape[1]), t[1].shape[0] + t[2].shape[0],
                     "path")
    for mode in ("path", "rr", "direct"):
        t, _, ids, *_ = _torus_record(cuda, mode)
        out[f"torus {mode}"] = (ids, cot(ids.shape[1]),
                                t[1].shape[0] + t[2].shape[0],
                                "direct" if mode == "direct" else "path")
    rand = torch.as_tensor(gen.integers(-1, 9, (6, 1024 + 37)),
                           dtype=torch.int32, device=cuda)
    out.update({
        "every ray misses": (torch.full((6, 3000), -1, dtype=torch.int32,
                                        device=cuda), cot(3000), 10, "path"),
        "every g zero": (rand, torch.zeros((1061, 3), device=cuda), 7,
                         "path"),
        "1061 rays, ids past the tables": (rand, cot(1061), 7, "path"),
        "31 rays": (rand[:, :31].contiguous(), cot(31), 7, "path"),
        "16 segments, 2^20 + 5 rays (a scan of three chunks)": (
            torch.as_tensor(gen.integers(-1, 40, (16, (1 << 20) + 5)),
                            dtype=torch.int32, device=cuda),
            cot((1 << 20) + 5), 37, "path"),
        "direct, 2000 rays": (torch.as_tensor(
            gen.integers(-1, 12, (1, 2000)), dtype=torch.int32,
            device=cuda), cot(2000), 10, "direct")})
    return out


def test_champ_order_equals_plain_version_on_the_card(cuda):
    """Kernel 3's ray order built on the card (three launches) equals its
    plain version element for element, the live count too, on kernel 1's
    records and on the edge cases of ``_order_records``."""
    for name, (ids, g, n_obj, mode) in _order_records(cuda).items():
        before = MKG.order_launches
        order, n_live = MKG.champ_order(ids, g, n_obj, mode)
        assert MKG.order_launches == before + 1
        want, n_want = MKG.champ_order_reference(ids, g, mode, n_obj)
        assert int(n_live) == n_want, name
        assert torch.equal(order[:n_want], want), name
        w = MKG.champ_warp_work(ids, g, order[:n_want], mode, n_obj)
        assert w["walked"] <= MKG.champ_warp_work(ids, g, None, mode,
                                                  n_obj)["walked"], name


@pytest.mark.parametrize("mode", ["path", "rr", "direct"])
def test_champion_kernel_in_its_mode_order(cuda, mode):
    """Kernel 3 on the streamed torus's record (64x48 b5, all five groups)
    against its plain version under phase 6's gates: path mode and the
    roulette swept in the record's ray order, built once per launch;
    direct mode in ray order, with no order built."""
    t, ipar, ids, occs, u, g, kw, _ = _torus_record(cuda, mode)
    before = MKG.order_launches
    _hold_champ(t, ipar, ids, occs, u, g, kw)
    assert MKG.order_launches == before + (0 if mode == "direct" else 2)


def test_champion_kernel_refuses_a_missing_or_stray_order(cuda):
    """Path mode without its ray order, or direct mode with one: the C
    entry returns cudaErrorInvalidValue (1) and launches nothing."""
    lib = _champ_lib()
    ptr = MK._ptr
    stream = torch.cuda.current_stream().cuda_stream
    for mode in ("path", "direct"):
        t, ipar, ids, occs, _, g, kw, _ = _torus_record(cuda, mode)
        slot, hot = MKG._hot_map(lib, ids, t[1].shape[0], t[2].shape[0])
        stray = MKG._order_map(lib, ids, g, t[1].shape[0] + t[2].shape[0])
        direct = int(mode == "direct")
        outs = [torch.zeros_like(x) for x in t]
        assert lib.rt_pathtrace_bwd_champ(
            ptr(t[0]), ptr(t[1]), t[1].shape[0], ptr(t[2]), t[2].shape[0],
            ptr(t[3]), t[3].shape[0], ptr(t[4]), t[4].shape[0], ptr(g),
            ptr(ids), ptr(occs), ptr(slot), ptr(hot), MKG.HOT_TRI,
            ptr(stray) if direct else None, g.shape[0], 0, None, 1, 2, 1,
            64, 0 if direct else 5, 0, 0, direct, 0, 1, 31,
            *(ptr(x) for x in outs), stream) == 1
        torch.cuda.synchronize()
        assert not any(x.any() for x in outs)


def test_champion_kernel_in_the_order_on_sphere_field(cuda):
    """Kernel 3 in the package's order on sphere_field(1024)'s record at
    64x48 b5 with and without the roulette, ("sph", "mat") and all five
    groups: phase 6's gates."""
    for rr in (False, True):
        cfg = RenderConfig(width=64, height=48, bounces=5,
                           russian_roulette=rr, rr_start_depth=2,
                           use_megakernel=True)
        scene = sphere_field(1024, cols=64, rows=48, device=cuda)
        t = mega.scene_tables(scene, cfg)
        ipar = torch.tensor([0, 0], dtype=torch.int32)
        u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                                   scene.lights.count, cuda)
        kw = dict(spp=1, width=64, bounces=5, two_sided=False,
                  normalize_emitter=True, seed=cfg.seed,
                  russian_roulette=rr, rr_start_depth=2)
        _, ids, occs = MK.pathtrace_pass(
            t[0], ipar, *t[1:], torch.zeros((cfg.total_rays, 3),
                                            device=cuda), u,
            record=True, **kw)
        g = torch.as_tensor(np.random.default_rng(7).normal(
            size=(cfg.total_rays, 3)).astype(np.float32), device=cuda)
        for wrt in (("sph", "mat"), MKG.DIFF_ALL):
            _hold_champ(t, ipar, ids, occs, u, g, kw, wrt=wrt)


def test_champ_order_without_host_sync(cuda):
    """The ray order and kernel 3 in it launch with no host
    synchronisation (any sync raises under sync debug mode "error")."""
    t, ipar, ids, occs, _, g, kw, _ = _torus_record(cuda)
    n_obj = t[1].shape[0] + t[2].shape[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        order, n_live = MKG.champ_order(ids, g, n_obj)
        got = MKG.pathtrace_pass_bwd_champ(t[0], ipar, *t[1:], g, None, ids,
                                           occs, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(n_live) == int((g != 0).any(-1).sum())
    assert all(torch.isfinite(x).all() for x in got)


def test_champ_order_refuses_bad_scratch(cuda):
    """A scratch of another size than ``rt_champ_order_words`` gives, or a
    record of more segments than the tape holds: cudaErrorInvalidValue (1)
    and nothing written."""
    t, _, ids, _, _, g, _, _ = _torus_record(cuda)
    lib = _champ_lib()
    n_seg, n = ids.shape
    words = lib.rt_champ_order_words(n, n_seg)
    assert words > n and lib.rt_champ_order_words(n, 17) == -1
    scratch = torch.full((words + 1,), -7, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = (ids.data_ptr(), n_seg, n, t[1].shape[0] + t[2].shape[0],
            g.data_ptr(), scratch.data_ptr())
    assert lib.rt_champ_order(*args, words + 1, stream) == 1
    assert lib.rt_champ_order(ids.data_ptr(), 17, n, 10, g.data_ptr(),
                              scratch.data_ptr(), words, stream) == 1
    torch.cuda.synchronize()
    assert bool((scratch == -7).all())


# ptxas's (registers, stack, spill stores) of kernels 2 and 2s, as their
# builds before kernel 3's ray order gave them on the H100 (their sources
# did not change with it)
K2_PTXAS = [(128, 32, 0), (128, 80, 160), (128, 80, 164)]
K2S_PTXAS = {
    "path": [(168, 168, 244), (168, 176, 256), (168, 176, 264),
             (168, 17392, 228)],
    "rr": [(168, 168, 240), (168, 168, 252), (168, 176, 260),
           (168, 17392, 224)],
    "direct": [(128, 152, 228), (128, 160, 240), (128, 160, 240),
               (128, 17416, 320)]}
# kernel 3's spill stores before its ray order (path, roulette, direct),
# bytes
K3_SPILL = {(0, 0): 244, (1, 0): 256, (0, 1): 0}


def _usage(name, flags):
    from raytracing_tpu_torch.ops import _build
    return _build.ptxas_usage(_build.ptxas_log(name, flags))


def test_kernel_registers_and_spill(cuda):
    """ptxas's report: kernels 2 and 2s keep their registers, stack and
    spill; each of kernel 3's three instances keeps at most 128 registers
    (its 4 blocks of 128 per SM) and spills at most 16 bytes more than
    before its ray order (path mode and the roulette take the order,
    direct mode not)."""
    import re
    from raytracing_tpu_torch.ops import _build
    _champ_lib()
    for flags in MKS.SOFT_BUILDS:
        _build.load("megakernel_soft", MKS._SIGNATURES, flags)
    _build.load("megakernel_grad", MKG._SIGNATURES, MKG.ADJ_FLAGS)

    def table(usage):
        return sorted((u["registers"], u["stack"], u["spill_stores"])
                      for u in usage.values())

    assert table(_usage("megakernel_grad", MKG.ADJ_FLAGS)) == K2_PTXAS
    for mode, flags in zip(("path", "rr", "direct"), MKS.SOFT_BUILDS):
        assert table(_usage("megakernel_soft", flags)) == K2S_PTXAS[mode]
    champ = {k: u for k, u in _usage("megakernel_champ",
                                     MKG.ADJ_FLAGS).items()
             if "pathtrace_bwd_champ_kernel" in k}
    assert len(champ) == 3
    for name, u in champ.items():
        rr, direct = (int(x) for x in re.search(
            r"kernelILb(\d)ELb(\d)EE", name).groups())
        assert u["registers"] <= 128, name
        assert u["spill_stores"] <= K3_SPILL[(rr, direct)] + 16, name


# ---------------------------------------------------------------------------
# Ray shards (parallel/mesh.py): kernels 1 and 3 on a slice of the film with
# a global ray offset, kernel 4 on a shard of the spheres
# ---------------------------------------------------------------------------

def _shards(n_rays: int, n: int) -> list:
    """(offset, count) of n ray shards as ``parallel.mesh.ray_slice`` cuts
    them: ceil(R / n) rays each, the last padded past the film."""
    local = -(-n_rays // n)
    return [(i * local, local) for i in range(n)]


@pytest.mark.parametrize("name", ["cornell", "sphere_field(1024)"])
def test_kernel_1_offset_slice_bit_equals_whole_film_rows(cuda, name):
    """Kernel 1 on five shards of a 64x48 b5 film (615 rays: not whole
    rows; the last padded by 3), keyed by the global ray id: each shard's
    accumulator after a 3-pass launch is the whole film's launch's rows
    bit for bit, and its record (one pass) the record's columns.
    sphere_field(1024) walks the sphere tree each call builds."""
    cfg = RenderConfig(width=64, height=48, bounces=5, use_megakernel=True)
    scene = (cornell_box(cols=64, rows=48, device=cuda) if name == "cornell"
             else sphere_field(1024, cols=64, rows=48, device=cuda))
    R = cfg.total_rays
    whole = pt.render_passes(scene, pt.init_state(cfg, cuda), cfg, 3)["acc"]
    t = mega.scene_tables(scene, cfg)
    kw = dict(spp=1, width=64, bounces=5, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    _, ids, occs = MK.pathtrace_pass(
        t[0], torch.tensor([0, 0], dtype=torch.int32), *t[1:],
        torch.zeros((R, 3), device=cuda), None, record=True, **kw)
    before = MK.launches
    for off, n in _shards(R, 5):
        st = {**pt.init_state(cfg, cuda),
              "acc": torch.zeros((n, 3), device=cuda)}
        got = pt.render_passes(scene, st, cfg, 3, ray_offset=off)["acc"]
        real = min(n, R - off)
        assert torch.equal(got[:real], whole[off:off + real]), off
        _, sid, socc = MK.pathtrace_pass(
            t[0], torch.tensor([0, off], dtype=torch.int32), *t[1:],
            torch.zeros((n, 3), device=cuda), None, record=True, **kw)
        assert torch.equal(sid[:, :real], ids[:, off:off + real]), off
        assert torch.equal(socc[:, :real], occs[:, off:off + real]), off
    torch.cuda.synchronize()
    assert MK.launches == before + 10


def test_kernel_3_order_and_sweep_on_an_offset_slice(cuda):
    """Kernel 3 on sphere_field(200)'s record of five ray shards (64x48
    b5): the ray order of each shard's record (local ray ids) equals its
    plain version element for element; each shard's sweep (the shard's
    u-planes and the PRNG route keyed by the global id) holds its plain
    version to phase 6's gates; and the shards' cotangents summed hold the
    whole film's launch to the same gates."""
    cfg = RenderConfig(width=64, height=48, bounces=5, use_megakernel=True)
    scene = sphere_field(200, cols=64, rows=48, device=cuda)
    R = cfg.total_rays
    t = mega.scene_tables(scene, cfg)
    n_obj = t[1].shape[0] + t[2].shape[0]
    u = mega.u_planes_for_pass(pt.init_state(cfg, cuda)["key"], 0, cfg,
                               scene.lights.count, cuda)
    g = torch.as_tensor(np.random.default_rng(13).normal(
        size=(R, 3)).astype(np.float32), device=cuda)
    kw = dict(spp=1, width=64, bounces=5, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    ipar0 = torch.tensor([0, 0], dtype=torch.int32)
    _, ids, occs = MK.pathtrace_pass(t[0], ipar0, *t[1:],
                                     torch.zeros((R, 3), device=cuda), None,
                                     record=True, **kw)
    whole = MKG.pathtrace_pass_bwd_champ(t[0], ipar0, *t[1:], g, None, ids,
                                         occs, **kw)
    total = [torch.zeros_like(x) for x in whole]
    for off, n in _shards(R, 5):
        ipar = torch.tensor([0, off], dtype=torch.int32)
        _, sid, socc = MK.pathtrace_pass(
            t[0], ipar, *t[1:], torch.zeros((n, 3), device=cuda), None,
            record=True, **kw)
        sg = torch.zeros((n, 3), device=cuda)
        real = min(n, R - off)
        sg[:real] = g[off:off + real]
        order, n_live = MKG.champ_order(sid, sg, n_obj, "path")
        want, n_want = MKG.champ_order_reference(sid, sg, "path", n_obj)
        assert int(n_live) == n_want and torch.equal(order[:n_want], want)
        su = torch.zeros((u.shape[0], n), device=cuda)
        su[:, :real] = u[:, off:off + real]
        _hold_champ(t, ipar, sid, socc, su, sg, kw)
        part = MKG.pathtrace_pass_bwd_champ(t[0], ipar, *t[1:], sg, None,
                                            sid, socc, **kw)
        total = [a + b for a, b in zip(total, part)]
    torch.cuda.synchronize()
    held = [(nm, a, b) for nm, a, b in zip(MKG.DIFF_ALL, whole, total)
            if a.numel() and a.abs().max() > 0]
    names, a, b = zip(*held)
    _gates(a, b, names=names)


@pytest.mark.parametrize("tie", [False, True])
def test_kernel_4_on_sphere_shards_with_index_offsets(cuda, tie):
    """Kernel 4 on shards of sphere_field(1024)'s rows (2 shards of 512:
    the tree instance; 8 of 128: the brute loop), each shard's indices
    offset by its first row and the least (t, shard) taken: the unsharded
    search's (t, idx) bit for bit. With ``tie`` the second half copies the
    first, so every hit ties across shards and the lower index wins."""
    sp = sphere_field(1024, device=cuda).spheres
    rows = HK.sphere_rows(sp.center, sp.radius, sp.mask)
    if tie:
        rows = torch.cat([rows[:512], rows[:512]]).contiguous()
    rays = _rays(cuda)
    want = HK.sphere_search_rows(*rays, rows)
    for n_shards in (2, 8):
        size = rows.shape[0] // n_shards
        ts, ids = [], []
        for k in range(n_shards):
            st, si = HK.sphere_search_rows(
                *rays, rows[k * size:(k + 1) * size].contiguous())
            ts.append(st)
            ids.append(torch.where(torch.isfinite(st), si + k * size, -1))
        ts, ids = torch.stack(ts), torch.stack(ids)
        win = torch.argmin(ts, 0)
        col = torch.arange(ts.shape[1], device=cuda)
        got = (ts[win, col], ids[win, col])
        _bit_equal(got, want)
        if tie:
            assert (want[1] < 512).all()


def test_xml_torus_renders_bit_equal_to_cornell_torus(cuda, tmp_path):
    """The torus scene written as XML and mesh JSON (io/scene_xml.py) and
    the programmatic cornell_torus, both prepared with "auto" grids,
    render bit-equal films through kernel 1's grid mode at 256x192: direct
    and path b5, 4 passes, the same seed."""
    from raytracing_tpu_torch.accel import prepare_grids
    from raytracing_tpu_torch.io.scene_xml import load_scene
    from raytracing_tpu_torch.render.direct import render_direct
    from torch_grid_scenes import cornell_torus
    from torch_xml_scenes import cornell_torus_xml
    path = cornell_torus_xml(str(tmp_path), 31, 16)
    got, want = (prepare_grids(s, "auto", mesh_slabs="auto") for s in (
        load_scene(path, 256, 192, cuda),
        cornell_torus(256, 192, 31, 16, device=cuda)))
    for bounces in (0, 5):
        cfg = RenderConfig(width=256, height=192, bounces=bounces,
                           use_grid=True, use_megakernel=True, mega_block=64)
        if bounces == 0:
            a, b = (render_direct(s, cfg, n_passes=4) for s in (got, want))
        else:
            a, b = (pt.render_passes(s, pt.init_state(cfg, cuda), cfg,
                                     4)["acc"] for s in (got, want))
        torch.cuda.synchronize()
        assert torch.isfinite(a).all() and a.max() > 0
        assert torch.equal(a, b)
