"""Edge-aware gradients on the port alone (the JAX-parity half is
``tests/test_torch_edge_parity.py``): the wiring of ``render_pass_mega``
with ``mega_edge_bandwidth > 0`` (hard forward, soft backward), edge mode
over grids, the edge x grid row contract, and the behaviour of the soft
program (the JAX package's ``tests/test_edge_grad.py`` on the port): it
converges to the hard pass as the bandwidth shrinks, its material
cotangents match the hard backward's, its gradient agrees with central
differences, it stays finite at a tiny bandwidth on grazing geometry, and a
silhouette recovery through it converges.

Everything runs on the CPU, where the wrappers run their plain versions;
kernel 2s itself is held to ``pathtrace_pass_bwd_soft_reference`` on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 20).
"""
import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.core.types import Camera
from raytracing_tpu_torch.diff import check_grad
from raytracing_tpu_torch.models.scenes import cornell_box
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.ops import megakernel_soft as MKS
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_edge_scenes import tri_row
from torch_threads import one_thread  # noqa: F401

BW = 2e-2
IPAR = torch.zeros(2, dtype=torch.int32)
PARAMS = ("center", "tv", "mat", "irr", "eye")


def _setup(w, h, bounces=1, scene=None, **kw):
    cfg = RenderConfig(width=w, height=h, bounces=bounces,
                       use_megakernel=True, **kw)
    scene = scene if scene is not None else cornell_box(cols=w, rows=h)
    u = mega.u_planes_for_pass(pt.init_state(cfg, "cpu")["key"], 0, cfg,
                               scene.lights.count)
    return cfg, scene, u


def _soft_kw(cfg, bw):
    return dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
                two_sided=cfg.two_sided_triangles,
                normalize_emitter=cfg.normalize_emitter,
                russian_roulette=cfg.russian_roulette,
                rr_start_depth=cfg.rr_start_depth, soft_bandwidth=bw,
                soft_tau=bw)


def _with(scene, p):
    """The scene with the parameters of ``p`` (a dict keyed as PARAMS)."""
    return replace(
        scene,
        spheres=replace(scene.spheres,
                        center=p.get("center", scene.spheres.center)),
        triangles=replace(scene.triangles,
                          v=p.get("tv", scene.triangles.v)),
        lights=replace(scene.lights,
                       irradiance=p.get("irr", scene.lights.irradiance)),
        materials=p.get("mat", scene.materials),
        camera=replace(scene.camera, eye=p.get("eye", scene.camera.eye)))


def _leaves(scene):
    p = {"center": scene.spheres.center, "tv": scene.triangles.v,
         "mat": scene.materials, "irr": scene.lights.irradiance,
         "eye": scene.camera.eye}
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


def _route_grads(scene, cfg, u, g):
    """(acc, grads of <g, acc>) through the port's render_pass_mega."""
    p = _leaves(scene)
    acc = mega.render_pass_mega(_with(scene, p), pt.init_state(cfg, "cpu"),
                                cfg, u_planes=u)["acc"]
    return acc, torch.autograd.grad((acc * g).sum(), [p[k] for k in PARAMS])


def _g(cfg, seed=3):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=(cfg.total_rays, 3)).astype(np.float32))


def test_torch_edge_wiring_matches_soft_value():
    """autograd through render_pass_mega in edge mode (hard forward, soft
    backward) equals autograd of soft_pass_value on the same tables and
    draws, with JAX's gate; the forward is the hard route's, bit for bit."""
    cfg, scene, u = _setup(16, 12, mega_edge_bandwidth=BW)
    g = _g(cfg)
    acc, got = _route_grads(scene, cfg, u, g)
    p = _leaves(scene)
    tables = mega.scene_tables(_with(scene, p), cfg)
    val = MKS.soft_pass_value(tables[0], IPAR, *tables[1:], u,
                              **_soft_kw(cfg, BW))
    want = torch.autograd.grad((val * g).sum(), [p[k] for k in PARAMS])
    for k, a, b in zip(PARAMS, want, got):
        assert torch.isfinite(b).all(), k
        assert a.abs().max() > 0, k
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    with torch.no_grad():
        hard = mega.render_pass_mega(
            scene, pt.init_state(cfg, "cpu"),
            replace(cfg, mega_edge_bandwidth=0.0), u_planes=u)["acc"]
    assert torch.equal(acc.detach(), hard)
    # mega_edge_tau sets the depth order's temperature apart
    _, got_tau = _route_grads(scene, replace(cfg, mega_edge_tau=5e-2), u, g)
    assert not torch.equal(got_tau[0], got[0])


def test_torch_edge_grid_matches_brute_and_row_contract():
    """Edge mode over prepare_grids(cornell, 2): the primal walks the grids,
    the soft backward sweeps the scene's own rows, so the cotangents are
    the brute edge route's. Tables with a grid's duplicated rows, or the
    champion backward in edge mode, are refused."""
    cfg, scene, u = _setup(16, 12, bounces=2, mega_edge_bandwidth=BW)
    g = _g(cfg, 4)
    gs, gcfg = prepare_grids(scene, 2), replace(cfg, use_grid=True)
    brute_tables = mega.scene_tables(scene, cfg)
    grid_tables = mega.scene_tables(gs, gcfg)
    for a, b in zip(brute_tables, grid_tables):
        assert torch.equal(a, b)
    _, want = _route_grads(scene, cfg, u, g)
    _, got = _route_grads(gs, gcfg, u, g)
    for k, a, b in zip(PARAMS, want, got):
        assert a.abs().max() > 0, k
        assert torch.equal(a, b), k

    par, sph, tri, mat, lig = grid_tables
    kw = dict(spp=1, width=cfg.width, bounces=cfg.bounces, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    acc = torch.zeros((cfg.total_rays, 3))
    dup = torch.cat([tri, tri[:3]])      # rows binned in two cells, twice
    with pytest.raises(ValueError, match="cell-major"):
        MKG.pathtrace_pass_diff(par, IPAR, sph, dup, mat, lig, acc, u,
                                grid=mega.grid_tables(gs, sph, tri),
                                soft_bandwidth=BW, **kw)
    with pytest.raises(ValueError, match="cell-major"):
        MKG.pathtrace_pass_diff(par, IPAR, torch.cat([sph, sph[:1]]), tri,
                                mat, lig, acc, u, grid=mega.grid_tables(gs, sph, tri),
                                soft_bandwidth=BW, **kw)
    with pytest.raises(ValueError, match="hard-gradient only"):
        MKG.pathtrace_pass_diff(par, IPAR, sph, tri, mat, lig, acc, u,
                                bwd_cell=True, soft_bandwidth=BW, **kw)
    # kernel 2s's wrapper takes CUDA tensors only (the CPU route above ran
    # its plain version through _PassDiffSoft)
    with pytest.raises(ValueError, match="kernel 2s takes CUDA tensors"):
        MKS.pathtrace_pass_bwd_soft(par, IPAR, sph, tri, mat, lig,
                                    torch.ones_like(acc), u,
                                    soft_bandwidth=BW, soft_tau=BW, **kw)


def test_torch_edge_soft_converges_to_hard():
    """As bandwidth = tau -> 0 the soft value converges to the hard plain
    pass, pixelwise except a shrinking silhouette set (JAX's
    test_edge_soft_converges_to_hard)."""
    cfg, scene, u = _setup(32, 24)
    tables = mega.scene_tables(scene, cfg)
    hard = MK.pathtrace_pass(tables[0], IPAR, *tables[1:],
                             torch.zeros((cfg.total_rays, 3)), u, spp=1,
                             width=cfg.width, bounces=1, two_sided=False,
                             normalize_emitter=True, seed=cfg.seed)
    fracs = []
    for bw in (1e-2, 1e-3, 1e-4):
        soft = MKS.soft_pass_value(tables[0], IPAR, *tables[1:], u,
                                   **_soft_kw(cfg, bw))
        fracs.append(float(((soft - hard).abs().amax(-1) > 1e-2)
                           .float().mean()))
    assert fracs[0] > fracs[1] > fracs[2], fracs
    assert fracs[2] < 0.01, fracs


def test_torch_edge_interior_matches_hard():
    """At a sub-pixel bandwidth the material cotangents (interior-
    dominated) match the hard backward's within 0.06 of their scale (JAX's
    test_edge_interior_matches_hard)."""
    cfg, scene, u = _setup(48, 36)
    tables = mega.scene_tables(scene, cfg)
    g = torch.ones((cfg.total_rays, 3))
    kw = dict(spp=1, width=cfg.width, bounces=1, two_sided=False,
              normalize_emitter=True, seed=cfg.seed, diff_wrt=("mat",))
    hard = MKG.pathtrace_pass_bwd_reference(tables[0], IPAR, *tables[1:], g,
                                            u, **kw)[3]
    soft = MKS.pathtrace_pass_bwd_soft_reference(
        tables[0], IPAR, *tables[1:], g, u, soft_bandwidth=2e-3,
        soft_tau=2e-3, **kw)[3]
    scale = hard.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(soft[:, :3].numpy(), hard[:, :3].numpy(),
                               atol=0.06 * scale, rtol=0.06)


def test_torch_edge_gradient_matches_finite_differences():
    """diff.check_grad on the unmasked image loss (silhouettes included):
    the soft gradient wrt sphere centres and wall vertices against central
    differences at its four largest entries per group; top 3 per group
    within 0.15 relative, the median within 0.10 (JAX's
    test_edge_fd_unmasked_fullimage_512, at 48x36). The step is 1e-4: the
    soft value has a square-root cusp where a ray's discriminant crosses
    zero (t = -b - sqrt(max(dis, 0))), and a wider step straddles such
    rays (at JAX's 2e-3 on this film, three of the top four centre entries
    are 0.3-0.6 off in float32 and in float64 alike)."""
    cfg, scene, u = _setup(48, 36)
    kw = _soft_kw(cfg, 5e-2)
    wts = torch.as_tensor(np.random.default_rng(7).normal(
        size=(cfg.total_rays, 3)).astype(np.float32) * 0.5 + 1.0)

    def loss(p):
        tables = mega.scene_tables(_with(scene, p), cfg)
        return torch.mean(MKS.soft_pass_value(tables[0], IPAR, *tables[1:],
                                              u, **kw) * wts)

    x0 = {"center": scene.spheres.center, "tv": scene.triangles.v}
    p = {k: v.clone().requires_grad_(True) for k, v in x0.items()}
    grads = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
    rels = {}
    for k, gk in grads.items():
        assert torch.isfinite(gk).all() and gk.abs().max() > 0, k
        top = torch.argsort(-gk.abs().reshape(-1))[:4]

        def probe(delta, k=k, top=top):
            # x0 moved by delta at the four entries
            xk = x0[k].reshape(-1).index_add(0, top, delta).reshape(
                x0[k].shape)
            return loss({**x0, k: xk})

        out = check_grad(probe, torch.zeros(4), eps=1e-4, rtol=1.0,
                         atol=1.0)
        ad, fd = out["ad"].numpy(), out["fd"]
        np.testing.assert_allclose(ad, gk.reshape(-1)[top].numpy(),
                                   rtol=1e-6)
        rels[k] = list(np.abs(ad - fd) / np.maximum(np.abs(fd), 1e-12))
    for k, r in rels.items():
        assert max(r[:3]) < 0.15, (k, r)
    assert np.median(rels["center"] + rels["tv"]) < 0.10, rels


def _probe_tables(cfg, scene, u):
    """cornell's tables with a sphere tangent to the centre pixel's primary
    ray and a triangle whose plane holds that ray (edge-on to it)."""
    par, sph, tri, mat, lig = (t.numpy().copy()
                               for t in mega.scene_tables(scene, cfg))
    o, d, _, _ = MK._camera_rays(torch.as_tensor(par), u[0:2].t(),
                                 cfg.total_rays, 0, 1, cfg.width)
    k = (cfg.height // 2) * cfg.width + cfg.width // 2
    o, d = o[k].double().numpy(), d[k].double().numpy()
    side = np.cross(d, [0.0, 1.0, 0.0])
    side /= np.linalg.norm(side)
    up = np.cross(side, d)
    ball = np.zeros((1, 8), np.float32)
    ball[0, 0:3] = o + 1.8 * d + 0.15 * side
    ball[0, 3], ball[0, 4], ball[0, 5] = 0.15, 3.0, 1.0
    edge = tri_row(o + 2.0 * d, o + 2.8 * d, o + 2.4 * d + 0.3 * up,
                   side, side, side, 0.0)
    return [torch.as_tensor(t) for t in
            (par, np.concatenate([sph, ball]),
             np.concatenate([tri, edge[None]]), mat, lig)]


@pytest.mark.parametrize("two_sided", [False, True])
def test_torch_edge_finite_at_tiny_bandwidth(two_sided):
    """Bandwidth 1e-4, a primary ray tangent to a sphere, a triangle edge-on
    to the camera, a wide field of view and two bounces (rays that leave
    the open box, cov ~ 0): every cotangent is finite."""
    w, h = 13, 9
    sc = cornell_box(cols=w, rows=h)
    sc = replace(sc, camera=Camera.look_at([0.0, 0.0, 2.6], [0.0, -0.1, 0.0],
                                           [0.0, 1.0, 0.0], 110.0, w, h))
    cfg, scene, u = _setup(w, h, bounces=2, scene=sc,
                           two_sided_triangles=two_sided)
    tables = _probe_tables(cfg, scene, u)
    kw = _soft_kw(cfg, 1e-4)
    val = MKS.soft_pass_value(tables[0], IPAR, *tables[1:], u, **kw)
    assert torch.isfinite(val).all()
    outs = MKS.pathtrace_pass_bwd_soft_reference(
        tables[0], IPAR, *tables[1:], _g(cfg, 9), u, seed=cfg.seed, **kw)
    for name, t in zip(MKG.DIFF_ALL, outs):
        assert torch.isfinite(t).all(), name
        assert t.abs().max() > 0, name


def test_torch_edge_silhouette_recovery_converges():
    """Silhouette recovery through the production route on the CPU: the
    hard forward and the edge-aware backward of render_pass_mega recover a
    sphere offset whose silhouette barely overlaps the target (JAX's
    test_edge_silhouette_optim_converges: 16x12, 6 Adam steps, lr 4e-2,
    bandwidth 4e-2)."""
    cfg, scene, u = _setup(16, 12, mega_edge_bandwidth=4e-2)
    true = scene.spheres.center.clone()

    def acc_of(c):
        sc = replace(scene, spheres=replace(scene.spheres, center=c))
        return mega.render_pass_mega(sc, pt.init_state(cfg, "cpu"), cfg,
                                     u_planes=u)["acc"]

    with torch.no_grad():
        target = acc_of(true)
    start = true.clone()
    start[0, 0] += 0.22
    start[0, 1] -= 0.12
    c = start.clone().requires_grad_(True)
    opt = torch.optim.Adam([c], lr=4e-2)
    for _ in range(6):
        opt.zero_grad()
        torch.mean((acc_of(c) - target) ** 2).backward()
        opt.step()
    start_err = float(torch.linalg.norm(start[0] - true[0]))
    final_err = float(torch.linalg.norm(c.detach()[0] - true[0]))
    assert final_err < 0.7 * start_err, (start_err, final_err)
