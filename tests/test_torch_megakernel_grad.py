"""The port's differentiable pass against the JAX package.

The plain version of kernel 2 (``pathtrace_pass_bwd_reference``: autograd
through the plain forward) against JAX's ``_bwd_reference`` (jax.vjp of
``_tile_program``) on the same tables, u-planes and cotangent; the
gradients of scene parameters through the port's ``render_pass`` against
JAX's XLA stage pipeline on the same draws; a finiteness probe at b5;
``mega_grad_wrt`` subsets; and the routing of requires-grad calls. The CUDA
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 6).

Tolerances: the plain backward vs ``_bwd_reference`` within 1e-3 of each
group's largest entry (measured <= 1.1e-4: float32 sums in another order);
end to end, the tolerance ``tests/test_megakernel_grad.py::_compare`` holds
the JAX megakernel to (rtol 5e-3, atol 5e-3 x the largest entry).
"""
import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.ops.pallas.megakernel_grad import _bwd_reference
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.models.scenes import sphere_field
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_threads import one_thread  # noqa: F401

W, H = 32, 24
PARAMS = ("center", "radius", "tv", "mat", "irr", "lpos", "eye")


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def scenes():
    js = cornell_box(cols=W, rows=H)
    return js, scene_from_numpy(scene_to_numpy(js))


def _kw(cfg):
    return dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
                two_sided=cfg.two_sided_triangles,
                normalize_emitter=cfg.normalize_emitter, seed=cfg.seed)


@pytest.mark.parametrize("bounces", [1, 5])
def test_plain_backward_matches_jax_bwd_reference(scenes, bounces):
    js, _ = scenes
    jcfg = JaxConfig(width=W, height=H, bounces=bounces)
    jtables = jmega.scene_tables(js, jcfg)
    ju = jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], 0, jcfg,
                                 js.lights.count)
    g = np.random.default_rng(bounces).normal(
        size=(jcfg.total_rays, 3)).astype(np.float32)
    ipar = np.zeros((2,), np.int32)
    want = _bwd_reference(*jtables[:1], ipar, *jtables[1:], g, ju,
                          mode="path", russian_roulette=False,
                          rr_start_depth=0, **_kw(jcfg))
    t = [torch.as_tensor(np.asarray(x)) for x in jtables]
    got = MKG.pathtrace_pass_bwd_reference(
        t[0], torch.as_tensor(ipar), *t[1:], torch.as_tensor(g),
        torch.as_tensor(np.asarray(ju)), **_kw(RenderConfig(
            width=W, height=H, bounces=bounces)))
    for name, a, b in zip(MKG.DIFF_ALL, want, got):
        a, b = np.asarray(a), b.numpy()
        assert b.shape == a.shape, name
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)


def _jax_grads(js, jcfg):
    import dataclasses

    import jax.numpy as jnp

    state0 = jpt.init_state(jcfg)

    def loss(p):
        sc = dataclasses.replace(
            js,
            spheres=dataclasses.replace(js.spheres, center=p["center"],
                                        radius=p["radius"]),
            triangles=dataclasses.replace(js.triangles, v=p["tv"]),
            lights=dataclasses.replace(js.lights, irradiance=p["irr"],
                                       position=p["lpos"]),
            materials=p["mat"],
            camera=dataclasses.replace(js.camera, eye=p["eye"]))
        return jnp.mean(jpt._render_pass(sc, state0, jcfg)["acc"] ** 2)

    params = {"center": js.spheres.center, "radius": js.spheres.radius,
              "tv": js.triangles.v, "mat": js.materials,
              "irr": js.lights.irradiance, "lpos": js.lights.position,
              "eye": js.camera.eye}
    v, gr = jax.value_and_grad(loss)(params)
    return float(v), {k: np.asarray(x) for k, x in gr.items()}


def _port_grads(ps, cfg, device="cpu"):
    """(loss, {param: grad}) of mean(acc^2) after one render_pass; groups
    outside cfg.mega_grad_wrt come back as zeros."""
    p = {"center": ps.spheres.center, "radius": ps.spheres.radius,
         "tv": ps.triangles.v, "mat": ps.materials,
         "irr": ps.lights.irradiance, "lpos": ps.lights.position,
         "eye": ps.camera.eye}
    p = {k: v.detach().clone().to(device).requires_grad_(True)
         for k, v in p.items()}
    sc = replace(
        ps.to(device),
        spheres=replace(ps.spheres.to(device), center=p["center"],
                        radius=p["radius"]),
        triangles=replace(ps.triangles.to(device), v=p["tv"]),
        lights=replace(ps.lights.to(device), irradiance=p["irr"],
                       position=p["lpos"]),
        materials=p["mat"],
        camera=replace(ps.camera.to(device), eye=p["eye"]))
    st = pt.render_pass(sc, pt.init_state(cfg, device), cfg)
    loss = torch.mean(st["acc"] ** 2)
    grads = torch.autograd.grad(loss, [p[k] for k in PARAMS],
                                allow_unused=True, materialize_grads=True)
    return loss.item(), {k: g.cpu().numpy() for k, g in zip(PARAMS, grads)}


def test_render_pass_grads_match_jax_pipeline(scenes):
    """Sphere center and radius, triangle vertices (through
    tri_constants), materials, light irradiance (through irr_n) and
    position (through the NEE sample and r2), and the camera eye."""
    js, ps = scenes
    vx, gx = _jax_grads(js, JaxConfig(width=W, height=H, bounces=1))
    vp, gp = _port_grads(ps, RenderConfig(width=W, height=H, bounces=1,
                                               use_megakernel=True))
    np.testing.assert_allclose(vp, vx, rtol=1e-5)
    for k in PARAMS:
        a, b = gx[k], gp[k]
        assert np.isfinite(b).all(), k
        scale = max(np.abs(a).max(), 1e-8)
        assert np.abs(a).max() > 0 and np.abs(b).max() > 0, k
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-3 * scale,
                                   err_msg=k)


def test_grads_finite_at_five_bounces(scenes):
    """Every group, triangles included, through the whole chain at b5 (the
    grazing sphere hit of ROADMAP Queue 3 included)."""
    _, ps = scenes
    _, g = _port_grads(ps, RenderConfig(width=W, height=H, bounces=5,
                                              use_megakernel=True))
    for k in PARAMS:
        assert np.isfinite(g[k]).all(), k
        assert np.abs(g[k]).max() > 0, k
    cfg = RenderConfig(width=W, height=H, bounces=5, use_megakernel=True)
    tables = mega.scene_tables(ps, cfg)
    gacc = torch.as_tensor(np.random.default_rng(5).normal(
        size=(cfg.total_rays, 3)).astype(np.float32))
    out = MKG.pathtrace_pass_bwd_reference(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:], gacc,
        None, **_kw(cfg))
    for name, d in zip(MKG.DIFF_ALL, out):
        assert torch.isfinite(d).all(), name


def test_grad_wrt_subset_zeroes_the_rest(scenes):
    """cfg.mega_grad_wrt: selected groups equal the full run, the rest
    get no cotangent; the plain backward returns zeros for them."""
    _, ps = scenes
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    _, g_full = _port_grads(ps, cfg)
    _, g_sub = _port_grads(ps, replace(cfg, mega_grad_wrt=("sph", "mat")))
    for k in ("center", "radius", "mat"):
        np.testing.assert_allclose(g_sub[k], g_full[k], rtol=1e-6, err_msg=k)
    for k in ("tv", "irr", "lpos", "eye"):
        assert (g_sub[k] == 0).all(), k
        assert np.abs(g_full[k]).max() > 0, k
    tables = mega.scene_tables(ps, cfg)
    gacc = torch.ones((cfg.total_rays, 3))
    out = MKG.pathtrace_pass_bwd_reference(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:], gacc,
        None, diff_wrt=("tri", "lig"), **_kw(cfg))
    for name, d in zip(MKG.DIFF_ALL, out):
        assert d.any() == (name in ("tri", "lig")), name


def test_routing_of_requires_grad_calls(scenes):
    _, ps = scenes
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    # nothing requires grad: the forward-only route, in place
    st = pt.init_state(cfg, "cpu")
    out = mega.render_pass_mega(ps, st, cfg)
    assert out["acc"] is st["acc"] and out["acc"].grad_fn is None
    c = ps.spheres.center.clone().requires_grad_(True)
    sc = replace(ps, spheres=replace(ps.spheres, center=c))
    # requires grad: a new, differentiable accumulator
    st = pt.init_state(cfg, "cpu")
    out = pt.render_pass(sc, st, cfg)
    assert out["acc"] is not st["acc"] and out["acc"].grad_fn is not None
    assert not st["acc"].any()
    # under no_grad the same scene takes the forward-only route
    with torch.no_grad():
        st = pt.init_state(cfg, "cpu")
        assert mega.render_pass_mega(sc, st, cfg)["acc"] is st["acc"]
    # the in-launch multi-pass route has no backward
    with pytest.raises(ValueError, match="one pass"):
        pt.render_passes(sc, pt.init_state(cfg, "cpu"), cfg, 2)


def test_backward_gates(scenes):
    """bwd_impl_for has the JAX package's semantics: "auto" is kernel 2
    ("pallas") up to 64 objects per type and the champion route ("cell")
    past that and in grid mode; "pallas" runs kernel 2 at any size the
    differentiable pass covers, grid scenes included; the TPU-only "xla"
    raises."""
    _, ps = scenes
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    assert mega.supported_diff(ps, cfg)
    assert mega.bwd_impl_for(ps, cfg) == "pallas"
    for impl in ("pallas", "cell"):
        assert mega.bwd_impl_for(ps, replace(cfg, mega_bwd_impl=impl)) == impl
    big = sphere_field(65, cols=W, rows=H)
    assert mega.bwd_impl_for(big, cfg) == "cell"
    with pytest.raises(NotImplementedError, match="Do not port"):
        mega.bwd_impl_for(ps, replace(cfg, mega_bwd_impl="xla"))
    # edge mode: kernel 2s at any size the pass covers, "cell" is hard-only
    edge = replace(cfg, mega_edge_bandwidth=1e-2)
    for impl in ("auto", "pallas"):
        assert mega.bwd_impl_for(ps, replace(edge, mega_bwd_impl=impl)) \
            == "pallas"
        assert mega.bwd_impl_for(big, replace(edge, mega_bwd_impl=impl)) \
            == "pallas"
    with pytest.raises(ValueError, match="hard-gradient only"):
        mega.bwd_impl_for(ps, replace(edge, mega_bwd_impl="cell"))
    # grid mode: "auto" trains on the cell route, "pallas" runs kernel 2's
    # large-table instance over the grids
    gs, gcfg = prepare_grids(ps, 2), replace(cfg, use_grid=True)
    assert mega.bwd_impl_for(gs, gcfg) == "cell"
    assert mega.bwd_impl_for(gs, replace(gcfg, mega_bwd_impl="pallas")) \
        == "pallas"
    assert mega.bwd_impl_for(big, replace(cfg, mega_bwd_impl="pallas")) \
        == "pallas"
    with pytest.raises(NotImplementedError, match="DIFF_TABLE_MAX"):
        mega.supported_diff(sphere_field(4097, cols=W, rows=H), cfg)
    with pytest.raises(ValueError, match="'auto', 'pallas' or 'cell'"):
        mega.bwd_impl_for(ps, replace(cfg, mega_bwd_impl="dense"))
    with pytest.raises(ValueError, match="unknown groups"):
        mega.supported_diff(ps, replace(cfg, mega_grad_wrt=("sph", "cam")))
    # kernel 2 takes CUDA tensors only; the CPU has the plain version
    tables = mega.scene_tables(ps, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        MKG.pathtrace_pass_bwd(tables[0], torch.zeros(2, dtype=torch.int32),
                               *tables[1:], torch.ones((cfg.total_rays, 3)),
                               None, **_kw(cfg))


def test_tangent_sphere_ray_has_finite_gradient():
    """A ray tangent to a sphere has a discriminant of exactly 0 (a 1024^2
    cornell image has such rays). The plain sphere test's sqrt must then
    give a zero cotangent, as JAX's _safe_sqrt does, not 0/0."""
    from raytracing_tpu_torch.ops import intersect as I
    row = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0],
                       requires_grad=True)
    o = torch.tensor([[0.0, 1.0, -5.0], [0.0, 0.5, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    a = (d * d).sum(-1)
    ok, t = I.sphere_hit(o, d, a, 0.5 / a, torch.zeros(2),
                         torch.full((2,), 10.0), row)
    assert ok.tolist() == [True, True]
    t.sum().backward()
    assert torch.isfinite(row.grad).all() and row.grad[3] != 0
