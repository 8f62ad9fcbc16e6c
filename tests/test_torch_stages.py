"""The port's stage pipeline (``render/stages.py``, the stage route of
``render/pathtracer.py``, ``render/direct.py``) against the JAX package's,
on the same scenes and the same draws.

``use_pallas=True`` on the JAX side runs the Pallas hit kernels in
interpret mode; that compiles slowly, so it is used at b0 and b2 only, and
b5 is held against JAX's ``use_pallas=False`` pass (the same route with
the XLA search). Tolerances are the megakernel tests' (ROADMAP Queue 3,
grazing sphere hits): 2e-4, and at b5 at most 0.1% of entries past 2e-4
and none past 1e-3. Gradients: ``tests/test_torch_megakernel_grad.py``'s
tolerance, rtol 5e-3 and atol 5e-3 x the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.core import types as jtypes
from raytracing_tpu.io.png import read_png
from raytracing_tpu.models.scenes import cornell_box, sphere_field
from raytracing_tpu.render import camera as jcamera
from raytracing_tpu.render import direct as jdirect
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu.render import stages as jstages
from raytracing_tpu_torch import RenderConfig, cli
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.core.types import (Hits, Rays, replace,
                                             scene_from_numpy,
                                             scene_to_numpy)
from raytracing_tpu_torch.ops import hit_kernels as HK
from raytracing_tpu_torch.render import camera, direct, stages
from raytracing_tpu_torch.render import pathtracer as pt
from test_torch_megakernel_grad import PARAMS, _jax_grads, _port_grads
from torch_threads import one_thread  # noqa: F401

W, H = 32, 24
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _pair(js):
    return js, scene_from_numpy(scene_to_numpy(js))


@pytest.fixture(scope="module")
def cornell():
    return _pair(cornell_box(cols=W, rows=H))


@pytest.fixture(scope="module")
def spheres():
    return _pair(sphere_field(24, cols=W, rows=H))


def _primary(js, ps, cfg_kw):
    """The same camera rays in both packages (JAX's, carried across)."""
    jcam = jtypes.replace(js.camera, cols=W, rows=H)
    jr = jcamera.generate_primary_rays(jcam, js.bounds, js.focal_length,
                                       js.lens_radius, 1,
                                       lens_uv=jnp.full((W * H, 2), 0.5))
    pr = Rays(*(torch.as_tensor(np.array(getattr(jr, f)))
                for f in ("o", "d", "mint", "maxt")))
    return jr, pr


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("scene", ["cornell", "spheres"])
def test_trace_all_and_occluded_any_match_jax(scene, use_pallas, request):
    js, ps = request.getfixturevalue(scene)
    kw = dict(width=W, height=H, use_pallas=use_pallas)
    jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
    jr, pr = _primary(js, ps, kw)
    jr2, jh = jstages.trace_all(jr, jtypes.Hits.none(W * H), js, jcfg)
    before = HK.sphere_launches + HK.triangle_launches
    pr2, ph = stages.trace_all(pr, Hits.none(W * H), ps, cfg)
    assert HK.sphere_launches + HK.triangle_launches == before
    np.testing.assert_array_equal(ph.mat_id.numpy(), np.asarray(jh.mat_id))
    assert (ph.mat_id.numpy() >= 0).sum() > 20
    for got, want in ((pr2.maxt, jr2.maxt), (ph.p, jh.p), (ph.n, jh.n),
                      (ph.t, jh.t)):
        _close(got, want, 1e-5)
    # shadow rays from every hit toward the light centre
    lpos = np.asarray(js.lights.position[0])
    o = np.asarray(jh.p) + 1e-3 * np.asarray(jh.n)
    delta = lpos[None] - o
    dist = np.linalg.norm(delta, axis=-1).astype(np.float32)
    d = (delta / np.maximum(dist, 1e-20)[:, None]).astype(np.float32)
    valid = np.asarray(jh.mat_id) >= 0
    mint = np.where(valid, 0.0, np.inf).astype(np.float32)
    maxt = np.where(valid, dist, np.inf).astype(np.float32)
    want = jstages.occluded_any(jtypes.Rays(*(jnp.asarray(x) for x in
                                              (o, d, mint, maxt))), js, jcfg)
    got = stages.occluded_any(Rays(*(torch.as_tensor(x) for x in
                                     (o, d, mint, maxt))), ps, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and (valid & ~got.numpy()).any()


def _jax_pass(js, n_passes=1, **kw):
    cfg = JaxConfig(**kw)
    st = jpt.init_state(cfg)
    for _ in range(n_passes):
        st = jpt._render_pass(js, st, cfg)
    return np.asarray(st["acc"])


def _port_pass(ps, n_passes=1, **kw):
    cfg = RenderConfig(**kw)
    assert not cfg.use_megakernel
    st = pt.init_state(cfg, "cpu")
    acc0 = st["acc"]
    st = pt.render_passes(ps, st, cfg, n_passes)
    assert st["passes"] == n_passes and not acc0.any()  # out of place
    return st["acc"].numpy()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bounces", [0, 2])
def test_stage_pass_matches_jax(cornell, bounces, use_pallas):
    js, ps = cornell
    kw = dict(width=W, height=H, bounces=bounces, use_pallas=use_pallas)
    _close(_port_pass(ps, **kw), _jax_pass(js, **kw))


def test_stage_pass_b5_matches_jax_xla_search(cornell):
    """The port's pass through the hit kernels' route against JAX's pass
    through its XLA search (the same route, other search form)."""
    js, ps = cornell
    kw = dict(width=W, height=H, bounces=5)
    want = _jax_pass(js, **kw)
    got = _port_pass(ps, use_pallas=True, **kw)
    err = np.abs(got - want)
    assert (err > TOL + TOL * np.abs(want)).mean() <= 1e-3
    assert err.max() <= 1e-3
    assert abs(got.mean() - want.mean()) <= 1e-6 * abs(want.mean())


STAGE_CASES = {
    "spp4": dict(spp=4, bounces=1),
    "russian_roulette": dict(bounces=3, russian_roulette=True,
                             rr_start_depth=1),
    "stale_poi": dict(bounces=2, replicate_stale_poi=True),
    "two_sided_two_passes": dict(bounces=1, two_sided_triangles=True),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_stage_pass_options_match_jax(cornell, case):
    js, ps = cornell
    kw = dict(width=W, height=H, **STAGE_CASES[case])
    n = 2 if case == "two_sided_two_passes" else 1
    _close(_port_pass(ps, n, use_pallas=True, **kw), _jax_pass(js, n, **kw),
           TOL if n == 1 else 5e-4)


def test_stage_pass_on_sphere_field_matches_jax(spheres):
    js, ps = spheres
    kw = dict(width=W, height=H, bounces=2)
    _close(_port_pass(ps, use_pallas=True, **kw), _jax_pass(js, **kw))


@pytest.mark.parametrize("spp", [1, 4])
def test_generate_primary_rays_matches_jax(cornell, spp):
    """spp 1 draws the lens point from a key, spp 4 takes stratified lens
    cells; a thin lens so that both matter."""
    js, ps = cornell
    js = jtypes.replace(js, lens_radius=jnp.float32(0.1))
    ps = replace(ps, lens_radius=torch.tensor(0.1))
    key = rng.draw_key(rng.base_key(3), rng.LENS)
    jkey = jax.random.wrap_key_data(jnp.asarray(key.numpy()))
    jcam = jtypes.replace(js.camera, cols=W, rows=H)
    want = jcamera.generate_primary_rays(jcam, js.bounds, js.focal_length,
                                         js.lens_radius, spp, key=jkey)
    pcam = replace(ps.camera, cols=W, rows=H)
    got = camera.generate_primary_rays(pcam, ps.bounds, ps.focal_length,
                                       ps.lens_radius, spp, key=key)
    for f in ("o", "d", "mint", "maxt"):
        _close(getattr(got, f), getattr(want, f), 1e-5)


@pytest.mark.parametrize("n_passes", [1, 2])
def test_render_direct_matches_jax(cornell, n_passes):
    js, ps = cornell
    kw = dict(width=W, height=H, use_pallas=True)
    want = jdirect.render_direct(js, JaxConfig(use_megakernel=False, **kw),
                                 n_passes=n_passes)
    got = direct.render_direct(ps, RenderConfig(**kw), n_passes=n_passes)
    assert got.shape == (H, W, 3)
    _close(got, want)
    # the megakernel branch runs kernel 1's direct mode (its plain version
    # on the CPU) on the same draws
    _close(direct.render_direct(ps, RenderConfig(use_megakernel=True, **kw),
                                n_passes=n_passes), want)


def test_default_config_takes_the_stage_route(cornell, monkeypatch):
    """``RenderConfig()`` routes to the stage pipeline in both packages;
    ``use_megakernel=True`` with ``use_pallas=True`` takes the megakernel
    (which ignores use_pallas, as JAX's does)."""
    _, ps = cornell
    assert RenderConfig().use_megakernel is JaxConfig().use_megakernel \
        is False

    def boom(*a, **k):
        raise AssertionError("wrong route")
    cfg = RenderConfig(width=W, height=H, bounces=1)
    with monkeypatch.context() as m:
        m.setattr(pt, "render_pass_mega", boom)
        st = pt.render_pass(ps, pt.init_state(cfg, "cpu"), cfg)
        st = pt.render_passes(ps, st, cfg, 2)
    assert st["passes"] == 3
    mcfg = replace(cfg, use_megakernel=True, use_pallas=True)
    with monkeypatch.context() as m:
        m.setattr(pt, "_render_pass_stages", boom)
        st = pt.render_pass(ps, pt.init_state(mcfg, "cpu"), mcfg)
        st = pt.render_passes(ps, st, mcfg, 2)
    assert st["passes"] == 3
    with pytest.raises(NotImplementedError, match="use_megakernel=False"):
        pt.render_pass(ps, pt.init_state(mcfg, "cpu"),
                       replace(mcfg, replicate_stale_poi=True))
    # grid mode reads the grids of accel.prepare_grids, never brute force
    with pytest.raises(ValueError, match="prepare_grids"):
        pt.render_pass(ps, pt.init_state(cfg, "cpu"),
                       replace(cfg, use_grid=True))


def test_stage_route_grads_match_jax():
    """Autograd through the stage route (hit kernels' search, differentiable
    recompute) against jax.grad of JAX's stage pipeline, 16x12 b1; every
    gradient finite at b5."""
    js, ps = _pair(cornell_box(cols=16, rows=12))
    kw = dict(width=16, height=12, bounces=1)
    vx, gx = _jax_grads(js, JaxConfig(**kw))
    vp, gp = _port_grads(ps, RenderConfig(use_pallas=True, **kw))
    np.testing.assert_allclose(vp, vx, rtol=1e-5)
    for k in ("center", "radius", "mat", "tv"):
        a, b = gx[k], gp[k]
        assert np.abs(a).max() > 0 and np.abs(b).max() > 0, k
        np.testing.assert_allclose(b, a, rtol=5e-3,
                                   atol=5e-3 * np.abs(a).max(), err_msg=k)
    _, g5 = _port_grads(ps, RenderConfig(use_pallas=True, **{**kw,
                                                             "bounces": 5}))
    for k in PARAMS:
        assert np.isfinite(g5[k]).all(), k


def test_cli_stage_route_on_spheres(tmp_path, capsys):
    """``--no-megakernel --pallas --scene spheres`` (sphere_field(512),
    beyond the megakernel's 64-object budget) renders, checkpoints and
    equals the same stage pass called directly."""
    out = str(tmp_path / "s.png")
    args = ["--cpu", "--scene", "spheres", "--no-megakernel", "--pallas",
            "--width", "16", "--height", "12", "--passes", "1", "--bounces",
            "1", "-o", out]
    assert cli.main(args) == 0
    assert "wrote" in capsys.readouterr().out
    st = pt.load_checkpoint(out + ".ckpt.npz", "cpu")
    assert st["passes"] == 1
    scene = cli.load_named_scene("spheres", 16, 12, "cpu")
    cfg = RenderConfig(width=16, height=12, bounces=1, use_pallas=True)
    want = pt.render_pass(scene, pt.init_state(cfg, "cpu"), cfg)
    np.testing.assert_array_equal(st["acc"].numpy(), want["acc"].numpy())
    assert read_png(out).max() > 0


def test_cli_direct_renderer(tmp_path):
    out = str(tmp_path / "d.png")
    base = ["--cpu", "--width", "16", "--height", "12", "--renderer",
            "direct", "-o", out]
    assert cli.main(base + ["--no-megakernel", "--pallas", "--passes",
                            "2"]) == 0
    scene = cli.load_named_scene("cornell", 16, 12, "cpu")
    want = direct.render_direct(scene, RenderConfig(width=16, height=12,
                                                    use_pallas=True),
                                n_passes=2)
    np.testing.assert_array_equal(
        read_png(out), (want.numpy() * 255 + 0.5).astype(np.uint8))
    # without --no-megakernel: kernel 1's direct mode (its plain version)
    assert cli.main(base + ["--passes", "2"]) == 0
    mk = direct.render_direct(scene, RenderConfig(width=16, height=12,
                                                  use_megakernel=True),
                              n_passes=2)
    np.testing.assert_array_equal(
        read_png(out), (mk.numpy() * 255 + 0.5).astype(np.uint8))
