"""The port's ``diff`` package against the JAX package's: the finite-
difference harness (``fd.finite_difference``, ``fd.check_grad``) and the
three toy soft renderers on the same inputs from one seed. Values at 8x6
within 2e-4 (float32 sums in another order); each renderer's autograd
gradient held to its own central differences by the port's
``check_grad``, with the tolerances of the JAX package's tests."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from raytracing_tpu import Camera as JCamera
from raytracing_tpu import RenderConfig as JConfig
from raytracing_tpu import make_spheres as jmake_spheres
from raytracing_tpu import replace as jreplace
from raytracing_tpu.diff import fd as jfd
from raytracing_tpu.diff import soft as jsoft
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.core.types import (Camera, make_spheres,
                                             scene_from_numpy, scene_to_numpy)
from raytracing_tpu_torch.diff import check_grad, finite_difference
from raytracing_tpu_torch.diff import soft
from torch_threads import one_thread  # noqa: F401

W, H = 8, 6
SEED = 5
COLORS = np.array([[0.9, 0.4, 0.2, 1.0], [0.2, 0.5, 0.9, 1.0]], np.float32)
CENTERS = np.array([[-0.4, 0.0, 0.0], [0.55, 0.1, 0.3]], np.float32)
RADII = np.array([0.55, 0.35], np.float32)


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _x():
    rng = np.random.default_rng(SEED)
    return {"a": rng.normal(size=(3,)).astype(np.float32),
            "b": rng.normal(size=(2, 2)).astype(np.float32)}


def test_torch_finite_difference_matches_jax():
    """The same pytree, function and step: the same central differences."""
    x = _x()

    def f_np(lib, t):
        return lib.sum(lib.sin(t["a"]) * t["a"] ** 2) \
            + lib.sum(t["b"] ** 3) * lib.sum(t["a"])

    want = jfd.finite_difference(lambda t: f_np(jnp, t),
                                 {k: jnp.asarray(v) for k, v in x.items()})
    got = finite_difference(lambda t: f_np(torch, t),
                            {k: torch.as_tensor(v) for k, v in x.items()})
    for k in x:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_torch_check_grad_passes_and_catches_a_wrong_gradient():
    x = {k: torch.as_tensor(v) for k, v in _x().items()}

    def f(t):
        return torch.sum(torch.sin(t["a"]) * t["a"] ** 2) \
            + torch.sum(t["b"] ** 3) * torch.sum(t["a"])

    out = check_grad(f, x, eps=1e-3, rtol=1e-2, atol=1e-3)
    assert out["max_abs_err"] < 1e-2
    np.testing.assert_allclose(
        out["ad"]["a"].numpy(),
        np.asarray(jax.grad(lambda a: jnp.sum(jnp.sin(a) * a ** 2)
                            + jnp.sum(jnp.asarray(_x()["b"]) ** 3)
                            * jnp.sum(a))(jnp.asarray(_x()["a"]))),
        rtol=1e-5, atol=1e-6)

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 1.0

        @staticmethod
        def backward(ctx, g):
            return 2.0 * g          # wrong on purpose

    with pytest.raises(AssertionError, match="grad mismatch"):
        check_grad(lambda a: torch.sum(Twice.apply(a) ** 2), x["a"])


def _cams():
    jc = JCamera.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0], 60.0, W, H)
    pc = Camera.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0], 60.0, W, H)
    return jc, pc


def test_torch_fake_shade_soft_matches_jax():
    jc, pc = _cams()
    want = np.asarray(jsoft.render_fake_shade_soft(
        jc, jmake_spheres(CENTERS, RADII), jnp.asarray(COLORS),
        bandwidth=0.05, tau=0.05))
    got = soft.render_fake_shade_soft(pc, make_spheres(CENTERS, RADII),
                                      torch.as_tensor(COLORS),
                                      bandwidth=0.05, tau=0.05).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    # the JAX package's test_soft_renderer_grad_everywhere, on the port
    def loss(center):
        sp = replace(make_spheres(CENTERS, RADII), center=center)
        return torch.mean(soft.render_fake_shade_soft(
            pc, sp, torch.as_tensor(COLORS), bandwidth=0.05, tau=0.05))

    check_grad(loss, torch.as_tensor(CENTERS), eps=1e-3, rtol=0.05,
               atol=1e-5)


def _cornell():
    js = cornell_box(cols=W, rows=H)
    return js, scene_from_numpy(scene_to_numpy(js))


def test_torch_direct_soft_matches_jax():
    js, ps = _cornell()
    jcfg = JConfig(width=W, height=H, spp=1, bounces=0)
    cfg = RenderConfig(width=W, height=H, spp=1, bounces=0)
    want = np.asarray(jsoft.render_direct_soft(js, jcfg, bandwidth=1e-2,
                                               tau=1e-2))
    got = soft.render_direct_soft(ps, cfg, bandwidth=1e-2, tau=1e-2).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def loss(c):
        sc = replace(ps, spheres=replace(ps.spheres, center=c))
        return torch.mean(soft.render_direct_soft(sc, cfg, bandwidth=1e-2,
                                                  tau=1e-2))

    # the JAX package's tolerance (test_soft_direct_fd_allclose_*)
    check_grad(loss, ps.spheres.center, eps=5e-4, rtol=5e-3, atol=2e-4)


def test_torch_pathtrace_soft_matches_jax():
    js, ps = _cornell()
    jcfg = JConfig(width=W, height=H, spp=1, bounces=1)
    cfg = RenderConfig(width=W, height=H, spp=1, bounces=1)
    want = np.asarray(jsoft.render_pathtrace_soft(js, jcfg, bandwidth=1e-2,
                                                  tau=1e-2))
    got = soft.render_pathtrace_soft(ps, cfg, bandwidth=1e-2,
                                     tau=1e-2).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def loss(c):
        sc = replace(ps, spheres=replace(ps.spheres, center=c))
        return torch.mean(soft.render_pathtrace_soft(sc, cfg, bandwidth=1e-2,
                                                     tau=1e-2))

    # the JAX package's tolerance (test_soft_pathtracer_fd_allclose_*)
    check_grad(loss, ps.spheres.center, eps=1e-4, rtol=5e-2, atol=2e-3)
    # and the gradient itself against JAX's
    jgrad = np.asarray(jax.grad(lambda c: jnp.mean(jsoft.render_pathtrace_soft(
        jreplace(js, spheres=jreplace(js.spheres, center=c)), jcfg,
        bandwidth=1e-2, tau=1e-2)))(js.spheres.center))
    c = ps.spheres.center.clone().requires_grad_(True)
    (pgrad,) = torch.autograd.grad(loss(c), [c])
    scale = np.abs(jgrad).max()
    np.testing.assert_allclose(pgrad.numpy(), jgrad, rtol=0,
                               atol=1e-3 * scale)
