"""The port's examples (``raytracing_tpu_torch/examples``) at their
``--cpu`` sizes on the CPU, against the JAX package where both compute the
same numbers.

smoke_render: the hit count, material ids, shaded image, pipeline sum and
centre gradient against JAX's same pipeline (image and sum at 2e-4, the
gradient at rtol 1e-3: JAX's sqrt and the port's round differently near
silhouettes). inverse_render: its material perturbation equals
``jax.random.normal``'s draws to 1e-6 (erfinv's last bits), and the
example runs to its own final assert (the loss halves in 40 steps).
silhouette_optim: the soft engine runs to its own final assert; the mega
engine (kernel 1's hard forward, kernel 2s's edge-aware adjoint, their
plain versions here) converges as the JAX package's own test of that
engine holds it (16x12, 6 steps: the error below 0.7 of its start). Its
``main`` at 24x18 and 12 steps asserts 0.6 of the start, which neither
package reaches on the CPU (JAX 0.2776, the port 0.3482 of 0.4301: the
trajectories part after three Adam steps, where the first gradients agree
to 0.5% but a small component differs by 4%); the port's kernels on an
H100 reach JAX's 0.2776, and fail that assert too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_tpu.core.types import Camera as JCamera
from raytracing_tpu.core.types import Spheres as JSpheres
from raytracing_tpu.core.types import make_spheres as jmake_spheres
from raytracing_tpu.ops.closest_hit import closest_hit_spheres as jclosest
from raytracing_tpu.ops.closest_hit import sphere_hit_attrs as jattrs
from raytracing_tpu.render.camera import pinhole_rays as jpinhole
from raytracing_tpu.render.camera import pixel_grid as jpixel_grid
from raytracing_tpu_torch.examples import (inverse_render, silhouette_optim,
                                           smoke_render)
from torch_threads import one_thread  # noqa: F401


def test_smoke_render_example_matches_jax(capsys):
    got = smoke_render.run("cpu")
    cam = JCamera.look_at(eye=[0, 0, 3], lookat=[0, 0, 0], vup=[0, 1, 0],
                          fov_deg=60, cols=60, rows=30)
    sp = jmake_spheres([[-0.7, 0, 0], [0.7, 0, 0]], [0.6, 0.4], [0, 1])
    col, row = jpixel_grid(cam)

    def pipe(spheres):
        r = jpinhole(cam, col, row)
        c = jclosest(r, spheres)
        _, n, mat = jattrs(r, spheres, c)
        return jnp.where(c.valid, jnp.einsum("j,ij->i", cam.w, n), 0.0), \
            c.valid, mat

    shade, valid, mat = pipe(sp)
    assert got["valid"] == int(valid.sum()) == 126
    assert got["mats"] == sorted(set(np.asarray(mat)[np.asarray(valid)]
                                     .tolist())) == [0, 1]
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(shade).reshape(30, 60), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got["pipe"], float(shade.sum()), rtol=2e-4)
    g = jax.grad(lambda c: pipe(JSpheres(center=c, radius=sp.radius,
                                         mat_id=sp.mat_id,
                                         mask=sp.mask))[0].sum())(sp.center)
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(g),
                               rtol=1e-3, atol=1e-3)
    assert not got["empty_any"] and not got["dead_any"]
    assert smoke_render.main(["--cpu"]) == 0
    assert "valid hits: 126 / 1800" in capsys.readouterr().out


def test_inverse_render_example_recovers_the_scene(capsys):
    np.testing.assert_allclose(
        inverse_render.normal(0, (5, 4)).numpy(),
        np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, 4))),
        rtol=0, atol=1e-6)
    assert inverse_render.main(["--cpu"]) == 0
    assert "OK: gradients" in capsys.readouterr().out


def test_silhouette_soft_example_recovers_the_sphere(capsys):
    assert silhouette_optim.main(["soft", "--cpu"]) == 0
    assert "OK: edge-aware" in capsys.readouterr().out


def test_silhouette_mega_engine_converges():
    start, final = silhouette_optim.optimize(
        engine="mega", width=16, height=12, steps=6, offset=(0.22, -0.12),
        lr=4e-2, bandwidth=4e-2, device="cpu")
    assert final < 0.7 * start, (start, final)


def test_examples_run_on_the_card_unless_asked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((smoke_render, []), (inverse_render, []),
                      (silhouette_optim, ["mega"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)
