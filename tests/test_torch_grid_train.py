"""Grid-mode training on the cell route (kernel 1 recording in grid mode,
then kernel 3 on its record; their plain versions here) against
``jax.grad`` of the JAX package's grid-mode ``render_pass_mega``
(``mega_bwd_impl="cell"``: its recording grid kernel in interpret mode,
then ``_bwd_champion`` over its duplicated cell-major diff rows, whose
cotangents JAX's AD scatters back onto the original rows).

The cornell box with a 128-triangle torus mesh (3^3 mesh grid), 12x8 b1
with Russian roulette from depth 0 (so the pass covers the path,
roulette and record modes at once), wrt ("sph", "mat", "tri"): the
sphere centres and radii, the materials and the mesh's vertices (the
first backward test of a new route covers triangle vertices). The
forward accumulator at rtol/atol 2e-4; per parameter group cosine >=
0.999 and norm ratio within 1% (``tests/test_torch_champion.py``'s
tolerances); and a finite-gradient probe at b5. JAX's gradient takes ~50
s of this file's time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.accel import prepare_grids as jprepare
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_grid_scenes import jax_cornell_torus
from torch_threads import one_thread  # noqa: F401

W, H = 12, 8
WRT = ("sph", "mat", "tri")
PARAMS = ("center", "radius", "mat", "tv")
KW = dict(width=W, height=H, bounces=1, use_grid=True, n_slabs=2,
          use_megakernel=True, russian_roulette=True, rr_start_depth=0,
          mega_grad_wrt=WRT)


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def jax_grads():
    """The port's scene, and JAX's accumulator and gradients of the mean
    square accumulator on the cell route."""
    js = jprepare(jax_cornell_torus(W, H), 2, mesh_slabs=3)
    jcfg = JaxConfig(**KW, mega_bwd_impl="cell")
    assert jmega.bwd_impl_for(js, jcfg) == "cell"
    state0 = jpt.init_state(jcfg)
    m = js.meshes[0]

    def loss(p):
        sc = dataclasses.replace(
            js, spheres=dataclasses.replace(js.spheres, center=p["center"],
                                            radius=p["radius"]),
            materials=p["mat"],
            meshes=(dataclasses.replace(m, tris=dataclasses.replace(
                m.tris, v=p["tv"])),))
        acc = jmega.render_pass_mega(sc, state0, jcfg, interpret=True)["acc"]
        return jnp.mean(acc ** 2), acc

    params = {"center": js.spheres.center, "radius": js.spheres.radius,
              "mat": js.materials, "tv": m.tris.v}
    (_, acc), grads = jax.value_and_grad(loss, has_aux=True)(params)
    ps = prepare_grids(scene_from_numpy(scene_to_numpy(
        jax_cornell_torus(W, H))), 2, mesh_slabs=3)
    return ps, np.asarray(acc), {k: np.asarray(v) for k, v in grads.items()}


def _port_grads(ps, cfg):
    m = ps.meshes[0]
    p = {"center": ps.spheres.center, "radius": ps.spheres.radius,
         "mat": ps.materials, "tv": m.tris.v}
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    sc = replace(ps, spheres=replace(ps.spheres, center=p["center"],
                                     radius=p["radius"]),
                 materials=p["mat"],
                 meshes=(replace(m, tris=replace(m.tris, v=p["tv"])),))
    st = pt.render_pass(sc, pt.init_state(cfg, "cpu"), cfg)
    torch.mean(st["acc"] ** 2).backward()
    return st["acc"].detach().numpy(), {k: p[k].grad.numpy()
                                        for k in PARAMS}


def test_grid_roulette_pass_matches_jax(jax_grads):
    """The differentiable pass's forward (kernel 1 recording in grid mode
    with the roulette) against JAX's."""
    ps, want, _ = jax_grads
    cfg = RenderConfig(**KW)
    assert mega.bwd_impl_for(ps, cfg) == "cell"
    got, _ = _port_grads(ps, cfg)
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_grid_training_matches_jax(jax_grads):
    """Cotangents of the sphere centres and radii, materials and mesh
    vertices against jax.grad: cosine >= 0.999, norm ratio within 1%."""
    ps, _, want = jax_grads
    _, got = _port_grads(ps, RenderConfig(**KW))
    for k in PARAMS:
        a, b = want[k].ravel().astype(np.float64), got[k].ravel()
        assert np.isfinite(b).all(), k
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert na > 0, k
        assert a @ b / (na * nb) >= 0.999, k
        assert abs(nb / na - 1.0) <= 0.01, k


def test_grid_gradients_finite_at_b5(jax_grads, monkeypatch):
    """A finite-gradient probe: b5 without the roulette, every group
    finite and the mesh's vertices reached; the forward is the grid
    record's (kernel 1 recording, counted by its wrapper as on the card)."""
    ps = jax_grads[0]
    calls = []
    record = MK.pathtrace_pass

    def counted(*a, **k):
        calls.append((k.get("record"), k.get("grid") is not None))
        return record(*a, **k)

    monkeypatch.setattr(MK, "pathtrace_pass", counted)
    cfg = RenderConfig(**{**KW, "bounces": 5, "russian_roulette": False})
    _, got = _port_grads(ps, cfg)
    assert calls == [(True, True)]
    for k in PARAMS:
        assert np.isfinite(got[k]).all(), k
    assert np.abs(got["tv"]).max() > 0
