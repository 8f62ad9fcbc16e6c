"""The port's pass (its plain PyTorch version, which the CUDA kernel is held
to on the card) against the JAX XLA stage pipeline with identical draws.

Tolerances are the JAX kernel's own against the same pipeline
(tests/test_megakernel.py): rtol/atol 2e-4 per pass, 5e-4 for two
accumulated passes. At 5 bounces one ray of this image takes a
near-grazing sphere hit (discriminant 1.5625 - 1.5600): there every
float32 evaluation of the quadratic is off from float64 by 1e-4..3e-4
(XLA pipeline 1.4e-4, JAX Pallas kernel 1.8e-4, this port 3.2e-4 in
green), so at b5 at most 0.1% of accumulator entries may exceed 2e-4,
each by no more than 1e-3, and the image mean must hold to 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_threads import one_thread  # noqa: F401

TOL = 2e-4


def _scenes(w, h):
    js = cornell_box(cols=w, rows=h)
    return js, scene_from_numpy(scene_to_numpy(js))


@pytest.fixture(scope="module")
def scenes_64x48():
    return _scenes(64, 48)


@pytest.fixture(scope="module")
def scenes_32x24():
    return _scenes(32, 24)


def _jax_passes(js, n_passes=1, **kw):
    cfg = JaxConfig(**kw)
    st = jpt.init_state(cfg)
    for _ in range(n_passes):
        st = jpt._render_pass(js, st, cfg)
    return np.asarray(st["acc"])


def _port_passes(ps, n_passes=1, **kw):
    cfg = RenderConfig(use_megakernel=True, **kw)
    st = pt.render_passes(ps, pt.init_state(cfg, "cpu"), cfg, n_passes)
    assert st["passes"] == n_passes
    return st["acc"].numpy()


@pytest.mark.parametrize("bounces", [0, 2, 5])
def test_plain_pass_matches_xla_pipeline(scenes_64x48, bounces):
    js, ps = scenes_64x48
    kw = dict(width=64, height=48, spp=1, bounces=bounces)
    want = _jax_passes(js, **kw)
    got = _port_passes(ps, **kw)
    if bounces < 5:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        return
    err = np.abs(got - want)
    beyond = err > TOL + TOL * np.abs(want)
    assert beyond.mean() <= 1e-3, beyond.sum()
    assert err.max() <= 1e-3
    assert abs(got.mean() - want.mean()) <= 1e-6 * abs(want.mean())


def test_plain_pass_matches_xla_spp4(scenes_32x24):
    js, ps = scenes_32x24
    kw = dict(width=32, height=24, spp=4, bounces=1)
    np.testing.assert_allclose(_port_passes(ps, **kw), _jax_passes(js, **kw),
                               rtol=TOL, atol=TOL)


def test_plain_passes_accumulate_like_xla(scenes_32x24):
    js, ps = scenes_32x24
    kw = dict(width=32, height=24, spp=1, bounces=1)
    np.testing.assert_allclose(_port_passes(ps, 2, **kw),
                               _jax_passes(js, 2, **kw),
                               rtol=5e-4, atol=5e-4)


def test_plain_pass_ignores_a_masked_sphere_in_front(scenes_32x24):
    """A masked sphere in front of cornell's first sphere (the kernels read
    a sphere's mask only for a candidate that beats the champion): the
    plain pass matches the XLA pipeline, and equals the pass without that
    sphere bit for bit."""
    js, ps = scenes_32x24
    sp = js.spheres
    masked = dataclasses.replace(js, spheres=dataclasses.replace(
        sp, center=jnp.concatenate([sp.center, jnp.asarray(
            [[-0.4, -0.55, 0.9]], jnp.float32)]),
        radius=jnp.concatenate([sp.radius, jnp.asarray([0.3], jnp.float32)]),
        mat_id=jnp.concatenate([sp.mat_id, jnp.asarray([4], jnp.int32)]),
        mask=jnp.concatenate([sp.mask, jnp.asarray([False])])))
    pm = scene_from_numpy(scene_to_numpy(masked))
    assert pm.spheres.count == 3
    kw = dict(width=32, height=24, spp=1, bounces=2)
    got = _port_passes(pm, **kw)
    np.testing.assert_allclose(got, _jax_passes(masked, **kw), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got, _port_passes(ps, **kw))


def test_prng_route_equals_u_planes_route(scenes_32x24):
    """Without u_planes the pass makes JAX's draws itself, keyed by
    fold_in(PRNGKey(seed), pass): identical accumulators, one pass at a
    time or several in one call."""
    _, ps = scenes_32x24
    cfg = RenderConfig(width=32, height=24, bounces=2, seed=77,
                       use_megakernel=True)
    key = rng.base_key(cfg.seed)
    st_u = pt.init_state(cfg, "cpu")
    for p in range(2):
        u = mega.u_planes_for_pass(key, p, cfg, ps.lights.count)
        st_u = mega.render_pass_mega(ps, st_u, cfg, u_planes=u)
    st_rng = pt.render_passes(ps, pt.init_state(cfg, "cpu"), cfg, 2)
    np.testing.assert_array_equal(st_rng["acc"].numpy(), st_u["acc"].numpy())


def test_state_key_must_match_seed(scenes_32x24):
    _, ps = scenes_32x24
    cfg = RenderConfig(width=32, height=24, bounces=0,
                       use_megakernel=True)
    st = dict(pt.init_state(cfg, "cpu"), key=rng.base_key(5))
    with pytest.raises(ValueError, match="cfg.seed"):
        pt.render_pass(ps, st, cfg)


def test_plain_pass_handles_ray_offset(scenes_32x24):
    """A shard of rays (global offset) equals the same rows of the whole
    image: pixel decode and draws follow the global ray id."""
    _, ps = scenes_32x24
    cfg = RenderConfig(width=32, height=24, bounces=1,
                       use_megakernel=True)
    tables = mega.scene_tables(ps, cfg)
    kw = dict(spp=1, width=32, bounces=1, two_sided=False,
              normalize_emitter=True, seed=cfg.seed)
    full = MK.pathtrace_pass_reference(
        *tables[:1], torch.tensor([3, 0], dtype=torch.int32), *tables[1:],
        torch.zeros((32 * 24, 3)), None, **kw)
    part = MK.pathtrace_pass_reference(
        *tables[:1], torch.tensor([3, 32 * 8], dtype=torch.int32),
        *tables[1:], torch.zeros((32 * 8, 3)), None, **kw)
    np.testing.assert_array_equal(part.numpy(),
                                  full[32 * 8:32 * 16].numpy())
