"""The port's threefry against jax.random: bit-equal keys and draws.

The port's draws (and the CUDA kernel's in-kernel draws) reproduce JAX's
partitionable threefry layout, so every parity test downstream can feed
both packages the same uniforms."""
import jax
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.core import rng as jrng
from raytracing_tpu.render.mega import u_planes_for_pass as jax_u_planes
from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.ops.megakernel import draw_planes
from raytracing_tpu_torch.render.mega import u_planes_for_pass

SEEDS = [0, 1234, 987654321]


@pytest.fixture(autouse=True)
def partitionable_threefry():
    """The draws the port reproduces are those of the partitionable
    layout; pin it for the comparison."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).view(np.uint32)


def test_threefry_block_matches_jax():
    g = np.random.default_rng(3)
    key = g.integers(0, 2**32, 2, dtype=np.uint32)
    x = g.integers(0, 2**32, (2, 64), dtype=np.uint32)
    want = np.asarray(threefry_2x32(key, x.reshape(-1))).reshape(2, 64)
    y0, y1 = rng.threefry2x32(int(key[0]), int(key[1]),
                              torch.from_numpy(x[0].astype(np.int64)),
                              torch.from_numpy(x[1].astype(np.int64)))
    np.testing.assert_array_equal(y0.numpy(), want[0])
    np.testing.assert_array_equal(y1.numpy(), want[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_uniform_bit_equal(seed):
    key = rng.base_key(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(key), _u32(jkey))
    for data in (0, 1, 7, 2**31 + 3):
        np.testing.assert_array_equal(_u32(rng.fold_in(key, data)),
                                      _u32(jax.random.fold_in(jkey, data)))
    kp = rng.pass_key(key, 5)
    jkp = jrng.pass_key(jkey, 5)
    u = rng.uniform(kp, (7, 5, 2))
    ju = jax.random.uniform(jkp, (7, 5, 2))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(_u32(u), _u32(ju))
    np.testing.assert_array_equal(
        _u32(rng.draw_key(kp, rng.LIGHT, 2, 1)),
        _u32(jrng.draw_key(jkp, jrng.LIGHT, 2, 1)))


def test_u_planes_for_pass_bit_equal_cornell_b5():
    cfg = RenderConfig(width=64, height=48, bounces=5)
    jcfg = JaxConfig(width=64, height=48, bounces=5)
    for passes in (0, 3):
        got = u_planes_for_pass(rng.base_key(cfg.seed), passes, cfg, 1)
        want = jax_u_planes(jax.random.PRNGKey(jcfg.seed), passes, jcfg, 1)
        assert tuple(got.shape) == tuple(want.shape) == (24, 64 * 48)
        np.testing.assert_array_equal(_u32(got), _u32(want))


def test_draw_planes_ray_offset_is_a_column_slice():
    key = rng.pass_key(rng.base_key(1), 2)
    full = draw_planes(key, 96, 4)
    np.testing.assert_array_equal(draw_planes(key, 32, 4, ray_offset=40)
                                  .numpy(), full[:, 40:72].numpy())


def test_uniform_range_and_mean():
    """Logical shifts only: a signed shift would put half the draws below
    zero (the bias once found in the TPU kernel's PRNG mode)."""
    u = rng.uniform(rng.base_key(99), (200_000,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
