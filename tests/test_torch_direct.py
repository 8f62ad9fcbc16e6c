"""Kernel 1's direct mode in the port against the JAX package.

The plain version (``direct_pass_reference``, which the CUDA kernel is held
to on the card: ``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 15)
through ``render_direct_mega`` against JAX's ``render_direct_mega`` in
interpret mode on the same ``u_planes_for_direct``, at spp 1 with a
pinhole and at spp 4 through a lens of diameter 0.1; the u-planes bit-equal
to JAX's; and ``render_direct(use_megakernel=True)``, whose in-kernel draws
are the stage route's, against JAX's stage-route ``render_direct`` with
the same key, for one and three passes.

Tolerance: the image at rtol/atol 2e-4 (``tests/test_megakernel.py:
48-50``), the tolerance the JAX package holds its own kernel to.
"""
import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.core import rng as jrng
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.render import direct as jdirect
from raytracing_tpu.render import mega as jmega
from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import direct, mega
from torch_threads import one_thread  # noqa: F401

W, H = 32, 24
TOL = 2e-4
# (spp, lens diameter): assign08's pinhole and assign09's thin lens
CASES = {"spp1": (1, 0.0), "spp4_lens": (4, 0.1)}


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _case(name, w=W, h=H):
    spp, lens = CASES[name]
    js = cornell_box(cols=w, rows=h, lens_diameter=lens)
    kw = dict(width=w, height=h, spp=spp, bounces=0, use_megakernel=True)
    return js, scene_from_numpy(scene_to_numpy(js)), JaxConfig(**kw), \
        RenderConfig(**kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_u_planes_for_direct_equal_jax(name):
    js, ps, jcfg, cfg = _case(name)
    key = rng.base_key(5)
    want = np.asarray(jmega.u_planes_for_direct(jrng.base_key(5), jcfg,
                                                js.lights.count))
    got = mega.u_planes_for_direct(key, cfg, ps.lights.count).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_direct_pass_matches_jax_kernel_interpret(name):
    """render_direct_mega on the same u-planes: the port's plain version
    against JAX's Pallas kernel in interpret mode (16x12)."""
    js, ps, jcfg, cfg = _case(name, 16, 12)
    ju = jmega.u_planes_for_direct(jrng.base_key(jcfg.seed), jcfg,
                                   js.lights.count)
    want = np.asarray(jmega.render_direct_mega(js, jcfg, u_planes=ju,
                                               interpret=True))
    counts = (MK.launches, MK.direct_launches)
    got = mega.render_direct_mega(ps, cfg, u_planes=torch.as_tensor(
        np.array(ju)))
    assert (MK.launches, MK.direct_launches) == counts   # no kernel here
    assert got.shape == (12, 16, 3) and got.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_passes", [1, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_megakernel_direct_matches_jax_stage_route(name, n_passes):
    """render_direct(use_megakernel=True): kernel 1's direct mode draws what
    the stage route draws (pass p keyed by the key itself for one pass,
    by pass_key(key, p) otherwise), so it matches JAX's stage-route
    render_direct with the same key."""
    js, ps, jcfg, cfg = _case(name)
    key = 7
    want = np.asarray(jdirect.render_direct(
        js, JaxConfig(width=W, height=H, spp=cfg.spp, bounces=0),
        key=jrng.base_key(key), n_passes=n_passes))
    got = direct.render_direct(ps, cfg, key=rng.base_key(key),
                               n_passes=n_passes)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_direct_pass_wrapper_on_the_cpu():
    """The wrapper on CPU tensors runs the plain version in place; its
    draws made from the key equal the u-planes route's; one u-planes
    tensor serves every pass."""
    _, ps, _, cfg = _case("spp1")
    tables = mega.scene_tables(ps, cfg)
    key = rng.base_key(3)
    kw = dict(key=key, spp=1, width=W, two_sided=False)
    acc = torch.zeros((W * H, 3))
    out = MK.direct_pass(tables[0], *tables[1:], acc, None, **kw)
    assert out is acc and acc.max() > 0
    u = mega.u_planes_for_direct(key, cfg, ps.lights.count)
    np.testing.assert_array_equal(
        MK.direct_pass_reference(tables[0], *tables[1:],
                                 torch.zeros((W * H, 3)), u, **kw).numpy(),
        acc.numpy())
    twice = MK.direct_pass(tables[0], *tables[1:], torch.zeros((W * H, 3)),
                           u, n_passes=2, **kw)
    np.testing.assert_allclose(twice.numpy(), 2 * acc.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="u_planes has shape"):
        MK.direct_pass(tables[0], *tables[1:], torch.zeros((W * H, 3)),
                       u[:2], **kw)
