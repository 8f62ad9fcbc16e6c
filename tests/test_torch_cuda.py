"""The CUDA megakernel against its plain PyTorch version on the card.

Runs only where there is a CUDA device; elsewhere each test skips. Imports
no jax, so it runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import pytest
import torch

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.models.scenes import cornell_box
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt

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
    cfg = RenderConfig(width=64, height=48, bounces=5)
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
    cfg = RenderConfig(width=64, height=48, bounces=5, seed=3)
    scene = cornell_box(cols=64, rows=48, device=cuda)
    st = pt.init_state(cfg, cuda)
    u = mega.u_planes_for_pass(st["key"], 0, cfg, 1, cuda)
    a = mega.render_pass_mega(scene, st, cfg, u_planes=u)["acc"]
    b = pt.render_pass(scene, pt.init_state(cfg, cuda), cfg)["acc"]
    assert torch.equal(a, b)
