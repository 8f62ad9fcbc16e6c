"""The two stage functions the port's slice needs
(``raytracing_tpu.render.stages``): the triangle fold and the
accumulator-to-image tonemap. The rest of the stage pipeline is ROADMAP
Queue 1 item 9."""
from __future__ import annotations

import torch

from ..core.config import RenderConfig
from ..core.types import Scene, Triangles


def _all_triangles(scene: Scene) -> Triangles:
    """Every triangle the brute-force path traces. The JAX package folds
    mesh instances in after the scene triangles; the port has no mesh
    instances yet (ROADMAP Queue 1 item 15), so this is the scene's
    triangle batch."""
    return scene.triangles


def copy_to_pixel(acc: torch.Tensor, passes: int,
                  cfg: RenderConfig) -> torch.Tensor:
    """Mean over spp sub-rays and passes, times exposure, clamped to
    [0, 1]. Returns the float image (H, W, 3)."""
    img = acc.reshape(cfg.height, cfg.width, cfg.spp, 3).sum(2)
    img = img * (cfg.exposure / (cfg.spp * passes))
    return torch.clamp(img, 0.0, 1.0)
