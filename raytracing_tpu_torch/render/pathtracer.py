"""Progressive Monte Carlo path tracer (``raytracing_tpu.render.pathtracer``).

The progressive state ``{"acc": (R, 3) float32 on the device, "key": (2,)
uint32 key data on the CPU, "passes": int}`` is the resumable checkpoint;
its npz form is the JAX package's, so a checkpoint resumes in either
package. Every pass runs as the megakernel (``render.mega``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.config import RenderConfig
from ..core.types import Scene
from . import stages
from .mega import render_pass_mega


def pass_draw_count(cfg: RenderConfig, n_lights: int) -> int:
    """Slots of the pass-wide (R, n_draws, 2) uniform tensor: lens, NEE per
    light, then per depth: [rr when enabled], bounce, NEE per light."""
    per_depth = (1 if cfg.russian_roulette else 0) + 1 + n_lights
    return 1 + n_lights + cfg.bounces * per_depth


def init_state(cfg: RenderConfig, device) -> dict:
    """Zeroed progressive state with the accumulator on ``device``."""
    return {"acc": torch.zeros((cfg.total_rays, 3), dtype=torch.float32,
                               device=device),
            "key": rng.base_key(cfg.seed),
            "passes": 0}


def render_pass(scene: Scene, state: dict, cfg: RenderConfig) -> dict:
    """One progressive pass (spp samples per pixel); the differentiable
    step. With grad mode on and scene parameters that require grad, the
    returned ``acc`` carries a graph: ``image`` of it, a loss and
    ``backward()`` give the parameters cotangents (on the card from kernel
    2, ``ops.megakernel_grad``), restricted to ``cfg.mega_grad_wrt``. The
    state contract is unchanged; thread ``acc.detach()`` into the next
    step's state so that one step's graph ends with it."""
    return render_pass_mega(scene, state, cfg)


def render_passes(scene: Scene, state: dict, cfg: RenderConfig,
                  n_passes: int) -> dict:
    """``n_passes`` passes; on the card they run in one kernel launch with
    the accumulator in registers across passes."""
    return render_pass_mega(scene, state, cfg, n_passes=n_passes)


def image(state: dict, cfg: RenderConfig) -> torch.Tensor:
    """Current tonemapped image (H, W, 3), float in [0, 1]."""
    return stages.copy_to_pixel(state["acc"], max(int(state["passes"]), 1),
                                cfg)


def render(scene: Scene, cfg: RenderConfig, n_passes: int = 1) -> torch.Tensor:
    """init -> n passes -> image, on the scene's device."""
    state = init_state(cfg, scene.device)
    return image(render_passes(scene, state, cfg, n_passes), cfg)


def save_checkpoint(path: str, state: dict) -> None:
    """npz checkpoint in the JAX package's format (acc, key data, passes)."""
    np.savez(path, acc=state["acc"].detach().cpu().numpy(),
             key=state["key"].numpy().astype(np.uint32),
             passes=np.asarray(int(state["passes"]), np.int32))


def load_checkpoint(path: str, device) -> dict:
    z = np.load(path)
    return {"acc": torch.as_tensor(z["acc"], dtype=torch.float32,
                                   device=device),
            "key": torch.as_tensor(np.asarray(z["key"], np.uint32)
                                   .reshape(2)),
            "passes": int(z["passes"])}
