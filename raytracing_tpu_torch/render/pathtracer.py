"""Progressive Monte Carlo path tracer (``raytracing_tpu.render.pathtracer``).

The progressive state ``{"acc": (R, 3) float32 on the device, "key": (2,)
uint32 key data on the CPU, "passes": int}`` is the resumable checkpoint;
its npz form is the JAX package's, so a checkpoint resumes in either
package.

A pass takes the route the JAX package's ``_render_pass`` takes:
``cfg.use_megakernel`` runs the whole pass as kernel 1 (``render.mega``;
kernel 2 in its backward), otherwise the wavefront stage pipeline
(``render.stages``; with ``cfg.use_pallas`` its hit searches run in
kernels 4 and 5). Both routes draw the same pass-wide uniforms in the same
slot order. One deliberate difference from the JAX package: where the
megakernel route does not cover a config (``mega.supported``), it raises
instead of falling through to the stage pipeline; set
``use_megakernel=False`` for that.

Schedule of a stage pass (the reference's executeRender): camera rays ->
closest hit -> emitter hits (primary segment only) -> NEE per light, then
``bounces`` times: [Russian roulette] -> bounce -> closest hit -> NEE per
light.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.config import RenderConfig
from ..core.types import Hits, Scene, replace
from . import stages
from .camera import generate_primary_rays
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


def _render_pass_stages(scene: Scene, state: dict, cfg: RenderConfig
                        ) -> dict:
    """One pass of the stage pipeline; ``acc`` is a new tensor."""
    acc, passes = state["acc"], int(state["passes"])
    kp = rng.pass_key(state["key"], passes)
    cam = replace(scene.camera, cols=cfg.width, rows=cfg.height)
    n_lights = scene.lights.count
    # one draw for the whole pass, (R, n_draws, 2); slots per depth:
    # [rr], bounce, NEE per light -- kernel 1 reads the same layout
    n_draws = pass_draw_count(cfg, n_lights)
    u_all = rng.uniform(kp, (cfg.total_rays, n_draws, 2), scene.device)
    draw = iter(range(n_draws))

    lens_u = u_all[:, next(draw)] if cfg.spp == 1 else None
    if cfg.spp > 1:
        next(draw)      # keep slot numbers stable across spp settings
    rays = generate_primary_rays(cam, scene.bounds, scene.focal_length,
                                 scene.lens_radius, cfg.spp, lens_uv=lens_u)
    tables = stages.hit_tables(scene, cfg)
    hits = Hits.none(rays.n, scene.device)
    rays, hits = stages.trace_all(rays, hits, scene, cfg, tables)
    for li in range(n_lights):
        acc, rays, hits = stages.light_render(acc, rays, hits, scene.lights,
                                              li, cfg)
    for li in range(n_lights):
        acc, hits = stages.nee_shade(acc, hits, scene, li,
                                     u_all[:, next(draw)], cfg, tables)
    for depth in range(1, cfg.bounces + 1):
        if cfg.russian_roulette:
            hits = stages.apply_russian_roulette(
                hits, u_all[:, next(draw), 0], depth - 1, cfg)
        rays = stages.bounce_paths(hits, u_all[:, next(draw)], cfg)
        rays, hits = stages.trace_all(rays, hits, scene, cfg, tables)
        for li in range(n_lights):
            acc, hits = stages.nee_shade(acc, hits, scene, li,
                                         u_all[:, next(draw)], cfg, tables)
    return {"acc": acc, "key": state["key"], "passes": passes + 1}


def render_pass(scene: Scene, state: dict, cfg: RenderConfig) -> dict:
    """One progressive pass (spp samples per pixel); the differentiable
    step. With grad mode on and scene parameters that require grad, the
    returned ``acc`` carries a graph: ``image`` of it, a loss and
    ``backward()`` give the parameters cotangents -- on the megakernel
    route from kernel 2 (``ops.megakernel_grad``) restricted to
    ``cfg.mega_grad_wrt``, on the stage route from autograd through the
    stages (every parameter). The state contract is unchanged; thread
    ``acc.detach()`` into the next step's state so that one step's graph
    ends with it. The megakernel route updates ``state["acc"]`` in place
    when nothing requires grad; the stage route never does."""
    if cfg.use_megakernel:
        return render_pass_mega(scene, state, cfg)
    return _render_pass_stages(scene, state, cfg)


def render_passes(scene: Scene, state: dict, cfg: RenderConfig,
                  n_passes: int) -> dict:
    """``n_passes`` passes. On the megakernel route they run in one kernel
    launch with the accumulator in registers across passes; the stage
    route runs them one after another."""
    if cfg.use_megakernel:
        return render_pass_mega(scene, state, cfg, n_passes=n_passes)
    for _ in range(n_passes):
        state = _render_pass_stages(scene, state, cfg)
    return state


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
