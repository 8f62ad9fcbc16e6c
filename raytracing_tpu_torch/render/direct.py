"""Direct-lighting renderer (``raytracing_tpu.render.direct``, the Assign08
pipeline): camera rays -> closest hit -> per light: shadow ray -> any-hit
-> ambient + clamped cosine shading; the image is the mean over spp and
passes divided by the light count.

Two routes, as in the JAX package: ``cfg.use_megakernel`` runs the whole
pass in kernel 1's direct mode (``render.mega.render_direct_mega``; where
that route does not cover the config, ``mega.supported`` raises), otherwise
the stage pipeline below, whose searches run in the hit kernels
(``ops/hit_kernels.py``) with ``cfg.use_pallas``. Both draw the same
uniforms.
"""
from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.config import RenderConfig
from ..core.sampling import sample_disk_point
from ..core.types import (Hits, Rays, Scene, clip, dot3, replace,
                          safe_normalize)
from ..ops.closest_hit import palette_lookup
from . import stages
from .camera import generate_primary_rays

INF = math.inf


def render_direct(scene: Scene, cfg: RenderConfig,
                  key: torch.Tensor | None = None,
                  n_passes: int = 1) -> torch.Tensor:
    """(H, W, 3) float image in [0, 1]. ``n_passes > 1`` averages that many
    independent estimates (fresh lens and light samples, keyed by
    ``pass_key(key, p)``); one pass uses ``key`` itself, as the JAX package
    does. ``key`` defaults to ``PRNGKey(cfg.seed)``."""
    if cfg.use_megakernel:
        from .mega import render_direct_mega
        return render_direct_mega(scene, cfg, key=key, n_passes=n_passes)
    if key is None:
        key = rng.base_key(cfg.seed)
    if n_passes == 1:
        acc = _direct_pass_acc(scene, cfg, key)
    else:
        acc = torch.zeros((cfg.total_rays, 3), device=scene.device)
        for p in range(n_passes):
            acc = acc + _direct_pass_acc(scene, cfg, rng.pass_key(key, p))
    n_lights = max(scene.lights.count, 1)
    img = acc.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2) \
        / (n_lights * n_passes)
    return clip(img, 0.0, 1.0)


def _direct_pass_acc(scene: Scene, cfg: RenderConfig, key: torch.Tensor
                     ) -> torch.Tensor:
    """One direct-lighting estimate: radiance per ray (R, 3), before the
    1/n_lights divisor and the clamp."""
    dev = scene.device
    cam = replace(scene.camera, cols=cfg.width, rows=cfg.height)
    rays = generate_primary_rays(cam, scene.bounds, scene.focal_length,
                                 scene.lens_radius, cfg.spp,
                                 key=rng.draw_key(key, rng.LENS))
    tables = stages.hit_tables(scene, cfg)
    rays, hits = stages.trace_all(rays, Hits.none(rays.n, dev), scene, cfg,
                                  tables)
    acc = torch.zeros((rays.n, 3), device=dev)
    t_ax, b_ax = scene.lights.frames()
    albedo = palette_lookup(scene.materials[:, :3], hits.mat_id)
    for li in range(scene.lights.count):
        u = rng.uniform2(rng.draw_key(key, rng.LIGHT, 0, li), rays.n, dev)
        target = sample_disk_point(scene.lights.position[li][None, :],
                                   t_ax[li][None, :], b_ax[li][None, :],
                                   scene.lights.radius[li][None], u)
        origin = hits.p + cfg.shadow_eps * hits.n
        delta = target - origin
        d2 = dot3(delta, delta)
        dist = torch.sqrt(torch.where(d2 > 0.0, d2, 1.0))
        dist = torch.where(d2 > 0.0, dist, 0.0)
        sdir = safe_normalize(delta)
        shadow = Rays(o=origin, d=sdir,
                      mint=torch.where(hits.valid, 0.0, INF),
                      maxt=torch.where(hits.valid, dist, INF))
        occ = stages.occluded_any(shadow, scene, cfg, tables)
        cosx = clip(dot3(sdir, hits.n), 0.0, 1.0)
        shade = cfg.ambient + torch.where(~occ, cosx, 0.0)
        contrib = albedo * clip(shade, 0.0, 1.0)[:, None]
        acc = acc + torch.where(hits.valid[:, None], contrib, 0.0)
    return acc
