"""Single-pass fake-shade sphere renderer, the Assign01/02 analog
(``raytracing_tpu.render.simple``): pinhole ray per pixel -> closest sphere
-> fake shade dot(W, n) -> colour = sphere colour x shade; black
background. Assign01 (one sphere) is the case of a one-row table.

The JAX package runs no Pallas kernel here, so neither does the port: the
searches are ``ops/closest_hit``'s, the colour fetch an indexed gather
(``palette_lookup``) where JAX fetches with a one-hot product.
"""
from __future__ import annotations

import torch

from ..core.types import AABB, Camera, Spheres, dot3
from ..ops.closest_hit import (closest_hit_spheres, palette_lookup,
                               sphere_hit_attrs)
from .camera import pinhole_rays, pixel_grid


def render_fake_shade(cam: Camera, spheres: Spheres, colors: torch.Tensor,
                      obj_chunk: int = 512) -> torch.Tensor:
    """(rows, cols, 3) float image; ``colors`` (S, 4) rgba per sphere."""
    col, row = pixel_grid(cam)
    rays = pinhole_rays(cam, col, row)
    ch = closest_hit_spheres(rays, spheres, obj_chunk=obj_chunk)
    _, n, _ = sphere_hit_attrs(rays, spheres, ch)
    shade = dot3(n, cam.w)
    rgb = palette_lookup(colors[:, :3], ch.idx) * shade[:, None]
    img = torch.where(ch.valid[:, None], rgb, 0.0)
    return img.reshape(cam.rows, cam.cols, 3)


def render_fake_shade_orbit(cam: Camera, spheres: Spheres,
                            colors: torch.Tensor, bounds: AABB,
                            n_frames: int = 16,
                            obj_chunk: int = 512) -> torch.Tensor:
    """(n_frames, rows, cols, 3): one full orbit of the eye around
    ``bounds`` at ``n_frames`` evenly spaced angles (the reference's rotate
    animation), one frame after another."""
    return torch.stack([
        render_fake_shade(cam.orbit(bounds, 360.0 * f / n_frames), spheres,
                          colors, obj_chunk) for f in range(n_frames)])
