"""Primary rays: pixel grid, film point, pinhole ray, parallel
(orthographic) ray, focal point, thin-lens ray, the scene-AABB clip and
the whole ``generate_primary_rays`` of the stage pipeline
(``raytracing_tpu.render.camera``; the kernel's
``ops/pallas/megakernel.py:444-493``, whose arithmetic order the thin-lens
origin follows, so both routes of a pass make the same camera rays)."""
from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.sampling import concentric_disk, stratified_lens_uv
from ..core.types import AABB, Camera, Rays, dot3, ray_window, \
    safe_normalize
from ..ops.intersect import aabb_window

INF = math.inf


def pixel_grid(cam: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """(col, row) float32 of every pixel, (rows * cols,) each, row-major."""
    dev = cam.eye.device
    col = torch.arange(cam.cols, dtype=torch.float32, device=dev)
    row = torch.arange(cam.rows, dtype=torch.float32, device=dev)
    return (col.repeat(cam.rows),
            row[:, None].expand(cam.rows, cam.cols).reshape(-1))


def film_point(cam: Camera, col: torch.Tensor, row: torch.Tensor
               ) -> torch.Tensor:
    """Film-plane point relative to the eye, (N, 3):
    (-.5 + (c+.5)/cols)*w*U + (.5 - (r+.5)/rows)*h*V - W."""
    su = (-0.5 + (col + 0.5) / cam.cols) * cam.width
    sv = (0.5 - (row + 0.5) / cam.rows) * cam.height
    return su[:, None] * cam.u + sv[:, None] * cam.v - cam.w


def pinhole_rays(cam: Camera, col: torch.Tensor, row: torch.Tensor) -> Rays:
    """Rays from the eye through the film points; window [0, INF)."""
    d = safe_normalize(film_point(cam, col, row))
    n = col.shape[0]
    return Rays(o=cam.eye.expand(n, 3), d=d,
                mint=torch.zeros((n,), device=d.device),
                maxt=torch.full((n,), INF, device=d.device))


def parallel_rays(cam: Camera, col: torch.Tensor, row: torch.Tensor
                  ) -> Rays:
    """Orthographic rays: o = the film point (relative to the eye, as the
    JAX package takes it), d = -W; window [0, INF)."""
    cop = film_point(cam, col, row)
    n = col.shape[0]
    return Rays(o=cop, d=(-cam.w).expand(n, 3),
                mint=torch.zeros((n,), device=cop.device),
                maxt=torch.full((n,), INF, device=cop.device))


def focal_points(cam: Camera, col: torch.Tensor, row: torch.Tensor,
                 focal_length) -> torch.Tensor:
    """Pinhole ray from the eye through the film point, cut with the plane
    at ``focal_length`` along -W."""
    rays = pinhole_rays(cam, col, row)
    pip = cam.eye - focal_length * cam.w
    dplane = -dot3(pip, cam.w)
    t = -(dot3(rays.o, cam.w) + dplane) / dot3(rays.d, cam.w)
    return rays.at(t)


def thin_lens_rays(cam: Camera, focal_pt: torch.Tensor, lens_radius,
                   lens_uv: torch.Tensor) -> Rays:
    """Rays from a lens point (concentric map of ``lens_uv`` (N, 2)) toward
    the focal point; the window is [0, INF) until clipped."""
    dxy = concentric_disk(lens_uv)
    o = cam.eye + lens_radius * (dxy[:, 0:1] * cam.u + dxy[:, 1:2] * cam.v)
    d = safe_normalize(focal_pt - o)
    n = o.shape[0]
    return Rays(o=o, d=d, mint=torch.zeros((n,), device=o.device),
                maxt=torch.full((n,), INF, device=o.device))


def clip_to_bounds(rays: Rays, bounds: AABB) -> Rays:
    """Clip windows to the scene AABB; a miss becomes a dead ray with
    mint = maxt = INF."""
    tmin, tmax, ok = aabb_window(rays.o, rays.d, bounds.pmin, bounds.pmax)
    return Rays(o=rays.o, d=rays.d, mint=torch.where(ok, tmin, INF),
                maxt=torch.where(ok, tmax, INF))


def generate_primary_rays(cam: Camera, bounds: AABB, focal_length,
                          lens_radius, spp: int,
                          key: torch.Tensor | None = None,
                          lens_uv: torch.Tensor | None = None,
                          ray_offset: int = 0,
                          n_rays: int | None = None) -> Rays:
    """Camera rays of a pass, pixel-major and sample-minor, clipped to
    ``bounds``: every ray of the film, or with ``n_rays`` rays
    ``[ray_offset, ray_offset + n_rays)`` (a ray shard). Each is decoded
    from its global id as kernel 1 decodes it, so a shard's rays are the
    film's bit for bit; ids past the film's last ray (a padded shard)
    decode to rows below the film, whose accumulator rows are discarded.
    spp > 1: stratified lens-cell centres. spp == 1: the lens point from
    ``lens_uv`` (the rays' own rows), else drawn from ``key`` (the film's
    draws, the shard's rows), else the lens centre."""
    npix = cam.cols * cam.rows
    n = npix * spp if n_rays is None else n_rays
    dev = cam.eye.device
    rid = torch.arange(ray_offset, ray_offset + n, dtype=torch.int64,
                       device=dev)
    pix = torch.div(rid, spp, rounding_mode="floor")
    row = torch.div(pix, cam.cols, rounding_mode="floor")
    fp = focal_points(cam, (pix - row * cam.cols).to(torch.float32),
                      row.to(torch.float32), focal_length)
    if spp > 1:
        uv = stratified_lens_uv(rid - pix * spp, spp)
    elif lens_uv is not None:
        uv = lens_uv
    elif key is not None:
        uv = ray_window(rng.uniform(key, (npix, 2), dev), ray_offset, n)
    else:
        uv = torch.full((n, 2), 0.5, device=dev)
    return clip_to_bounds(thin_lens_rays(cam, fp, lens_radius, uv), bounds)
