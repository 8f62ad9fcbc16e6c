"""Primary rays: pixel grid, film point, pinhole ray, focal point, thin-lens
ray, the scene-AABB clip and the whole ``generate_primary_rays`` of the
stage pipeline (``raytracing_tpu.render.camera``; the kernel's
``ops/pallas/megakernel.py:444-493``, whose arithmetic order the thin-lens
origin follows, so both routes of a pass make the same camera rays)."""
from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.sampling import concentric_disk
from ..core.types import AABB, Camera, Rays, dot3, safe_normalize
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


def stratified_lens_uv(samp: torch.Tensor, spp: int) -> torch.Tensor:
    """(N, 2) lens-cell centres of sub-ray ``samp`` for spp = k^2: sample
    j varies fastest in x."""
    k = int(round(spp ** 0.5))
    if k * k != spp:
        raise ValueError(f"spp must be a perfect square, got {spp}")
    si = torch.div(samp, k, rounding_mode="floor")
    sj = samp - si * k
    return torch.stack([(sj.to(torch.float32) + 0.5) / k,
                        (si.to(torch.float32) + 0.5) / k], -1)


def generate_primary_rays(cam: Camera, bounds: AABB, focal_length,
                          lens_radius, spp: int,
                          key: torch.Tensor | None = None,
                          lens_uv: torch.Tensor | None = None) -> Rays:
    """Every camera ray of a pass, pixel-major and sample-minor, clipped to
    ``bounds``. spp > 1: stratified lens-cell centres. spp == 1: the lens
    point from ``lens_uv`` (P, 2), else drawn from ``key``, else the lens
    centre."""
    col, row = pixel_grid(cam)
    fp = focal_points(cam, col, row, focal_length)
    npix = col.shape[0]
    dev = fp.device
    if spp > 1:
        samp = torch.arange(npix * spp, device=dev) % spp
        uv = stratified_lens_uv(samp, spp)
        fp = fp[:, None].expand(npix, spp, 3).reshape(-1, 3)
    elif lens_uv is not None:
        uv = lens_uv
    elif key is not None:
        uv = rng.uniform(key, (npix, 2), dev)
    else:
        uv = torch.full((npix, 2), 0.5, device=dev)
    return clip_to_bounds(thin_lens_rays(cam, fp, lens_radius, uv), bounds)
