"""Samplers: the [0, 1]^2 -> [-1, 1]^2 map, concentric disk map, stratified
lens grid, cosine hemisphere, disk-light point
(``raytracing_tpu.core.sampling``; the kernel's ``_concentric`` and
bounce direction, ``ops/pallas/megakernel.py:212-242, 1502-1512``).
Shape-polymorphic over leading batch axes."""
from __future__ import annotations

import math

import torch

from .types import safe_normalize, tangent_frame

_PI_4 = math.pi / 4.0
_PI_2 = math.pi / 2.0


def distort(u: torch.Tensor) -> torch.Tensor:
    """[0, 1]^2 -> [-1, 1]^2 with (0, 0) pinned."""
    zero = (u == 0.0).all(-1, keepdim=True)
    return torch.where(zero, 0.0, u * 2.0 - 1.0)


def concentric_disk(u: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric square -> unit disk map.
    u: (..., 2) in [0, 1)^2 -> (..., 2); (0, 0) maps to itself."""
    a = 2.0 * u[..., 0] - 1.0
    b = 2.0 * u[..., 1] - 1.0
    top = a * a > b * b
    safe_a = torch.where(a == 0.0, 1.0, a)
    safe_b = torch.where(b == 0.0, 1.0, b)
    radius = torch.where(top, a, b)
    phi = torch.where(top, _PI_4 * (b / safe_a),
                      _PI_2 - _PI_4 * (a / safe_b))
    out = torch.stack([torch.cos(phi) * radius, torch.sin(phi) * radius], -1)
    zero = (u[..., 0] == 0.0) & (u[..., 1] == 0.0)
    return torch.where(zero[..., None], u, out)


def stratified_lens_uv(samp: torch.Tensor, spp: int) -> torch.Tensor:
    """(N, 2) lens-cell centres of sub-ray ``samp`` for spp = k^2: sample
    j varies fastest in x (the kernel's arithmetic)."""
    k = int(round(spp ** 0.5))
    if k * k != spp:
        raise ValueError(f"spp must be a perfect square, got {spp}")
    si = torch.div(samp, k, rounding_mode="floor")
    sj = samp - si * k
    return torch.stack([(sj.to(torch.float32) + 0.5) / k,
                        (si.to(torch.float32) + 0.5) / k], -1)


def stratified_lens_coords(spp: int, device=None) -> torch.Tensor:
    """(spp, 2) stratified cell centres on [0, 1]^2 for spp = k^2 sub-rays
    per pixel, in the ray-slot order of a pixel's rays (j fastest, in x)."""
    return stratified_lens_uv(torch.arange(spp, device=device), spp)


def cosine_hemisphere(normal: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about ``normal`` (..., 3) from uniforms
    ``u`` (..., 2): concentric disk lifted by z = sqrt(1 - x^2 - y^2)."""
    t, b = tangent_frame(normal)
    xy = concentric_disk(u)
    x, y = xy[..., 0], xy[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return safe_normalize(x[..., None] * t + y[..., None] * b
                          + z[..., None] * normal)


def sample_disk_point(center: torch.Tensor, t_axis: torch.Tensor,
                      b_axis: torch.Tensor, radius: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Point on a disk light: center + r * concentric(u) in its (T, B)."""
    xy = concentric_disk(u) * radius[..., None]
    return center + xy[..., 0:1] * t_axis + xy[..., 1:2] * b_axis
