"""Smoke render through the package's public pieces: camera rays ->
closest sphere -> fake shade, printed as an ASCII image with the hit
count and the material ids seen, then four probes: an empty sphere batch,
dead rays, the whole pipeline as one function, and its gradient with
respect to the sphere centres (autograd).

    python -m raytracing_tpu_torch.examples.smoke_render [--cpu]
"""
import argparse
import math

import torch

from raytracing_tpu_torch import default_device
from raytracing_tpu_torch.core.types import (Camera, Rays, Spheres, dot3,
                                             make_spheres, replace)
from raytracing_tpu_torch.ops.closest_hit import (closest_hit_spheres,
                                                  sphere_hit_attrs)
from raytracing_tpu_torch.render.camera import pinhole_rays, pixel_grid

CHARS = " .:-=+*#%@"


def run(dev) -> dict:
    """The render and its probes on ``dev``; returns what it prints."""
    cam = Camera.look_at(eye=[0, 0, 3], lookat=[0, 0, 0], vup=[0, 1, 0],
                         fov_deg=60, cols=60, rows=30, device=dev)
    sp = make_spheres([[-0.7, 0, 0], [0.7, 0, 0]], [0.6, 0.4], [0, 1],
                      device=dev)
    col, row = pixel_grid(cam)
    rays = pinhole_rays(cam, col, row)
    ch = closest_hit_spheres(rays, sp)
    _, n, mat = sphere_hit_attrs(rays, sp, ch)
    shade = torch.where(ch.valid, dot3(n, cam.w), 0.0)
    out = {"image": shade.reshape(30, 60).cpu(),
           "valid": int(ch.valid.sum()),
           "mats": sorted(set(mat[ch.valid].tolist()))}

    # probe 1: empty sphere batch
    out["empty_any"] = bool(closest_hit_spheres(
        rays, Spheres.empty(dev)).valid.any())
    # probe 2: dead rays (mint = maxt = INF)
    z3 = torch.zeros((rays.n, 3), device=dev)
    inf = torch.full((rays.n,), math.inf, device=dev)
    out["dead_any"] = bool(closest_hit_spheres(
        Rays(o=z3, d=z3, mint=inf, maxt=inf), sp).valid.any())

    # probe 3: the whole pipeline as one function of the spheres
    def pipe(spheres):
        r = pinhole_rays(cam, col, row)
        c = closest_hit_spheres(r, spheres)
        _, nn, _ = sphere_hit_attrs(r, spheres, c)
        return torch.where(c.valid, dot3(nn, cam.w), 0.0).sum()

    out["pipe"] = float(pipe(sp))
    # probe 4: its gradient with respect to the sphere centres
    center = sp.center.clone().requires_grad_()
    pipe(replace(sp, center=center)).backward()
    out["grad"] = center.grad.cpu()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="smoke_render")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    out = run(default_device(cpu=args.cpu))
    for r in out["image"].tolist():
        print("".join(CHARS[int(max(0, min(0.999, v)) * 10)] for v in r))
    print("valid hits:", out["valid"], "/", 30 * 60)
    print("mat ids seen:", out["mats"])
    print("probe empty scene: any valid =", out["empty_any"])
    print("probe dead rays: any valid =", out["dead_any"])
    print("probe pipeline:", out["pipe"])
    print("probe grad wrt centers:", out["grad"].numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
