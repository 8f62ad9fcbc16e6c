"""Inverse rendering: recover sphere centres and radii and the material
albedo from a target image by gradient descent through the path tracer
(the stage pipeline under autograd, as the JAX package's example runs it).

    python -m raytracing_tpu_torch.examples.inverse_render [--cpu]

``--cpu`` runs 48x36, else 128x96; 40 steps of plain gradient descent,
and the loss must fall below half its start.
"""
import argparse
import math
import time

import torch

from raytracing_tpu_torch import RenderConfig, default_device, replace
from raytracing_tpu_torch.core import rng
from raytracing_tpu_torch.models.scenes import cornell_box
from raytracing_tpu_torch.render import pathtracer

STEPS = 40
LR = {"center": 2.0, "radius": 1.0, "materials": 3.0}


def normal(seed: int, shape, device=None) -> torch.Tensor:
    """Standard normal draws of ``jax.random.normal(PRNGKey(seed), shape)``:
    its uniform bits on (-1, 1), then sqrt(2) erfinv."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    u = rng.uniform(rng.base_key(seed), shape) * (1.0 - lo) + lo
    return (math.sqrt(2.0) * torch.erfinv(torch.maximum(lo, u))).to(device)


def optimize(dev, width: int, height: int, steps: int = STEPS,
             verbose: bool = False) -> tuple[float, float, float]:
    """Returns (first loss, last loss, final mean |centre error|)."""
    cfg = RenderConfig(width=width, height=height, spp=1, bounces=2, seed=7)
    true_scene = cornell_box(cols=width, rows=height, device=dev)

    def render(scene, n_passes=2):
        st = pathtracer.init_state(cfg, dev)
        return pathtracer.image(
            pathtracer.render_passes(scene, st, cfg, n_passes), cfg)

    with torch.no_grad():
        target = render(true_scene, 4)

    sp = true_scene.spheres
    params = {
        "center": sp.center + torch.tensor([[0.25, 0.1, -0.15],
                                            [-0.2, 0.15, 0.1]], device=dev),
        "radius": sp.radius * torch.tensor([0.8, 1.25], device=dev),
        "materials": torch.clamp(
            true_scene.materials
            + 0.25 * normal(0, tuple(true_scene.materials.shape), dev),
            0.05, 1.0),
    }

    def loss_fn(p):
        spheres = replace(sp, center=p["center"], radius=p["radius"])
        img = render(replace(true_scene, spheres=spheres,
                             materials=p["materials"]))
        return torch.mean((img - target) ** 2)

    loss0 = loss = None
    for it in range(steps):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = loss_fn(p)
        loss.backward()
        loss = float(loss.detach())
        loss0 = loss if loss0 is None else loss0
        with torch.no_grad():
            params = {k: p[k] - LR[k] * p[k].grad for k in p}
            params["radius"] = torch.clamp(params["radius"], 0.05, 0.9)
            params["materials"] = torch.clamp(params["materials"], 0.0, 1.0)
        if verbose and (it % 10 == 0 or it == steps - 1):
            err = float((params["center"] - sp.center).abs().mean())
            print(f"it {it:3d}  loss {loss:.6f}  center err {err:.4f}",
                  flush=True)
    err = float((params["center"] - sp.center).abs().mean())
    return loss0, loss, err


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="inverse_render")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    w, h = (48, 36) if args.cpu else (128, 96)
    t0 = time.time()
    loss0, loss, err = optimize(default_device(cpu=args.cpu), w, h,
                                verbose=True)
    print(f"\n{time.time() - t0:.1f}s; loss {loss0:.6f} -> {loss:.6f}")
    print(f"center error: {0.175:.3f} -> {err:.3f}")   # mean |perturbation|
    assert loss < 0.5 * loss0, "optimization failed to reduce loss"
    print("OK: gradients through the path tracer recover scene parameters")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
