"""Silhouette-driven inverse rendering with edge-aware gradients: recover
a sphere's position when the first guess barely overlaps the target
silhouette, where the hard renderer's gradients (exact only inside
surfaces) go silent.

Two engines:

  * ``soft``: the soft path tracer (``diff/soft.render_pathtrace_soft``),
    soft forward and backward, the bandwidth annealed;
  * ``mega``: kernel 1's hard forward and kernel 2s, the edge-aware
    adjoint (``RenderConfig.mega_edge_bandwidth``, through
    ``ops.megakernel_grad.pathtrace_pass_diff``): the image optimised is
    the real render.

    python -m raytracing_tpu_torch.examples.silhouette_optim \
        [soft|mega] [--cpu]
"""
import argparse

import torch

from raytracing_tpu_torch import RenderConfig, default_device, replace
from raytracing_tpu_torch.models.scenes import cornell_box
from raytracing_tpu_torch.render import pathtracer


def optimize(engine="soft", width=48, height=36, steps=None,
             offset=(0.35, -0.25), lr=2e-2, bandwidth=None,
             verbose=False, device=None) -> tuple[float, float]:
    """Run the silhouette recovery; returns (start error, final error)."""
    dev = default_device() if device is None else torch.device(device)
    cfg = RenderConfig(width=width, height=height, spp=1, bounces=1)
    scene = cornell_box(cols=cfg.width, rows=cfg.height, device=dev)
    true_center = scene.spheres.center.detach().clone()

    def with_center(center):
        return replace(scene, spheres=replace(scene.spheres, center=center))

    if engine == "mega":
        from raytracing_tpu_torch.render.mega import (render_pass_mega,
                                                      u_planes_for_pass)
        bw = bandwidth or 3e-2
        cfg_m = replace(cfg, use_megakernel=True, mega_edge_bandwidth=bw)
        key = pathtracer.init_state(cfg_m, dev)["key"]
        u = u_planes_for_pass(key, 0, cfg_m, scene.lights.count, dev)

        def render(center, _bw):
            # a fresh state per call: the forward-only launch accumulates
            # into its state in place
            return render_pass_mega(with_center(center),
                                    pathtracer.init_state(cfg_m, dev), cfg_m,
                                    u_planes=u)["acc"]

        schedule = [bw] * (steps if steps is not None else 40)
    else:
        from raytracing_tpu_torch.diff.soft import render_pathtrace_soft

        def render(center, bw):
            return render_pathtrace_soft(with_center(center), cfg,
                                         bandwidth=bw, tau=bw)

        schedule = [3e-2] * 30 + [1e-2] * 30 + [3e-3] * 20
        if steps is not None:
            schedule = schedule[:steps]

    with torch.no_grad():
        target = render(true_center, 2e-3)

    start = true_center.clone()
    start[0, 0] += offset[0]
    start[0, 1] += offset[1]
    params = start.clone().requires_grad_()

    def error(center) -> float:
        return float(torch.linalg.norm(center.detach()[0] - true_center[0]))

    start_err = error(start)

    opt = torch.optim.Adam([params], lr=lr)
    for i, bw in enumerate(schedule):
        opt.zero_grad()
        torch.mean((render(params, bw) - target) ** 2).backward()
        opt.step()
        if verbose and i % max(1, len(schedule) // 10) == 0:
            print(f"step {i:3d}  bw={bw:.0e}  center err={error(params):.4f}",
                  flush=True)
    return start_err, error(params)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="silhouette_optim")
    p.add_argument("engine", nargs="?", default="soft",
                   choices=["soft", "mega"])
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    mega = args.engine == "mega"
    start_err, final_err = optimize(
        engine=args.engine, width=24 if mega else 48,
        height=18 if mega else 36, steps=12 if mega else None,
        verbose=True, device=default_device(cpu=args.cpu))
    print(f"[{args.engine}] final center error: {final_err:.4f} "
          f"(started at {start_err:.4f})")
    thresh = 0.6 * start_err if mega else 0.06
    assert final_err < thresh, "silhouette optimization did not converge"
    print("OK: edge-aware gradients recovered the sphere position")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
