"""Command-line progressive renderer (``raytracing_tpu.cli``, path renderer):

  python -m raytracing_tpu_torch.cli --list-devices
  python -m raytracing_tpu_torch.cli --scene cornell --width 1024 \\
      --height 1024 --passes 16 -o out.png
  python -m raytracing_tpu_torch.cli --cpu --width 64 --height 48 -o x.png

Same flags as the JAX CLI. The progressive state is checkpointed after
every chunk of passes and on Ctrl-C, and ``--resume`` continues it (JAX
checkpoints included). Flags for parts not ported yet raise.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracing_tpu_torch",
        description="path tracer on an NVIDIA GPU (PyTorch + CUDA)")
    p.add_argument("--scene", default="cornell",
                   help="builtin scene name (cornell, spheres)")
    p.add_argument("--renderer", default="path",
                   choices=["path", "direct", "fake"],
                   help="pipeline; only path is ported")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--spp", type=int, default=1,
                   help="rays per pixel per pass (perfect square)")
    p.add_argument("--passes", type=int, default=16)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--focal-length", type=float, default=None)
    p.add_argument("--lens-diameter", type=float, default=None)
    p.add_argument("--exposure", type=float, default=1.8)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--grid", type=int, default=0, metavar="N",
                   help="uniform-grid acceleration (not ported yet)")
    p.add_argument("--mesh-slabs", default="auto", metavar="N|xml|auto",
                   help="per-mesh grid resolution (with --grid)")
    p.add_argument("--pallas", action="store_true",
                   help="stage-pipeline hit kernels (not ported yet)")
    p.add_argument("--no-megakernel", action="store_true",
                   help="accepted for compatibility; the port has only the "
                        "kernel route")
    p.add_argument("--block", type=int, default=0, metavar="B",
                   help="blocked pixel layout (not ported yet)")
    p.add_argument("--chunk-passes", type=int, default=8,
                   help="passes per kernel launch (progress granularity)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (default <output>.ckpt.npz)")
    p.add_argument("--resume", action="store_true",
                   help="resume from checkpoint")
    p.add_argument("--orbit", type=int, default=0, metavar="N",
                   help="orbit animation (not ported yet)")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernel's plain PyTorch version)")
    return p


def _not_ported(what: str, item: int) -> SystemExit:
    return SystemExit(f"{what} is not ported yet (ROADMAP Queue 1 item "
                      f"{item})")


def load_named_scene(name: str, width: int, height: int, device):
    from .models.scenes import cornell_box, sphere_field
    if name.endswith(".xml"):
        raise _not_ported("XML scenes", 15)
    if name == "cornell":
        return cornell_box(cols=width, rows=height, device=device)
    if name == "spheres":
        return sphere_field(512, cols=width, rows=height, device=device)
    raise SystemExit(f"unknown scene {name!r} (builtin: cornell, spheres)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.list_devices:
        if not torch.cuda.is_available():
            print("no CUDA devices")
        for i in range(torch.cuda.device_count()):
            pr = torch.cuda.get_device_properties(i)
            print(f"[{i}] cuda: {pr.name} ({pr.multi_processor_count} SMs, "
                  f"{pr.total_memory / 2**30:.0f} GiB)")
        return 0
    if args.renderer != "path":
        raise _not_ported(f"--renderer {args.renderer}", 8)
    if args.grid > 0:
        raise _not_ported("--grid", 11)
    if args.pallas:
        raise _not_ported("--pallas", 9)
    if args.block:
        raise _not_ported("--block", 10)
    if args.orbit:
        raise _not_ported("--orbit", 15)

    from . import RenderConfig, default_device, replace
    from .io.png import write_png
    from .render import pathtracer

    device = default_device(cpu=args.cpu)
    scene = load_named_scene(args.scene, args.width, args.height, device)
    if args.focal_length is not None:
        scene = replace(scene, focal_length=torch.tensor(
            args.focal_length, dtype=torch.float32, device=device))
    if args.lens_diameter is not None:
        scene = replace(scene, lens_radius=torch.tensor(
            args.lens_diameter / 2, dtype=torch.float32, device=device))
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       bounces=args.bounces, exposure=args.exposure,
                       seed=args.seed, use_megakernel=not args.no_megakernel)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "plain PyTorch version")
    print(f"device: {device.type} ({name})")
    print(f"  spheres: {scene.spheres.count}  triangles: "
          f"{scene.triangles.count}  lights: {scene.lights.count}")

    ckpt = args.checkpoint or (args.output + ".ckpt.npz")
    if args.resume:
        state = pathtracer.load_checkpoint(ckpt, device)
        print(f"resumed at pass {state['passes']}")
    else:
        state = pathtracer.init_state(cfg, device)

    done = state["passes"]
    target = done + args.passes
    segs = cfg.total_rays * (1 + scene.lights.count
                             + cfg.bounces * (1 + scene.lights.count))
    t0 = time.perf_counter()
    start = done
    try:
        while done < target:
            n = min(args.chunk_passes, target - done)
            state = pathtracer.render_passes(scene, state, cfg, n)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            done = state["passes"]
            pathtracer.save_checkpoint(ckpt, state)
            dt = time.perf_counter() - t0
            print(f"\rRendering... Pass: {done}  "
                  f"({(done - start) * segs / max(dt, 1e-9) / 1e6:.1f} "
                  f"M segs/s)", end="", flush=True)
    except KeyboardInterrupt:
        print("\nStopped; checkpointing.")
    finally:
        pathtracer.save_checkpoint(ckpt, state)
        write_png(args.output, pathtracer.image(state, cfg))
        print(f"\nwrote {args.output} ({state['passes']} passes), "
              f"checkpoint {ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
