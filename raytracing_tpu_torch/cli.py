"""Command-line renderer (``raytracing_tpu.cli``: path and direct renderers):

  python -m raytracing_tpu_torch.cli --list-devices
  python -m raytracing_tpu_torch.cli --scene cornell --width 1024 \\
      --height 1024 --passes 16 -o out.png
  python -m raytracing_tpu_torch.cli --scene spheres --no-megakernel \\
      --pallas --width 1024 --height 1024 --passes 4 -o spheres.png
  python -m raytracing_tpu_torch.cli --renderer direct -o direct.png
  python -m raytracing_tpu_torch.cli --renderer direct --no-megakernel \\
      --pallas -o direct.png
  python -m raytracing_tpu_torch.cli --renderer fake -o fake.png
  python -m raytracing_tpu_torch.cli --renderer direct --grid 4 --block 64 \
      -o grid.png
  python -m raytracing_tpu_torch.cli --scene scenes/cornell_teapot.xml \
      --grid 3 --block 64 --width 1024 --height 1024 -o teapot.png
  python -m raytracing_tpu_torch.cli --orbit 16 -o orbit.png
  python -m raytracing_tpu_torch.cli --cpu --width 64 --height 48 -o x.png

Same flags as the JAX CLI: the megakernel by default (kernel 1, in path
or direct mode), the stage pipeline with ``--no-megakernel`` (its hit
searches in the hit kernels with ``--pallas``); ``--renderer fake`` is the
fake-shade sphere renderer (``render/simple.py``). ``--grid N`` builds
the uniform grids (``accel.prepare_grids(scene, N, mesh_slabs=...)``) and
renders in kernel 1's grid mode (the stage route's grid branch with
``--no-megakernel``); ``--block B`` is kernel 1's blocked layout.
``--scene`` takes a builtin name or an XML scene file
(``io.scene_xml``). ``--orbit N`` writes N path-traced frames
``<output>_frameNNN.png`` with the eye orbited around the scene. The path
renderer's progressive state is checkpointed after every chunk of passes
and on Ctrl-C, and ``--resume`` continues it (JAX checkpoints included).
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
                   help="builtin scene name (cornell, spheres) or XML path")
    p.add_argument("--renderer", default="path",
                   choices=["path", "direct", "fake"],
                   help="pipeline: path tracing, direct lighting, or the "
                        "fake-shade sphere renderer (Assign01/02)")
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
                   help="use N^3 uniform-grid acceleration (0 = brute "
                        "force); mesh instances get their own grids")
    p.add_argument("--mesh-slabs", default="auto", metavar="N|xml|auto",
                   help="per-mesh grid resolution: 'auto' (default) from "
                        "the cost model, 'xml' each mesh's nslabs, an int "
                        "for every mesh")
    p.add_argument("--pallas", action="store_true",
                   help="stage pipeline: run the closest-hit and any-hit "
                        "searches in the hit kernels (kernels 4 and 5)")
    p.add_argument("--no-megakernel", action="store_true",
                   help="run the wavefront stage pipeline instead of the "
                        "whole-pass megakernel")
    p.add_argument("--block", type=int, default=0, metavar="B",
                   help="megakernel blocked pixel layout: a warp's rays in "
                        "a BxB pixel block (0 = row-major; 64 for mesh "
                        "scenes)")
    p.add_argument("--chunk-passes", type=int, default=8,
                   help="passes per call, between checkpoints (one kernel "
                        "launch on the megakernel route)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (default <output>.ckpt.npz)")
    p.add_argument("--resume", action="store_true",
                   help="resume from checkpoint")
    p.add_argument("--orbit", type=int, default=0, metavar="N",
                   help="render N frames orbiting the scene (Assign02 "
                        "rotate-camera animation); output becomes a "
                        "frame_%%03d.png sequence")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernel's plain PyTorch version)")
    return p


def load_named_scene(name: str, width: int, height: int, device):
    if name.endswith(".xml"):
        from .io.scene_xml import load_scene
        return load_scene(name, width, height, device)
    from .models.scenes import cornell_box, sphere_field
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
    from . import RenderConfig, default_device, replace
    from .io.png import write_png
    from .render import pathtracer
    from .utils.runtime import scene_stats

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
                       seed=args.seed, use_grid=args.grid > 0,
                       n_slabs=max(args.grid, 1), use_pallas=args.pallas,
                       use_megakernel=not args.no_megakernel,
                       mega_block=args.block)
    if args.grid > 0:
        from .accel import prepare_grids
        ms = args.mesh_slabs
        scene = prepare_grids(scene, args.grid,
                              mesh_slabs=ms if ms in ("xml", "auto")
                              else int(ms))

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "plain PyTorch version")
    print(f"device: {device.type} ({name})")
    for k, v in scene_stats(scene).items():
        print(f"  {k}: {v}")

    if args.orbit:
        # the reference's rotate animation: the eye orbited around the
        # scene bounds, a fresh progressive render per frame
        import os

        base, ext = os.path.splitext(args.output)
        for f in range(args.orbit):
            cam = scene.camera.orbit(scene.bounds, 360.0 * f / args.orbit)
            state = pathtracer.render_passes(
                replace(scene, camera=cam), pathtracer.init_state(cfg, device),
                cfg, args.passes)
            frame = f"{base}_frame{f:03d}{ext}"
            write_png(frame, pathtracer.image(state, cfg))
            print(f"frame {f + 1}/{args.orbit}: {frame}")
        return 0

    if args.renderer == "fake":
        from .render.simple import render_fake_shade
        cam = replace(scene.camera, cols=args.width, rows=args.height)
        sp = scene.spheres
        colors = scene.materials[sp.mat_id.clamp(min=0).long()]
        write_png(args.output, render_fake_shade(cam, sp, colors))
        print(f"wrote {args.output}")
        return 0

    if args.renderer == "direct":
        from .render.direct import render_direct
        # --passes: independent direct-lighting estimates, averaged
        write_png(args.output, render_direct(scene, cfg,
                                             n_passes=args.passes))
        print(f"wrote {args.output} ({args.passes} passes)")
        return 0

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
