"""Scaling harness (``raytracing_tpu.parallel.scaling``): ray segments per
second of the ray-sharded render at 1..N devices, and the efficiency per
device against one.

    python -m raytracing_tpu_torch.parallel.scaling [--cpu]

``scaling_report`` spawns one group per device count (``mesh.spawn``), one
rank per card up to the visible cards (NCCL), or gloo ranks on the CPU when
asked for, where the ranks share the host's cores and the numbers validate
the bookkeeping only: they are not a device's rates. Each call is fenced
with ``torch.cuda.synchronize()`` (``utils.runtime.fence``), and a group's
time is its slowest rank's.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..core.config import RenderConfig
from ..core.types import Scene
from ..models.scenes import cornell_box
from ..render import pathtracer
from ..utils.runtime import fence
from . import mesh as pm


def segments_per_pass(cfg: RenderConfig, n_lights: int) -> int:
    """Ray segments of one pass, counted as JAX counts them: a camera ray
    and a shadow ray per light, then per bounce a ray and a shadow ray per
    light, for every ray of the film."""
    return cfg.total_rays * (1 + n_lights + cfg.bounces * (1 + n_lights))


def measure_rays_per_s(scene: Scene, cfg: RenderConfig,
                       n_devices: int | None = None, n_passes: int = 4,
                       reps: int = 3, cpu: bool = False) -> float:
    """Segments per second of the sharded render on this group's mesh
    (every rank calls it): one warm-up call, then ``reps`` calls of
    ``n_passes`` passes, the slowest rank's wall time."""
    m = pm.make_mesh(n_devices, cpu=cpu)
    sscene = pm.replicate_scene(scene, m)
    state = pm.shard_state(pathtracer.init_state(cfg, pm.mesh_device(m)), m)
    render = pm.sharded_render_passes(m, cfg, n_passes)
    state = render(sscene, state)
    fence(state)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = render(sscene, state)
    fence(state)
    dt = pm.all_reduce_(torch.tensor([time.perf_counter() - t0],
                                     dtype=torch.float64,
                                     device=pm.mesh_device(m)),
                        m.get_group("rays"), dist.ReduceOp.MAX)
    segs = segments_per_pass(cfg, scene.lights.count)
    return segs * n_passes * reps / float(dt)


def _measure_rank(scene_fn, cfg: RenderConfig, cpu: bool) -> float:
    return measure_rays_per_s(scene_fn(cfg.width, cfg.height), cfg, cpu=cpu)


def _cornell(width: int, height: int) -> Scene:
    return cornell_box(cols=width, rows=height)


def scaling_report(scene_fn, width: int, height: int,
                   device_counts=(1, 2, 4, 8), bounces: int = 3,
                   weak: bool = True, megakernel: bool = False,
                   cpu: bool = False) -> list[dict]:
    """Weak scaling (rays per device held constant: the width scales with
    N) or strong (``weak=False``: the film fixed), one spawned group per
    count up to the visible cards (``cpu``: up to the host's cores).
    ``scene_fn(width, height)`` builds the scene in each rank: it must be
    importable by name. ``megakernel`` renders through kernel 1."""
    have = (os.cpu_count() or 1) if cpu else torch.cuda.device_count()
    if not cpu and not have:
        raise RuntimeError("CUDA is not available; ask for the CPU "
                           "explicitly (cpu=True)")
    rows, base = [], None
    for n in device_counts:
        if n > have:
            break
        cfg = RenderConfig(width=width * n if weak else width,
                           height=height, spp=1, bounces=bounces,
                           use_megakernel=megakernel)
        rps = pm.spawn(_measure_rank, n, scene_fn, cfg, cpu, cpu=cpu)[0]
        per_dev = rps / n
        base = base or per_dev
        rows.append({"devices": n, "rays_per_s": rps,
                     "rays_per_s_per_device": per_dev,
                     "efficiency": per_dev / base})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (bookkeeping only)")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--megakernel", action="store_true")
    args = ap.parse_args(argv)
    rows = scaling_report(_cornell, args.width, args.height, cpu=args.cpu,
                          megakernel=args.megakernel)
    for r in rows:
        print(f"devices={r['devices']}  rays/s={r['rays_per_s']:.3e}  "
              f"per-dev={r['rays_per_s_per_device']:.3e}  "
              f"eff={r['efficiency']:.2f}")


if __name__ == "__main__":
    main()
