"""A multi-rank dry run of the port's sharding on the CPU, the analog of
``__graft_entry__.dryrun_multichip``:

    python -m raytracing_tpu_torch.parallel.dryrun [N]

spawns N gloo ranks on the CPU (default 2) and runs, in order, on tiny
shapes: the sharded forward on both routes (kernel 1's plain version with
global ray offsets, and the stage pipeline over kernels 4 and 5's plain
versions); a train step on the stage route, on the megakernel route
(kernel 2's "pallas") and on the cell route with ``bounces=0``, each
checked finite with cotangents that do not vanish; and, with an even N,
the object-sharded sphere search on an (N/2, 2) mesh against the unsharded
search.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import RenderConfig
from ..core.types import Rays, make_spheres
from ..models.scenes import cornell_box
from ..ops.closest_hit import closest_hit_spheres
from ..render import pathtracer
from . import mesh as pm
from .obj_parallel import closest_hit_spheres_objsharded


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {msg}")


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def _rank(n_devices: int) -> dict:
    """One rank of the dry run; returns the losses."""
    cfg = RenderConfig(width=8 * n_devices, height=8, spp=1, bounces=1)
    m = pm.make_mesh(n_devices, cpu=True)
    scene = pm.replicate_scene(cornell_box(cols=cfg.width, rows=cfg.height),
                               m)
    out = {}
    for name, c in (("stage", dataclasses.replace(cfg, use_pallas=True)),
                    ("megakernel", dataclasses.replace(
                        cfg, use_megakernel=True))):
        state = pm.shard_state(pathtracer.init_state(c, "cpu"), m)
        state = pm.sharded_render_passes(m, c, 1)(scene, state)
        _check(_finite(state["acc"]), f"{name} forward acc not finite")

    params = {"center": scene.spheres.center, "radius": scene.spheres.radius,
              "materials": scene.materials}
    target = torch.zeros((cfg.height, cfg.width, 3))
    mega = dataclasses.replace(cfg, use_megakernel=True,
                               mega_grad_wrt=("sph", "mat"))
    for name, c in (("stage", dataclasses.replace(cfg, use_pallas=True)),
                    ("pallas", dataclasses.replace(
                        mega, mega_bwd_impl="pallas")),
                    ("cell", dataclasses.replace(
                        mega, bounces=0, mega_bwd_impl="cell"))):
        step = pm.make_train_step(m, c)
        state = pm.shard_state(pathtracer.init_state(c, "cpu"), m)
        (loss, _), grads = step(params, scene, state, target)
        _check(bool(torch.isfinite(loss)), f"{name} train loss not finite")
        for k, g in grads.items():
            _check(_finite(g), f"{name} grad {k} not finite")
        _check(float(grads["center"].abs().sum()) > 0,
               f"{name} train grads vanished")
        out[name] = float(loss)

    if n_devices >= 2 and n_devices % 2 == 0:
        m2 = pm.make_mesh(n_devices, obj_parallel=2, cpu=True)
        rng = np.random.default_rng(0)
        n_rays, n_sph = 128, 16
        d = rng.normal(size=(n_rays, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rays = Rays(o=torch.as_tensor(rng.normal(size=(n_rays, 3))
                                      .astype(np.float32)),
                    d=torch.as_tensor(d.astype(np.float32)),
                    mint=torch.zeros(n_rays),
                    maxt=torch.full((n_rays,), float("inf")))
        sp = make_spheres((rng.normal(size=(n_sph, 3)) * 2)
                          .astype(np.float32),
                          rng.uniform(0.2, 0.8, n_sph).astype(np.float32))
        ref = closest_hit_spheres(rays, sp, use_pallas=True)
        got = closest_hit_spheres_objsharded(rays, sp, m2, axis="obj")
        _check(torch.equal(got.valid, ref.valid)
               and torch.equal(got.idx, ref.idx), "obj-sharded mismatch")
    out["rank"] = dist.get_rank()
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """Spawn ``n_devices`` gloo ranks on the CPU and run the dry run;
    raises on any failure, returns rank 0's losses."""
    res = pm.spawn(_rank, n_devices, n_devices, cpu=True)
    print(f"dryrun_multichip({n_devices}): OK  losses " + "  ".join(
        f"{k}={v:.6f}" for k, v in res[0].items() if k != "rank"))
    return res[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
