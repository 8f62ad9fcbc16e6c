"""What each gloo rank of ``tests/test_torch_parallel.py`` runs.

The ranks are processes started by ``parallel.mesh.spawn`` (the spawn
start method), which import this module by name: it imports torch and the
port only, never JAX, and hands back numpy arrays. ``run_cases`` runs
every sharded case of one group on the CPU and returns rank 0's results
(and each rank's own where they differ by rank); the test module compares
them with the single-process port and with the JAX package."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core.types import Rays, make_spheres, \
    scene_from_numpy
from raytracing_tpu_torch.parallel import mesh as pm
from raytracing_tpu_torch.parallel.scaling import measure_rays_per_s
from raytracing_tpu_torch.parallel.obj_parallel import \
    closest_hit_spheres_objsharded
from raytracing_tpu_torch.render import pathtracer as pt
from raytracing_tpu_torch.utils.runtime import device_info

PARAMS = ("center", "radius", "materials")

# (name, cfg fields) of the sharded renders: both routes, the uneven film
# (ray counts that are not whole rows of a shard) and a padded one (a ray
# count the ranks do not divide)
RENDERS = {
    "mega": dict(width=16, height=12, bounces=1, seed=4,
                 use_megakernel=True),
    "stage": dict(width=16, height=12, bounces=1, seed=4, use_pallas=True),
    "mega uneven": dict(width=36, height=15, bounces=1, seed=4,
                        use_megakernel=True),
    "stage uneven": dict(width=36, height=15, bounces=1, seed=4,
                         use_pallas=True),
    "mega padded": dict(width=35, height=15, bounces=1, seed=4,
                        use_megakernel=True),
    "stage padded": dict(width=35, height=15, bounces=1, seed=4,
                         use_pallas=True),
}
RENDER_PASSES = 2

# the train steps: kernel 2's route ("pallas"), the cell route, the stage
# route, each with the L2 loss on a zero target
STEPS = {
    "pallas": dict(width=16, height=12, bounces=1, seed=4,
                   use_megakernel=True, mega_grad_wrt=("sph", "mat"),
                   mega_bwd_impl="pallas"),
    "cell": dict(width=16, height=12, bounces=1, seed=4, use_megakernel=True,
                 mega_grad_wrt=("sph", "mat"), mega_bwd_impl="cell"),
    "stage": dict(width=16, height=12, bounces=1, seed=4, use_pallas=True),
    "pallas padded": dict(width=35, height=15, bounces=1, seed=4,
                          use_megakernel=True, mega_grad_wrt=("sph", "mat"),
                          mega_bwd_impl="pallas"),
}
CUSTOM = {
    # JAX's custom case: light irradiance through apply_params, L1 loss
    "l1 irradiance": dict(width=16, height=12, bounces=1, seed=4,
                          use_pallas=True),
    # a loss that no ray decides alone: each pixel against the image's
    # mean, through kernel 2's route with the light group
    "contrast": dict(width=16, height=12, bounces=1, seed=4,
                     use_megakernel=True, mega_grad_wrt=("lig",),
                     mega_bwd_impl="pallas"),
}


def apply_irradiance(scene, params):
    return dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, irradiance=params["irradiance"]))


def l1(img, target):
    return torch.mean(torch.abs(img - target))


def contrast(img, target):
    return torch.mean((img - img.mean()) ** 2) + torch.mean(
        torch.abs(img - target))


LOSSES = {"l1 irradiance": (l1, apply_irradiance),
          "contrast": (contrast, apply_irradiance)}


def default_params(scene) -> dict:
    return {"center": scene.spheres.center, "radius": scene.spheres.radius,
            "materials": scene.materials}


def custom_params(scene) -> dict:
    return {"irradiance": scene.lights.irradiance}


def search_inputs(n_rays: int = 256, n_spheres: int = 32, seed: int = 1):
    """JAX's object-sharded case (random rays and spheres), with every
    sphere of the first half copied into the second: each ray that hits
    one hits its copy at the same t, a tie the lower index must win."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = (rng.normal(size=(n_spheres, 3)) * 2).astype(np.float32)
    r = rng.uniform(0.2, 0.8, n_spheres).astype(np.float32)
    half = n_spheres // 2
    c[half:], r[half:] = c[:half], r[:half]
    rays = Rays(o=torch.as_tensor(o), d=torch.as_tensor(d),
                mint=torch.zeros(n_rays),
                maxt=torch.full((n_rays,), float("inf")))
    return rays, make_spheres(c, r)


def _scene(arrays: dict, mesh):
    return pm.replicate_scene(scene_from_numpy(arrays), mesh)


def _render(mesh, arrays: dict, fields: dict) -> np.ndarray:
    cfg = RenderConfig(**fields)
    state = pm.shard_state(pt.init_state(cfg, "cpu"), mesh)
    state = pm.sharded_render_passes(mesh, cfg, RENDER_PASSES)(
        _scene(arrays, mesh), state)
    return pm.gather_state(state, mesh, cfg)["acc"].numpy()


def _step(mesh, arrays: dict, fields: dict, loss=None) -> dict:
    cfg = RenderConfig(**fields)
    scene = _scene(arrays, mesh)
    if loss is None:
        step = pm.make_train_step(mesh, cfg)
        params = default_params(scene)
    else:
        fn, apply = LOSSES[loss]
        step = pm.make_train_step(mesh, cfg, loss_fn=fn, apply_params=apply)
        params = custom_params(scene)
    target = torch.zeros((cfg.height, cfg.width, 3))
    state = pm.shard_state(pt.init_state(cfg, "cpu"), mesh)
    (value, new), grads = step(params, scene, state, target)
    return {"loss": float(value),
            "acc": pm.gather_state(new, mesh, cfg)["acc"].numpy(),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "passes": int(new["passes"])}


def _search(mesh) -> dict:
    rays, spheres = search_inputs()
    ch = closest_hit_spheres_objsharded(rays, spheres, mesh, axis="obj")
    return {"t": ch.t.numpy(), "idx": ch.idx.numpy(),
            "valid": ch.valid.numpy()}


def _checkpoint(mesh, arrays: dict, load_from: str | None,
                save_to: str) -> dict:
    """Render a pass, save it sharded, load it back, render on from both;
    and, with ``load_from``, load a checkpoint another mesh wrote."""
    cfg = RenderConfig(**RENDERS["mega padded"])
    scene = _scene(arrays, mesh)
    render = pm.sharded_render_passes(mesh, cfg, 1)
    state = render(scene, pm.shard_state(pt.init_state(cfg, "cpu"), mesh))
    pt.save_checkpoint_sharded(save_to, state, mesh, cfg)
    back = pt.load_checkpoint_sharded(save_to, state, mesh, cfg)
    out = {"saved": pm.gather_state(state, mesh, cfg)["acc"].numpy(),
           "loaded": pm.gather_state(back, mesh, cfg)["acc"].numpy(),
           "passes": back["passes"], "key": back["key"].numpy(),
           "on": pm.gather_state(render(scene, back), mesh, cfg)["acc"]
           .numpy(),
           "on_saved": pm.gather_state(render(scene, state), mesh,
                                       cfg)["acc"].numpy()}
    if load_from is not None:
        other = pt.load_checkpoint_sharded(load_from, state, mesh, cfg)
        out["other"] = pm.gather_state(other, mesh, cfg)["acc"].numpy()
        out["other_passes"] = other["passes"]
    return out


def run_cases(arrays: dict, ckpt_dir: str, load_from: str | None) -> dict:
    """Every case on this group; rank 0's results (the gathered ones are
    every rank's), with each rank's ray slice and device entry."""
    n = dist.get_world_size()
    mesh = pm.make_mesh(cpu=True)
    out = {"mesh": (tuple(mesh.shape), mesh.mesh_dim_names)}
    out["renders"] = {k: _render(mesh, arrays[k], f)
                      for k, f in RENDERS.items()}
    out["steps"] = {k: _step(mesh, arrays[k], f) for k, f in STEPS.items()}
    out["custom"] = {k: _step(mesh, arrays[k], f, loss=k)
                     for k, f in CUSTOM.items()}
    searches = {}
    for obj in sorted({2, n}):
        m2 = pm.make_mesh(n, obj_parallel=obj, cpu=True)
        searches[obj] = {"mesh": (tuple(m2.shape), m2.mesh_dim_names),
                         **_search(m2)}
    out["searches"] = searches
    out["checkpoint"] = _checkpoint(mesh, arrays["mega padded"], load_from,
                                    f"{ckpt_dir}/ckpt{n}")
    out["devices"] = device_info(cpu=True)
    cfg = RenderConfig(**RENDERS["mega"])
    out["rays_per_s"] = measure_rays_per_s(
        scene_from_numpy(arrays["mega"]), cfg, n_passes=1, reps=1, cpu=True)
    mine = {"slice": pm.ray_slice(mesh, 525), "rank": dist.get_rank()}
    ranks = [None] * n
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    return out


def fail_on_rank(rank: int, how: str) -> int:
    """Raise (``how`` "raise") or die without a word ("exit") on ``rank``;
    the other ranks wait for it in a barrier."""
    import os
    if dist.get_rank() == rank:
        if how == "exit":
            os._exit(7)
        raise ValueError(f"rank {rank} fails")
    dist.barrier()
    return 0
