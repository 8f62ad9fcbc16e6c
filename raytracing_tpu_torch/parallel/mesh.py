"""Multi-device sharding over a ``torch.distributed`` DeviceMesh
(``raytracing_tpu.parallel.mesh``): ray-axis data parallelism, and the
object axis of ``obj_parallel``.

The JAX package runs one controller over a ``jax.sharding.Mesh``
(``shard_map`` on the megakernel route, GSPMD on the stage pipeline). Here
every rank is a process of its own (``spawn`` starts a group of them, or
any launcher whose processes call ``init_distributed``), holds plain local
tensors, and meets the others only in ``torch.distributed`` collectives:

* 'rays' -- each rank renders a slice of the film: rays ``[i * local,
  (i + 1) * local)`` with ``local = ceil(R / n)`` (``ray_slice``), the last
  slice padded past the film's last ray as JAX pads it. The pass keys pixel
  decode and draws by the global ray id (``render_pass(ray_offset=)``), so
  each ray is the whole film's, and the forward needs no collective. The
  scene is replicated (``replicate_scene``: a broadcast from rank 0).
* 'obj' -- ``obj_parallel.closest_hit_spheres_objsharded``.
* gradients -- parameters are replicated; ``make_train_step`` all-reduces
  their cotangents (SUM) over 'rays'.

Backends (``init_distributed``): NCCL where every rank has a card of its
own, gloo where ranks share a card or run on the CPU (asked for with
``cpu=True``). Gloo's collectives here take host tensors: a CUDA tensor is
copied to the host and back around each (``_host_staged``); NCCL takes the
card's tensors.

Where the megakernel route does not cover a config (``render.mega.
supported``), a sharded pass raises as the single-process pass does, rather
than fall through to the stage pipeline as JAX's does; set
``use_megakernel=False`` for the stage route. The film's ray count stays
below 2^24 on the megakernel route whatever the shards.
"""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
import uuid

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.config import RenderConfig
from ..core.types import Scene, map_tensors, ray_window, replace
from ..render import pathtracer


def pick_backend(world_size: int, cpu: bool = False) -> tuple[str, str]:
    """(backend, why) for ``world_size`` ranks on this host: gloo on the
    CPU when asked for, NCCL with a card per rank, gloo where ranks share a
    card (NCCL refuses two ranks on one card). Raises where CUDA is
    missing and the CPU was not asked for."""
    if cpu:
        return "gloo", "ranks on the CPU, as asked"
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; ask for the CPU "
                           "explicitly (cpu=True)")
    cards = torch.cuda.device_count()
    if cards >= world_size:
        return "nccl", f"one card per rank ({cards} visible)"
    return "gloo", (f"{world_size} ranks share {cards} card(s): NCCL takes "
                    "one rank per card; collectives staged through the host")


def init_distributed(rank: int = 0, world_size: int = 1,
                     init_method: str | None = None,
                     cpu: bool = False) -> str | None:
    """Join the process group of ``world_size`` ranks that meet at
    ``init_method`` (``tcp://host:port`` or ``file://path``) as ``rank``,
    with the rank's card current. A no-op returning None with one process
    and no ``init_method``, as JAX's ``init_distributed`` is without a
    coordinator. Returns the backend (``pick_backend``), which rank 0
    prints with the reason."""
    if world_size == 1 and init_method is None:
        return None
    if init_method is None:
        raise ValueError(f"{world_size} ranks need an init_method "
                         "(tcp://host:port or file://path)")
    backend, why = pick_backend(world_size, cpu)
    if not cpu:
        # card rank mod cards of this host
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    if rank == 0:
        print(f"init_distributed: {world_size} rank(s), backend {backend} "
              f"({why})", flush=True)
    return backend


def _rank_main(rank: int, world_size: int, init_method: str, cpu: bool,
               fn, args: tuple, results) -> None:
    """A rank of ``spawn``: join the group, run ``fn(*args)``, hand back
    (rank, ok, value or traceback)."""
    try:
        if cpu:
            # ranks share the host's cores; one intra-op thread each
            torch.set_num_threads(1)
        init_distributed(rank, world_size, init_method, cpu)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, cpu: bool = False,
          store_dir: str | None = None, timeout: float = 900.0) -> list:
    """``fn(*args)`` on ``world_size`` ranks, one process each (the spawn
    start method, so ``fn`` must be importable by name), each inside the
    group ``init_distributed`` makes over a ``file://`` store in
    ``store_dir`` (a new directory under the temporary one, removed after,
    by default). Returns each rank's return value in rank order (pickled:
    hand back CPU tensors or numpy). A rank that raises, or a group that
    outlives ``timeout`` seconds, fails the call with the traceback; every
    process is joined or killed before it returns. Build the kernels in
    the calling process first, so that the ranks load them and no two
    ranks build into one directory."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="rt_store_") if own_dir else store_dir
    os.makedirs(store_dir, exist_ok=True)
    init_method = "file://" + os.path.join(
        os.path.abspath(store_dir), f"store-{uuid.uuid4().hex}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, init_method, cpu, fn, args,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                waiting = sorted(set(range(world_size)) - set(out))
                dead = [r for r in waiting if procs[r].exitcode not in
                        (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{world_size} ranks: no result from ranks "
                        f"{waiting}" + (f"; ranks {dead} exited with codes "
                                        f"{[procs[r].exitcode for r in dead]}"
                                        if dead else
                                        f" within {timeout:.0f} s")) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} of {world_size} exited with codes "
                           f"{[procs[r].exitcode for r in bad]}")
    return [out[r] for r in range(world_size)]


def make_mesh(n_devices: int | None = None, obj_parallel: int = 1,
              cpu: bool = False) -> DeviceMesh:
    """The 1-D ``("rays",)`` or 2-D ``("rays", "obj")`` mesh over every
    rank of the group, rank ``r`` at ``(r // obj_parallel, r %
    obj_parallel)`` as JAX reshapes its devices; on the ranks' cards, or
    on the CPU when asked for."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans every rank: n_devices {n}, world "
                         f"size {world}")
    if obj_parallel < 1 or n % obj_parallel:
        raise ValueError(f"obj_parallel {obj_parallel} must divide {n}")
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; ask for the CPU "
                           "explicitly (cpu=True)")
    kind = "cpu" if cpu else "cuda"
    if obj_parallel > 1:
        return init_device_mesh(kind, (n // obj_parallel, obj_parallel),
                                mesh_dim_names=("rays", "obj"))
    return init_device_mesh(kind, (n,), mesh_dim_names=("rays",))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def ray_slice(mesh: DeviceMesh, n_rays: int) -> tuple[int, int]:
    """(offset, count) of this rank's rays of a film of ``n_rays``:
    ``count = ceil(n_rays / n)`` over the n ranks of 'rays' (JAX pads,
    never asserts), the last slice padded past the film."""
    local = -(-n_rays // mesh.size(0))
    return mesh.get_local_rank(0) * local, local


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """``t`` of every rank of ``group``, in its rank order."""
    host = _host_staged(t, group)
    x = t.detach().cpu() if host else t.detach().contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return [o.to(t.device) for o in out] if host else out


def all_reduce_(t: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` (a sum by default) of ``t`` over ``group``, written into
    ``t``."""
    if _host_staged(t, group):
        x = t.cpu()
        dist.all_reduce(x, op=op, group=group)
        return t.copy_(x)
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """``t`` of rank 0, written into ``t`` on every rank."""
    if _host_staged(t, dist.group.WORLD):
        x = t.cpu()
        dist.broadcast(x, 0)
        return t.copy_(x)
    dist.broadcast(t, 0)
    return t


def shard_state(state: dict, mesh: DeviceMesh) -> dict:
    """This rank's slice of a whole-film state (``ray_slice``; the last
    slice zero-padded): a new accumulator, the key and pass count as
    they are."""
    off, local = ray_slice(mesh, state["acc"].shape[0])
    return {**state, "acc": ray_window(state["acc"], off, local).clone()}


def gather_state(state: dict, mesh: DeviceMesh, cfg: RenderConfig) -> dict:
    """The whole film's state from every rank's slice (padding cut), on
    every rank, e.g. for ``pathtracer.image``."""
    parts = all_gather(state["acc"], mesh.get_group("rays"))
    return {**state, "acc": torch.cat(parts)[:cfg.total_rays]}


def replicate_scene(scene: Scene, mesh: DeviceMesh) -> Scene:
    """The scene of rank 0 on every rank's device (a broadcast of each
    tensor, in field order), so that every rank renders the same tables."""
    dev = mesh_device(mesh)
    return map_tensors(scene, lambda t: broadcast_(
        t.detach().to(dev).contiguous().clone()))


def _offset(mesh: DeviceMesh, cfg: RenderConfig, state: dict) -> int:
    """This rank's ray offset; raises unless ``state`` holds its slice."""
    off, local = ray_slice(mesh, cfg.total_rays)
    if state["acc"].shape[0] != local:
        raise ValueError(f"state['acc'] holds {state['acc'].shape[0]} rays, "
                         f"this rank's slice {local}: shard_state first")
    return off


def sharded_render_passes(mesh: DeviceMesh, cfg: RenderConfig,
                          n_passes: int):
    """``fn(scene, state) -> state``: ``n_passes`` passes over this rank's
    slice (``shard_state``), keyed by the global ray ids: on the megakernel
    route one kernel-1 launch per call (``render_pass_mega(ray_offset=)``),
    on the stage route (``use_megakernel=False``) the stage passes over the
    slice. No collective."""
    def fn(scene: Scene, state: dict) -> dict:
        off = _offset(mesh, cfg, state)
        with torch.no_grad():
            return pathtracer.render_passes(scene, state, cfg, n_passes,
                                            ray_offset=off)
    return fn


# ---------------------------------------------------------------------------
# Differentiable training step
# ---------------------------------------------------------------------------

def apply_default_params(scene: Scene, params: dict) -> Scene:
    """Default parameterization: {center, radius, materials} (any subset)
    over the scene's spheres and materials, as JAX's. Any other is a custom
    ``apply_params``."""
    if "center" in params or "radius" in params:
        sp = scene.spheres
        scene = replace(scene, spheres=replace(
            sp, center=params.get("center", sp.center),
            radius=params.get("radius", sp.radius)))
    if "materials" in params:
        scene = replace(scene, materials=params["materials"])
    return scene


def _l2(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def make_train_step(mesh: DeviceMesh, cfg: RenderConfig, *, loss_fn=None,
                    apply_params=None):
    """Inverse-rendering step over the mesh: ``step(params, scene, state,
    target) -> ((loss, new_state), grads)``, JAX's contract.

    ``apply_params(scene, params) -> Scene`` maps a dict of replicated
    parameter tensors onto the scene (default ``apply_default_params``);
    ``loss_fn(img, target) -> scalar`` is any loss of the whole image
    (default L2). Each rank runs one differentiable pass over its slice
    (``render_pass(ray_offset=)``: kernel 1 and the backward of
    ``cfg.mega_bwd_impl`` on the megakernel route, autograd through the
    stages otherwise), gathers the film's detached accumulator, takes the
    loss and its cotangent with respect to that accumulator on every rank,
    backpropagates its own rows of the cotangent through its pass, and
    all-reduces the parameters' cotangents (SUM) over 'rays': the
    single-process gradient of any loss, separable or not. ``state`` is
    this rank's slice; the new one comes back detached."""
    loss_fn = loss_fn or _l2
    apply_params = apply_params or apply_default_params
    group = mesh.get_group("rays")

    def step(params: dict, scene: Scene, state: dict,
             target: torch.Tensor):
        off = _offset(mesh, cfg, state)
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            new = pathtracer.render_pass(apply_params(scene, leaves), state,
                                         cfg, ray_offset=off)
            acc = new["acc"]
            full = gather_state({**new, "acc": acc.detach()}, mesh, cfg)
            whole = full["acc"].requires_grad_(True)
            loss = loss_fn(pathtracer.image({**full, "acc": whole}, cfg),
                           target)
            (g_full,) = torch.autograd.grad(loss, whole)
            g = ray_window(g_full, off, acc.shape[0])
            if acc.requires_grad:
                grads = torch.autograd.grad(
                    acc, [leaves[k] for k in names], grad_outputs=g,
                    allow_unused=True, materialize_grads=True)
            else:
                grads = [torch.zeros_like(leaves[k]) for k in names]
        out = {k: all_reduce_(gk.detach().contiguous(), group)
               for k, gk in zip(names, grads)}
        return (loss.detach(), {**new, "acc": acc.detach()}), out

    return step
