"""Runtime and observability utilities (``raytracing_tpu.utils.runtime``):
device info, scene statistics and validation (the analog of the
reference's struct-size ABI check: shape and dtype invariants), a
completion fence, and timing harnesses.

The fence is ``torch.cuda.synchronize()`` of every card that holds a
tensor of its argument (a CUDA launch returns before the card finishes);
CPU tensors need none. ``profile_trace`` is ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import os
import platform
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..core.types import Scene


def _device_entry(dev: torch.device) -> dict:
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return {"id": idx, "platform": "gpu",
                "kind": torch.cuda.get_device_name(idx)}
    return {"id": 0, "platform": "cpu",
            "kind": platform.processor() or platform.machine() or "cpu"}


def device_info(cpu: bool = False) -> list[dict]:
    """One entry {"id", "platform", "kind"} per device: in a process group
    one per rank (gathered; with its "rank"), the rank's card or, with
    ``cpu``, the CPU; without one every visible card, or the CPU when
    asked for. Raises where CUDA is missing and the CPU was not asked
    for."""
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; ask for the CPU "
                           "explicitly (cpu=True)")
    if dist.is_initialized():
        mine = {**_device_entry(torch.device("cpu" if cpu else "cuda")),
                "rank": dist.get_rank()}
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        return out
    if cpu:
        return [_device_entry(torch.device("cpu"))]
    return [_device_entry(torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def scene_stats(scene: Scene) -> dict:
    """Scene census (the reference logs these at load, code.js:749-811)."""
    return {
        "spheres": scene.spheres.count,
        "triangles": scene.triangles.count,
        "meshes": len(scene.meshes),
        "mesh_triangles": sum(m.tris.count for m in scene.meshes),
        "lights": scene.lights.count,
        "materials": int(scene.materials.shape[0]),
    }


def validate_scene(scene: Scene) -> list[str]:
    """Shape and dtype invariants, the analog of the reference's
    struct-size ABI negotiation. Returns the problems (empty: valid)."""
    issues = []

    def chk(cond, msg):
        if not cond:
            issues.append(msg)

    sp, tr = scene.spheres, scene.triangles
    chk(tuple(sp.center.shape) == (sp.count, 3), "spheres.center shape")
    chk(tuple(sp.radius.shape) == (sp.count,), "spheres.radius shape")
    chk(sp.mat_id.dtype == torch.int32, "spheres.mat_id dtype")
    chk(tuple(tr.v.shape) == (tr.count, 3, 3), "triangles.v shape")
    chk(tuple(tr.vn.shape) == (tr.count, 3, 3), "triangles.vn shape")
    chk(scene.materials.dim() == 2 and scene.materials.shape[1] == 4,
        "materials must be (M, 4) rgba")
    n_mat = scene.materials.shape[0]
    for name, ids in (("spheres", sp.mat_id), ("triangles", tr.mat_id)):
        if ids.shape[0]:
            mx = int(ids.max())
            chk(mx < n_mat, f"{name} mat_id {mx} out of range (<{n_mat})")
    lg = scene.lights
    chk(tuple(lg.position.shape) == (lg.count, 3), "lights.position shape")
    if lg.count:
        norms = torch.linalg.norm(lg.normal.detach().double(), dim=-1)
        chk(bool(torch.allclose(norms, torch.ones_like(norms), atol=1e-4)),
            "light normals must be unit length")
    for i, m in enumerate(scene.meshes):
        chk(tuple(m.tris.v.shape) == (m.tris.count, 3, 3),
            f"mesh{i} tris shape")
    return issues


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def fence(x) -> None:
    """Completion barrier: ``torch.cuda.synchronize`` of every card that
    holds a tensor of ``x`` (tensors, and dicts, lists and tuples of
    them)."""
    cards = {t.device for t in _tensors(x) if t.is_cuda}
    for dev in cards:
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median-of-iters wall time in seconds, fence-synchronized."""
    for _ in range(warmup):
        fence(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fence(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and CUDA where it is
    available); writes ``log_dir/trace.json`` (a Chrome trace) on exit and
    yields the profiler (``key_averages()`` for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Per-stage timing harness: named stage timings (median) around
    fenced calls."""

    def __init__(self):
        self.records: dict[str, list[float]] = {}

    def run(self, name: str, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        fence(out)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> dict[str, float]:
        return {k: sorted(v)[len(v) // 2] for k, v in self.records.items()}
