#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raytracing_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the time;
  3. kernel vs its plain PyTorch version, cornell b5 at 256x192 and at the
     main path's 1024x1024, same u-planes: at most 1% of rays beyond
     rtol/atol 2e-4 (contracted FMAs move rays at silhouettes and grazing
     hits) and the mean accumulator within 1e-5 relative;
  4. the kernel's in-kernel threefry vs its own u-planes route for the same
     passes: bit-equal accumulators (1 pass, and 3 passes in one launch);
  5. the main path: render_passes(cornell 1024^2, b5, 16 passes per call),
     1 warm-up + 5 timed calls. The launch counter must grow by one per
     call, acc must be finite and the mean radiance per pass within 2% of
     the plain version's first pass (same draws). Prints ray segments/s
     and the times per pass, writes build/chip_smoke_cornell_1024.png.
Ends with a kernels JSON line and, last, the device JSON line. Exits non-zero
without a result where CUDA is missing or the package is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TOL = 2e-4
BOUNCES = 5
MAIN_W = MAIN_H = 1024
PASSES_PER_CALL = 16
TIMED_CALLS = 5


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


def _smi(query: str) -> str:
    """First card's line of ``nvidia-smi --query-gpu=<query>``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _plain(MK, mega, scene, cfg, u, acc):
    """The kernel's plain PyTorch version on the same tables and draws."""
    import torch
    tables = mega.scene_tables(scene, cfg)
    return MK.pathtrace_pass_reference(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        acc, u, spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
        two_sided=cfg.two_sided_triangles,
        normalize_emitter=cfg.normalize_emitter, seed=cfg.seed)


def compare_with_plain(dev, w: int, h: int) -> float:
    """Phase 3 at one size; returns max |kernel - plain|."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES)
    scene = cornell_box(cols=w, rows=h, device=dev)
    st = pt.init_state(cfg, dev)
    u = mega.u_planes_for_pass(st["key"], 0, cfg, scene.lights.count, dev)
    got = mega.render_pass_mega(scene, st, cfg, u_planes=u)["acc"]
    want = _plain(MK, mega, scene, cfg, u, torch.zeros_like(got))
    torch.cuda.synchronize()
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    gm, wm = got.double().mean().item(), want.double().mean().item()
    rel_mean = abs(gm - wm) / abs(wm)
    max_err = err.max().item()
    print(f"phase 3 {w}x{h} b{BOUNCES}: max|d acc| {max_err:.6g}, rays "
          f"beyond {TOL:g}: {beyond:.6%}, mean acc kernel {gm:.9g} plain "
          f"{wm:.9g} (rel {rel_mean:.3g})")
    _check(bool(torch.isfinite(got).all()), "kernel acc not finite")
    _check(beyond <= 0.01, f"{beyond:.4%} of rays beyond {TOL:g} (> 1%)")
    _check(rel_mean <= 1e-5, f"mean acc differs by {rel_mean:.3g} relative")
    return max_err


def prng_equals_u_planes(dev, w: int, h: int) -> None:
    """Phase 4: in-kernel threefry vs u-planes, same passes."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES)
    scene = cornell_box(cols=w, rows=h, device=dev)
    start = 5
    st_u = dict(pt.init_state(cfg, dev), passes=start)
    for p in range(3):
        u = mega.u_planes_for_pass(st_u["key"], start + p, cfg,
                                   scene.lights.count, dev)
        st_u = mega.render_pass_mega(scene, st_u, cfg, u_planes=u)
        if p == 0:
            one_u = st_u["acc"].clone()
    one = pt.render_pass(scene, dict(pt.init_state(cfg, dev), passes=start),
                         cfg)["acc"]
    three = pt.render_passes(scene, dict(pt.init_state(cfg, dev),
                                         passes=start), cfg, 3)["acc"]
    torch.cuda.synchronize()
    d1 = (one - one_u).abs().max().item()
    d3 = (three - st_u["acc"]).abs().max().item()
    print(f"phase 4 {w}x{h} b{BOUNCES}: PRNG vs u-planes max|d| 1 pass "
          f"{d1:g}, 3 passes in one launch {d3:g}")
    _check(torch.equal(one, one_u), "PRNG route != u-planes route (1 pass)")
    _check(torch.equal(three, st_u["acc"]),
           "PRNG route != u-planes route (3 passes in one launch)")


def main_path(dev, smi: str) -> dict:
    """Phase 5: the main path through render_passes; returns the kernel
    entry of the kernels line."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.io.png import write_png
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES)
    scene = cornell_box(cols=MAIN_W, rows=MAIN_H, device=dev)
    n_l = scene.lights.count
    segs_per_pass = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))

    MK.launches = 0
    state = pt.init_state(cfg, dev)
    state = pt.render_passes(scene, state, cfg, PASSES_PER_CALL)  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_CALLS):
        state = pt.render_passes(scene, state, cfg, PASSES_PER_CALL)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = MK.launches
    # clocks and power under load: sample while ~0.5 s of passes is queued
    busy = pt.init_state(cfg, dev)
    for _ in range(20):
        busy = pt.render_passes(scene, busy, cfg, PASSES_PER_CALL)
    clocks = _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    torch.cuda.synchronize()
    del busy
    n_calls = 1 + TIMED_CALLS
    _check(launches == n_calls,
           f"{launches} kernel launches for {n_calls} render_passes calls")
    acc = state["acc"]
    _check(tuple(acc.shape) == (cfg.total_rays, 3), "acc shape")
    _check(bool(torch.isfinite(acc).all()), "main-path acc not finite")
    passes = state["passes"]
    _check(passes == n_calls * PASSES_PER_CALL, f"passes = {passes}")

    timed_passes = TIMED_CALLS * PASSES_PER_CALL
    kernel_ms = start.elapsed_time(end) / timed_passes
    rate = segs_per_pass * timed_passes / wall

    # the plain version's first pass on the same draws: time and mean
    u = mega.u_planes_for_pass(state["key"], 0, cfg, n_l, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = _plain(MK, mega, scene, cfg, u, torch.zeros_like(acc))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    mean_kernel = acc.double().mean().item() / passes
    mean_plain = plain.double().mean().item()
    rel = abs(mean_kernel - mean_plain) / abs(mean_plain)
    img = pt.image(state, cfg)
    out = HERE / "build" / "chip_smoke_cornell_1024.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(out), img)
    print(f"phase 5 cornell {MAIN_W}x{MAIN_H} b{BOUNCES}, "
          f"{PASSES_PER_CALL} passes/call x {TIMED_CALLS} timed calls on "
          f"[{smi}]: {rate:.6g} ray segments/s ({segs_per_pass} per pass), "
          f"kernel {kernel_ms:.6g} ms/pass (CUDA events), wall "
          f"{wall * 1e3 / timed_passes:.6g} ms/pass; plain version "
          f"{plain_ms:.6g} ms/pass; launches {launches}; mean radiance/pass "
          f"kernel {mean_kernel:.7g} vs plain pass 0 {mean_plain:.7g} "
          f"(rel {rel:.3g}); image mean {img.mean().item():.6g} -> {out}; "
          f"under load after the timed calls: SM clock, max SM clock, "
          f"power, temperature = {clocks}")
    _check(rel <= 0.02, f"mean radiance differs by {rel:.3g} (> 2%)")

    # kernel-only times: tables packed once, CUDA events around the wrapper
    # alone (render_pass_mega repacks the tables on the host every call)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)

    def kernel_only_ms(u_planes, n_passes, reps):
        acc_k = torch.zeros_like(acc)
        kw = dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
                  two_sided=cfg.two_sided_triangles,
                  normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
                  n_passes=n_passes)
        MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc_k, u_planes, **kw)
        start.record()
        for _ in range(reps):
            MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc_k, u_planes,
                              **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * n_passes)

    k16 = kernel_only_ms(None, PASSES_PER_CALL, TIMED_CALLS)
    # the cost of making the draws in-kernel: PRNG route vs reading the same
    # pass's u-planes (96 B/ray), one pass per launch, in turns
    one = [kernel_only_ms(x, 1, 20) for x in (None, u, u, None)]
    print(f"phase 5 kernel only: {k16:.6g} ms/pass in {PASSES_PER_CALL}-pass "
          f"launches (main path {kernel_ms:.6g}: device idle share "
          f"{max(0.0, 1 - k16 / kernel_ms):.3%}); one pass per launch "
          f"(order PRNG, u, u, PRNG): PRNG route {one[0]:.6g} / "
          f"{one[3]:.6g} ms, u-planes route {one[1]:.6g} / {one[2]:.6g} ms")
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(HERE))
    import raytracing_tpu_torch
    pkg = Path(raytracing_tpu_torch.__file__).resolve().parent
    _check(pkg.parent == HERE,
           f"raytracing_tpu_torch found at {pkg}, not beside this script")
    dev = torch.device("cuda", 0)

    # phase 1: the card
    smi = _smi("name,power.limit")
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)

    # phase 2: build the kernels
    from raytracing_tpu_torch.ops import _build
    from raytracing_tpu_torch.ops import megakernel as MK
    t0 = time.perf_counter()
    _build.load("megakernel", MK._SIGNATURES)
    info = _build.build_log.get("megakernel")
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
          f"({'built' if info else 'cached'} {_build.BUILD_DIR})")
    if info:
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # phase 3: kernel vs plain version
    compare_with_plain(dev, 256, 192)
    max_err = compare_with_plain(dev, MAIN_W, MAIN_H)
    # phase 4: in-kernel PRNG vs u-planes
    prng_equals_u_planes(dev, 256, 192)
    # phase 5: the main path
    k = main_path(dev, smi)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "pathtrace_pass (megakernel)", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:284",
        "launches": k["launches"], "max_abs_err": max_err,
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
