"""Time kernels 1-3 of several builds of ``csrc/`` side by side on one card.

    python -m raytracing_tpu_torch.profile_kernels \
        [--variant LABEL=CSRC_DIR ...] [--sass LABEL ...] [--out DIR]

Each variant is a directory of CUDA sources laid out like
``raytracing_tpu_torch/csrc`` (the package's own by default, label
"tree"); e.g. a parent commit's, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, or a copy with one constant changed.
The C interfaces of the three kernels must be those of the package's
wrappers: each variant's libraries are put in the wrappers' place in turn,
so every variant runs through the same argument checks, tables and draws.

Measured per variant (CUDA events, in turns: first to last variant, then
back), cornell at 1024x1024 b5 and sphere_field(1024) at 1024x1024 b5:
kernel 1 per pass in 16-pass launches and in one-pass launches on
cornell, kernel 1 per pass in 16-pass launches and in one-pass launches
on the sphere fields of FIELDS, kernel 1 recording on
sphere_field(1024), kernel 2 on cornell
with ("sph", "mat") on a training step's cotangent of acc (the gradient of
mean(image^2) after 11 passes) and on a seeded random one, kernel 2 with
("mat",) and with all five groups, and kernel 3 with ("sph", "mat") on
sphere_field(1024)'s step cotangent and kernel 1's record of the pass;
then the same source's Russian-roulette instances (from depth RR_START,
as ``bench.py`` runs config 5: kernel 1 on cornell in 16-pass launches,
kernel 2 on the step cotangent with ("sph", "mat")) and kernel 1's direct
mode on cornell in 16-pass launches; kernel 2s (the edge-aware backward,
bandwidth and tau EDGE_BW as ``bench.py``'s BENCH_EDGE) on cornell's step
cotangent with ("sph", "mat"), with all five groups and with the roulette,
and on the seeded random one, where the variant has ``megakernel_soft.cu``
(a tree from before kernel 2s has none and times the rest), each
variant's kernel 2s cotangents held to the first variant's (cosine and
max |d| printed); then kernel 1's grid mode on the
scenes of ``chip_smoke.py``'s phase 18 (config 3's shape: cornell plus a
992-triangle torus mesh in its 3^3 grid, in direct mode at block 64 and
0 and in path mode at block 64, and recording; sphere_field(8192) in its
6^3 sphere grid in path mode and recording) and kernel 3 on the sphere
grid's record; then kernel 1 over streamed Morton chunks on the scenes of
``chip_smoke.py``'s phase 21 (the same torus scene without its grid, in
direct mode at block 64 and in path mode at blocks 64 and 0, with the
roulette, and recording; sphere_field(8192) without its sphere grid in
path mode and recording) and kernel 3 on the streamed torus's record
with ("sph", "mat", "tri"); last the differentiable direct pass's four
kernels on cornell's direct training step (kernel 1 recording, kernels 2,
3 and 2s with ("sph", "mat"), ``DirectCase``). A variant whose sources
predate those modes or their C interfaces (a parent commit's) is timed by
running this tool from that commit's own checkout instead.
``--sass`` dumps ``cuobjdump -sass`` of the named variants' libraries into
``--out`` and prints, per kernel, the count of each memory, atomic and
warp-level opcode, and the instructions around the first shared-memory
atomic. Every build's ``ptxas -v`` report is printed. Results also go to
``--out``/profile.json. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .core import rng
from .models.scenes import cornell_box, sphere_field
from .ops import _build
from .ops import megakernel as MK
from .ops import megakernel_grad as MKG
from .ops import megakernel_soft as MKS
from .render import mega
from .render import pathtracer as pt
from .core.config import RenderConfig

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "profile"
SIZE = 1024
BOUNCES = 5
STEP_PASSES = 11          # the training step's pass index + 1
N_SPHERES = 1024
# sphere fields on either side of kernel 1's switch between its 2-row and
# 8-row sphere loops (csrc/megakernel.cu kWideSpheres)
FIELDS = (16, 32, 64, 128, 256, 512)
REPS = 10
TRAIN_WRT = ("sph", "mat")
RR_START = 2
EDGE_BW = 2e-2            # bench.py BENCH_EDGE's mega_edge_bandwidth

# (library, C signatures, nvcc flags after _build.NVCC_FLAGS), keyed as the
# wrappers load them
LIBS = (("megakernel", MK._SIGNATURES, ()),
        ("megakernel", MK._SIGNATURES, MK.GRID_FLAGS),
        ("megakernel_grad", MKG._SIGNATURES, MKG.ADJ_FLAGS),
        ("megakernel_champ", MKG._CHAMP_SIGNATURES, MKG.ADJ_FLAGS),
        ("megakernel_soft", MKS._SIGNATURES, MKG.ADJ_FLAGS))
# kernel 2s past 64 objects runs seconds per launch at 1024^2: it is timed
# on the torus scene at this size
SOFT_LARGE_SIZE = 256


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _stem(name: str, flags: tuple) -> str:
    """A library's file stem: its source's name, "-grid" for kernel 1's
    grid-mode half."""
    return name + ("-grid" if MK.GRID_FLAGS[0] in flags else "")


def build(label: str, src: Path, name: str, signatures: dict,
          flags: tuple):
    """nvcc ``src/<name>.cu`` as _build.load does; (ctypes lib, ptxas)."""
    out = BUILD / label
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{_stem(name, flags)}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                           "-I", str(src), "-o", str(so),
                           str(src / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {label}/{name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fname, (restype, argtypes) in signatures.items():
        # a tree from before the large-table instances lacks their entries
        if not hasattr(lib, fname):
            continue
        getattr(lib, fname).restype = restype
        getattr(lib, fname).argtypes = argtypes
    return lib, proc.stdout + proc.stderr


def use(libs: dict) -> None:
    """Put one variant's libraries in the wrappers' place (a library the
    variant has no source for is taken out)."""
    for name, _, flags in LIBS:
        lib = libs.get(_stem(name, flags))
        if lib is None:
            _build._loaded.pop((name, tuple(flags)), None)
        else:
            _build._loaded[(name, tuple(flags))] = lib


def sass_summary(label: str, name: str, out: Path) -> None:
    """``name``: a library's file stem (``_stem``)."""
    so = BUILD / label / f"lib{name}.so"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        print(f"  cuobjdump failed on {so}: {proc.stderr.strip()}")
        return
    dump = out / f"{label}_{name}.sass"
    dump.write_text(proc.stdout)
    func, lines = None, {}
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            lines[func] = []
        elif func and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            lines[func].append(line.strip())
    keep = re.compile(r"^(ATOM|RED|LDS|STS|LDL|STL|LDG|STG|MATCH|SHFL|VOTE|"
                      r"BSSY|BSYNC|WARPSYNC|BAR|LDC)")
    for func, body in lines.items():
        ops = Counter()
        first_atoms = None
        for i, ins in enumerate(body):
            text = re.sub(r"^/\*[0-9a-f]+\*/\s*", "", ins)
            text = re.sub(r"^@!?U?P[T0-9]+\s+", "", text)
            op = text.split(" ")[0].rstrip(";")
            if keep.match(op):
                ops[op] += 1
            if first_atoms is None and op.startswith("ATOMS"):
                first_atoms = i
        print(f"  sass {label}/{name} {func[:90]}: {len(body)} instructions;"
              f" {dict(sorted(ops.items()))}")
        if first_atoms is not None:
            lo, hi = max(0, first_atoms - 6), first_atoms + 6
            print("    around the first ATOMS:\n      "
                  + "\n      ".join(body[lo:hi]))


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def time_ms(fn, reps: int = REPS, per: int = 1) -> float:
    fn()
    start, end = _events()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * per)


class Case:
    """One scene's tables and, with ``step``, a training step's cotangent
    of acc and kernel 1's record of that step's pass; ``grid``: in kernel
    1's grid mode over the scene's prepared grids, in the blocked layout
    ``block``; without a grid, tables past the resident budgets stream in
    Morton chunks (``render/mega.chunk_tables``)."""

    def __init__(self, scene, dev, step: bool = True, grid: bool = False,
                 block: int = 0, size: int = SIZE):
        self.cfg = RenderConfig(width=size, height=size, bounces=BOUNCES,
                                use_megakernel=True, use_grid=grid,
                                mega_block=block)
        self.scene = scene
        self.grid = mega.grid_tables(scene) if grid else None
        self.block = block
        self.tables = mega.scene_tables(scene, self.cfg)
        self.chunks = mega.chunk_tables(scene, self.cfg, self.tables[1],
                                        self.tables[2])
        self.kw = dict(spp=1, width=size, bounces=BOUNCES, two_sided=False,
                       normalize_emitter=True, seed=self.cfg.seed)
        self.ipar = torch.tensor([STEP_PASSES - 1, 0], dtype=torch.int32)
        self.acc = torch.zeros((size * size, 3), device=dev)
        self.key = rng.base_key(self.cfg.seed)
        if not step:
            return
        state = pt.render_passes(scene, pt.init_state(self.cfg, dev),
                                 self.cfg, STEP_PASSES)
        acc = state["acc"].clone().requires_grad_(True)
        loss = torch.mean(pt.image(dict(state, acc=acc), self.cfg) ** 2)
        self.g = torch.autograd.grad(loss, acc)[0].contiguous()
        self.g_rand = torch.as_tensor(np.random.default_rng(2).normal(
            size=tuple(self.g.shape)).astype(np.float32), device=dev)
        _, self.ids, self.occs = self.k1(record=True)
        self.live = (self.g != 0).any(-1).double().mean().item()

    def _mode(self, block=None) -> dict:
        if self.grid is None and self.chunks is None:
            return {}
        return {"grid": self.grid, "chunks": self.chunks,
                "block": self.block if block is None else block}

    def k1(self, n_passes: int = 1, record: bool = False, rr=False):
        return MK.pathtrace_pass(self.tables[0], self.ipar, *self.tables[1:],
                                 self.acc, None, n_passes=n_passes,
                                 record=record, **self.kw, **self._rr(rr),
                                 **self._mode())

    def k2(self, g, wrt, rr=False):
        # past 64 objects (the large-table instance) over the forward's own
        # grid or chunks
        replay = {k: v for k, v in self._mode().items() if k != "block"}
        return MKG.pathtrace_pass_bwd(self.tables[0], self.ipar,
                                      *self.tables[1:], g, None,
                                      diff_wrt=wrt, **self.kw, **self._rr(rr),
                                      **replay)

    def direct(self, n_passes: int, block=None):
        return MK.direct_pass(self.tables[0], *self.tables[1:], self.acc,
                              None, key=self.key, spp=1, width=SIZE,
                              two_sided=False, n_passes=n_passes,
                              **self._mode(block))

    @staticmethod
    def _rr(rr: bool) -> dict:
        return ({"russian_roulette": True, "rr_start_depth": RR_START}
                if rr else {})

    def k2s(self, g, wrt, rr=False):
        # past 64 triangles the soft backward takes them in Morton order
        st = mega.soft_tri_order(self.scene, self.tables[2], self.chunks)
        tri = self.tables[2] if st is None else st.rows
        return MKS.pathtrace_pass_bwd_soft(
            self.tables[0], self.ipar, self.tables[1], tri, *self.tables[3:],
            g, None, diff_wrt=wrt, soft_bandwidth=EDGE_BW, soft_tau=EDGE_BW,
            **self.kw, **self._rr(rr))

    def k3(self, g, wrt):
        return MKG.pathtrace_pass_bwd_champ(
            self.tables[0], self.ipar, *self.tables[1:], g, None, self.ids,
            self.occs, diff_wrt=wrt, **self.kw)


class DirectCase:
    """Direct mode's differentiable pass on ``scene`` at SIZE^2 spp 1
    (``pathtrace_pass_diff(mode="direct")``'s kernels): a training step's
    cotangent of acc (the gradient of mean(image^2), the image the
    per-pixel mean over the lights) and kernel 1's record of the pass."""

    def __init__(self, scene, dev):
        cfg = RenderConfig(width=SIZE, height=SIZE, use_megakernel=True)
        self.tables = mega.scene_tables(scene, cfg)
        self.ipar = torch.tensor([STEP_PASSES - 1, 0], dtype=torch.int32)
        self.kw = dict(spp=1, width=SIZE, bounces=0, two_sided=False,
                       normalize_emitter=True, seed=cfg.seed, mode="direct")
        self.fkw = dict(key=MK.pass_key_of(self.ipar, cfg.seed), spp=1,
                        width=SIZE, two_sided=False)
        self.acc = torch.zeros((SIZE * SIZE, 3), device=dev)
        acc = self.k1().clone().requires_grad_(True)
        loss = torch.mean((acc / scene.lights.count) ** 2)
        self.g = torch.autograd.grad(loss, acc)[0].contiguous()
        _, self.ids, self.occs = self.k1(record=True)

    def k1(self, record: bool = False):
        return MK.direct_pass(*self.tables, self.acc.zero_(), None,
                              record=record, **self.fkw)

    def k2(self):
        t = self.tables
        return MKG.pathtrace_pass_bwd(t[0], self.ipar, *t[1:], self.g, None,
                                      diff_wrt=TRAIN_WRT, **self.kw)

    def k3(self):
        t = self.tables
        return MKG.pathtrace_pass_bwd_champ(
            t[0], self.ipar, *t[1:], self.g, None, self.ids, self.occs,
            diff_wrt=TRAIN_WRT, **self.kw)

    def k2s(self):
        t = self.tables
        return MKS.pathtrace_pass_bwd_soft(
            t[0], self.ipar, *t[1:], self.g, None, diff_wrt=TRAIN_WRT,
            soft_bandwidth=EDGE_BW, soft_tau=EDGE_BW, **self.kw)


def measure_direct(d: DirectCase) -> dict:
    """The differentiable direct pass's four kernels on cornell's step."""
    return {
        "k1_direct_record_ms": time_ms(lambda: d.k1(record=True)),
        "k2_direct_step_g_sph_mat_ms": time_ms(d.k2),
        "k3_direct_step_g_sph_mat_ms": time_ms(d.k3),
        "k2s_direct_step_g_sph_mat_ms": time_ms(d.k2s, reps=3),
    }


def stream_cases(dev) -> dict:
    """Kernel 1's streamed cases on chip_smoke.py's phase 21 scenes."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return {"torus": Case(chip_smoke._stream_scene("torus", SIZE, SIZE, dev),
                          dev, block=64),
            "spheres": Case(chip_smoke._stream_scene("spheres", SIZE, SIZE,
                                                     dev), dev, step=False)}


def measure_stream(cases: dict) -> dict:
    torus, spheres = cases["torus"], cases["spheres"]
    return {
        "k1_stream_torus_direct_B64_16pass_ms_per_pass": time_ms(
            lambda: torus.direct(16), reps=3, per=16),
        "k1_stream_torus_path_B64_16pass_ms_per_pass": time_ms(
            lambda: torus.k1(n_passes=16), reps=1, per=16),
        "k1_stream_torus_path_B0_16pass_ms_per_pass": time_ms(
            lambda: MK.pathtrace_pass(
                torus.tables[0], torus.ipar, *torus.tables[1:], torus.acc,
                None, n_passes=16, **torus.kw, **torus._mode(block=0)),
            reps=1, per=16),
        "k1_stream_torus_rr_B64_16pass_ms_per_pass": time_ms(
            lambda: torus.k1(n_passes=16, rr=True), reps=1, per=16),
        "k1_stream_torus_record_ms": time_ms(lambda: torus.k1(record=True),
                                             reps=3),
        "k3_stream_torus_step_g_sph_mat_tri_ms": time_ms(
            lambda: torus.k3(torus.g, ("sph", "mat", "tri"))),
        "k1_stream_spheres_16pass_ms_per_pass": time_ms(
            lambda: spheres.k1(n_passes=16), reps=2, per=16),
        "k1_stream_spheres_record_ms": time_ms(
            lambda: spheres.k1(record=True), reps=5),
    }


def large_cases(dev, spheres: Case, stream: dict) -> dict:
    """Kernels 2 and 2s past 64 objects (their large-table instances):
    kernel 2 on sphere_field(N_SPHERES)'s and the streamed torus's step
    cotangents (the cases above), kernel 2s on the streamed torus at
    SOFT_LARGE_SIZE^2."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return {"spheres": spheres, "torus": stream["torus"],
            "soft": Case(chip_smoke._stream_scene(
                "torus", SOFT_LARGE_SIZE, SOFT_LARGE_SIZE, dev), dev,
                size=SOFT_LARGE_SIZE)}


def measure_large(cases: dict) -> dict:
    sp, torus, soft = cases["spheres"], cases["torus"], cases["soft"]
    return {
        "k2_large_spheres_step_g_sph_mat_ms": time_ms(
            lambda: sp.k2(sp.g, TRAIN_WRT), reps=3),
        "k2_large_stream_torus_step_g_sph_mat_tri_ms": time_ms(
            lambda: torus.k2(torus.g, ("sph", "mat", "tri")), reps=2),
        f"k2s_large_stream_torus_{SOFT_LARGE_SIZE}_step_g_sph_mat_ms":
            time_ms(lambda: soft.k2s(soft.g, TRAIN_WRT), reps=1),
    }


def grid_cases(dev) -> dict:
    """Kernel 1's grid-mode cases on chip_smoke.py's phase 18 scenes (the
    torus mesh is the smoke script's, not the package's)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return {"torus": Case(chip_smoke._grid_scene("torus", SIZE, SIZE, dev),
                          dev, step=False, grid=True, block=64),
            "spheres": Case(chip_smoke._grid_scene("spheres", SIZE, SIZE,
                                                   dev), dev, grid=True)}


def measure_grid(cases: dict) -> dict:
    torus, spheres = cases["torus"], cases["spheres"]
    return {
        "k1_grid_torus_direct_B64_16pass_ms_per_pass": time_ms(
            lambda: torus.direct(16), reps=5, per=16),
        "k1_grid_torus_direct_B0_16pass_ms_per_pass": time_ms(
            lambda: torus.direct(16, block=0), reps=5, per=16),
        "k1_grid_torus_path_B64_16pass_ms_per_pass": time_ms(
            lambda: torus.k1(n_passes=16), reps=2, per=16),
        "k1_grid_torus_record_ms": time_ms(lambda: torus.k1(record=True),
                                           reps=5),
        "k1_grid_spheres_16pass_ms_per_pass": time_ms(
            lambda: spheres.k1(n_passes=16), reps=2, per=16),
        "k1_grid_spheres_record_ms": time_ms(
            lambda: spheres.k1(record=True), reps=5),
        "k3_grid_spheres_step_g_sph_mat_ms": time_ms(
            lambda: spheres.k3(spheres.g, TRAIN_WRT)),
    }


def measure(cornell: Case, spheres: Case, fields: dict) -> dict:
    by_field = {}
    for n, case in fields.items():
        by_field[f"k1_field{n}_16pass_ms_per_pass"] = time_ms(
            lambda: case.k1(n_passes=16), reps=5, per=16)
        by_field[f"k1_field{n}_1pass_ms"] = time_ms(lambda: case.k1(),
                                                     reps=20)
    return {
        "k1_cornell_16pass_ms_per_pass": time_ms(
            lambda: cornell.k1(n_passes=16), reps=5, per=16),
        "k1_cornell_1pass_ms": time_ms(lambda: cornell.k1(), reps=20),
        "k1_spheres_record_ms": time_ms(lambda: spheres.k1(record=True)),
        "k2_cornell_step_g_sph_mat_ms": time_ms(
            lambda: cornell.k2(cornell.g, TRAIN_WRT)),
        "k2_cornell_random_g_sph_mat_ms": time_ms(
            lambda: cornell.k2(cornell.g_rand, TRAIN_WRT)),
        "k2_cornell_step_g_mat_ms": time_ms(
            lambda: cornell.k2(cornell.g, ("mat",))),
        "k2_cornell_step_g_all_ms": time_ms(
            lambda: cornell.k2(cornell.g, MKG.DIFF_ALL)),
        "k3_spheres_step_g_sph_mat_ms": time_ms(
            lambda: spheres.k3(spheres.g, TRAIN_WRT)),
        **by_field,
        "k1_cornell_rr_16pass_ms_per_pass": time_ms(
            lambda: cornell.k1(n_passes=16, rr=True), reps=5, per=16),
        "k2_cornell_rr_step_g_sph_mat_ms": time_ms(
            lambda: cornell.k2(cornell.g, TRAIN_WRT, rr=True)),
        "k1_direct_cornell_16pass_ms_per_pass": time_ms(
            lambda: cornell.direct(16), reps=5, per=16),
    }


def measure_soft(cornell: Case, first: dict) -> dict:
    """Kernel 2s on cornell's step cotangent (and the seeded random one).
    Each variant's cotangents are held to those of the first variant
    measured (``first``, filled on the first call): cosine and max |d|
    over the group's scale, printed, so that a variant that computes
    something else is not timed as a faster one."""
    for name, wrt in (("sph_mat", TRAIN_WRT), ("all", MKG.DIFF_ALL)):
        got = cornell.k2s(cornell.g, wrt)
        want = first.setdefault(name, got)
        for gname, a, b in zip(MKG.DIFF_ALL, want, got):
            if gname in wrt:
                a, b = a.double().ravel(), b.double().ravel()
                cos = (a @ b).item() / max(a.norm().item() * b.norm().item(),
                                           1e-300)
                rel = ((a - b).abs().max() / a.abs().max()).item()
                print(f"  k2s {name} {gname} vs the first variant: cosine "
                      f"{cos:.9f}, max|d| {rel:.3g} x scale")
    return {
        "k2s_cornell_step_g_sph_mat_ms": time_ms(
            lambda: cornell.k2s(cornell.g, TRAIN_WRT), reps=3),
        "k2s_cornell_random_g_sph_mat_ms": time_ms(
            lambda: cornell.k2s(cornell.g_rand, TRAIN_WRT), reps=3),
        "k2s_cornell_step_g_all_ms": time_ms(
            lambda: cornell.k2s(cornell.g, MKG.DIFF_ALL), reps=3),
        "k2s_cornell_rr_step_g_sph_mat_ms": time_ms(
            lambda: cornell.k2s(cornell.g, TRAIN_WRT, rr=True), reps=3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL=CSRC_DIR (repeatable; default the package's "
                         "csrc/ as 'tree')")
    ap.add_argument("--sass", action="append", default=[],
                    help="dump the SASS of this variant's libraries")
    ap.add_argument("--out", default=str(BUILD / "out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA card")
    dev = torch.device("cuda", 0)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = _smi("name,power.limit")
    print(f"card: {torch.cuda.get_device_name(0)} [{smi}]")

    variants = [tuple(v.split("=", 1)) for v in args.variant] or [
        ("tree", str(_build.CSRC))]
    variants = [(label, Path(src).resolve()) for label, src in variants]
    t0 = time.perf_counter()
    jobs = [(label, src, *lib) for label, src in variants for lib in LIBS
            if (src / f"{lib[0]}.cu").exists()]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    libs: dict = {}
    for (label, _, name, _, flags), (lib, log) in zip(jobs, built):
        libs.setdefault(label, {})[_stem(name, flags)] = lib
        for line in log.splitlines():
            if re.search(r"registers|spill|stack|Compiling entry", line):
                print(f"  ptxas {label}/{_stem(name, flags)}: "
                      f"{line.strip()}")
    print(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.2f} s")
    for label in args.sass:
        for name, _, flags in LIBS:
            sass_summary(label, _stem(name, flags), out)

    labels = [label for label, _ in variants]
    use(libs[labels[0]])
    cornell = Case(cornell_box(cols=SIZE, rows=SIZE, device=dev), dev)
    spheres = Case(sphere_field(N_SPHERES, cols=SIZE, rows=SIZE,
                                device=dev), dev)
    fields = {n: Case(sphere_field(n, cols=SIZE, rows=SIZE, device=dev), dev,
                     step=False) for n in FIELDS}
    print(f"cotangent share of rays with g != 0: cornell {cornell.live:.4%},"
          f" sphere_field({N_SPHERES}) {spheres.live:.4%}")
    grid = grid_cases(dev)
    stream = stream_cases(dev)
    large = large_cases(dev, spheres, stream)
    direct = DirectCase(cornell_box(cols=SIZE, rows=SIZE, device=dev), dev)
    results: dict = {"card": smi, "turns": []}
    soft_first: dict = {}
    for order in (labels, labels[::-1]):
        turn = {}
        for label in order:
            use(libs[label])
            turn[label] = {**measure(cornell, spheres, fields),
                           **measure_grid(grid), **measure_stream(stream)}
            if "megakernel_soft" in libs[label]:
                print(f"{label}:")
                turn[label].update(measure_soft(cornell, soft_first))
            if (hasattr(libs[label].get("megakernel_grad"),
                        "rt_pathtrace_bwd_large")
                    and hasattr(libs[label].get("megakernel_soft"),
                                "rt_pathtrace_bwd_soft_large")):
                turn[label].update(measure_large(large))
            turn[label].update(measure_direct(direct))
            print(f"{label}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in turn[label].items()))
        results["turns"].append(turn)
    (out / "profile.json").write_text(json.dumps(results, indent=1))
    print(f"card: [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
