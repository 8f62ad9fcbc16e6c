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
``--only soft`` builds kernel 2s alone and times only it: cornell's step
cotangent (("sph", "mat"), all groups, the roulette, the random
cotangent), direct mode, and past 64 objects (the large-table instance)
the torus scene at each size of ``--soft-large-sizes`` (256 by default;
1024 is the main path's) in path mode, with the roulette and in direct
mode, and sphere_field(1024) at each size of ``--soft-sphere-sizes``
(none by default), each on its own step cotangent, each variant's
cotangents held to the first variant's, with what each large launch took
(``MKS.last_launch``: registers, local bytes, resident warps per SM);
``--soft-live`` also counts, by the plain version on a strided subsample
of whole warps of each large case's rays and draws, the live spans per
warp-segment and the warp's union of live rows per span
(``MKS.live_stats``); ``--soft-excused`` runs ``chip_smoke.py``'s phase
22 comparisons of kernel 2s with its plain version under each variant
and prints how many rays each excused. ``--only stream`` builds kernel
1's grid-mode half and kernels 2 and 3 and times only the streamed cases
above, the torus of ``chip_smoke.py``'s HOUSE_SEGMENTS (5,322 triangles)
in path mode at block 64, kernel 2's large-table instance on the streamed
torus's step cotangent with ("sph", "mat", "tri"), each streamed scene's
``chunk_tables`` build (host clock, synchronised) and grid shape 1 in
direct mode at block 64 (whose instances share no code with the streamed
ones), each variant at each of ``--leaf-sizes`` (``MK.STREAM_LEAF``, the
streamed tables' leaf rows, rebuilt per size). Its harness uses only what
a tree from before the streamed tree walk has too, so a parent commit is
timed by copying this file into its checkout and running it there.
``--sass`` dumps ``cuobjdump -sass`` of the named variants' libraries
into ``--out`` and
prints, per kernel, the count of each memory, atomic, warp-level and
special-function (MUFU) opcode, and the instructions around the first
shared-memory atomic. Every build's ``ptxas -v`` report is printed.
Results also go to ``--out``/profile.json. Needs a CUDA card.
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
        *(("megakernel_soft", MKS._SIGNATURES, flags)
          for flags in MKS.SOFT_BUILDS))
SOFT_LIBS = LIBS[-len(MKS.SOFT_BUILDS):]
# kernel 1's grid-mode half (the streamed instances) and kernels 2 and 3
STREAM_LIBS = LIBS[1:4]
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
    grid-mode half, "-rr" and "-direct" for kernel 2s's builds of those
    modes."""
    soft = {MKS.SOFT_BUILDS[1]: "-rr", MKS.SOFT_BUILDS[2]: "-direct"}
    return name + ("-grid" if MK.GRID_FLAGS[0] in flags
                   else soft.get(tuple(flags), ""))


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
                      r"BSSY|BSYNC|WARPSYNC|BAR|LDC|MUFU)")
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

    def soft_tables(self) -> list:
        """The tables as the soft backward takes them: past 64 triangles
        in Morton order."""
        st = mega.soft_tri_order(self.scene, self.tables[2], self.chunks)
        return [*self.tables[:2], self.tables[2] if st is None else st.rows,
                *self.tables[3:]]

    def soft_kw(self, rr=False, direct=False) -> dict:
        kw = dict(self.kw, soft_bandwidth=EDGE_BW, soft_tau=EDGE_BW,
                  **self._rr(rr))
        return dict(kw, bounces=0, mode="direct") if direct else kw

    def k2s(self, g, wrt, rr=False, direct=False):
        t = self.soft_tables()
        return MKS.pathtrace_pass_bwd_soft(t[0], self.ipar, *t[1:], g, None,
                                           diff_wrt=wrt,
                                           **self.soft_kw(rr, direct))

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


def stream_cases(dev, house: bool = False) -> dict:
    """Kernel 1's streamed cases on chip_smoke.py's phase 21 scenes (with
    ``house`` also its torus of HOUSE_SEGMENTS, 5,322 triangles)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cases = {"torus": Case(chip_smoke._stream_scene("torus", SIZE, SIZE,
                                                    dev), dev, block=64),
             "spheres": Case(chip_smoke._stream_scene("spheres", SIZE, SIZE,
                                                      dev), dev, step=False)}
    if house:
        cases["house"] = Case(chip_smoke._stream_scene("house", SIZE, SIZE,
                                                       dev), dev, step=False,
                              block=64)
    return cases


def rechunk(cases: dict) -> None:
    """Build each case's streamed tables again (after MK.STREAM_LEAF
    changed)."""
    for c in cases.values():
        c.chunks = mega.chunk_tables(c.scene, c.cfg, c.tables[1],
                                     c.tables[2])


def chunk_build_ms(case: Case, reps: int = 10) -> float:
    """Host-clock ms of one ``chunk_tables`` call on the case's tables,
    synchronised (every streamed call builds its chunks)."""
    mega.chunk_tables(case.scene, case.cfg, case.tables[1], case.tables[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mega.chunk_tables(case.scene, case.cfg, case.tables[1],
                          case.tables[2])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def measure_stream_only(cases: dict, grid: Case) -> dict:
    """``--only stream``: kernel 1's streamed cases (``measure_stream``),
    the house-size torus at block 64, kernel 2's large-table instance on
    the streamed torus's step cotangent, the chunk build of each scene,
    and grid shape 1 in direct mode, whose instances share no code with
    the streamed ones."""
    house = cases["house"]
    out = measure_stream(cases)
    out.update({
        "k1_stream_house_path_B64_16pass_ms_per_pass": time_ms(
            lambda: house.k1(n_passes=16), reps=1, per=16),
        "k2_large_stream_torus_step_g_sph_mat_tri_ms": time_ms(
            lambda: cases["torus"].k2(cases["torus"].g,
                                      ("sph", "mat", "tri")), reps=2),
        "k1_grid_torus_direct_B64_16pass_ms_per_pass": time_ms(
            lambda: grid.direct(16), reps=5, per=16),
        **{f"chunk_build_{k}_ms": chunk_build_ms(c)
           for k, c in cases.items()}})
    return out


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


def _hold(name: str, wrt, want, got) -> None:
    """Prints cosine and max |d| over the group's scale of ``got`` against
    ``want``, per group in ``wrt``."""
    for gname, a, b in zip(MKG.DIFF_ALL, want, got):
        if gname in wrt:
            a, b = a.double().ravel(), b.double().ravel()
            cos = (a @ b).item() / max(a.norm().item() * b.norm().item(),
                                       1e-300)
            rel = ((a - b).abs().max() / a.abs().max().clamp_min(1e-300)
                   ).item()
            print(f"  k2s {name} {gname} vs the first variant: cosine "
                  f"{cos:.9f}, max|d| {rel:.3g} x scale")


def measure_soft(cornell: Case, first: dict) -> dict:
    """Kernel 2s on cornell's step cotangent (and the seeded random one).
    Each variant's cotangents are held to those of the first variant
    measured (``first``, filled on the first call): cosine and max |d|
    over the group's scale, printed, so that a variant that computes
    something else is not timed as a faster one."""
    for name, wrt in (("sph_mat", TRAIN_WRT), ("all", MKG.DIFF_ALL)):
        got = cornell.k2s(cornell.g, wrt)
        _hold(name, wrt, first.setdefault(name, got), got)
    got = cornell.k2s(cornell.g, TRAIN_WRT, rr=True)
    _hold("rr", TRAIN_WRT, first.setdefault("rr", got), got)
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


def soft_cases(dev, sizes, sphere_sizes=()) -> dict:
    """Kernel 2s's cases for ``--only soft``: cornell's path-mode and
    direct-mode steps, the streamed torus scene at each size and
    sphere_field(N_SPHERES) at each of sphere_sizes."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cases = {"cornell": Case(cornell_box(cols=SIZE, rows=SIZE, device=dev),
                             dev),
             "direct": DirectCase(cornell_box(cols=SIZE, rows=SIZE,
                                              device=dev), dev)}
    for n in sizes:
        cases[f"torus{n}"] = Case(chip_smoke._stream_scene("torus", n, n,
                                                           dev), dev, size=n)
    for n in sphere_sizes:
        cases[f"spheres{n}"] = Case(sphere_field(N_SPHERES, cols=n, rows=n,
                                                 device=dev), dev, size=n)
    return cases


LARGE_MODES = (("", {}), ("_rr", {"rr": True}), ("_direct", {"direct": True}))


def soft_live(cases: dict, blocks: int = 8, block: int = 1024) -> dict:
    """MKS.live_stats of each large case (torus, sphere_field) in each mode
    on ``blocks`` blocks of ``block`` rays spread evenly over its film."""
    out = {}
    for key, c in cases.items():
        if not key.startswith(("torus", "spheres")):
            continue
        n = c.cfg.total_rays
        step = n // blocks // 32 * 32
        spans = [(k * step, min(block, n - k * step)) for k in range(blocks)]
        t = c.soft_tables()
        for tag, mode in LARGE_MODES:
            st = MKS.live_stats(t[0], c.ipar, *t[1:], None, blocks=spans,
                                **c.soft_kw(**mode))
            out[f"{key}{tag}"] = st
            print(f"live rows, {key}{tag} (plain version, {blocks} blocks of "
                  f"{block} rays): " + json.dumps(st))
    return out


def soft_excused(dev, libs: dict, labels) -> dict:
    """Per variant, the rays that ``chip_smoke.py``'s phase 22 excuses
    when it holds kernel 2s to its plain version (the torus scene and
    sphere_field(256), with and without the roulette); a failed
    comparison counts as None."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = {}
    for label in labels:
        use(libs[label])
        counts = []
        for shape, wrt in (("torus", chip_smoke.MESH_WRT),
                           ("spheres", chip_smoke.TRAIN_WRT)):
            for rr in (False, True):
                try:
                    counts.append(chip_smoke.large_vs_plain(
                        dev, shape, True, rr, wrt)["excused"])
                except SystemExit:
                    counts.append(None)
        out[label] = counts
        print(f"{label}: phase 22 excused rays (torus, torus rr, spheres, "
              f"spheres rr) {counts}")
    return out


def measure_soft_only(cases: dict, first: dict) -> dict:
    """Kernel 2s alone: cornell (measure_soft), direct mode and the torus
    past 64 objects, each held to the first variant's cotangents."""
    out = measure_soft(cases["cornell"], first)
    d = cases["direct"]
    got = d.k2s()
    _hold("direct", TRAIN_WRT, first.setdefault("direct", got), got)
    out["k2s_direct_step_g_sph_mat_ms"] = time_ms(d.k2s, reps=5)
    for key, c in cases.items():
        if not key.startswith(("torus", "spheres")):
            continue
        for tag, mode in LARGE_MODES:
            name = f"{key}{tag}"
            got = c.k2s(c.g, TRAIN_WRT, **mode)
            _hold(name, TRAIN_WRT, first.setdefault(name, got), got)
            out[f"k2s_large_{name}_step_g_sph_mat_ms"] = time_ms(
                lambda: c.k2s(c.g, TRAIN_WRT, **mode), reps=1)
            last = MKS.last_launch()
            for k in ("registers", "local_bytes", "warps_per_sm",
                      "smem_bytes"):
                out[f"k2s_large_{name}_{k}"] = last[k]
    return out


def hold_records(key: str, cases: dict, first: dict) -> None:
    """Kernel 1's record of one pass (b5 at block 64 on the torus scenes,
    block 0 on the spheres) under this variant and leaf size against the
    first one's: the champion ids and occlusion bits that differ (any
    visiting order gives the least (t, original id) pair, so none should)
    and the accumulator's max |d|."""
    for name, c in cases.items():
        got = MK.pathtrace_pass(c.tables[0], c.ipar, *c.tables[1:],
                                torch.zeros_like(c.acc), None, record=True,
                                **c.kw, **c._mode())
        want = first.setdefault(name, got)
        n_ids = int((got[1] != want[1]).sum())
        n_occ = int((got[2] != want[2]).sum())
        d = (got[0] - want[0]).abs().max().item()
        print(f"  {key} {name} record vs the first: ids differ {n_ids} of "
              f"{got[1].numel()}, occlusion bits differ {n_occ}, max|d acc| "
              f"{d:.3g}", flush=True)


def stream_only(dev, smi: str, libs: dict, labels: list, out: Path,
                leaf_sizes: str) -> int:
    """``--only stream``: each variant at each leaf size in turns (first
    to last, then back), the leaf sizes where the package has them (a
    parent tree before the streamed tree walk has no leaves: it is timed
    at its own layout)."""
    use(libs[labels[0]])
    cases = stream_cases(dev, house=True)
    grid = grid_cases(dev)["torus"]
    leaves = ([int(n) for n in leaf_sizes.split(",") if n]
              if hasattr(MK, "STREAM_LEAF") else []) or [None]
    results: dict = {"card": smi, "turns": []}
    first: dict = {}
    for order in (labels, labels[::-1]):
        turn = {}
        for label in order:
            use(libs[label])
            for leaf in leaves:
                key = label if leaf is None else f"{label}/leaf{leaf}"
                if leaf is not None:
                    MK.STREAM_LEAF = leaf
                    rechunk(cases)
                hold_records(key, cases, first)
                turn[key] = measure_stream_only(cases, grid)
                print(f"{key}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in turn[key].items()),
                    flush=True)
        results["turns"].append(turn)
    (out / "profile.json").write_text(json.dumps(results, indent=1))
    print(f"card: [{smi}]")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL=CSRC_DIR (repeatable; default the package's "
                         "csrc/ as 'tree')")
    ap.add_argument("--sass", action="append", default=[],
                    help="dump the SASS of this variant's libraries")
    ap.add_argument("--out", default=str(BUILD / "out"))
    ap.add_argument("--only", choices=("all", "soft", "stream"),
                    default="all",
                    help="soft: build and time kernel 2s alone; stream: "
                         "kernel 1's streamed cases, kernel 2's streamed "
                         "step and grid shape 1's direct mode alone")
    ap.add_argument("--leaf-sizes", default="",
                    help="with --only stream: the streamed tables' leaf "
                         "sizes to time each variant at (MK.STREAM_LEAF; "
                         "default the package's)")
    ap.add_argument("--soft-large-sizes", default="256",
                    help="with --only soft: film sizes of the torus case")
    ap.add_argument("--soft-sphere-sizes", default="",
                    help="with --only soft: film sizes of the "
                         "sphere_field(1024) case past 64 objects")
    ap.add_argument("--soft-live", action="store_true",
                    help="with --only soft: the plain version's count of "
                         "the large cases' live rows per warp")
    ap.add_argument("--soft-excused", action="store_true",
                    help="with --only soft: phase 22's excused rays per "
                         "variant")
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
    libs_used = {"all": LIBS, "soft": SOFT_LIBS,
                 "stream": STREAM_LIBS}[args.only]
    jobs = [(label, src, *lib) for label, src in variants
            for lib in libs_used if (src / f"{lib[0]}.cu").exists()]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    libs: dict = {}
    ptxas = []
    for (label, _, name, _, flags), (lib, log) in zip(jobs, built):
        libs.setdefault(label, {})[_stem(name, flags)] = lib
        for line in log.splitlines():
            if re.search(r"registers|spill|stack|Compiling entry", line):
                ptxas.append(f"  ptxas {label}/{_stem(name, flags)}: "
                             f"{line.strip()}")
    print("\n".join(ptxas))
    (out / "ptxas.txt").write_text("\n".join(ptxas) + "\n")
    print(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.2f} s")
    for label in args.sass:
        for name, _, flags in libs_used:
            sass_summary(label, _stem(name, flags), out)

    labels = [label for label, _ in variants]
    if args.only == "soft":
        # the other kernels come from the package's own csrc
        for label in labels:
            libs[label] = {_stem(name, flags): libs[label][_stem(name, flags)]
                           for name, _, flags in SOFT_LIBS}
        use(libs[labels[0]])
        cases = soft_cases(dev, [int(n) for n in
                                 args.soft_large_sizes.split(",") if n],
                           [int(n) for n in
                            args.soft_sphere_sizes.split(",") if n])
        results: dict = {"card": smi, "turns": []}
        if args.soft_live:
            results["live"] = soft_live(cases)
        first: dict = {}
        for order in (labels, labels[::-1]):
            turn = {}
            for label in order:
                use(libs[label])
                print(f"{label}:")
                turn[label] = measure_soft_only(cases, first)
                print(f"{label}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in turn[label].items()))
            results["turns"].append(turn)
        if args.soft_excused:
            results["excused"] = soft_excused(dev, libs, labels)
        (out / "profile.json").write_text(json.dumps(results, indent=1))
        print(f"card: [{smi}]")
        return 0
    if args.only == "stream":
        return stream_only(dev, smi, libs, labels, out, args.leaf_sizes)
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
