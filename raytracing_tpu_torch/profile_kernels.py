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
``--only grid`` does the same for kernel 1's grid mode: the grid cases
above (shape 1 direct at blocks 64 and 0, shape 2 path at blocks 64 and
0, with the roulette and recording, shape 3 path and recording), kernel 3
on both records, kernel 2's large-table instance on each grid scene's
step cotangent and each scene's grid-mode arguments' build (the cell-major
copies' gather, host clock, synchronised), each variant at each of
``--leaf-sizes`` (``MK.GRID_LEAF``), each variant's records held to the
first's; a parent commit before the copies is timed from its own checkout
with this file copied in (its ``grid_tables`` takes the scene alone).
``--only large`` times this checkout alone (a parent commit is timed by
copying this file into its checkout and running it there): kernel 2
past 64 objects per type through its wrapper, the record it differentiates
(kernel 1's ``--fmad=false`` build; where the package has
``MKG._record`` its own, over the rays with g != 0, and beside it every
ray's) and kernel 3 on that record, on sphere_field(1024), the streamed
torus (block 64), the torus in its mesh grid (block 64) and
sphere_field(8192) in its sphere grid, in path mode, with the roulette
and in direct mode, each on its step's cotangent; the rows that must not
move (kernel 2 on cornell's step, kernel 3 on the cell route's record,
kernel 1's passes); ``chip_smoke.py`` phase 22's "pallas" steps; and
each launch's grid, registers, shared memory and blocks per SM from
``torch.profiler``'s trace; with ``--bounds`` each scene's bound
(``k2_large_bound``), which ``--only grid`` prints for its two scenes.
``--only hit`` times this checkout alone (a parent commit is timed by
copying this file and ``chip_smoke.py`` into its checkout and running it
there): kernels 4 and 5 (the stage pipeline's searches; ``--hit-kernels``
picks them) in each configuration, the brute loop and the tree walk at
each of ``--leaf-sizes`` (``HK.SPHERE_LEAF``, ``HK.TRIANGLE_LEAF``):
kernel 4 on ``chip_smoke.py`` phase 8's rays over sphere_field(1024) and
sphere_field(4096), on the same rays over small fields (where the brute
loop and the walk cross) and on the 12 searches of one stage pass on
sphere_field(1024) at 1024^2 b5 as phase 9 records them (their sum is the
kernel's time per pass); kernel 5 on phase 8's rays over its soup of 4096
triangles (single- and two-sided) and over soups of 8-512, and on the 12
searches of one stage pass on the torus scene (1,002 triangles) at 1024^2
b5 as phase 24 records them, over the whole table and over its first
8-512 rows; each held to the brute loop's results, then the sizes where
the brute loop and the walks cross; each stage-pass tree's build (device
time by torch.profiler, the torch build's host time after a warm-up);
kernel 5 on cornell's 10, kernel 1's cornell pass and the stage passes of
phases 9, 10 and 24 (with ``torch.profiler``'s splits), and the
instances' and the builds' registers and spills.
``--only champ`` times kernel 3 of each variant (sources with the
package's C interface) in every case the main path runs it, each step's
record and cotangent at 1024^2 b5: the torus scene's grid and streamed
records with ("sph", "mat", "tri"), sphere_field(1024) and its roulette
step, the sphere grid, direct mode on cornell and sphere_field(1024),
cornell with all five groups and ``chip_smoke.py`` phase 22's two sweeps
(``champ_cases``); beside them each variant's kernel 2 on cornell's step,
each case's device time, ``chip_smoke.py``'s train steps that run kernel
3 (``champ_steps``, timed first, before any case, so that every
checkout times them after the same work), the hot rows' build and the
plain count of each case's adds; where the package has kernel 3's ray
order (``MKG.champ_order``), the order's own device time per case, the
order held to its plain version and the plain count of the warps'
segments in ray order and in the order (``MKG.champ_warp_work``); a
parent commit from before the hot rows or the order is timed by copying
this file into its checkout and running it there.
``--only direct`` times this checkout alone (a parent commit is timed by
copying this file into its checkout and running it there): kernel 1's
direct mode at 1024^2 spp 1 on sphere_field(64, 128, 160, 192, 224, 256,
512, 1024, 4608) and cornell, one recording pass and 16-pass launches,
through the package's route (past ``MK.SPH_BRUTE_MAX["direct"]``
spheres
the sphere tree, its build included), forced to the brute loop, and
forced to the walk, in two turns, each record held to the first's bit
for bit (another walk is timed from a copy of the tree under
``build/<name>/`` with this file copied in); one route call's kernels on
sphere_field(1024) and (4608) as torch.profiler's trace times them (the
build, then the walk), the build wrapper's host time and the torch
build's; kernels 2 and 3 on the direct step cotangents of sphere_field(1024) (row 2d's record and sweep)
and cornell; ``chip_smoke.py`` phase 23's direct train steps on
sphere_field(1024) (cell and "pallas" routes, host clock); the direct
instances' ptxas lines. ``--only direct-steps`` times those steps alone,
so that one call can alternate a parent and a change several times.
``--only path`` does the same for kernel 1's path mode at 1024^2 b5 on
the fields of ``--path-fields`` (default sphere_field(128-4608)) and
cornell: one recording pass (row 1s's shape) and 16-pass launches per
configuration (the package's route, past ``MK.SPH_BRUTE_MAX["path"]``
spheres the sphere tree with its build included; forced to the brute
loop; forced to the walk), on sphere_field(256, 1024, 4608) and cornell
also the one-pass launch and the roulette, recording and not, in two
turns, each record held to the first configuration's bit for bit; first
the cell and "pallas" train steps on sphere_field(1024) (host clock,
median of 7); kernel 2′'s record and whole split on that field's step
cotangent; one route call's kernels as torch.profiler's trace times them
(the build, then the walk); the path instances' ptxas lines. A parent is
timed by copying this file into its checkout; another walk or
``__launch_bounds__`` from a copy of the package under ``build/<name>/``
with its ``csrc/`` edited, run from there.
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
import inspect
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
from .ops import hit_kernels as HK
from .ops import megakernel as MK
from .ops import megakernel_grad as MKG
from .ops import megakernel_soft as MKS
from .render import mega
from .render import pathtracer as pt
from .core.config import RenderConfig
from .core.types import replace

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
# kernel 1's grid-mode half (the grid and streamed instances) and kernels
# 2 and 3
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


def _grid_tables(scene, tables):
    """Kernel 1's grid-mode arguments with their cell-major copies of the
    tables (a tree from before the copies builds them from the scene
    alone)."""
    try:
        return mega.grid_tables(scene, tables[1], tables[2])
    except TypeError:
        return mega.grid_tables(scene)


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
        self.block = block
        self.tables = mega.scene_tables(scene, self.cfg)
        self.grid = _grid_tables(scene, self.tables) if grid else None
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


def grid_cases(dev, step: bool = False) -> dict:
    """Kernel 1's grid-mode cases on chip_smoke.py's phase 18 scenes (the
    torus mesh is the smoke script's, not the package's); with ``step``
    the torus's training step too."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return {"torus": Case(chip_smoke._grid_scene("torus", SIZE, SIZE, dev),
                          dev, step=step, grid=True, block=64),
            "spheres": Case(chip_smoke._grid_scene("spheres", SIZE, SIZE,
                                                   dev), dev, grid=True)}


def regrid(cases: dict) -> None:
    """Build each case's grid-mode arguments again (after the cells' leaf
    sizes changed)."""
    for c in cases.values():
        c.grid = _grid_tables(c.scene, c.tables)


def grid_build_ms(case: Case, reps: int = 10) -> float:
    """Host-clock ms of one ``grid_tables`` call on the case's tables
    (the cell-major copies' gather; their layout is cached), synchronised
    (every grid-mode call builds them)."""
    _grid_tables(case.scene, case.tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _grid_tables(case.scene, case.tables)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def measure_grid_only(cases: dict) -> dict:
    """``--only grid``: kernel 1's grid cases (``measure_grid``), the torus
    path pass at block 0 and with the roulette, kernel 3 on the torus's
    record with ("sph", "mat", "tri"), kernel 2's large-table instance on
    each grid scene's step cotangent (its replay walks the same cells),
    and each scene's grid-mode arguments' build."""
    torus, spheres = cases["torus"], cases["spheres"]
    out = measure_grid(cases)
    out.update({
        "k1_grid_torus_path_B0_16pass_ms_per_pass": time_ms(
            lambda: MK.pathtrace_pass(
                torus.tables[0], torus.ipar, *torus.tables[1:], torus.acc,
                None, n_passes=16, **torus.kw, **torus._mode(block=0)),
            reps=2, per=16),
        "k1_grid_torus_rr_B64_16pass_ms_per_pass": time_ms(
            lambda: torus.k1(n_passes=16, rr=True), reps=2, per=16),
        "k3_grid_torus_step_g_sph_mat_tri_ms": time_ms(
            lambda: torus.k3(torus.g, ("sph", "mat", "tri"))),
        "k2_large_grid_torus_step_g_sph_mat_tri_ms": time_ms(
            lambda: torus.k2(torus.g, ("sph", "mat", "tri")), reps=2),
        "k2_large_grid_spheres_step_g_sph_mat_ms": time_ms(
            lambda: spheres.k2(spheres.g, TRAIN_WRT), reps=2),
        **{f"grid_build_{k}_ms": grid_build_ms(c) for k, c in cases.items()}})
    return out


def grid_only(dev, smi: str, libs: dict, labels: list, out: Path,
              leaf_sizes: str) -> int:
    """``--only grid``: each variant at each leaf size of the mesh grid's
    cell trees (``MK.GRID_LEAF``) in turns (first to last, then back),
    each variant's records held to the first's (a parent tree before the
    cell-major copies is timed at its own layout)."""
    use(libs[labels[0]])
    cases = grid_cases(dev, step=True)
    leaves = ([int(n) for n in leaf_sizes.split(",") if n]
              if hasattr(MK, "GRID_LEAF") else []) or [None]
    results: dict = {"card": smi, "turns": [], "k2_large_bounds": {
        f"grid_{key}": k2_large_bound(dev, f"grid_{key}", c,
                                      MESH_WRT if key == "torus"
                                      else TRAIN_WRT)
        for key, c in cases.items()}}
    first: dict = {}
    for order in (labels, labels[::-1]):
        turn = {}
        for label in order:
            use(libs[label])
            for leaf in leaves:
                key = label if leaf is None else f"{label}/leaf{leaf}"
                if leaf is not None:
                    MK.GRID_LEAF = leaf
                    regrid(cases)
                hold_records(key, cases, first)
                turn[key] = measure_grid_only(cases)
                print(f"{key}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in turn[key].items()),
                    flush=True)
        results["turns"].append(turn)
    (out / "profile.json").write_text(json.dumps(results, indent=1))
    print(f"card: [{smi}]")
    return 0


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


# --only large: kernel 2 past 64 objects and the launches of its two pieces
EXACT = ("--fmad=false",)     # kernel 1's uncontracted build (the record's)
MESH_WRT = ("sph", "mat", "tri")
LARGE_SPECS = (("megakernel", MK._SIGNATURES, ()),
               ("megakernel", MK._SIGNATURES, MK.GRID_FLAGS),
               ("megakernel", MK._SIGNATURES, EXACT),
               ("megakernel", MK._SIGNATURES, EXACT + MK.GRID_FLAGS),
               ("megakernel_grad", MKG._SIGNATURES, MKG.ADJ_FLAGS),
               ("megakernel_champ", MKG._CHAMP_SIGNATURES, MKG.ADJ_FLAGS))
THREADS_PER_SM = 2048


class LargeCase:
    """Kernel 2's route past 64 objects on one scene at SIZE^2 (b5 in path
    mode and with the roulette, one segment in direct mode): the step
    cotangent of the pass (``Case``'s in path mode, the gradient of
    mean((acc / L)^2) of the direct pass in direct mode), and the three
    pieces it is timed as: (a) ``MKG.pathtrace_pass_bwd``, (b) kernel 1's
    --fmad=false recording launch over the forward's own grid, chunks and
    block (where the package has ``MKG._record``, the split's own, which
    traces only the rays with g != 0; else every ray), (c) kernel 3 on
    that record."""

    def __init__(self, scene, dev, wrt, grid: bool = False, block: int = 0):
        self.case = Case(scene, dev, grid=grid, block=block)
        self.wrt = wrt
        c = self.case
        # the forward's arguments that kernel 2 takes (a tree before the
        # record takes no block)
        takes_block = "block" in inspect.signature(
            MKG.pathtrace_pass_bwd).parameters
        self.fwd = {k: v for k, v in c._mode().items()
                    if k != "block" or takes_block}
        self.key = MK.pass_key_of(c.ipar, c.cfg.seed)
        zeros = torch.zeros_like(c.acc)
        acc = MK.direct_pass(*c.tables, zeros, None, key=self.key, spp=1,
                             width=SIZE, two_sided=False, **c._mode())
        acc = acc.clone().requires_grad_(True)
        loss = torch.mean((acc / scene.lights.count) ** 2)
        self.g = {"path": c.g, "rr": c.g,
                  "direct": torch.autograd.grad(loss, acc)[0].contiguous()}

    def kw(self, mode: str) -> dict:
        c = self.case
        kw = dict(c.kw, **c._rr(mode == "rr"))
        return dict(kw, bounces=0, mode="direct") if mode == "direct" else kw

    def k2(self, mode: str):
        c = self.case
        return MKG.pathtrace_pass_bwd(c.tables[0], c.ipar, *c.tables[1:],
                                      self.g[mode], None, diff_wrt=self.wrt,
                                      **self.kw(mode), **self.fwd)

    def record(self, mode: str):
        c = self.case
        if hasattr(MKG, "_record"):
            # the split's own record launch: the rays with g != 0 only
            kw = {"russian_roulette": False, "rr_start_depth": 0,
                  "mode": "path", **self.kw(mode)}
            return (None, *MKG._record(c.tables[0], c.ipar, *c.tables[1:],
                                       self.g[mode], None, grid=c.grid,
                                       chunks=c.chunks, block=c.block
                                       if c._mode() else 0, **kw))
        return self.record_all(mode)

    def record_all(self, mode: str):
        """kernel 1's --fmad=false record of every ray of the pass"""
        c = self.case
        zeros = torch.zeros_like(c.acc)
        if mode == "direct":
            return MK.direct_pass(*c.tables, zeros, None, key=self.key,
                                  spp=1, width=SIZE, two_sided=False,
                                  record=True, build_flags=EXACT,
                                  **c._mode())
        return MK.pathtrace_pass(c.tables[0], c.ipar, *c.tables[1:], zeros,
                                 None, record=True, build_flags=EXACT,
                                 **c.kw, **c._rr(mode == "rr"), **c._mode())

    def k3(self, mode: str, rec):
        c = self.case
        return MKG.pathtrace_pass_bwd_champ(
            c.tables[0], c.ipar, *c.tables[1:], self.g[mode], None, rec[1],
            rec[2], diff_wrt=self.wrt, **self.kw(mode))


def split_cases(dev) -> dict:
    """--only large's scenes: sphere_field(N_SPHERES) (resident spheres,
    kernel 1's 8-row loop), the streamed torus scene at block 64, the same
    torus in its mesh grid at block 64, and sphere_field(8192) in its
    sphere grid (chip_smoke.py's phases 21 and 18)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return {
        "spheres1024": LargeCase(sphere_field(N_SPHERES, cols=SIZE,
                                              rows=SIZE, device=dev), dev,
                                 TRAIN_WRT),
        "stream_torus": LargeCase(chip_smoke._stream_scene(
            "torus", SIZE, SIZE, dev), dev, MESH_WRT, block=64),
        "grid_torus": LargeCase(chip_smoke._grid_scene(
            "torus", SIZE, SIZE, dev), dev, MESH_WRT, grid=True, block=64),
        "grid_spheres": LargeCase(chip_smoke._grid_scene(
            "spheres", SIZE, SIZE, dev), dev, TRAIN_WRT, grid=True)}


def _agree(want, got, wrt) -> str:
    """cosine and max |d| over the group's scale, per group in wrt."""
    parts = []
    for name, a, b in zip(MKG.DIFF_ALL, want, got):
        if name in wrt and a.numel():
            a, b = a.double().ravel(), b.double().ravel()
            cos = (a @ b).item() / max(a.norm().item() * b.norm().item(),
                                       1e-300)
            rel = ((a - b).abs().max() / a.abs().max().clamp_min(1e-300)
                   ).item()
            parts.append(f"{name} cos {cos:.7f} max|d| {rel:.3g}")
    return ", ".join(parts)


def launch_shapes(fn, out: Path) -> list:
    """The kernels of one call of ``fn`` as torch.profiler's CUPTI trace
    reports them: name, grid, block, registers per thread, shared memory
    and the blocks per SM the card keeps resident (the trace's est.
    achieved occupancy, from CUDA's occupancy calculator, in blocks of the
    launch's threads; 0 where the calculator is not given the launch's
    opt-in shared memory) beside the grid's blocks per SM (what
    ``fit_grid`` launches for a grid-stride kernel: the resident blocks
    per SM); torch's own fills and copies are left out. Empty where the
    trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = []
    for e in json.loads(path.read_text()).get("traceEvents", []):
        a = e.get("args", {})
        if e.get("cat") != "kernel" or "at::" in e.get("name", ""):
            continue
        threads = int(np.prod(a.get("block", [0])))
        occ = a.get("est. achieved occupancy %")
        shapes.append({
            "name": re.sub(r"\(.*", "", e["name"])[-70:],
            "us": e.get("dur"), "grid": a.get("grid"), "block": threads,
            "registers": a.get("registers per thread"),
            "smem": a.get("shared memory"), "occupancy_pct": occ,
            "blocks_per_sm": (None if occ is None or not threads
                              else occ / 100 * THREADS_PER_SM / threads),
            "grid_per_sm": int(np.prod(a.get("grid", [0]))) / sms})
    return shapes


def k2_large_bound(dev, key: str, case: Case, wrt) -> dict:
    """Kernel 2 past 64 objects' bound on ``case``'s step cotangent (path
    b5), as ``chip_smoke.py`` phase 22 prices it: the record's count over
    the rays with g != 0 (kernel 1's brute loops, or the smaller of the
    streamed tables' Morton and tree counts or of the grids' march and
    cell-walk counts, as phases 21 and 17 count them with the plain
    version at SMALL_W x SMALL_H, scaled to the live rays) plus the sweep's
    own operations; bytes: 12 per ray, the tables (and the chunks' or
    grids' arrays) twice, and the record, (4 + L) B per segment, written
    and read."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    t = case.tables
    n_s, n_t, n_l = t[1].shape[0], t[2].shape[0], t[4].shape[0]
    _, ids, occs = MK.pathtrace_pass(t[0], case.ipar, *t[1:],
                                     torch.zeros_like(case.acc), None,
                                     record=True, build_flags=EXACT,
                                     **case.kw, **case._mode())
    live = (case.g != 0).any(-1)
    w = S._pass_work(ids, occs, n_l, n_s, live)
    scale = (live.double().mean().item() * case.acc.shape[0]
             / (S.SMALL_W * S.SMALL_H))
    shape = "torus" if "torus" in key else "spheres"
    if case.grid is not None:
        work = S.grid_vs_plain(dev, shape, "path")["work"]
        ops = min(S._grid_ops(w, S._scaled(work[o], scale), case.grid, n_s,
                              n_l, False) for o in work)
        nbytes = S._grid_bytes(t, case.grid)
    elif case.chunks is not None:
        work = S.stream_vs_plain(dev, shape, "path")["work"]
        ops = min(S._stream_ops(w, S._scaled(work[o], scale), case.chunks,
                                n_s, n_t, n_l, False) for o in work)
        nbytes = S._stream_bytes(t, case.chunks)
    else:
        ops = S._k1_ops(w, n_s, n_t, n_l)
        nbytes = S._table_bytes(t)
    ops += S._adj_ops(w, wrt)
    bound = S._bound(ops, 12 * case.acc.shape[0] + 2 * nbytes
                     + 2 * (4 + n_l) * ids.numel())
    print(f"kernel 2 past 64 objects, {key} step g wrt {list(wrt)}: bound "
          f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}; "
          f"{ops / max(w['rays'], 1):.6g} FP32 operations per live ray, "
          f"{w['rays']} live rays)", flush=True)
    return bound


def measure_large_only(cases: dict, others: dict) -> dict:
    """(a) kernel 2 past 64 objects through its wrapper, (b) kernel 1's
    --fmad=false record of the same pass, (c) kernel 3 on that record, per
    case and mode, CUDA events; each case's (a) held to (c) (in a tree
    whose kernel 2 replays inside its sweep the two are different kernels
    that must agree to float tolerance). Then the rows this route must
    not move: kernel 2 at 64 objects (cornell's step cotangent), kernel 3
    on sphere_field(N_SPHERES)'s default-build record (the cell route) and
    kernel 1's passes."""
    out = {}
    for key, c in cases.items():
        for mode in ("path", "rr", "direct"):
            rec = c.record(mode)
            print(f"  {key} {mode}: kernel 2 vs kernel 3 on the record: "
                  + _agree(c.k3(mode, rec), c.k2(mode), c.wrt), flush=True)
            out[f"k2_large_{key}_{mode}_ms"] = time_ms(lambda: c.k2(mode))
            out[f"k1_exact_record_{key}_{mode}_ms"] = time_ms(
                lambda: c.record(mode))
            out[f"k1_exact_record_all_rays_{key}_{mode}_ms"] = time_ms(
                lambda: c.record_all(mode))
            out[f"k3_on_record_{key}_{mode}_ms"] = time_ms(
                lambda: c.k3(mode, rec))
    cornell, spheres = others["cornell"], cases["spheres1024"].case
    grid_t, stream_t = cases["grid_torus"].case, cases["stream_torus"].case
    out.update({
        "k2_cornell_step_g_sph_mat_ms": time_ms(
            lambda: cornell.k2(cornell.g, TRAIN_WRT)),
        "k3_spheres_step_g_sph_mat_ms": time_ms(
            lambda: spheres.k3(spheres.g, TRAIN_WRT)),
        "k1_cornell_16pass_ms_per_pass": time_ms(
            lambda: cornell.k1(n_passes=16), reps=5, per=16),
        "k1_spheres1024_16pass_ms_per_pass": time_ms(
            lambda: spheres.k1(n_passes=16), reps=2, per=16),
        "k1_grid_torus_path_B64_16pass_ms_per_pass": time_ms(
            lambda: grid_t.k1(n_passes=16), reps=2, per=16),
        "k1_stream_torus_path_B64_16pass_ms_per_pass": time_ms(
            lambda: stream_t.k1(n_passes=16), reps=2, per=16),
        "k1_spheres1024_record_ms": time_ms(
            lambda: spheres.k1(record=True), reps=5)})
    return out


def large_steps(dev, smi: str) -> dict:
    """chip_smoke.py phase 22's "pallas" train steps (kernel 1, then
    kernel 2 past 64 objects): sphere_field(N_SPHERES) with ("sph", "mat")
    and the streamed torus scene with ("sph", "mat", "tri") at SIZE^2 b5,
    LARGE_STEPS timed steps after a warm-up, median ms."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = {}
    for shape, wrt in (("spheres1024", TRAIN_WRT), ("torus", MESH_WRT)):
        scene = chip_smoke._large_scene(shape, SIZE, SIZE, dev)
        cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES,
                           use_megakernel=True, mega_grad_wrt=wrt,
                           mega_bwd_impl="pallas")
        step = chip_smoke._large_step(scene, cfg, dev, chip_smoke
                                      ._large_params(scene, shape == "torus"))
        state, _, _ = step(pt.init_state(cfg, dev))
        torch.cuda.synchronize()
        times = []
        for _ in range(chip_smoke.LARGE_STEPS):
            t0 = time.perf_counter()
            state, _, _ = step(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"pallas_step_{shape}_ms"] = sorted(times)[len(times) // 2]
    return out


def large_only(dev, smi: str, out: Path, bounds: bool) -> int:
    """``--only large``: this checkout's kernels (a parent commit is timed
    by copying this file into its checkout and running it there): the
    builds, then measure_large_only, the "pallas" steps and each piece's
    launches (launch_shapes); with ``bounds`` each scene's bound
    (k2_large_bound) first."""
    t0 = time.perf_counter()
    _build.load_all(LARGE_SPECS)
    print(f"built {len(LARGE_SPECS)} libraries at once in "
          f"{time.perf_counter() - t0:.2f} s")
    for (name, flags), b in sorted(_build.build_log.items()):
        print(f"  nvcc {name} {' '.join(flags)}: {b['seconds']:.2f} s")
        for line in b["ptxas"].splitlines():
            if re.search(r"registers|spill", line):
                print(f"    ptxas {name}: {line.strip()}")
    cases = split_cases(dev)
    others = {"cornell": Case(cornell_box(cols=SIZE, rows=SIZE, device=dev),
                              dev)}
    results = {"card": smi, "bounds": {
        key: k2_large_bound(dev, key, c.case, c.wrt)
        for key, c in cases.items()} if bounds else {}}
    results["times"] = measure_large_only(cases, others)
    results["times"].update(large_steps(dev, smi))
    print("times: " + ", ".join(f"{k} {v:.6g}"
                                for k, v in results["times"].items()))
    shapes = {}
    for key, c in cases.items():
        for mode in ("path", "rr", "direct"):
            rec = c.record(mode)
            for piece, fn in (("k2", lambda: c.k2(mode)),
                              ("record", lambda: c.record(mode)),
                              ("k3", lambda: c.k3(mode, rec))):
                shapes[f"{key} {mode} {piece}"] = launch_shapes(fn, out)
                print(f"launches {key} {mode} {piece}: "
                      f"{json.dumps(shapes[f'{key} {mode} {piece}'])}")
    results["launches"] = shapes
    (out / "profile.json").write_text(json.dumps(results, indent=1))
    print(f"card: [{smi}]")
    return 0


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


# --only hit: kernel 4 (the stage pipeline's sphere search) and its
# neighbours on the stage route
HIT_FIELDS = (64, 128, 192, 256, 384, 512)   # the brute / tree split
HIT_SPEC = ("hit_kernels", HK._SIGNATURES, ())


def _hit_configs(leaf_sizes: str) -> list:
    """(label, HK attributes) of each kernel-4 configuration: the brute
    loop on every table, then the tree walk at each leaf size (a tree from
    before the tree instance has the brute loop alone)."""
    if not hasattr(HK, "sphere_tree"):
        return [("brute", {})]
    leaves = [int(n) for n in leaf_sizes.split(",") if n] or [1, 2, 4]
    return [("brute", {"SPHERE_BRUTE_MAX": 1 << 30})] + [
        (f"tree/leaf{leaf}", {"SPHERE_BRUTE_MAX": 0, "SPHERE_LEAF": leaf})
        for leaf in leaves]


def _hit_cases(dev) -> dict:
    """name -> (rays, rows): chip_smoke.py phase 8's rays on
    sphere_field(N_SPHERES) and sphere_field(BIG_SPHERES), and the 12
    searches of one stage pass on sphere_field(N_SPHERES) at SIZE^2 b5
    (camera rays, then each segment's shadow and bounce rays, in pixel
    order) as chip_smoke.py's phase 9 records them; then for the brute /
    tree split each field of HIT_FIELDS on phase 8's rays and its own
    stage pass's searches."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    def rows_of(n):
        sp = sphere_field(n, device=dev).spheres
        return HK.sphere_rows(sp.center, sp.radius, sp.mask)

    def stage(n):
        scene = sphere_field(n, cols=SIZE, rows=SIZE, device=dev)
        cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES,
                           use_pallas=True)
        return [(list(args[:4]), args[4])
                for args, _ in cs._stage_searches(scene, cfg, dev)]

    rays = cs._seeded_rays(dev, cs.HIT_RAYS, cs.HIT_SEED, -6.0, 6.0)
    cases = {f"phase8 {N_SPHERES}": (rays, rows_of(N_SPHERES)),
             f"phase8 {cs.BIG_SPHERES}": (
                 cs._seeded_rays(dev, cs.BIG_RAYS, cs.HIT_SEED + 3, -6.0,
                                 6.0), rows_of(cs.BIG_SPHERES))}
    cases.update({f"stage{N_SPHERES} {k}": c
                  for k, c in enumerate(stage(N_SPHERES))})
    for n in HIT_FIELDS:
        cases[f"phase8 {n}"] = (rays, rows_of(n))
        cases.update({f"stage{n} {k}": c for k, c in enumerate(stage(n))})
    return cases


def _stage_pass(dev) -> dict:
    """chip_smoke.py phases 9, 10 and 24's stage passes: sphere_field(
    N_SPHERES), cornell and the torus scene at SIZE^2 b5, ms per one-pass
    call (host clock, synchronised, the median of 5 after a warm-up) and
    torch.profiler's split of one sphere_field pass and one torus pass."""
    import chip_smoke as cs
    out = {}
    for name, scene in (("spheres", sphere_field(N_SPHERES, cols=SIZE,
                                                 rows=SIZE, device=dev)),
                        ("cornell", cornell_box(cols=SIZE, rows=SIZE,
                                                device=dev)),
                        ("torus", cs._stream_scene("torus", SIZE, SIZE,
                                                   dev))):
        cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES,
                           use_pallas=True)
        state = pt.render_passes(scene, pt.init_state(cfg, dev), cfg, 1)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = pt.render_passes(scene, state, cfg, 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"stage_pass_{name}_ms"] = sorted(times)[2]
        if name != "cornell":
            split = cs._profile_split(
                lambda: pt.render_passes(scene, state, cfg, 1))
            print(f"  stage pass {name}: {split}")
    return out


def measure_hit(cases: dict, configs: list, first: dict) -> dict:
    """Each kernel-4 configuration on each case (CUDA events, REPS
    launches after one, each with the tree built once beforehand, as the
    stage pass does), each result held to the first result of its case
    (the brute loop's, bit for bit); per stage pass the 12 searches' sum
    (``stage<n>``); each tree's build (host clock, synchronised)."""
    out = {}
    defaults = {k: getattr(HK, k) for _, attrs in configs for k in attrs}
    for label, attrs in configs:
        for k, v in {**defaults, **attrs}.items():
            setattr(HK, k, v)
        trees = {}
        for name, (rays, rows) in cases.items():
            tree = None
            if (hasattr(HK, "sphere_tree")
                    and rows.shape[0] > HK.SPHERE_BRUTE_MAX):
                if id(rows) not in trees:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trees[id(rows)] = HK.sphere_tree(rows)
                    torch.cuda.synchronize()
                    out[f"{label} tree_build_ms {rows.shape[0]}"] = (
                        time.perf_counter() - t0) * 1e3
                tree = trees[id(rows)]
            args = (*rays, rows) + ((tree,) if tree is not None else ())
            got = HK.sphere_search_rows(*args)
            want = first.setdefault(name, got)
            bad = int((got[1] != want[1]).sum() + (got[0] != want[0]).sum())
            if bad:
                print(f"  {label} {name}: {bad} values differ from the "
                      "first result's")
            key = name.split(" ")[0]
            ms = time_ms(lambda: HK.sphere_search_rows(*args))
            if key.startswith("stage"):
                out[f"{label} {key}"] = out.get(f"{label} {key}", 0.0) + ms
            else:
                out[f"{label} {name}"] = ms
    for k, v in defaults.items():
        setattr(HK, k, v)
    return out


# kernel 5: the brute / tree split over tables of these many rows
TRI_SPLIT = (8, 10, 12, 14, 16, 32, 64, 128, 256, 512)


def _tri_configs(leaf_sizes: str) -> list:
    """(label, HK attributes) of each kernel-5 configuration: the brute
    loop on every table, then the tree walk at each leaf size (a tree from
    before the tree instance has the brute loop alone)."""
    if not hasattr(HK, "triangle_tree"):
        return [("brute", {})]
    leaves = [int(n) for n in leaf_sizes.split(",") if n] or [1, 2, 4]
    return [("brute", {"TRIANGLE_BRUTE_MAX": 1 << 30})] + [
        (f"tree/leaf{leaf}", {"TRIANGLE_BRUTE_MAX": 0, "TRIANGLE_LEAF": leaf})
        for leaf in leaves]


def _tri_cases(dev) -> dict:
    """name -> (rays, v, rows, two_sided) of kernel 5: chip_smoke.py phase
    8's rays over its soup of SOUP_TRIANGLES (single- and two-sided) and
    the 12 searches of one stage pass on the torus scene (cornell plus
    the 992-face torus, 1,002 triangles) at SIZE^2 b5 as chip_smoke.py's
    phase 24 records them; for the brute / tree split, phase 8's rays over
    a soup of each size of TRI_SPLIT and the pass's searches over the
    table's first rows of each size (cornell's walls and a strip of the
    torus)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    from raytracing_tpu_torch.render import stages
    rays = cs._seeded_rays(dev, cs.HIT_RAYS, cs.HIT_SEED, -6.0, 6.0)

    def soup(n, seed):
        t = cs._soup(n, seed).to(dev)
        return t.v, HK.triangle_rows(t.v, t.mask)

    v, rows = soup(cs.SOUP_TRIANGLES, cs.HIT_SEED + 1)
    cases = {f"soup{cs.SOUP_TRIANGLES} {ts}": (rays, v, rows, ts)
             for ts in (False, True)}
    scene = cs._stream_scene("torus", SIZE, SIZE, dev)
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES,
                       use_pallas=True)
    tris = stages._all_triangles(scene)
    searches = [(list(args[:4]), args[5])
                for args, _ in cs._stage_searches(scene, cfg, dev,
                                                  "triangle_search_rows")]
    for n in (*TRI_SPLIT, tris.count):
        tv = tris.v[:n].contiguous()
        trows = HK.triangle_rows(tv, tris.mask[:n])
        cases.update({f"torus{n} {k}": (r, tv, trows, ts)
                      for k, (r, ts) in enumerate(searches)})
    for n in TRI_SPLIT:
        cases[f"soup{n} False"] = (rays, *soup(n, cs.HIT_SEED + 1), False)
    return cases


def measure_tri(cases: dict, configs: list, first: dict) -> dict:
    """Each kernel-5 configuration on each case (CUDA events, REPS
    launches after one, each table's tree built once beforehand as the
    stage pass builds it), each result held to the first result of its
    case (the brute loop's, bit for bit); per stage pass the 12 searches'
    sum (``torus<n>``)."""
    out = {}
    defaults = {k: getattr(HK, k) for _, attrs in configs for k in attrs}
    for label, attrs in configs:
        for k, v in {**defaults, **attrs}.items():
            setattr(HK, k, v)
        trees = {}
        for name, (rays, v, rows, ts) in cases.items():
            tree = ()
            if hasattr(HK, "pass_triangle_tree"):
                if id(rows) not in trees:
                    trees[id(rows)] = HK.pass_triangle_tree(v, rows)
                tree = (trees[id(rows)],)
            args = (*rays, rows, ts, *tree)
            got = HK.triangle_search_rows(*args)
            want = first.setdefault(name, got)
            bad = int((got[1] != want[1]).sum() + (got[0] != want[0]).sum())
            if bad:
                print(f"  k5 {label} {name}: {bad} values differ from the "
                      "first result's")
            key = name.split(" ")[0]
            ms = time_ms(lambda: HK.triangle_search_rows(*args))
            if key.startswith("torus"):
                out[f"k5 {label} {key}"] = out.get(f"k5 {label} {key}",
                                                   0.0) + ms
            else:
                out[f"k5 {label} {name}"] = ms
    for k, v in defaults.items():
        setattr(HK, k, v)
    return out


def _tri_split(turns: list, labels: list) -> None:
    """Per kernel-5 case (a table of each size) the brute loop's ms (the
    first label's) against each tree's, the least of the turns, and
    which trees beat it: the sizes where they cross."""
    head = f"k5 {labels[0]} "
    for key in [k[len(head):] for k in turns[0] if k.startswith(head)]:
        best = {lb: min(t[f"k5 {lb} {key}"] for t in turns) for lb in labels}
        faster = [lb for lb in labels[1:] if best[lb] < best[labels[0]]]
        print(f"  split {key}: " + ", ".join(f"{lb} {ms:.6g}" for lb, ms
                                               in best.items())
              + f"; faster than the brute loop: {faster or 'none'}")


def tree_builds_ms(dev) -> dict:
    """Each stage-pass tree's build alone, ms of device time
    (torch.profiler; chip_smoke._profiled_ms): the sphere tree of
    sphere_field(N_SPHERES) and the triangle trees of the soup and the
    torus scene, through the one-launch builds; the torch builds' host
    ms beside them."""
    import chip_smoke as cs
    from raytracing_tpu_torch.render import stages
    sp = sphere_field(N_SPHERES, device=dev).spheres
    srows = HK.sphere_rows(sp.center, sp.radius, sp.mask)
    soup = cs._soup(cs.SOUP_TRIANGLES, cs.HIT_SEED + 1).to(dev)
    tris = stages._all_triangles(cs._stream_scene("torus", 8, 8, dev))
    out = {}
    builds = [("sphere_field", "sphere_tree_build",
               lambda: MK.sphere_tree_build(srows, HK.SPHERE_LEAF),
               lambda: HK.sphere_tree(srows))]
    if hasattr(HK, "triangle_tree_build"):
        for name, t in (("soup", soup), ("torus", tris)):
            trows = HK.triangle_rows(t.v, t.mask)
            builds.append((name, "triangle_tree_build",
                           lambda v=t.v, r=trows: HK.triangle_tree_build(v,
                                                                         r),
                           lambda v=t.v, r=trows: HK.triangle_tree(v, r)))
    for name, key, card, plain in builds:
        ms, clock = cs._profiled_ms(card, key)
        plain()         # the first call loads torch's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        out[f"build {name}"] = ms
        out[f"torch build {name}"] = (time.perf_counter() - t0) * 1e3
        print(f"  build {name}: {ms:.6g} ms ({clock}); the torch build "
              f"{out[f'torch build {name}']:.6g} ms (host clock)")
    return out


def _hit_variants(variants: list) -> dict:
    """label -> kernel 4's library built from each variant's sources (the
    package's own as "tree" when none is named)."""
    if not variants:
        return {"tree": _build.load(*HIT_SPEC)}
    libs = {}
    for label, src in variants:
        lib, log = build(label, src, *HIT_SPEC)
        libs[label] = lib
        _print_ptxas(label, log)
    return libs


def _print_ptxas(label: str, log: str) -> None:
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill|stack", line):
            print(f"    ptxas {label}: {line.strip()}")


def hit_only(dev, smi: str, out: Path, leaf_sizes: str,
             variants: list, kernels: str = "4,5") -> int:
    """``--only hit``: kernels 4 and 5 (``kernels``) in each configuration
    (``_hit_configs``, ``_tri_configs``) of each variant (``--variant``,
    libraries with this checkout's C interface) on phase 8's rays, one
    stage pass's recorded searches and the brute / tree split's tables
    (``_hit_cases``, ``_tri_cases``), in turns (first to last, then
    back), then the split's sizes (``_tri_split``); then each stage-pass
    tree's build (``tree_builds_ms``), kernel 5 on cornell's 10 triangles,
    kernel 1's cornell pass (16-pass launches) and the stage passes of
    phases 9, 10 and 24 (``_stage_pass``). A parent commit is timed by
    copying this file and ``chip_smoke.py`` into its checkout and running
    it there (its kernel 5 the brute loop alone)."""
    import chip_smoke as cs
    t0 = time.perf_counter()
    specs = [HIT_SPEC, ("megakernel", MK._SIGNATURES, ())]
    if hasattr(MK, "_TREE_SIGNATURES"):
        specs.append(("sphere_tree", MK._TREE_SIGNATURES, ()))
    _build.load_all(specs)
    print(f"built {len(specs)} libraries at once in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("hit_kernels", "sphere_tree"):
        for log in sorted(_build.BUILD_DIR.glob(f"lib{name}-*.log")):
            _print_ptxas("package", log.read_text())
    libs = _hit_variants(variants)
    cases = _hit_cases(dev) if "4" in kernels else {}
    tri_cases = _tri_cases(dev) if "5" in kernels else {}
    configs = [(f"{label}:{name}" if len(libs) > 1 else name, lib, attrs)
               for label, lib in libs.items()
               for name, attrs in _hit_configs(leaf_sizes)]
    tri_configs = [(f"{label}:{name}" if len(libs) > 1 else name, lib,
                    attrs) for label, lib in libs.items()
                   for name, attrs in _tri_configs(leaf_sizes)]
    results: dict = {"card": smi, "turns": []}
    first: dict = {}
    tri_first: dict = {}
    for turn_no in range(2):
        turn = {}
        for label, lib, attrs in (configs if turn_no == 0
                                  else configs[::-1]) if cases else ():
            _build._loaded[(HIT_SPEC[0], HIT_SPEC[2])] = lib
            turn.update(measure_hit(cases, [(label, attrs)], first))
        for label, lib, attrs in (tri_configs if turn_no == 0
                                  else tri_configs[::-1]) if tri_cases else ():
            _build._loaded[(HIT_SPEC[0], HIT_SPEC[2])] = lib
            turn.update(measure_tri(tri_cases, [(label, attrs)], tri_first))
        print("turn: " + ", ".join(f"{k} {v:.6g}" for k, v in turn.items()),
              flush=True)
        results["turns"].append(turn)
    _build._loaded[(HIT_SPEC[0], HIT_SPEC[2])] = _build.load(*HIT_SPEC)
    if tri_cases:
        _tri_split(results["turns"], [lb for lb, _, _ in tri_configs])
    others = tree_builds_ms(dev)
    room = cs._seeded_rays(dev, cs.HIT_RAYS, cs.HIT_SEED + 2, -0.95, 0.95)
    tris = cornell_box(device=dev).triangles
    trow = HK.triangle_rows(tris.v, tris.mask)
    others["k5 cornell(10)"] = time_ms(
        lambda: HK.triangle_search_rows(*room, trow, False))
    cornell = Case(cornell_box(cols=SIZE, rows=SIZE, device=dev), dev,
                   step=False)
    others["k1 cornell 16-pass"] = time_ms(lambda: cornell.k1(16), per=16)
    others.update(_stage_pass(dev))
    print("others: " + ", ".join(f"{k} {v:.6g}" for k, v in others.items()))
    results["others"] = others
    (out / "profile.json").write_text(json.dumps(results, indent=1))
    print(f"card: [{smi}]")
    return 0


# --only champ: kernel 3 in every case the main path runs it, per variant
CHAMP_SPECS = (("megakernel", MK._SIGNATURES, ()),
               ("megakernel", MK._SIGNATURES, MK.GRID_FLAGS),
               ("megakernel", MK._SIGNATURES, EXACT),
               ("megakernel", MK._SIGNATURES, EXACT + MK.GRID_FLAGS),
               ("megakernel_champ", MKG._CHAMP_SIGNATURES, MKG.ADJ_FLAGS))


def _sweep_record(c: Case):
    """Row 2′'s record of ``c``'s step: kernel 1's --fmad=false build over
    the rays with g != 0 (``MKG._record``), as the "pallas" step makes it."""
    kw = dict(c.kw, russian_roulette=False, rr_start_depth=0, mode="path")
    return MKG._record(c.tables[0], c.ipar, *c.tables[1:], c.g, None,
                       grid=c.grid, chunks=c.chunks,
                       block=c.block if c._mode() else 0, **kw)


def champ_cases(dev) -> dict:
    """name -> (call, wrt, ids, n_sph, n_tri, g) of every kernel-3 case:
    rows 3g (the grid torus, shape 2; the sphere grid, shape 3) and 3s (the
    streamed torus) on their steps' records, row 3 (sphere_field(1024)) and
    3a (its roulette step), 3d (direct mode on cornell and on
    sphere_field(1024)), cornell with all five groups, and row 2′'s two
    sweeps of chip_smoke.py phase 22 (sphere_field(1024) and the streamed
    torus, on the record of the rays with g != 0), all at SIZE^2 b5."""
    cornell = Case(cornell_box(cols=SIZE, rows=SIZE, device=dev), dev)
    spheres = Case(sphere_field(N_SPHERES, cols=SIZE, rows=SIZE, device=dev),
                   dev)
    grid = grid_cases(dev, step=True)
    torus = stream_cases(dev)["torus"]
    d_cornell = DirectCase(cornell_box(cols=SIZE, rows=SIZE, device=dev), dev)
    d_spheres = DirectCase(sphere_field(N_SPHERES, cols=SIZE, rows=SIZE,
                                        device=dev), dev)
    _, rr_ids, rr_occs = spheres.k1(record=True, rr=True)

    def case(c, ids, occs, wrt, **kw):
        def call():
            return MKG.pathtrace_pass_bwd_champ(
                c.tables[0], c.ipar, *c.tables[1:], c.g, None, ids, occs,
                diff_wrt=wrt, **{**c.kw, **kw})
        return (call, wrt, ids, c.tables[1].shape[0], c.tables[2].shape[0],
                c.g)

    cases = {
        "3g_grid_torus": case(grid["torus"], grid["torus"].ids,
                              grid["torus"].occs, MESH_WRT),
        "3s_stream_torus": case(torus, torus.ids, torus.occs, MESH_WRT),
        "3_spheres1024": case(spheres, spheres.ids, spheres.occs, TRAIN_WRT),
        "3a_spheres1024_rr": case(spheres, rr_ids, rr_occs, TRAIN_WRT,
                                  **Case._rr(True)),
        "3g_grid_spheres": case(grid["spheres"], grid["spheres"].ids,
                                grid["spheres"].occs, TRAIN_WRT),
        "3_cornell_all": case(cornell, cornell.ids, cornell.occs,
                              MKG.DIFF_ALL),
        "2p_sweep_spheres1024": case(spheres, *_sweep_record(spheres),
                                     TRAIN_WRT),
        "2p_sweep_stream_torus": case(torus, *_sweep_record(torus),
                                      MESH_WRT)}
    for name, d in (("3d_cornell", d_cornell), ("3d_spheres1024", d_spheres)):
        cases[name] = (d.k3, TRAIN_WRT, d.ids, d.tables[1].shape[0],
                       d.tables[2].shape[0], d.g)
    # kernel 2 on cornell's step (it shares the sweep): must not move
    for name, wrt in (("k2_cornell", TRAIN_WRT),
                      ("k2_cornell_all", MKG.DIFF_ALL)):
        cases[name] = ((lambda w=wrt: cornell.k2(cornell.g, w)), wrt, None,
                       2, 10, cornell.g)
    return cases


def champ_steps(dev) -> dict:
    """chip_smoke.py's 1024^2 b5 train steps that run kernel 3 (one pass,
    mean(image^2), the gradients, ``_large_step``): the cell route on the
    torus scene over its grids at block 64 (phase 18) and streamed at block
    64 (phase 21), and on sphere_field(N_SPHERES); the "pallas" route (row
    2′: the record, then kernel 3's sweep) on the streamed torus and
    sphere_field(N_SPHERES) (phase 22). name -> (step, state)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    out = {}
    for name, shape, impl, block in (
            ("cell_grid_torus", "torus-grid", "cell", 64),
            ("cell_stream_torus", "torus", "cell", 64),
            ("cell_spheres1024", "spheres1024", "cell", 0),
            ("pallas_stream_torus", "torus", "pallas", 0),
            ("pallas_spheres1024", "spheres1024", "pallas", 0)):
        mesh = "torus" in shape
        cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES,
                           use_megakernel=True, use_grid=shape == "torus-grid",
                           mega_block=block, mega_bwd_impl=impl,
                           mega_grad_wrt=MESH_WRT if mesh else TRAIN_WRT)
        scene = cs._large_scene(shape, SIZE, SIZE, dev)
        step = cs._large_step(scene, cfg, dev, cs._large_params(scene, mesh))
        state, _, _ = step(pt.init_state(cfg, dev))
        out[name] = [step, state]
    torch.cuda.synchronize()
    return out


def time_steps(steps: dict, n: int = 7) -> dict:
    """Median host-clock ms of ``n`` synchronised steps of each."""
    out = {}
    for name, st in steps.items():
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            st[1], _, _ = st[0](st[1])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"step_{name}"] = sorted(times)[n // 2]
    return out


def device_ms(fn, out: Path) -> float:
    """The device time of one call of ``fn``: the sum of its kernels'
    durations in torch.profiler's trace (``launch_shapes``), ms."""
    return sum(k["us"] or 0.0 for k in launch_shapes(fn, out)) / 1e3


def champ_counts(cases: dict) -> dict:
    """The hot rows of each case's record built on the card, held equal to
    their plain version, and the plain count of its row adds
    (``MKG.champ_add_count``) over the rays with g != 0; where the package
    has kernel 3's ray order, the order built on the card held equal to
    its plain version element for element, the plain count of the warps'
    segments (``MKG.champ_warp_work``) in ray order and in the order, and
    the adds in the order. None where the package has no hot rows (a
    parent's checkout)."""
    if not hasattr(MKG, "hot_rows"):
        return {}
    ordered = hasattr(MKG, "champ_order")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, (_, wrt, ids, n_s, n_t, g) in cases.items():
        if ids is None:
            continue
        slot, hot = MKG.hot_rows(ids, n_s, n_t)
        want = MKG.hot_rows_reference(ids.cpu(), n_s, n_t, MKG.HOT_TRI)
        if not (torch.equal(slot.cpu(), want[0])
                and torch.equal(hot.cpu(), want[1])):
            raise SystemExit(f"{name}: the hot rows on the card differ from "
                             f"their plain version")
        c = MKG.champ_add_count(ids, n_s, n_t, slot, wrt,
                                live=(g != 0).any(-1), blocks=4 * sms)
        out[name] = c
        print(f"  adds {name}: parent's scalar atomics {c['atomics_parent']}"
              f", new design's {c['adds_new']} (slab {c['slab_adds']}, "
              f"vector {c['vector_reds']}, flush {c['flush_reds']}); "
              f"triangle champions per ray "
              f"{c['tri_champions_per_ray']:.4g}, hot share of triangle "
              f"groups {c['tri_hot_groups'] / max(c['tri_groups'], 1):.4g}",
              flush=True)
        if not ordered:
            continue
        mode = "direct" if ids.shape[0] == 1 else "path"
        order, n_live = MKG.champ_order(ids, g, n_s + n_t, mode)
        n_live = int(n_live)
        plain, n_plain = MKG.champ_order_reference(ids, g, mode, n_s + n_t)
        if n_live != n_plain or not torch.equal(order[:n_live], plain):
            raise SystemExit(f"{name}: kernel 3's ray order on the card "
                             f"differs from its plain version")
        c["warp_work_ray_order"] = MKG.champ_warp_work(ids, g, None, mode,
                                                       n_s + n_t)
        c["warp_work_order"] = MKG.champ_warp_work(ids, g, plain, mode,
                                                   n_s + n_t)
        c["adds_in_order"] = MKG.champ_add_count(
            ids, n_s, n_t, slot, wrt, blocks=4 * sms, order=plain)
        print(f"  order {name}: {n_live} live rays (equal to the plain "
              f"version's); lane-segments walked / needed, ray order "
              f"{c['warp_work_ray_order']}, the order "
              f"{c['warp_work_order']}; row groups in the order: spheres "
              f"{c['adds_in_order']['sph_groups']} (ray order "
              f"{c['sph_groups']}), triangles "
              f"{c['adds_in_order']['tri_groups']} ({c['tri_groups']})",
              flush=True)
    return out


def order_device_ms(cases: dict, lib, out: Path, reps: int = 20) -> dict:
    """Kernel 3's ray order alone on each path-mode case's record and g
    (direct mode sweeps in ray order): the device time of one
    ``MKG._order_map`` (its three launches), ms, and its host time per
    call over ``reps`` calls queued back to back (no sync)."""
    res = {}
    for name, (_, _, ids, n_s, n_t, g) in cases.items():
        if ids is None or ids.shape[0] == 1:
            continue

        def build():
            return MKG._order_map(lib, ids, g, n_s + n_t)
        res[f"order_device_{name}"] = device_ms(build, out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            build()
        res[f"order_host_{name}"] = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
    return res


def champ_only(dev, smi: str, out: Path, variants: list) -> int:
    """``--only champ``: kernel 3 of each variant (``--variant``, the
    package's csrc as "tree" when none is named; sources with the
    package's C interface) on every case of ``champ_cases``, in turns
    (first to last, then back), CUDA events around the wrapper (the hot
    rows' build included), each result held to the first variant's
    (cosine, max |d|); with each variant's kernel 2 (which shares the
    sweep) on cornell's step, each case's device time (the sum of its
    kernels' durations in torch.profiler's trace; the host sets the pace
    of the short cases' wrapper calls) and, before any case, twice, the
    train steps of ``champ_steps`` (host clock; the package's csrc); each
    variant's ptxas report and its
    launches' registers, shared memory and blocks per SM. Where the
    package builds hot rows: their build alone per case, held to their
    plain version, and the plain count of each case's adds; a variant
    built with another ``kHot`` runs with ``MKG.HOT_TRI`` set to it. A
    parent from before the hot rows is timed by copying this file into
    its checkout and running it there."""
    t0 = time.perf_counter()
    _build.load_all(CHAMP_SPECS + (("megakernel_grad", MKG._SIGNATURES,
                                    MKG.ADJ_FLAGS),))
    variants = list(variants) or [("tree", _build.CSRC)]
    jobs = [(label, src, name, sig, MKG.ADJ_FLAGS)
            for label, src in variants
            for name, sig in (("megakernel_champ", MKG._CHAMP_SIGNATURES),
                              ("megakernel_grad", MKG._SIGNATURES))]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    print(f"built {len(built)} libraries of kernels 3 and 2 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    libs: dict = {}
    for (label, _, name, _, _), (lib, log) in zip(jobs, built):
        _print_ptxas(f"{label}/{name}", log)
        libs.setdefault(label, {})[name] = lib
    # each variant's hot rows (a timing copy may change kHot; a parent's
    # sources from before the hot rows have none)
    k_hot = {label: re.search(r"constexpr int kHot = (\d+);",
                              (src / "megakernel_champ.cu").read_text())
             for label, src in variants}
    package_k = getattr(MKG, "HOT_TRI", None)
    keys = {name: (name, tuple(MKG.ADJ_FLAGS))
            for name in ("megakernel_champ", "megakernel_grad")}
    package = {name: _build._loaded[key] for name, key in keys.items()}
    # the train steps first: the work before them is the same in every
    # checkout (the cases' counts below are not)
    steps = champ_steps(dev)
    results: dict = {"card": smi, "steps": []}
    for _ in range(2):
        results["steps"].append(time_steps(steps))
        print("steps: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                    results["steps"][-1].items()),
              flush=True)
    del steps
    cases = champ_cases(dev)
    results.update(turns=[], counts=champ_counts(cases))
    first: dict = {}
    labels = list(libs)
    hot = hasattr(MKG, "_hot_map")
    ordered = hasattr(MKG, "_order_map")

    def put(label):
        for name, key in keys.items():
            _build._loaded[key] = libs[label][name]
        if k_hot[label]:
            MKG.HOT_TRI = int(k_hot[label].group(1))

    for order in (labels, labels[::-1]):
        turn = {}
        for label in order:
            put(label)
            row = {}
            for name, (call, wrt, ids, n_s, n_t, _) in cases.items():
                got = call()
                want = first.setdefault(name, got)
                if got is not want:
                    print(f"  {label} {name} vs {labels[0]}: "
                          + _agree(want, got, wrt), flush=True)
                row[name] = time_ms(call)
                row[f"device_{name}"] = device_ms(call, out)
                if hot and ids is not None and n_t:
                    lib = libs[label]["megakernel_champ"]
                    row[f"map_{name}"] = time_ms(
                        lambda: MKG._hot_map(lib, ids, n_s, n_t))
            if ordered:
                row.update(order_device_ms(
                    cases, libs[label]["megakernel_champ"], out))
            turn[label] = row
            print(f"{label}: " + ", ".join(f"{k} {v:.6g}"
                                           for k, v in row.items()),
                  flush=True)
        results["turns"].append(turn)
    shapes = {}
    for label in labels:
        put(label)
        for name in ("3_spheres1024", "3s_stream_torus", "3a_spheres1024_rr",
                     "3d_cornell", "k2_cornell"):
            shapes[f"{label} {name}"] = launch_shapes(cases[name][0], out)
            print(f"launches {label} {name}: "
                  f"{json.dumps(shapes[f'{label} {name}'])}", flush=True)
    results["launches"] = shapes
    for name, key in keys.items():
        _build._loaded[key] = package[name]
    if package_k is not None:
        MKG.HOT_TRI = package_k
    (out / "profile.json").write_text(json.dumps(results, indent=1))
    print(f"card: [{smi}]")
    return 0


# --only direct: kernel 1's direct mode over resident sphere tables (the
# brute loop against the sphere tree's walk) and the pieces around it
# the threshold sweep
DIRECT_FIELDS = (64, 128, 160, 192, 224, 256, 512, 1024, 4608)
DIRECT_PASSES = 16        # bench.py's BENCH_PASSES for configs 2 and 4
STEP_REPS = 7


def _walk_args(walk) -> dict:
    """direct_pass's route argument where the package has one (a parent
    from before the sphere tree runs the brute loop alone)."""
    if walk is None or "sphere_walk" not in inspect.signature(
            MK.direct_pass).parameters:
        return {}
    return {"sphere_walk": walk}


def _direct_configs(has_walk: bool) -> list:
    """(label, route) of each direct-mode configuration: the package's
    route, the brute loop and the walk."""
    if not has_walk:
        return [("route", None)]
    return [("route", None), ("brute", False), ("walk", True)]


def direct_cases(dev) -> dict:
    """Tables at SIZE^2 spp 1: each field of DIRECT_FIELDS and cornell."""
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=0,
                       use_megakernel=True)
    cases = {f"field{n}": mega.scene_tables(
        sphere_field(n, cols=SIZE, rows=SIZE, device=dev), cfg)
        for n in DIRECT_FIELDS}
    cases["cornell"] = mega.scene_tables(
        cornell_box(cols=SIZE, rows=SIZE, device=dev), cfg)
    return cases


def measure_direct_only(cases: dict, configs: list, first: dict) -> dict:
    """Each configuration on each table: one recording pass (row 1d's
    shape; the route's tree build included) and DIRECT_PASSES passes in one
    launch (per pass), CUDA events; each record held to the first
    configuration's bit for bit."""
    out = {}
    key = rng.base_key(0)
    for label, walk in configs:
        for name, t in cases.items():
            acc = torch.zeros((SIZE * SIZE, 3), device=t[0].device)
            kw = dict(key=key, spp=1, width=SIZE, two_sided=False,
                      **_walk_args(walk))
            rec = MK.direct_pass(*t, acc.zero_(), None, record=True, **kw)
            want = first.setdefault(name, [x.clone() for x in rec])
            bad = sum(int((a != b).sum()) for a, b in zip(rec, want))
            if bad:
                print(f"  {label} {name}: {bad} values differ from the "
                      "first configuration's")
            out[f"{label} {name} record"] = time_ms(
                lambda: MK.direct_pass(*t, acc, None, record=True, **kw))
            out[f"{label} {name} pass"] = time_ms(
                lambda: MK.direct_pass(*t, acc, None,
                                       n_passes=DIRECT_PASSES, **kw),
                reps=3, per=DIRECT_PASSES)
    return out


def direct_steps_only(dev, smi: str, out: Path) -> int:
    """``--only direct-steps``: phase 23's direct train steps alone
    (``direct_steps``, 3 STEP_REPS per route), so that a call can run a
    parent and a change in several alternating processes."""
    _build.load_all([("megakernel", MK._SIGNATURES, ()),
                     ("megakernel", MK._SIGNATURES, MKG.RECORD_FLAGS),
                     ("megakernel_champ", MKG._CHAMP_SIGNATURES,
                      MKG.ADJ_FLAGS)])
    res = direct_steps(dev, 3 * STEP_REPS)
    print("steps: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    (out / "profile.json").write_text(json.dumps({"card": smi, **res},
                                                 indent=1))
    print(f"card: [{smi}]")
    return 0


def direct_steps(dev, reps: int = STEP_REPS) -> dict:
    """chip_smoke.py phase 23's direct train steps on sphere_field(
    N_SPHERES) at SIZE^2 spp 1 with ("sph", "mat"): the cell route (kernel
    1 recording, kernel 3) and the "pallas" route (kernel 1, then kernel 2
    past 64 objects: the record and kernel 3's sweep); ms per step, host
    clock around a synchronised step, the median of ``reps`` after a
    warm-up."""
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=0,
                       use_megakernel=True)
    scene = sphere_field(N_SPHERES, cols=SIZE, rows=SIZE, device=dev)
    kw = dict(spp=1, width=SIZE, bounces=0, two_sided=False,
              normalize_emitter=cfg.normalize_emitter, seed=cfg.seed)
    out = {}
    for route in ("cell", "pallas"):
        params = [scene.spheres.center.clone().requires_grad_(True),
                  scene.materials.clone().requires_grad_(True)]

        def step(i):
            sc = replace(scene, spheres=replace(scene.spheres,
                                                center=params[0]),
                         materials=params[1])
            t = mega.scene_tables(sc, cfg)
            acc = MKG.pathtrace_pass_diff(
                t[0], torch.tensor([i, 0], dtype=torch.int32), *t[1:],
                torch.zeros((cfg.total_rays, 3), device=dev), None,
                mode="direct", diff_wrt=TRAIN_WRT,
                bwd_cell=route == "cell", **kw)
            torch.mean(acc ** 2).backward()
            with torch.no_grad():
                for p in params:
                    p -= 1e-3 * p.grad
                    p.grad = None

        step(0)
        times = []
        for i in range(1, 1 + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"step {route} ms"] = sorted(times)[reps // 2]
        out[f"step {route} ms all"] = [round(x, 4) for x in times]
    return out


def direct_only(dev, smi: str, out: Path) -> int:
    """``--only direct``: this checkout's kernel 1 in direct mode on the
    fields of DIRECT_FIELDS and cornell at SIZE^2 spp 1 (``_direct_configs``:
    the package's route, the brute loop and the walk;
    recording and DIRECT_PASSES-pass launches), in two turns (first to last,
    then back); the tree's build alone; kernel 2 past 64 objects on
    sphere_field(N_SPHERES)'s direct step cotangent (row 2d's record and
    sweep) and cornell's step pieces; phase 23's direct train steps
    (``direct_steps``); the direct kernels' ptxas lines. A parent commit
    is timed by copying this file into its checkout and running it there
    (it has the route alone)."""
    has_walk = hasattr(MK, "sphere_walks") or hasattr(MK, "direct_walks")
    t0 = time.perf_counter()
    specs = [("megakernel", MK._SIGNATURES, ()),
             ("megakernel", MK._SIGNATURES, MKG.RECORD_FLAGS),
             ("megakernel_champ", MKG._CHAMP_SIGNATURES, MKG.ADJ_FLAGS),
             ("megakernel_grad", MKG._SIGNATURES, MKG.ADJ_FLAGS)]
    if has_walk:
        specs.append(("sphere_tree", MK._TREE_SIGNATURES, ()))
    _build.load_all(specs)
    print(f"built {len(specs)} libraries at once in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, _, flags in specs:
        info = _build.build_log.get((name, tuple(flags)))
        lines = (info["ptxas"] if info else "").splitlines()
        for i, line in enumerate(lines):
            if re.search(r"Compiling entry.*(direct_kernel|sphere_tree)",
                         line):
                entry = re.search(r"(direct_kernel\w*|sphere_tree\w*)",
                                  line).group(1)[:60]
                rest = [x.split("info    :")[-1].strip()
                        for x in lines[i + 1:i + 4]
                        if re.search(r"registers|stack|spill", x)]
                print(f"    ptxas {name} {' '.join(flags)} {entry}: "
                      f"{'; '.join(rest)}")
        if info:
            (out / f"ptxas_{name}{'_'.join(flags)}.txt").write_text(
                info["ptxas"])
    cases = direct_cases(dev)
    configs = _direct_configs(has_walk)
    results: dict = {"card": smi, "turns": [], "has_walk": has_walk,
                     "brute_max": getattr(MK, "SPH_BRUTE_MAX", None)}
    first: dict = {}
    for order in (configs, configs[::-1]):
        turn = measure_direct_only(cases, order, first)
        print("turn: " + ", ".join(f"{k} {v:.6g}" for k, v in turn.items()),
              flush=True)
        results["turns"].append(turn)
    others = {}
    if has_walk:
        for n in (1024, 4608):
            t = cases[f"field{n}"]
            rows = t[1]
            acc = torch.zeros((SIZE * SIZE, 3), device=dev)
            # one route call's kernels (the build, then the walk) as
            # torch.profiler's trace times them, with their registers
            for k in launch_shapes(lambda: MK.direct_pass(
                    *t, acc, None, key=rng.base_key(0), spp=1, width=SIZE,
                    two_sided=False, record=True), out):
                others[f"field{n} route kernel {k['name'][-40:]}"] = (
                    f"{k['us']} us, {k['registers']} registers, "
                    f"{k['blocks_per_sm']} blocks per SM, smem {k['smem']}")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(REPS):
                MK.sphere_tree_build(rows, MK.SPH_TREE_LEAF)
            torch.cuda.synchronize()
            others[f"tree build {n} wrapper ms (host clock)"] = (
                time.perf_counter() - t1) * 1e3 / REPS
            torch_ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                MK.sphere_tree(rows, MK.SPH_TREE_LEAF)
                torch.cuda.synchronize()
                torch_ms.append((time.perf_counter() - t1) * 1e3)
            others[f"torch tree {n} ms (host clock, median of 5)"] = sorted(
                torch_ms)[2]
    for name in ("field1024", "cornell"):
        scene = (sphere_field(N_SPHERES, cols=SIZE, rows=SIZE, device=dev)
                 if name == "field1024" else
                 cornell_box(cols=SIZE, rows=SIZE, device=dev))
        d = DirectCase(scene, dev)
        others[f"{name} k2 direct step g ms"] = time_ms(d.k2)
        others[f"{name} k3 direct step g ms"] = time_ms(d.k3)
        others[f"{name} k1 direct record (step key) ms"] = time_ms(
            lambda: d.k1(record=True))
    others.update(direct_steps(dev))
    print("others: " + ", ".join(f"{k} {v}" for k, v in others.items()))
    results["others"] = others
    (out / "profile.json").write_text(json.dumps(results, indent=1))
    print(f"card: [{smi}]")
    return 0


# ---------------------------------------------------------------------------
# --only path: kernel 1's path mode over resident sphere tables (the brute
# loop against the sphere tree's walk) and the pieces around it
# the threshold sweep (record and 16-pass launches); the fields of
# PATH_FULL also run the one-pass launch and the roulette
PATH_FIELDS = (128, 160, 192, 224, 256, 512, 1024, 4608)
PATH_FULL = ("field256", "field1024", "field4608", "cornell")
PATH_PASSES = 16          # render_passes' passes per call (bench.py)


def _path_walk_args(walk) -> dict:
    """pathtrace_pass's route argument where the package has one (a parent
    from before the path walk runs the brute loop alone)."""
    if walk is None or "sphere_walk" not in inspect.signature(
            MK.pathtrace_pass).parameters:
        return {}
    return {"sphere_walk": walk}


def _path_configs(has_walk: bool) -> list:
    """(label, route) of each path-mode configuration: the package's route,
    the brute loop and the walk."""
    if not has_walk:
        return [("route", None)]
    return [("route", None), ("brute", False), ("walk", True)]


def path_cases(dev, fields) -> dict:
    """Tables at SIZE^2 b5: each field of ``fields`` and cornell."""
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES,
                       use_megakernel=True)
    cases = {f"field{n}": mega.scene_tables(
        sphere_field(n, cols=SIZE, rows=SIZE, device=dev), cfg)
        for n in fields}
    cases["cornell"] = mega.scene_tables(
        cornell_box(cols=SIZE, rows=SIZE, device=dev), cfg)
    return cases


def measure_path_only(cases: dict, configs: list, first: dict) -> dict:
    """Each configuration on each table at SIZE^2 b5 (the PRNG draws of
    pass STEP_PASSES - 1): one recording pass (row 1s's shape; the route's
    tree build included) and PATH_PASSES passes in one launch (per pass),
    on PATH_FULL also one pass and one pass with the roulette (from
    RR_START), CUDA events; each record held to the first configuration's
    bit for bit."""
    out = {}
    ipar = torch.tensor([STEP_PASSES - 1, 0], dtype=torch.int32)
    base = dict(spp=1, width=SIZE, bounces=BOUNCES, two_sided=False,
                normalize_emitter=True, seed=0)
    for label, walk in configs:
        for name, t in cases.items():
            acc = torch.zeros((SIZE * SIZE, 3), device=t[0].device)
            kw = dict(base, **_path_walk_args(walk))
            rr = dict(kw, russian_roulette=True, rr_start_depth=RR_START)

            def run(n_passes=1, record=False, **extra):
                return MK.pathtrace_pass(t[0], ipar, *t[1:], acc, None,
                                         n_passes=n_passes, record=record,
                                         **(extra or kw))

            for key, args in (("record", dict(record=True)),
                              ("rr record", dict(record=True, **rr))):
                if key == "rr record" and name not in PATH_FULL:
                    continue
                acc.zero_()
                rec = run(**args)
                want = first.setdefault((name, key),
                                        [x.clone() for x in rec])
                bad = sum(int((a != b).sum()) for a, b in zip(rec, want))
                if bad:
                    print(f"  {label} {name} {key}: {bad} values differ "
                          "from the first configuration's")
            out[f"{label} {name} record"] = time_ms(
                lambda: run(record=True))
            out[f"{label} {name} pass"] = time_ms(
                lambda: run(PATH_PASSES), reps=3, per=PATH_PASSES)
            if name in PATH_FULL:
                out[f"{label} {name} one pass"] = time_ms(lambda: run())
                out[f"{label} {name} rr"] = time_ms(lambda: run(**rr))
                out[f"{label} {name} rr record"] = time_ms(
                    lambda: run(record=True, **rr))
    return out


def path_record_k2(dev) -> dict:
    """Kernel 2′ past 64 objects on sphere_field(N_SPHERES)'s step
    cotangent (``Case``): its ``--fmad=false`` record over the rays with g
    != 0 (``MKG._record``: the route's, building its own tree where it
    walks, and walking the forward's tree where the package has one), the
    whole split (the record and kernel 3's sweep), CUDA events."""
    c = Case(sphere_field(N_SPHERES, cols=SIZE, rows=SIZE, device=dev), dev)
    t = c.tables
    rec = dict(c.kw, russian_roulette=False, rr_start_depth=0, mode="path",
               grid=None, chunks=None, block=0)
    out = {"k2 live share": c.live,
           "k2 record ms": time_ms(lambda: MKG._record(
               t[0], c.ipar, *t[1:], c.g, None, **rec)),
           "k2 split ms": time_ms(lambda: MKG.pathtrace_pass_bwd_split(
               t[0], c.ipar, *t[1:], c.g, None, diff_wrt=TRAIN_WRT,
               **c.kw))}
    if "sph_tree" in inspect.signature(MK._launch_pass).parameters:
        tree = MK.pass_tree(t[1])
        out["k2 record, the forward's tree ms"] = time_ms(
            lambda: MKG._record(t[0], c.ipar, *t[1:], c.g, None,
                                sph_tree=tree, **rec))
    return out


def path_only(dev, smi: str, out: Path, fields) -> int:
    """``--only path``: this checkout's kernel 1 in path mode on the
    fields of ``fields`` and cornell at SIZE^2 b5 (``_path_configs``: the
    package's route, the brute loop and the walk; ``measure_path_only``),
    in two turns (first to last, then back); one route call's kernels on
    sphere_field(1024) and (4608) as torch.profiler's trace times them
    (the build, then the walk); kernel 2′'s record and split on
    sphere_field(N_SPHERES)'s step cotangent (``path_record_k2``); the
    cell and "pallas" train steps on sphere_field(N_SPHERES)
    (``champ_steps``' two, host clock, median of 7); the path instances'
    ptxas lines. A parent commit is timed by copying this file into its
    checkout and running it there (it has the route alone); a variant of
    the kernel (another walk, another __launch_bounds__) from a copy of the
    package under ``build/<name>/`` with this file, run the same way."""
    has_walk = "sphere_walk" in inspect.signature(
        MK.pathtrace_pass).parameters
    t0 = time.perf_counter()
    specs = [("megakernel", MK._SIGNATURES, ()),
             ("megakernel", MK._SIGNATURES, MKG.RECORD_FLAGS),
             ("megakernel_champ", MKG._CHAMP_SIGNATURES, MKG.ADJ_FLAGS),
             ("megakernel_grad", MKG._SIGNATURES, MKG.ADJ_FLAGS)]
    if hasattr(MK, "_TREE_SIGNATURES"):
        specs.append(("sphere_tree", MK._TREE_SIGNATURES, ()))
    _build.load_all(specs)
    print(f"built {len(specs)} libraries at once in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, _, flags in specs[:2]:
        usage = _build.ptxas_usage(_build.ptxas_log(name, flags))
        for entry, u in usage.items():
            if "pathtrace_kernel" in entry:
                print(f"    ptxas {name} {' '.join(flags)} "
                      f"{entry[-44:]}: {u}")
        (out / f"ptxas_{name}{'_'.join(flags)}.txt").write_text(
            _build.ptxas_log(name, flags))
    steps = {k: v for k, v in champ_steps(dev).items()
             if k in ("cell_spheres1024", "pallas_spheres1024")}
    results: dict = {"card": smi, "turns": [], "has_walk": has_walk,
                     "brute_max": getattr(MK, "SPH_BRUTE_MAX", None)}
    # the steps first, so that every checkout's steps follow the same work
    results["steps"] = time_steps(steps)
    print("steps: " + ", ".join(f"{k} {v:.6g}"
                                for k, v in results["steps"].items()),
          flush=True)
    cases = path_cases(dev, fields)
    configs = _path_configs(has_walk)
    first: dict = {}
    for order in (configs, configs[::-1]):
        turn = measure_path_only(cases, order, first)
        print("turn: " + ", ".join(f"{k} {v:.6g}" for k, v in turn.items()),
              flush=True)
        results["turns"].append(turn)
    others = path_record_k2(dev)
    ipar = torch.tensor([STEP_PASSES - 1, 0], dtype=torch.int32)
    for n in (1024, 4608):
        t = cases.get(f"field{n}")
        if t is None:
            continue
        acc = torch.zeros((SIZE * SIZE, 3), device=dev)
        for k in launch_shapes(lambda: MK.pathtrace_pass(
                t[0], ipar, *t[1:], acc, None, record=True, spp=1,
                width=SIZE, bounces=BOUNCES, two_sided=False,
                normalize_emitter=True, seed=0), out):
            others[f"field{n} route kernel {k['name'][-40:]}"] = (
                f"{k['us']} us, {k['registers']} registers, "
                f"{k['blocks_per_sm']} blocks per SM, smem {k['smem']}")
    print("others: " + ", ".join(f"{k} {v}" for k, v in others.items()))
    results["others"] = others
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
    ap.add_argument("--only", choices=("all", "soft", "stream", "grid",
                                       "large", "hit", "champ", "direct",
                                       "direct-steps", "path"),
                    default="all",
                    help="soft: build and time kernel 2s alone; stream: "
                         "kernel 1's streamed cases, kernel 2's streamed "
                         "step and grid shape 1's direct mode alone; grid: "
                         "kernel 1's grid cases and kernels 2 and 3 on the "
                         "grid scenes alone; large: kernel 2 past 64 "
                         "objects and its pieces, this checkout only; hit: "
                         "kernel 4's configurations and the stage route, "
                         "this checkout only; champ: kernel 3 in every "
                         "case of the main path, per variant; direct: "
                         "kernel 1's direct mode, brute loop and sphere "
                         "tree, this checkout only; direct-steps: its "
                         "direct train steps alone; path: kernel 1's path "
                         "mode, brute loop and sphere tree, this checkout "
                         "only")
    ap.add_argument("--leaf-sizes", default="",
                    help="with --only stream or grid: the streamed tables' "
                         "leaf sizes (MK.STREAM_LEAF) or the mesh grid "
                         "cells' (MK.GRID_LEAF) to time each variant at "
                         "(default the package's); with --only hit kernels "
                         "4 and 5's tree leaves (HK.SPHERE_LEAF, "
                         "HK.TRIANGLE_LEAF; default 1,2,4)")
    ap.add_argument("--hit-kernels", default="4,5",
                    help="with --only hit: the kernels to time, 4 (spheres) "
                         "and 5 (triangles)")
    ap.add_argument("--path-fields",
                    default=",".join(str(n) for n in PATH_FIELDS),
                    help="with --only path: the sphere fields to time")
    ap.add_argument("--bounds", action="store_true",
                    help="with --only large: each scene's bound of kernel "
                         "2 past 64 objects (the plain version's counts)")
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

    if args.only == "large":
        return large_only(dev, smi, out, args.bounds)
    if args.only == "champ":
        return champ_only(dev, smi, out,
                          [(label, Path(src).resolve()) for label, src in
                           (v.split("=", 1) for v in args.variant)])
    if args.only == "direct":
        return direct_only(dev, smi, out)
    if args.only == "direct-steps":
        return direct_steps_only(dev, smi, out)
    if args.only == "path":
        return path_only(dev, smi, out,
                         [int(n) for n in args.path_fields.split(",") if n])
    if args.only == "hit":
        return hit_only(dev, smi, out, args.leaf_sizes,
                        [(label, Path(src).resolve()) for label, src in
                         (v.split("=", 1) for v in args.variant)],
                        args.hit_kernels)
    variants = [tuple(v.split("=", 1)) for v in args.variant] or [
        ("tree", str(_build.CSRC))]
    variants = [(label, Path(src).resolve()) for label, src in variants]
    t0 = time.perf_counter()
    libs_used = {"all": LIBS, "soft": SOFT_LIBS, "stream": STREAM_LIBS,
                 "grid": STREAM_LIBS}[args.only]
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
    if args.only == "grid":
        return grid_only(dev, smi, libs, labels, out, args.leaf_sizes)
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
            if hasattr(libs[label].get("megakernel_soft"),
                       "rt_pathtrace_bwd_soft_large"):
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
