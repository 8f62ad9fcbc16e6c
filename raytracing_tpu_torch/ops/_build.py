"""Build ``csrc/<name>.cu`` with nvcc at first use and bind it with ctypes.

The library has a plain C interface: pointers and the stream go in as
``c_void_p``, and each launcher returns ``cudaGetLastError()``. The build
lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. The build runs inside
the first call that launches a kernel, never at import.

``load(name, signatures, flags)`` adds ``flags`` after ``NVCC_FLAGS``; each
set of flags is a library of its own (the adjoints are built with
``--fmad=false``, see ``csrc/pathtrace_adj.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[tuple, ctypes.CDLL] = {}
# (name, flags) -> {"path", "seconds", "ptxas"} for libraries built by this
# process
build_log: dict[tuple, dict] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built from csrc/ at first use")


def _source_hash(src: Path, flags: tuple) -> str:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def load(name: str, signatures: dict, flags: tuple = ()) -> ctypes.CDLL:
    """The built library ``lib<name>``, compiled with ``flags`` after
    ``NVCC_FLAGS``; ``signatures`` maps each exported function to
    ``(restype, argtypes)``."""
    key = (name, tuple(flags))
    if key in _loaded:
        return _loaded[key]
    src = CSRC / f"{name}.cu"
    nvcc_flags = NVCC_FLAGS + key[1]
    so = BUILD_DIR / f"lib{name}-{_source_hash(src, nvcc_flags)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *nvcc_flags, "-I", str(CSRC),
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)          # atomic: concurrent builds agree
        log = proc.stdout + proc.stderr
        so.with_suffix(".log").write_text(log)
        build_log[key] = {"path": str(so),
                          "seconds": time.perf_counter() - t0, "ptxas": log}
    lib = ctypes.CDLL(str(so))
    for fname, (restype, argtypes) in signatures.items():
        fn = getattr(lib, fname)
        fn.restype = restype
        fn.argtypes = argtypes
    _loaded[key] = lib
    return lib


def load_all(specs) -> list:
    """``load`` of several ``(name, signatures, flags)``; the nvcc builds
    run at the same time."""
    from concurrent.futures import ThreadPoolExecutor
    specs = list(specs)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        return list(pool.map(lambda spec: load(*spec), specs))


def ptxas_log(name: str, flags: tuple = ()) -> str:
    """The ptxas report of the built library ``lib<name>`` for ``flags``
    (the ``.log`` beside it; empty where it is not built)."""
    stem = _source_hash(CSRC / f"{name}.cu", NVCC_FLAGS + tuple(flags))
    log = BUILD_DIR / f"lib{name}-{stem}.log"
    return log.read_text() if log.exists() else ""


def ptxas_usage(log: str) -> dict:
    """Each kernel entry of a ptxas report (``-Xptxas -v``): mangled name,
    its anonymous namespace's per-build hash cut out -> {"registers",
    "stack", "spill_stores", "spill_loads"} in registers and bytes."""
    def key(name):
        return re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", name)

    out: dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = out.setdefault(key(m.group(1)), {})
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = out.setdefault(key(m.group(1)), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}
