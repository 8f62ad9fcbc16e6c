"""Build ``csrc/<name>.cu`` with nvcc at first use and bind it with ctypes.

The library has a plain C interface: pointers and the stream go in as
``c_void_p``, and each launcher returns ``cudaGetLastError()``. The build
lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. The build runs inside
the first call that launches a kernel, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"path", "seconds", "ptxas"} for libraries built by this process
build_log: dict[str, dict] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built from csrc/ at first use")


def _source_hash(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library ``lib<name>``; ``signatures`` maps each exported
    function to ``(restype, argtypes)``."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"lib{name}-{_source_hash(src)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC),
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)          # atomic: concurrent builds agree
        log = proc.stdout + proc.stderr
        so.with_suffix(".log").write_text(log)
        build_log[name] = {"path": str(so),
                           "seconds": time.perf_counter() - t0,
                           "ptxas": log}
    lib = ctypes.CDLL(str(so))
    for fname, (restype, argtypes) in signatures.items():
        fn = getattr(lib, fname)
        fn.restype = restype
        fn.argtypes = argtypes
    _loaded[name] = lib
    return lib
