"""raytracing_tpu_torch -- the PyTorch + CUDA port of raytracing_tpu.

Module names mirror ``raytracing_tpu`` (core/, models/, ops/, render/,
io/, cli.py). With ``RenderConfig.use_megakernel`` a progressive pass runs
on an NVIDIA Hopper card as one hand-written CUDA kernel
(``csrc/megakernel.cu``), and its backward, when scene parameters require
grad, as a second one (``csrc/megakernel_grad.cu``); otherwise it runs as
the wavefront stage pipeline, whose hit searches run in a third pair
(``csrc/hit_kernels.cu``) with ``use_pallas``. All are built from source
at first use; on CPU tensors the same entry points run the kernels' plain
PyTorch versions. The package never imports jax.
"""
from __future__ import annotations

import torch

from .core.config import RenderConfig
from .core.types import replace

__version__ = "0.1.0"


def default_device(cpu: bool = False) -> torch.device:
    """``cuda`` -- raises if CUDA is missing, unless ``cpu=True`` asks for
    the CPU (which runs the kernel's plain PyTorch version)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; ask for the CPU "
                           "explicitly (default_device(cpu=True), CLI --cpu)")
    return torch.device("cuda")


__all__ = ["RenderConfig", "default_device", "replace"]
