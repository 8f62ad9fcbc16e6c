"""JAX-exact threefry2x32 in PyTorch.

``jax.random`` with ``jax_threefry_partitionable=True`` (the default of
current JAX) computes every 32-bit draw of ``uniform(key, shape)`` as
``y0 ^ y1`` where ``(y0, y1) = threefry2x32(key, (hi, lo))`` and
``(hi, lo)`` are the two words of the element's flat row-major index.
Reproducing that here lets the port make JAX's draws without JAX, so the
port's renders are exactly testable against the JAX package, and the CUDA
kernel (``csrc/threefry.cuh``) makes the same draws in-kernel.

A key is its key data: a (2,) ``torch.uint32`` tensor on the CPU. The
arithmetic runs on int64 tensors masked to 32 bits: torch's uint32 support
is partial, and an int32 right shift is arithmetic (the signed-shift trap
that once biased the TPU kernel's draws).
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# purpose tags of draw_key (same integers as raytracing_tpu.core.rng)
LENS = 0
LIGHT = 1
BOUNCE = 2
INIT = 3


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on uint32 values held in Python
    ints or int64 tensors (which broadcast). Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key_words(key: torch.Tensor) -> tuple[int, int]:
    """The two uint32 words of a key as Python ints."""
    k0, k1 = (int(v) for v in key.to(torch.int64).reshape(2).tolist())
    return k0, k1


def _make_key(y0: int, y1: int) -> torch.Tensor:
    return torch.tensor([y0, y1], dtype=torch.int64).to(torch.uint32)


def _seed_word(seed: int) -> int:
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise OverflowError(f"seed {seed} outside the 32-bit range JAX takes")
    return seed & MASK32


def base_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: key data ``[0, seed mod 2**32]``."""
    return torch.tensor([0, _seed_word(seed)],
                        dtype=torch.int64).to(torch.uint32)


def pass_key_words(seed: int, pass_idx: int) -> tuple[int, int]:
    """``key_words(pass_key(base_key(seed), pass_idx))`` on Python ints
    alone: the words a kernel launch takes, with no tensor made on the
    way (a launch's host work)."""
    return threefry2x32(0, _seed_word(seed), 0, int(pass_idx) & MASK32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry2x32(key, (0, data))."""
    return _make_key(*threefry2x32(*key_words(key), 0, int(data) & MASK32))


def pass_key(key: torch.Tensor, pass_idx: int) -> torch.Tensor:
    """Key of one progressive pass (raytracing_tpu.core.rng.pass_key)."""
    return fold_in(key, pass_idx)


def draw_key(key: torch.Tensor, purpose: int, depth: int = 0,
             light: int = 0) -> torch.Tensor:
    return fold_in(fold_in(fold_in(key, purpose), depth), light)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 tensor) -> float32 in [0, 1) by the mantissa
    trick of ``jax.random.uniform``: ``((bits >> 9) | 0x3F800000) - 1``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)), bit for bit:
    element n takes the bits ``xor(threefry2x32(key, (n >> 32, n & MASK)))``
    of the partitionable layout."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(*key_words(key), idx >> 32, idx & MASK32)
    return bits_to_uniform(y0 ^ y1).reshape(tuple(shape))


def uniform2(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """(n, 2) uniforms in [0, 1): ``raytracing_tpu.core.rng.uniform2``."""
    return uniform(key, (n, 2), device)
