"""Finite-difference oracle harness (``raytracing_tpu.diff.fd``): central
differences of a scalar function, and ``check_grad``, which holds autograd's
gradient to them."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree


def finite_difference(f: Callable, x, eps: float = 1e-3):
    """Central-difference gradient of scalar ``f`` wrt the pytree ``x`` of
    tensors (a tensor, or lists, tuples and dicts of them), as float64
    numpy arrays in the same tree. ``f`` must be deterministic (fix draws
    outside); each probe evaluates it at float32 inputs."""
    leaves, spec = pytree.tree_flatten(x)
    grads = []
    for li, leaf in enumerate(leaves):
        base = np.asarray(leaf.detach().cpu().numpy(), np.float64)
        flat = base.reshape(-1)
        g = np.zeros_like(flat)
        for i in range(flat.size):
            vals = []
            for step in (eps, -eps):
                probe = flat.copy()
                probe[i] += step
                args = list(leaves)
                args[li] = torch.as_tensor(probe.reshape(base.shape),
                                           dtype=torch.float32,
                                           device=leaf.device)
                with torch.no_grad():
                    vals.append(float(f(pytree.tree_unflatten(args, spec))))
            g[i] = (vals[0] - vals[1]) / (2 * eps)
        grads.append(g.reshape(base.shape))
    return pytree.tree_unflatten(grads, spec)


def check_grad(f: Callable, x, eps: float = 1e-3, rtol: float = 0.05,
               atol: float = 1e-4) -> dict:
    """Compare autograd's gradient of ``f`` at ``x`` with central
    differences. Returns a dict with the ``ad`` and ``fd`` trees and the
    largest absolute error; raises AssertionError on a mismatch (|ad - fd|
    > atol + rtol * max(|ad|, |fd|) anywhere)."""
    leaves, spec = pytree.tree_flatten(x)
    req = [leaf.detach().clone().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        out = f(pytree.tree_unflatten(req, spec))
        ad_leaves = torch.autograd.grad(out, req, allow_unused=True,
                                        materialize_grads=True)
    ad = pytree.tree_unflatten([g.detach() for g in ad_leaves], spec)
    fd = finite_difference(f, x, eps)
    ad_flat = np.concatenate([g.cpu().numpy().ravel().astype(np.float64)
                              for g in ad_leaves])
    fd_flat = np.concatenate([np.asarray(v).ravel()
                              for v in pytree.tree_leaves(fd)])
    abs_err = np.abs(ad_flat - fd_flat)
    scale = np.maximum(np.abs(fd_flat), np.abs(ad_flat))
    ok = abs_err <= atol + rtol * scale
    if not ok.all():
        worst = int(np.argmax(abs_err - rtol * scale))
        raise AssertionError(
            f"grad mismatch at flat index {worst}: ad={ad_flat[worst]:.6g} "
            f"fd={fd_flat[worst]:.6g} ({(~ok).sum()}/{ok.size} bad)")
    return {"ad": ad, "fd": fd, "max_abs_err": float(abs_err.max())}
