"""The differentiable pass: the counterpart of
``raytracing_tpu/ops/pallas/megakernel_grad.py`` (hard route, unrolled
tables, path mode).

* ``pathtrace_pass_bwd_reference`` -- the plain version of kernel 2: the
  parameter cotangents of one pass by ``torch.autograd.grad`` through the
  plain forward (``ops/megakernel._pass_reference``). It returns what JAX's
  ``_bwd_reference`` returns; the CPU tests hold it against it.
* ``pathtrace_pass_bwd`` -- the wrapper of the hand-written CUDA adjoint
  ``csrc/megakernel_grad.cu``. It takes CUDA tensors or raises, and counts
  its launches in the module integer ``launches``.
* ``pathtrace_pass_diff`` -- one differentiable pass. On CUDA tensors it is
  ``_PassDiff``: forward = kernel 1, backward = kernel 2. On CPU tensors it
  runs the plain forward under autograd.

Gradients follow the JAX package's hard convention: the cotangent of a
closest hit flows to its champion only, occlusion has no adjoint, and the
scene-AABB window only selects (pmin, pmax and ambient get zeros).
``diff_wrt`` (``cfg.mega_grad_wrt``) names the table groups that get
cotangents; the others get none.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import rng
from . import _build
from . import megakernel as MK

DIFF_ALL = ("par", "sph", "tri", "mat", "lig")
# csrc/megakernel_grad.cu: the tape holds bounces + 1 segments, and one
# occlusion bit per light per segment
MAX_BOUNCES = 15
MAX_LIGHTS = 32

launches = 0

_VP, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "rt_pathtrace_bwd": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _I, _I,                                  # g, n_rays, ray_offset
        _VP, _U, _U,                                  # u_planes, pass key
        _I, _I, _I, _I, _I,                           # spp, width, bounces,
                                                      # two_sided, normalize
        _I,                                           # diff_wrt bits
        _VP, _VP, _VP, _VP, _VP,                      # dpar .. dlig
        _VP]),                                        # stream
}


def _check_wrt(diff_wrt) -> tuple:
    bad = [n for n in diff_wrt if n not in DIFF_ALL]
    if bad:
        raise ValueError(f"diff_wrt names unknown groups {bad}; "
                         f"expected a subset of {DIFF_ALL}")
    return tuple(n for n in DIFF_ALL if n in diff_wrt)


def pathtrace_pass_bwd_reference(par, ipar, sph, tri, mat, lig, g, u_planes,
                                 *, spp: int, width: int, bounces: int,
                                 two_sided: bool, normalize_emitter: bool,
                                 seed: int, diff_wrt=DIFF_ALL):
    """Plain version of kernel 2: ``(dpar, dsph, dtri, dmat, dlig)`` of
    ``sum(g * acc_delta)`` for one pass, by autograd through the plain
    forward. Groups outside ``diff_wrt`` come back as zeros."""
    sel = _check_wrt(diff_wrt)
    tables = dict(par=par, sph=sph, tri=tri, mat=mat, lig=lig)
    with torch.enable_grad():
        leaves = {k: (v.detach().requires_grad_(True) if k in sel
                      else v.detach()) for k, v in tables.items()}
        acc = MK.pathtrace_pass_reference(
            leaves["par"], ipar, leaves["sph"], leaves["tri"], leaves["mat"],
            leaves["lig"], torch.zeros_like(g), u_planes, spp=spp,
            width=width, bounces=bounces, two_sided=two_sided,
            normalize_emitter=normalize_emitter, seed=seed)
        grads = dict(zip(sel, torch.autograd.grad(
            acc, [leaves[k] for k in sel], grad_outputs=g,
            allow_unused=True, materialize_grads=True))) if sel else {}
    return tuple(grads[k] if k in grads else torch.zeros_like(v)
                 for k, v in tables.items())


def _check_bwd_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp, width,
                    bounces):
    MK._check_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp, width,
                   bounces, 1)
    if g.device.type != "cuda":
        raise ValueError(f"kernel 2 takes CUDA tensors, got {g.device}; "
                         "on the CPU use pathtrace_pass_bwd_reference")
    if bounces > MAX_BOUNCES:
        raise ValueError(f"the adjoint's tape holds at most {MAX_BOUNCES} "
                         f"bounces, got {bounces}")
    if lig.shape[0] > MAX_LIGHTS:
        raise ValueError(f"the adjoint takes at most {MAX_LIGHTS} lights, "
                         f"got {lig.shape[0]}")


def pathtrace_pass_bwd(par, ipar, sph, tri, mat, lig, g, u_planes, *,
                       spp: int, width: int, bounces: int, two_sided: bool,
                       normalize_emitter: bool, seed: int,
                       diff_wrt=DIFF_ALL):
    """Kernel 2: the cotangents of ``pathtrace_pass_bwd_reference`` from
    the hand-written CUDA adjoint, for CUDA tensors (anything else raises).
    ``g`` (R, 3) is the cotangent of the pass's accumulator; the draws are
    ``u_planes`` or, without them, those of pass ``ipar[0]`` of ``seed``,
    made in-kernel as the forward makes them. Groups outside ``diff_wrt``
    come back as zeros."""
    global launches
    sel = _check_wrt(diff_wrt)
    _check_bwd_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp, width,
                    bounces)
    outs = tuple(torch.zeros_like(t) for t in (par, sph, tri, mat, lig))
    wrt = sum(1 << i for i, n in enumerate(DIFF_ALL) if n in sel)
    if not wrt:
        return outs
    lib = _build.load("megakernel_grad", _SIGNATURES)
    pass0, roff = (int(x) for x in ipar.tolist())
    k0, k1 = rng.key_words(rng.pass_key(rng.base_key(seed), pass0))
    ptr = MK._ptr
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.rt_pathtrace_bwd(
            ptr(par), ptr(sph), sph.shape[0], ptr(tri), tri.shape[0],
            ptr(mat), mat.shape[0], ptr(lig), lig.shape[0], ptr(g),
            g.shape[0], roff, ptr(u_planes), k0, k1, spp, width, bounces,
            int(two_sided), int(normalize_emitter), wrt,
            *(ptr(t) for t in outs), stream)
        if err != 0:
            raise RuntimeError(f"kernel 2 launch failed with CUDA error {err}")
        launches += 1
    return outs


class _PassDiff(torch.autograd.Function):
    """One pass on the card: forward = kernel 1, backward = kernel 2.

    The forward runs kernel 1 out of place, on a copy of ``acc_in``, so the
    tensor autograd saw going in is never overwritten behind its back. The
    backward hands ``g`` on to ``acc_in`` unchanged (acc_out = acc_in +
    delta) and returns no cotangent for ``ipar`` and ``u_planes``."""

    @staticmethod
    def forward(ctx, par, sph, tri, mat, lig, acc_in, ipar, u_planes, kw,
                diff_wrt):
        acc = acc_in.clone()
        MK.pathtrace_pass(par, ipar, sph, tri, mat, lig, acc, u_planes, **kw)
        ctx.save_for_backward(par, sph, tri, mat, lig)
        # ipar carries the pass index (the draws' key) and the ray offset
        ctx.ipar, ctx.u_planes, ctx.kw = ipar, u_planes, kw
        ctx.diff_wrt = diff_wrt
        return acc

    @staticmethod
    def backward(ctx, g_out):
        tables = ctx.saved_tensors
        wrt = tuple(n for n, need in zip(DIFF_ALL, ctx.needs_input_grad[:5])
                    if need and n in ctx.diff_wrt)
        grads = [None] * 5
        if wrt:
            outs = pathtrace_pass_bwd(
                tables[0], ctx.ipar, *tables[1:], g_out.contiguous(),
                ctx.u_planes, diff_wrt=wrt, **ctx.kw)
            grads = [o if n in wrt else None for n, o in zip(DIFF_ALL, outs)]
        return (*grads, g_out, None, None, None, None)


def pathtrace_pass_diff(par, ipar, sph, tri, mat, lig, acc, u_planes, *,
                        spp: int, width: int, bounces: int, two_sided: bool,
                        normalize_emitter: bool, seed: int,
                        diff_wrt=DIFF_ALL) -> torch.Tensor:
    """One differentiable progressive pass: returns a new accumulator
    (``acc`` is not modified); autograd reaches the tables in ``diff_wrt``
    and ``acc``. Arguments as ``ops.megakernel.pathtrace_pass`` with one
    pass; JAX's ``pathtrace_pass_diff`` without its TPU-only arguments.

    On CUDA tensors the pass is kernel 1 and its backward kernel 2. On CPU
    tensors it is the plain forward under autograd, with the groups outside
    ``diff_wrt`` detached."""
    sel = _check_wrt(diff_wrt)
    kw = dict(spp=spp, width=width, bounces=bounces, two_sided=two_sided,
              normalize_emitter=normalize_emitter, seed=seed)
    if acc.device.type == "cpu":
        t = [x if n in sel else x.detach()
             for n, x in zip(DIFF_ALL, (par, sph, tri, mat, lig))]
        return MK.pathtrace_pass_reference(t[0], ipar, *t[1:], acc,
                                           u_planes, **kw)
    if acc.device.type != "cuda":
        raise ValueError(f"no kernel for device {acc.device}")
    return _PassDiff.apply(par, sph, tri, mat, lig, acc, ipar, u_planes, kw,
                           sel)
