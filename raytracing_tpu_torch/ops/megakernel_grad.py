"""The differentiable pass: the counterpart of
``raytracing_tpu/ops/pallas/megakernel_grad.py`` (hard route, path mode
with or without Russian roulette, and direct mode): two backwards, as in
the JAX package.

Kernel 2, the backward by replay (``bwd_impl_for`` "pallas"; up to
``DIFF_TABLE_MAX`` objects per type, grid scenes included):

* ``pathtrace_pass_bwd_reference`` -- its plain version: the parameter
  cotangents of one pass by ``torch.autograd.grad`` through the plain
  forward (``ops/megakernel._pass_reference``). It returns what JAX's
  ``_bwd_reference`` returns; the CPU tests hold it against it.
* ``pathtrace_pass_bwd`` -- the wrapper of the hand-written CUDA adjoint
  ``csrc/megakernel_grad.cu``. It takes CUDA tensors or raises, and counts
  its launches in the module integers ``launches`` (at most 64 objects
  per type, tables in shared memory) and ``large_launches`` (past 64, or
  over kernel 1's streamed chunks or grids: the large-table instance, JAX's
  ``_loop_diff`` windows).

Kernel 3, the champion ("cell") backward (``bwd_impl_for`` "cell"; what
"auto" takes past 64 objects and in grid mode), which differentiates
kernel 1's record of the pass (``ops.megakernel.pathtrace_pass(record=
True)``) and sweeps no table:

* ``champ_surface`` -- JAX's ``_champ_surface``: a recorded champion's
  surface re-derived from its row with the kernels' formulas;
* ``pathtrace_pass_bwd_champ_reference`` -- its plain version, JAX's
  ``_bwd_champion``: autograd through the plain pass whose trace and
  any-hit read the record (``champ_surface``, the recorded bits);
* ``pathtrace_pass_bwd_champ`` -- the wrapper of the hand-written CUDA
  kernel ``csrc/megakernel_champ.cu``: on CUDA tensors it launches it and
  counts ``champ_launches``, on CPU tensors it runs the plain version.

``pathtrace_pass_diff`` is one differentiable pass. Kernel 2's route on
CUDA tensors is ``_PassDiff`` (forward = kernel 1, backward = kernel 2),
on CPU tensors the plain forward under autograd. The cell route
(``bwd_cell=True``) is ``_PassDiffCell`` on either device: forward = kernel
1 recording, backward = kernel 3, each the plain version on CPU tensors.

Direct mode (``mode="direct"``, JAX's: ``_tile_program``'s direct branch,
``megakernel_grad.py:795-829``) runs every route over kernel 1's direct
pass (``MK.direct_pass``): one segment, the primary hit shaded per light by
``albedo * clip(ambient + (occluded ? 0 : clip(cos)))``, its draws
``u_planes_for_direct``'s (``MK.diff_draws``); the record is one segment
(``_check_record``); ``bounces`` and the roulette are ignored. Ambient
gets a cotangent there.

Gradients follow the JAX package's hard convention: the cotangent of a
closest hit flows to its champion only, occlusion has no adjoint, and the
scene-AABB window only selects (pmin, pmax and ambient get zeros). With
Russian roulette the survival test is a step function, and the cotangent
of a survivor's throughput flows through its 1 / p, p = clip(max(tp),
0.05, 1), split at ties and bounds as JAX's jnp.maximum and jnp.clip
split it.
``diff_wrt`` (``cfg.mega_grad_wrt``) names the table groups that get
cotangents; the others get none.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import rng
from ..core.types import cross3, dot3, safe_normalize
from . import _build
from . import intersect as I
from . import megakernel as MK

DIFF_ALL = ("par", "sph", "tri", "mat", "lig")
# csrc/megakernel_grad.cu: the tape holds bounces + 1 segments, and one
# occlusion bit per light per segment
MAX_BOUNCES = 15
MAX_LIGHTS = 32

# the differentiable pass's table budget per object type, kernels 2 and 2s
# (JAX's render/mega.py DIFF_TABLE_MAX)
DIFF_TABLE_MAX = 4096

launches = 0          # kernel 2, tables of at most 64 objects per type
large_launches = 0    # kernel 2 past 64 objects (rt_pathtrace_bwd_large)
champ_launches = 0    # kernel 3

# nvcc flags of kernels 2 and 3: no contracted multiply-adds
# (csrc/pathtrace_adj.cuh says why)
ADJ_FLAGS = ("--fmad=false",)

_VP, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "rt_pathtrace_bwd": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _I, _I,                                  # g, n_rays, ray_offset
        _VP, _U, _U,                                  # u_planes, pass key
        _I, _I, _I, _I, _I,                # spp, width, bounces, rr, start
        _I, _I, _I,                           # direct, two_sided, normalize
        _I,                                           # diff_wrt bits
        _VP, _VP, _VP, _VP, _VP,                      # dpar .. dlig
        _VP]),                                        # stream
    # past 64 objects per type: streamed chunks, grids, resident or global
    # spheres
    "rt_pathtrace_bwd_large": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _I, _I,                                  # g, n_rays, ray_offset
        _VP, _U, _U,                                  # u_planes, pass key
        _I, _I, _I, _I, _I,                # spp, width, bounces, rr, start
        _I, _I, _I,                           # direct, two_sided, normalize
        _I,                                           # diff_wrt bits
        _VP, _I, _I, _I, _VP,     # grids, n_grids, sph grid, start, streams
        _VP, _VP, _VP, _VP, _VP,                      # dpar .. dlig
        _VP]),                                        # stream
}
_CHAMP_SIGNATURES = {
    "rt_pathtrace_bwd_champ": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _VP, _VP, _I, _I,            # g, ids, occs, n_rays, ray_offset
        _VP, _U, _U,                                  # u_planes, pass key
        _I, _I, _I, _I, _I,                # spp, width, bounces, rr, start
        _I, _I, _I,                           # direct, two_sided, normalize
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


def _leaf_stream(st, leaf: torch.Tensor):
    """``st`` with its sorted rows gathered from ``leaf`` through its
    ``perm`` (padding rows zero), so that autograd reaches the table's own
    rows."""
    if st is None:
        return None
    keep = (st.perm >= 0)[:, None]
    return st._replace(rows=torch.where(
        keep, leaf[st.perm.clamp(min=0).to(torch.int64)], 0.0))


MODES = ("path", "direct")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def n_draws_of(n_lights: int, bounces: int, rr: bool, mode: str) -> int:
    """Draw slots of one pass (JAX's ``n_draw_pairs`` with the lens slot
    kept): path mode's ``MK.n_draws_of``; direct mode's lens and one per
    light (``u_planes_for_direct``), whatever the bounces and roulette."""
    return (1 + n_lights if mode == "direct"
            else MK.n_draws_of(n_lights, bounces, rr))


def _plain_pass(par, ipar, sph, tri, mat, lig, acc, u, *, mode: str,
                spp: int, width: int, bounces: int, two_sided: bool,
                normalize_emitter: bool, russian_roulette: bool,
                rr_start_depth: int, chunks=None, trace=None,
                anyhit=None) -> torch.Tensor:
    """``acc`` plus the plain pass on the draws ``u``: path mode's
    ``MK._pass_reference`` or direct mode's ``MK._direct_reference``, with
    its ``chunks`` and trace / any-hit hooks."""
    roff = int(ipar[1])
    if mode == "direct":
        return MK._direct_reference(par, sph, tri, mat, lig, acc, u, roff,
                                    spp=spp, width=width,
                                    two_sided=two_sided, chunks=chunks,
                                    trace=trace, anyhit=anyhit)
    return MK._pass_reference(par, sph, tri, mat, lig, acc, u, roff, spp=spp,
                              width=width, bounces=bounces,
                              two_sided=two_sided,
                              normalize_emitter=normalize_emitter,
                              russian_roulette=russian_roulette,
                              rr_start_depth=rr_start_depth, trace=trace,
                              anyhit=anyhit, chunks=chunks)


def _autograd_cotangents(tables: dict, sel, g, program):
    """``(dpar, dsph, dtri, dmat, dlig)`` of ``sum(g * program(leaves))``
    by autograd, the groups outside ``sel`` zeros."""
    with torch.enable_grad():
        leaves = {k: (v.detach().requires_grad_(True) if k in sel
                      else v.detach()) for k, v in tables.items()}
        acc = program(leaves)
        grads = dict(zip(sel, torch.autograd.grad(
            acc, [leaves[k] for k in sel], grad_outputs=g,
            allow_unused=True, materialize_grads=True))) if sel else {}
    return tuple(grads[k] if k in grads else torch.zeros_like(v)
                 for k, v in tables.items())


def pathtrace_pass_bwd_reference(par, ipar, sph, tri, mat, lig, g, u_planes,
                                 *, spp: int, width: int, bounces: int,
                                 two_sided: bool, normalize_emitter: bool,
                                 seed: int, russian_roulette: bool = False,
                                 rr_start_depth: int = 0, diff_wrt=DIFF_ALL,
                                 chunks=None, mode: str = "path"):
    """Plain version of kernel 2: ``(dpar, dsph, dtri, dmat, dlig)`` of
    ``sum(g * acc_delta)`` for one pass, by autograd through the plain
    forward, JAX's ``_bwd_reference``. ``mode`` "path" or "direct" (JAX's
    ``mode``; direct mode ignores ``bounces`` and the roulette, as JAX
    does). Groups outside ``diff_wrt`` come back as zeros. With ``chunks``
    (``MK.KernelChunks`` of these tables) the forward tests the streamed
    tables a chunk of rows at a time (``MK._stream_closest``: the brute
    version's champions, bits and values), its rows gathered from the
    tables through ``perm``: the same cotangents, in far fewer launches on
    a long table."""
    _check_mode(mode)
    sel = _check_wrt(diff_wrt)
    u = MK.diff_draws(ipar, u_planes, g.shape[0], lig.shape[0], bounces,
                      seed, g.device, russian_roulette, mode, spp)

    def program(t):
        ch = chunks
        if ch is not None:
            ch = MK.KernelChunks(tri=_leaf_stream(ch.tri, t["tri"]),
                                 sph=_leaf_stream(ch.sph, t["sph"]))
        return _plain_pass(
            t["par"], ipar, t["sph"], t["tri"], t["mat"], t["lig"],
            torch.zeros_like(g), u, mode=mode, spp=spp, width=width,
            bounces=bounces, two_sided=two_sided,
            normalize_emitter=normalize_emitter,
            russian_roulette=russian_roulette, rr_start_depth=rr_start_depth,
            chunks=ch)

    return _autograd_cotangents(dict(par=par, sph=sph, tri=tri, mat=mat,
                                     lig=lig), sel, g, program)


def _check_bwd_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp, width,
                    bounces, rr, what: str = "kernel 2", grid=None,
                    chunks=None, resident=True, mode: str = "path"):
    """A backward's arguments: ``MK._check_args``' (with ``grid`` and
    ``chunks`` its caps apply to the resident prefix; ``resident=False``
    drops them), CUDA tensors, and the adjoint's tape and light caps."""
    _check_mode(mode)
    MK._check_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp, width,
                   n_draws_of(lig.shape[0], bounces, rr, mode), 1, grid=grid,
                   chunks=chunks, resident=resident)
    if g.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {g.device}; "
                         "on the CPU use its plain version (the wrapper's "
                         "name with _reference)")
    _check_caps(bounces, lig.shape[0], mode)


def _check_caps(bounces: int, n_lig: int, mode: str) -> None:
    """The adjoints' tape (path mode) and light caps."""
    if mode == "path" and bounces > MAX_BOUNCES:
        raise ValueError(f"the adjoint's tape holds at most {MAX_BOUNCES} "
                         f"bounces, got {bounces}")
    if n_lig > MAX_LIGHTS:
        raise ValueError(f"the adjoint takes at most {MAX_LIGHTS} lights, "
                         f"got {n_lig}")


def _c_settings(bounces: int, rr: bool, mode: str) -> tuple:
    """(bounces, rr, direct) as the adjoints' C entries take them: direct
    mode traces one segment and plays no roulette."""
    direct = mode == "direct"
    return (0, 0, 1) if direct else (bounces, int(rr), 0)


def large_route(sph, tri, grid=None, chunks=None) -> bool:
    """Whether kernel 2 runs its large-table instance: tables past
    ``UNROLL_OBJECTS`` (64) objects of a type, streamed or gridded ones."""
    return (grid is not None or chunks is not None
            or max(sph.shape[0], tri.shape[0]) > MK.UNROLL_OBJECTS)


def pathtrace_pass_bwd(par, ipar, sph, tri, mat, lig, g, u_planes, *,
                       spp: int, width: int, bounces: int, two_sided: bool,
                       normalize_emitter: bool, seed: int,
                       russian_roulette: bool = False,
                       rr_start_depth: int = 0, diff_wrt=DIFF_ALL,
                       grid=None, chunks=None, mode: str = "path"):
    """Kernel 2: the cotangents of ``pathtrace_pass_bwd_reference`` from
    the hand-written CUDA adjoint, for CUDA tensors (anything else raises).
    ``g`` (R, 3) is the cotangent of the pass's accumulator; the draws are
    ``u_planes`` or, without them, those of pass ``ipar[0]`` of ``seed``,
    made in-kernel as the forward makes them (``MK.diff_draws``). Groups
    outside ``diff_wrt`` come back as zeros. ``mode`` "direct" runs the
    adjoint of direct mode's shade (one segment, no roulette).

    Up to 64 objects per type (``large_route`` False) the tables and
    their gradient buffers sit in shared memory (counter ``launches``).
    Past that, and over kernel 1's streamed ``chunks`` or ``grid`` (the
    forward's own arguments), the large-table instance replays with kernel
    1's streamed and grid loops and adds the row cotangents into global
    memory (counter ``large_launches``); cotangents land on the original
    rows (a streamed champion is named by ``perm``), whatever the replay
    reads."""
    global launches, large_launches
    sel = _check_wrt(diff_wrt)
    large = large_route(sph, tri, grid, chunks)
    _check_bwd_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp, width,
                    bounces, russian_roulette, grid=grid, chunks=chunks,
                    mode=mode)
    outs = tuple(torch.zeros_like(t) for t in (par, sph, tri, mat, lig))
    wrt = sum(1 << i for i, n in enumerate(DIFF_ALL) if n in sel)
    if not wrt:
        return outs
    roff = int(ipar[1])
    k0, k1 = rng.key_words(MK.pass_key_of(ipar, seed))
    n_b, rr, direct = _c_settings(bounces, russian_roulette, mode)
    ptr = MK._ptr
    args = (ptr(par), ptr(sph), sph.shape[0], ptr(tri), tri.shape[0],
            ptr(mat), mat.shape[0], ptr(lig), lig.shape[0], ptr(g),
            g.shape[0], roff, ptr(u_planes), k0, k1, spp, width, n_b, rr,
            rr_start_depth, direct, int(two_sided), int(normalize_emitter),
            wrt)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        lib = _build.load("megakernel_grad", _SIGNATURES, ADJ_FLAGS)
        if large:
            # the descriptor arrays must outlive the call
            gargs, _desc = MK._grid_args(grid, chunks, sph.shape[0],
                                         tri.shape[0])
            err = lib.rt_pathtrace_bwd_large(
                *args, *gargs[1:], *(ptr(t) for t in outs), stream)
        else:
            err = lib.rt_pathtrace_bwd(*args, *(ptr(t) for t in outs),
                                       stream)
        if err != 0:
            raise RuntimeError(f"kernel 2 launch failed with CUDA error {err}")
        if large:
            large_launches += 1
        else:
            launches += 1
    return outs


# ---------------------------------------------------------------------------
# kernel 3: the champion ("cell") backward
# ---------------------------------------------------------------------------

def champ_surface(ids, o, d, mint, maxt, sph, tri):
    """JAX's ``_champ_surface`` (``megakernel_grad.py:951-1029``): the
    surface of each ray's recorded champion ``ids`` (R,) (sphere i, n_sph +
    triangle j, -1 or anything outside the tables for a miss), re-derived
    from its gathered row with the formulas of the plain sweep
    (``ops/megakernel._trace``): the sphere's root under the same [mint,
    maxt] window, the constant-split Moller-Trumbore terms. Returns what
    ``_trace`` returns: (new maxt, hit point, normal, material, champion).
    Where the champion is the sweep's, every value equals the sweep's bit
    for bit. Autograd through the row gathers scatter-adds the cotangents
    onto the champions' rows."""
    n, dev = o.shape[0], o.device
    n_sph, n_tri = sph.shape[0], tri.shape[0]
    ids = ids.to(torch.int64)
    t_sel = torch.zeros((n,), device=dev)
    hn = torch.zeros((n, 3), device=dev)
    matf = torch.full((n,), -1.0, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    if n_sph:
        is_s = (ids >= 0) & (ids < n_sph)
        row = sph[ids.clamp(0, n_sph - 1)]
        a = dot3(d, d)
        inv2a = 0.5 / a
        c = row[:, 0:3]
        m = o - c
        r = row[:, 3]
        b = 2.0 * dot3(m, d)
        cq = dot3(m, m) - r * r
        dis = b * b - 4.0 * a * cq
        # _safe_sqrt's double where: a tangent ray (dis == 0) gets a zero
        # cotangent, not 0/0
        pos = dis > 0.0
        sq = torch.where(pos, I.sqrt_rn(torch.where(pos, dis, 1.0)), 0.0)
        t0 = (-b - sq) * inv2a
        t1 = (-b + sq) * inv2a
        tmn = torch.minimum(t0, t1)
        tmx = torch.maximum(t0, t1)
        t = torch.where((tmn >= mint) & (tmn <= maxt), tmn, tmx)
        ts = torch.where(is_s, t, 0.0)
        sn = safe_normalize(o + ts[:, None] * d - c)
        t_sel = torch.where(is_s, t, t_sel)
        hn = torch.where(is_s[:, None], sn, hn)
        matf = torch.where(is_s, row[:, 4], matf)
        found = found | is_s
    if n_tri:
        is_t = (ids >= n_sph) & (ids < n_sph + n_tri)
        row = tri[(ids - n_sph).clamp(0, n_tri - 1)]
        ng = row[:, 0:3]
        oxd = cross3(o, d)
        div = dot3(d, ng)
        idiv = 1.0 / torch.where(div == 0.0, 1.0, div)
        beta = (dot3(oxd, row[:, 12:15]) - dot3(d, row[:, 6:9])) * idiv
        gamma = (dot3(d, row[:, 3:6]) - dot3(oxd, row[:, 9:12])) * idiv
        t = (row[:, 15] - dot3(o, ng)) * idiv
        alpha = 1.0 - beta - gamma
        tn = safe_normalize(alpha[:, None] * row[:, 18:21]
                            + beta[:, None] * row[:, 21:24]
                            + gamma[:, None] * row[:, 24:27])
        t_sel = torch.where(is_t, t, t_sel)
        hn = torch.where(is_t[:, None], tn, hn)
        matf = torch.where(is_t, row[:, 16], matf)
        found = found | is_t
    ts = torch.where(found, t_sel, 0.0)
    return (torch.where(found, t_sel, maxt), o + ts[:, None] * d,
            torch.where(found[:, None], hn, 0.0),
            torch.where(found, matf, -1.0), torch.where(found, ids, -1))


def _champ_hooks(ids, occs, sph, tri):
    """``_pass_reference``'s trace and any-hit hooks over a record, in
    schedule order (JAX's ``_tile_program_champ``)."""
    seg, occ = iter(ids), iter(occs)

    def trace(o, d, mint, maxt):
        return champ_surface(next(seg), o, d, mint, maxt, sph, tri)

    def anyhit(o, d, mint, maxt):
        return next(occ)

    return trace, anyhit


def pathtrace_pass_bwd_champ_reference(par, ipar, sph, tri, mat, lig, g,
                                       u_planes, ids, occs, *, spp: int,
                                       width: int, bounces: int,
                                       two_sided: bool,
                                       normalize_emitter: bool, seed: int,
                                       russian_roulette: bool = False,
                                       rr_start_depth: int = 0,
                                       diff_wrt=DIFF_ALL, mode: str = "path"):
    """Plain version of kernel 3, JAX's ``_bwd_champion``: ``(dpar, dsph,
    dtri, dmat, dlig)`` of ``sum(g * acc_delta)`` for one pass, by autograd
    through the plain pass on the record ``ids`` (1 + bounces, R) and
    ``occs`` ((1 + bounces) * L, R) -- in direct mode (1, R) and (L, R) --
    which stay fixed. Groups outside ``diff_wrt`` come back as zeros."""
    _check_mode(mode)
    sel = _check_wrt(diff_wrt)
    u = MK.diff_draws(ipar, u_planes, g.shape[0], lig.shape[0], bounces,
                      seed, g.device, russian_roulette, mode, spp)

    def program(t):
        trace, anyhit = _champ_hooks(ids, occs, t["sph"], t["tri"])
        return _plain_pass(
            t["par"], ipar, t["sph"], t["tri"], t["mat"], t["lig"],
            torch.zeros_like(g), u, mode=mode, spp=spp, width=width,
            bounces=bounces, two_sided=two_sided,
            normalize_emitter=normalize_emitter,
            russian_roulette=russian_roulette, rr_start_depth=rr_start_depth,
            trace=trace, anyhit=anyhit)

    return _autograd_cotangents(dict(par=par, sph=sph, tri=tri, mat=mat,
                                     lig=lig), sel, g, program)


def _check_record(ids, occs, n_rays: int, n_lig: int, bounces: int, dev,
                  mode: str = "path"):
    """Kernel 1's record of a pass: ``ids`` (n_seg, R) int32 and ``occs``
    (n_seg * L, R) bool, n_seg = 1 + bounces in path mode and 1 in direct
    mode (JAX's ``n_seg_rec``)."""
    n_seg = 1 if mode == "direct" else 1 + bounces
    for name, t, rows, dtype in (("ids", ids, n_seg, torch.int32),
                                 ("occs", occs, n_seg * n_lig, torch.bool)):
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != (rows, n_rays) or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous ({rows}, {n_rays}) {dtype} "
                f"tensor on {dev} (kernel 1's record of the pass), got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")


def pathtrace_pass_bwd_champ(par, ipar, sph, tri, mat, lig, g, u_planes, ids,
                             occs, *, spp: int, width: int, bounces: int,
                             two_sided: bool, normalize_emitter: bool,
                             seed: int, russian_roulette: bool = False,
                             rr_start_depth: int = 0, diff_wrt=DIFF_ALL,
                             mode: str = "path"):
    """Kernel 3: the cotangents of ``pathtrace_pass_bwd_champ_reference``
    from the hand-written CUDA kernel on CUDA tensors, from the plain
    version on CPU tensors. ``ids`` and ``occs`` are kernel 1's record of
    the pass (``ops.megakernel.pathtrace_pass(record=True)``, in direct
    mode ``direct_pass(record=True)``) on the same tables and draws; ``g``
    (R, 3) is the cotangent of the pass's accumulator; the draws are
    ``u_planes`` or, without them, those of pass ``ipar[0]`` of ``seed``
    (``MK.diff_draws``). Groups outside ``diff_wrt`` come back as
    zeros."""
    global champ_launches
    _check_mode(mode)
    sel = _check_wrt(diff_wrt)
    # kernel 3 reads the sphere and triangle tables from global memory, at
    # any size (a grid scene's whole tables)
    MK._check_args(par, ipar, sph, tri, mat, lig, g, u_planes, spp, width,
                   n_draws_of(lig.shape[0], bounces, russian_roulette, mode),
                   1, resident=False)
    _check_caps(bounces, lig.shape[0], mode)
    _check_record(ids, occs, g.shape[0], lig.shape[0], bounces, g.device,
                  mode)
    kw = dict(spp=spp, width=width, bounces=bounces, two_sided=two_sided,
              normalize_emitter=normalize_emitter, seed=seed,
              russian_roulette=russian_roulette,
              rr_start_depth=rr_start_depth, mode=mode)
    if g.device.type == "cpu":
        return pathtrace_pass_bwd_champ_reference(
            par, ipar, sph, tri, mat, lig, g, u_planes, ids, occs,
            diff_wrt=sel, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    outs = tuple(torch.zeros_like(t) for t in (par, sph, tri, mat, lig))
    wrt = sum(1 << i for i, n in enumerate(DIFF_ALL) if n in sel)
    if not wrt:
        return outs
    lib = _build.load("megakernel_champ", _CHAMP_SIGNATURES, ADJ_FLAGS)
    roff = int(ipar[1])
    k0, k1 = rng.key_words(MK.pass_key_of(ipar, seed))
    n_b, rr, direct = _c_settings(bounces, russian_roulette, mode)
    ptr = MK._ptr
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.rt_pathtrace_bwd_champ(
            ptr(par), ptr(sph), sph.shape[0], ptr(tri), tri.shape[0],
            ptr(mat), mat.shape[0], ptr(lig), lig.shape[0], ptr(g),
            ptr(ids), ptr(occs), g.shape[0], roff, ptr(u_planes), k0, k1,
            spp, width, n_b, rr, rr_start_depth, direct, int(two_sided),
            int(normalize_emitter), wrt, *(ptr(t) for t in outs), stream)
        if err != 0:
            raise RuntimeError(f"kernel 3 launch failed with CUDA error {err}")
        champ_launches += 1
    return outs


def _forward(par, ipar, sph, tri, mat, lig, acc, u_planes, kw, fwd,
             mode: str, record: bool = False):
    """Kernel 1's pass of the differentiable pass (its plain version on CPU
    tensors), on ``acc`` in place: path mode's ``MK.pathtrace_pass``, or
    direct mode's ``MK.direct_pass`` keyed by ``MK.pass_key_of(ipar,
    seed)`` at the ray offset ``ipar[1]``. ``fwd``: ``grid``, ``chunks``,
    ``block``; ``record`` returns the record too."""
    if mode == "path":
        return MK.pathtrace_pass(par, ipar, sph, tri, mat, lig, acc,
                                 u_planes, record=record, **kw, **fwd)
    return MK.direct_pass(par, sph, tri, mat, lig, acc, u_planes,
                          key=MK.pass_key_of(ipar, kw["seed"]),
                          spp=kw["spp"], width=kw["width"],
                          two_sided=kw["two_sided"], ray_offset=int(ipar[1]),
                          record=record, **fwd)


class _PassDiff(torch.autograd.Function):
    """One pass on the card: forward = kernel 1, backward = kernel 2.

    The forward runs kernel 1 out of place, on a copy of ``acc_in``, so the
    tensor autograd saw going in is never overwritten behind its back. The
    backward hands ``g`` on to ``acc_in`` unchanged (acc_out = acc_in +
    delta) and returns no cotangent for ``ipar`` and ``u_planes``. Kernel
    2 replays over the forward's own ``grid`` and ``chunks`` (``fwd``), so
    it picks the champions the forward picked."""

    @staticmethod
    def forward(ctx, par, sph, tri, mat, lig, acc_in, ipar, u_planes, kw,
                diff_wrt, fwd, mode):
        acc = acc_in.clone()
        _forward(par, ipar, sph, tri, mat, lig, acc, u_planes, kw, fwd, mode)
        ctx.save_for_backward(par, sph, tri, mat, lig)
        # ipar carries the pass index (the draws' key) and the ray offset
        ctx.ipar, ctx.u_planes, ctx.kw = ipar, u_planes, kw
        ctx.diff_wrt, ctx.mode = diff_wrt, mode
        ctx.replay = dict(grid=fwd["grid"], chunks=fwd["chunks"])
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
                ctx.u_planes, diff_wrt=wrt, mode=ctx.mode, **ctx.kw,
                **ctx.replay)
            grads = [o if n in wrt else None for n, o in zip(DIFF_ALL, outs)]
        return (*grads, g_out, None, None, None, None, None, None)


class _PassDiffCell(torch.autograd.Function):
    """One pass on the cell route: forward = kernel 1 recording, out of
    place; backward = kernel 3 on that record (JAX's ``_make_diff_op`` with
    ``bwd_cell``). On CPU tensors the two wrappers run their plain
    versions, so the CPU exercises the same wiring: the saved record,
    ``diff_wrt`` and the hand-off of ``g`` to ``acc_in``. ``fwd`` holds
    the recording forward's own arguments (``grid``, ``chunks``,
    ``block``): the record names original rows in grid mode and over
    streamed tables too, so kernel 3 takes the whole tables as they
    are."""

    @staticmethod
    def forward(ctx, par, sph, tri, mat, lig, acc_in, ipar, u_planes, kw,
                diff_wrt, fwd, mode):
        acc, ids, occs = _forward(par, ipar, sph, tri, mat, lig,
                                  acc_in.clone(), u_planes, kw, fwd, mode,
                                  record=True)
        ctx.save_for_backward(par, sph, tri, mat, lig, ids, occs)
        ctx.ipar, ctx.u_planes, ctx.kw = ipar, u_planes, kw
        ctx.diff_wrt, ctx.mode = diff_wrt, mode
        return acc

    @staticmethod
    def backward(ctx, g_out):
        par, sph, tri, mat, lig, ids, occs = ctx.saved_tensors
        wrt = tuple(n for n, need in zip(DIFF_ALL, ctx.needs_input_grad[:5])
                    if need and n in ctx.diff_wrt)
        grads = [None] * 5
        if wrt:
            outs = pathtrace_pass_bwd_champ(
                par, ctx.ipar, sph, tri, mat, lig, g_out.contiguous(),
                ctx.u_planes, ids, occs, diff_wrt=wrt, mode=ctx.mode,
                **ctx.kw)
            grads = [o if n in wrt else None for n, o in zip(DIFF_ALL, outs)]
        return (*grads, g_out, None, None, None, None, None, None)


def _check_soft_grid_rows(grid, sph, tri) -> None:
    """The edge x grid contract (JAX ``render/mega.py:687-699``): the soft
    backward composites each of the scene's rows once, so the tables it
    differentiates hold the scene's own rows (``grid.rows``, counted where
    ``render/mega.grid_tables`` built the grids), never a grid's
    cell-major duplicates."""
    have = (sph.shape[0], tri.shape[0])
    if have != tuple(grid.rows):
        raise ValueError(
            f"edge x grid: {have[0]} sphere / {have[1]} triangle rows, but "
            f"the scene has {grid.rows[0]} / {grid.rows[1]}: the soft "
            "backward takes the scene's own rows, not cell-major duplicates")


def unpermute_rows(d_sorted: torch.Tensor, perm: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Cotangents of a Morton-sorted copy (``MK.Stream``'s rows, padded)
    on the original rows: row ``perm[r]`` gets sorted row r's, padding rows
    (perm -1) are dropped. ``n`` is the original row count."""
    out = d_sorted.new_zeros((n, d_sorted.shape[1]))
    keep = perm >= 0
    out[perm[keep].to(torch.int64)] = d_sorted[keep]
    return out


class _PassDiffSoft(torch.autograd.Function):
    """One pass on the edge-aware route (JAX's ``_make_diff_op`` with
    ``soft_bandwidth > 0``): forward = the hard pass, kernel 1 out of place
    (``fwd``: its ``grid``, ``chunks`` and ``block``); backward = kernel
    2s, the adjoint of the soft program over the scene's own rows, also in
    grid mode. With ``soft_tri`` (an ``MK.Stream``) the backward
    composites the triangles in its Morton order, as JAX's soft route takes
    the streamed table (``tri_chunk_tables``, padded to whole chunks), and
    the cotangents return to the original rows through its ``perm``. On
    CPU tensors the forward and backward are their plain versions, so the
    CPU runs the same wiring."""

    @staticmethod
    def forward(ctx, par, sph, tri, mat, lig, acc_in, ipar, u_planes, kw,
                diff_wrt, fwd, mode, soft, soft_tri):
        acc = acc_in.clone()
        _forward(par, ipar, sph, tri, mat, lig, acc, u_planes, kw, fwd, mode)
        ctx.save_for_backward(par, sph, tri, mat, lig)
        ctx.ipar, ctx.u_planes, ctx.kw = ipar, u_planes, kw
        ctx.diff_wrt, ctx.soft, ctx.soft_tri = diff_wrt, soft, soft_tri
        ctx.mode = mode
        return acc

    @staticmethod
    def backward(ctx, g_out):
        from . import megakernel_soft as MKS
        par, sph, tri, mat, lig = ctx.saved_tensors
        wrt = tuple(n for n, need in zip(DIFF_ALL, ctx.needs_input_grad[:5])
                    if need and n in ctx.diff_wrt)
        grads = [None] * 5
        if wrt:
            bwd = (MKS.pathtrace_pass_bwd_soft if g_out.device.type == "cuda"
                   else MKS.pathtrace_pass_bwd_soft_reference)
            st = ctx.soft_tri
            outs = list(bwd(par, ctx.ipar, sph,
                            tri if st is None else st.rows, mat, lig,
                            g_out.contiguous(), ctx.u_planes, diff_wrt=wrt,
                            mode=ctx.mode, **ctx.kw, **ctx.soft))
            if st is not None:
                outs[2] = unpermute_rows(outs[2], st.perm, tri.shape[0])
            grads = [o if n in wrt else None for n, o in zip(DIFF_ALL, outs)]
        return (*grads, g_out, None, None, None, None, None, None, None,
                None)


def pathtrace_pass_diff(par, ipar, sph, tri, mat, lig, acc, u_planes, *,
                        spp: int, width: int, bounces: int, two_sided: bool,
                        normalize_emitter: bool, seed: int,
                        russian_roulette: bool = False,
                        rr_start_depth: int = 0, diff_wrt=DIFF_ALL,
                        bwd_cell: bool = False, grid=None, chunks=None,
                        block: int = 0, soft_bandwidth: float = 0.0,
                        soft_tau: float = 0.0, soft_tri=None,
                        mode: str = "path") -> torch.Tensor:
    """One differentiable progressive pass: returns a new accumulator
    (``acc`` is not modified); autograd reaches the tables in ``diff_wrt``
    and ``acc``. Arguments as ``ops.megakernel.pathtrace_pass`` with one
    pass; JAX's ``pathtrace_pass_diff`` without its TPU-only arguments.

    ``mode`` (JAX's): "path", or "direct", kernel 1's direct mode
    (``MK.direct_pass``: the primary hit shaded by ambient + clipped cosine
    per light, times albedo), its draws ``u_planes`` (``u_planes_for_direct``'s
    layout) or those of ``MK.diff_draws`` (keyed by pass ``ipar[0]`` of
    ``seed``); ``bounces`` and the roulette are ignored there, as in JAX.
    Every route below takes either mode.

    ``bwd_cell=False`` (kernel 2's route): on CUDA tensors the pass is
    kernel 1 and its backward kernel 2, which replays over the same
    ``grid`` (kernel 1's grid mode) or ``chunks`` (kernel 1's streamed
    tables) as the forward, past 64 objects in its large-table instance; on
    CPU tensors it is the plain brute forward under autograd (the
    champions of the streamed and grid modes are the brute loops', the
    least (t, id) pair), with the groups outside ``diff_wrt`` detached.
    ``bwd_cell=True``: kernel 1 recording and kernel 3 (``_PassDiffCell``),
    their plain versions on CPU tensors. ``block`` is kernel 1's blocked
    layout.

    ``soft_bandwidth > 0`` (edge-aware gradients, ``_PassDiffSoft`` on
    either device): the forward stays the hard pass, the backward is kernel
    2s, the adjoint of the soft program (``ops.megakernel_soft``), with
    ``soft_tau`` its depth-order temperature. It differentiates the tables
    it is given, which must be the scene's own rows: with ``grid`` too, no
    cell-major duplicates (they would composite a surface twice).
    ``soft_tri`` (an ``MK.Stream`` of the triangle table, e.g.
    ``chunks.tri``) hands it the triangles in that Morton order; past 64
    objects the two-level composite's spans follow the order it is
    given."""
    _check_mode(mode)
    sel = _check_wrt(diff_wrt)
    soft = soft_bandwidth > 0.0
    if soft and bwd_cell:
        raise ValueError("the champion (cell) backward is hard-gradient "
                         "only; edge mode needs the soft sweep")
    fwd = dict(grid=grid, chunks=chunks, block=block)
    kw = dict(spp=spp, width=width, bounces=bounces, two_sided=two_sided,
              normalize_emitter=normalize_emitter, seed=seed,
              russian_roulette=russian_roulette,
              rr_start_depth=rr_start_depth)
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {acc.device}")
    if soft:
        if grid is not None:
            _check_soft_grid_rows(grid, sph, tri)
        return _PassDiffSoft.apply(par, sph, tri, mat, lig, acc, ipar,
                                   u_planes, kw, sel, fwd, mode,
                                   dict(soft_bandwidth=soft_bandwidth,
                                        soft_tau=soft_tau or soft_bandwidth),
                                   soft_tri)
    if bwd_cell:
        return _PassDiffCell.apply(par, sph, tri, mat, lig, acc, ipar,
                                   u_planes, kw, sel, fwd, mode)
    if acc.device.type == "cpu":
        t = [x if n in sel else x.detach()
             for n, x in zip(DIFF_ALL, (par, sph, tri, mat, lig))]
        u = MK.diff_draws(ipar, u_planes, acc.shape[0], lig.shape[0],
                          bounces, seed, acc.device, russian_roulette, mode,
                          spp)
        kw.pop("seed")
        return _plain_pass(t[0], ipar, *t[1:], acc, u, mode=mode, **kw)
    return _PassDiff.apply(par, sph, tri, mat, lig, acc, ipar, u_planes, kw,
                           sel, fwd, mode)
