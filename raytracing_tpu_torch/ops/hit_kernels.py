"""The stage pipeline's closest-hit searches: the counterpart of
``raytracing_tpu/ops/pallas/hit_kernels.py`` (kernel 4 ``_sphere_kernel``,
kernel 5 ``_triangle_kernel``).

Each search returns, per ray, the closest object whose hit parameter lies
inside [mint, maxt]: ``(t float32 (R,), idx int32 (R,))``, INF / -1 on a
miss and for dead rays (mint == maxt). Exact ties go to the lowest index:
the least (t, index) pair wins.

Three layers per object type:

* ``sphere_rows`` / ``triangle_rows`` pack the object table once (the
  stage pass packs once per pass): spheres (S, 8) ``[center xyz, radius,
  0, mask, 0, 0]``, triangles (T, 20) ``[n_geo, c1, c2, e1, e2, k, 0,
  mask, 0, 0]`` -- the megakernel's row layouts with the columns a search
  does not read left 0, so ``ops/intersect.sphere_hit`` / ``triangle_hit``
  read them as they are;
* ``sphere_search_reference`` / ``triangle_search_reference``: the plain
  PyTorch versions, a loop over objects in increasing index with a strict
  ``t < best``, in the Pallas kernels' arithmetic
  (``ops/intersect.sphere_hit`` / ``triangle_hit``);
* ``sphere_search_rows`` / ``triangle_search_rows``: the wrappers. On CUDA
  tensors they launch the hand-written kernels of ``csrc/hit_kernels.cu``
  (built at first use) or raise; on CPU tensors they run the plain
  version. Each launch adds one to the module integer ``sphere_launches``
  or ``triangle_launches``. No host-device synchronisation.

Kernel 4 has two instances, picked by the table's size alone: up to
``SPHERE_BRUTE_MAX`` rows every live ray tests every row (the brute
loop); past it each ray walks a box tree over the rows (``sphere_tree``:
``MK.sphere_tree``'s ``SphereTree``, JAX's Morton order and
``MK.box_tree``'s layout, built on the device with no host
synchronisation, the layout kernel 1's direct mode walks too; the stage
pass builds it once
per pass, ``render/stages.hit_tables``), counted in
``sphere_tree_launches`` as well. Both give the brute loop's (t, idx)
bit for bit; ``sphere_walk_reference`` is the plain version of the walk,
in the kernel's order and arithmetic (``MK._walk_tree``), which also
counts its node and row tests.

``sphere_search`` / ``triangle_search`` take the JAX launchers' arguments
and pack the rows themselves. None of it is differentiable: the callers
run it under ``torch.no_grad()`` and recompute the champions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.types import cross3, dot3
from . import _build
from . import intersect as I
from . import megakernel as MK
from .megakernel import SphereTree

INF = math.inf
SPH_ROW, TRI_ROW = 8, 20
# kernel 4: tables of up to SPHERE_BRUTE_MAX rows take the brute loop,
# larger ones the walk of a box tree over leaves of SPHERE_LEAF rows (a
# power of two up to 32; csrc/hit_kernels.cu sphere_tree_kernel). Both
# measured on one H100 (PERF.md section 6, row 4): the walk overtakes the
# brute loop between 128 and 192 rows on a stage pass's searches (192 to
# 256 on random rays), and leaves of 1 row beat 2 and 4 at every size
SPHERE_BRUTE_MAX = 128
SPHERE_LEAF = 1

sphere_launches = 0
sphere_tree_launches = 0   # of sphere_launches, the tree instance's
triangle_launches = 0


def sphere_rows(center: torch.Tensor, radius: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """(S, 8) float32 rows ``[center xyz, radius, 0, mask, 0, 0]``."""
    s = center.shape[0]
    z = torch.zeros((s, 1), dtype=torch.float32, device=center.device)
    return torch.cat([center.to(torch.float32),
                      radius.to(torch.float32)[:, None], z,
                      mask.to(torch.float32)[:, None], z, z],
                     -1).contiguous()


def triangle_rows(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(T, 20) float32 rows ``[n_geo, c1, c2, e1, e2, k, 0, mask, 0, 0]``
    of the constant-split Moller-Trumbore form."""
    tc = I.tri_constants(v.to(torch.float32))
    z = torch.zeros((v.shape[0], 1), dtype=torch.float32, device=v.device)
    return torch.cat([tc.n_geo, tc.c1, tc.c2, tc.e1, tc.e2, tc.k[:, None],
                      z, mask.to(torch.float32)[:, None], z, z],
                     -1).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def sphere_search_reference(o, d, mint, maxt, rows
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest sphere (t, idx) per ray over packed rows (S, 8)."""
    n = o.shape[0]
    alive = mint != maxt
    a = dot3(d, d)
    # a true division, as in the kernels: ``0.5 / a`` of a tensor is
    # 0.5 * reciprocal(a) in PyTorch, rounded twice
    inv2a = torch.full_like(a, 0.5) / a
    bt = torch.full((n,), INF, device=o.device)
    bi = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for i in range(rows.shape[0]):
        ok, t = I.sphere_hit(o, d, a, inv2a, mint, maxt, rows[i])
        t = torch.where(ok & alive, t, INF)
        better = t < bt
        bt = torch.where(better, t, bt)
        bi = torch.where(better, i, bi)
    return bt, bi


def triangle_search_reference(o, d, mint, maxt, rows, two_sided: bool
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest triangle (t, idx) per ray over packed rows (T, 20);
    single-sided accepts div > 0, two-sided div != 0."""
    n = o.shape[0]
    alive = mint != maxt
    oxd = cross3(o, d)
    bt = torch.full((n,), INF, device=o.device)
    bi = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for i in range(rows.shape[0]):
        ok, t, _, _ = I.triangle_hit(o, d, oxd, mint, maxt, rows[i],
                                     two_sided)
        t = torch.where(ok & alive, t, INF)
        better = t < bt
        bt = torch.where(better, t, bt)
        bi = torch.where(better, i, bi)
    return bt, bi


# ---------------------------------------------------------------------------
# kernel 4's box tree
# ---------------------------------------------------------------------------

def sphere_tree(rows: torch.Tensor, leaf: int | None = None) -> SphereTree:
    """Kernel 4's tree of the packed sphere rows: ``MK.sphere_tree`` over
    leaves of ``leaf`` rows (``SPHERE_LEAF``)."""
    return MK.sphere_tree(rows, SPHERE_LEAF if leaf is None else leaf)


def sphere_walk_reference(o, d, mint, maxt, tree: SphereTree,
                          work: dict | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel 4's tree instance: each ray walks
    ``tree`` as the kernel's lane does (``MK._walk_tree``: the loose rows,
    then nearest child first, culled at the champion's t, each row in the
    brute loop's arithmetic, the least (t, original index) winning).
    Returns ``sphere_search_reference``'s (t, idx); ``work`` gets the
    walk's counts (``node_tests``, ``leaf_visits``, ``sph_tests``,
    ``loose_tests``, and per 32 consecutive rays the union of their
    leaves, ``union_leaves`` and ``union_sph_tests``)."""
    n = o.shape[0]
    a = dot3(d, d)
    inv2a = torch.full_like(a, 0.5) / a
    st = MK._tree_stream(tree)
    champ = (torch.full((n,), INF, device=o.device),
             torch.full((n,), -1, dtype=torch.int64, device=o.device))
    out = {} if work is None else work
    bt, bi = MK._walk_tree("sph", st, o, d, a, inv2a, None, mint, maxt,
                           False, 0, True, champ, out, 32)
    return bt, bi.to(torch.int32)


def _check_tree(tree: SphereTree, rows: torch.Tensor) -> None:
    """A sphere tree's shapes, types and device against the table ``rows``
    it was built from: the sorted rows and perm over whole leaves of at
    most 32 rows that hold the table, and the walk's layout over them
    (``MK._check_tree``)."""
    if not isinstance(tree, SphereTree):
        raise ValueError(f"tree must be a SphereTree, got {type(tree)}")
    leaf = tree.tree.leaf
    if not 0 < leaf <= 32 or leaf & (leaf - 1):
        raise ValueError(f"sphere tree leaves of {leaf} rows: a power of "
                         "two up to 32")
    n = -(-rows.shape[0] // leaf) * leaf
    for what, t, shape, dtype in (
            ("rows", tree.rows, (n, SPH_ROW), torch.float32),
            ("perm", tree.perm, (n,), torch.int32)):
        if (t.device != rows.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"sphere tree {what} must be a contiguous {shape} {dtype} "
                f"tensor on {rows.device}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")
    MK._check_tree("sphere", tree.tree, n, rows.device)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # o, d, mint, maxt, rows, n_obj, [two_sided,] t_out, i_out, n_rays,
    # stream; the spheres' also the tree (sorted rows, perm, nodes, masks,
    # loose, rows, leaf, slots, loose count) and the instance (0 brute, 1
    # tree) after n_obj
    "rt_sphere_search": (ctypes.c_int, [_VP, _VP, _VP, _VP, _VP, _I,
                                        _VP, _VP, _VP, _VP, _VP, _I, _I,
                                        _I, _I, _I, _VP, _VP, _I, _VP]),
    "rt_triangle_search": (ctypes.c_int, [_VP, _VP, _VP, _VP, _VP, _I, _I,
                                          _VP, _VP, _I, _VP]),
}


def _check_args(o, d, mint, maxt, rows, row_cols: int) -> None:
    n = o.shape[0]
    shapes = {"o": (o, (n, 3)), "d": (d, (n, 3)), "mint": (mint, (n,)),
              "maxt": (maxt, (n,)), "rows": (rows, (None, row_cols))}
    for name, (t, shape) in shapes.items():
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, o on {o.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != ts for s, ts in zip(shape, t.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (o, d, mint, maxt, rows)):
        raise RuntimeError("the hit searches are not differentiable: call "
                           "them under torch.no_grad() and recompute the "
                           "champions")
    if n >= (1 << 31) or rows.shape[0] >= (1 << 31):
        raise ValueError("ray and object counts must fit in int32")


def _launch(fname: str, o, d, mint, maxt, rows, *extra):
    """Allocate (t, idx), launch ``fname`` on the current stream, raise on
    a CUDA error."""
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    lib = _build.load("hit_kernels", _SIGNATURES)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    idx = torch.empty((n,), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = getattr(lib, fname)(
            o.data_ptr(), d.data_ptr(), mint.data_ptr(), maxt.data_ptr(),
            rows.data_ptr() if rows.numel() else None, rows.shape[0], *extra,
            t.data_ptr(), idx.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"{fname} launch failed with CUDA error {err}")
    return t, idx


def sphere_search_rows(o, d, mint, maxt, rows,
                       tree: SphereTree | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest sphere (t, idx) per ray: kernel 4 on CUDA tensors, the plain
    version on CPU tensors. o, d (R, 3), mint, maxt (R,), rows (S, 8), all
    float32 and contiguous on one device. Past ``SPHERE_BRUTE_MAX`` rows
    the kernel walks ``tree`` (``sphere_tree(rows)``, built here when
    None); a tree that is passed is checked on every device, and raises
    ValueError where malformed."""
    global sphere_launches, sphere_tree_launches
    _check_args(o, d, mint, maxt, rows, SPH_ROW)
    if tree is not None:
        _check_tree(tree, rows)
    if o.device.type == "cpu":
        return sphere_search_reference(o, d, mint, maxt, rows)
    walk = rows.shape[0] > SPHERE_BRUTE_MAX
    if walk:
        if tree is None:
            tree = sphere_tree(rows)
        tr, st = tree, tree.tree
        extra = (tr.rows.data_ptr(), tr.perm.data_ptr(),
                 st.nodes.data_ptr(), st.masks.data_ptr(),
                 st.loose.data_ptr(), tr.rows.shape[0], st.leaf,
                 st.n_slots, st.loose.shape[0], 1)
    else:
        extra = (None,) * 5 + (0,) * 5
    out = _launch("rt_sphere_search", o, d, mint, maxt, rows, *extra)
    sphere_launches += 1
    sphere_tree_launches += int(walk)
    return out


def triangle_search_rows(o, d, mint, maxt, rows, two_sided: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest triangle (t, idx) per ray: kernel 5 on CUDA tensors, the
    plain version on CPU tensors; rows (T, 20)."""
    global triangle_launches
    _check_args(o, d, mint, maxt, rows, TRI_ROW)
    if o.device.type == "cpu":
        return triangle_search_reference(o, d, mint, maxt, rows, two_sided)
    out = _launch("rt_triangle_search", o, d, mint, maxt, rows,
                  int(two_sided))
    triangle_launches += 1
    return out


def sphere_search(o, d, mint, maxt, center, radius, mask
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sphere_search_pallas``'s arguments: packs the rows, then
    ``sphere_search_rows`` (which builds the tree it walks)."""
    return sphere_search_rows(o, d, mint, maxt,
                              sphere_rows(center, radius, mask))


def triangle_search(o, d, mint, maxt, v, mask, two_sided: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``triangle_search_pallas``'s arguments: packs the rows, then
    ``triangle_search_rows``."""
    return triangle_search_rows(o, d, mint, maxt, triangle_rows(v, mask),
                                two_sided)
