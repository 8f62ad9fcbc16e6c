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
pass builds it once per pass, ``render/stages.hit_tables``), counted in
``sphere_tree_launches`` as well. Both give the brute loop's (t, idx)
bit for bit; ``sphere_walk_reference`` is the plain version of the walk,
in the kernel's order and arithmetic (``MK._walk_tree``), which also
counts its node and row tests.

Kernel 5 has the same two instances: up to ``TRIANGLE_BRUTE_MAX`` rows
the brute loop, past it each ray walks a box tree over the rows
(``triangle_tree``: ``TriangleTree``, the rows in the Morton order of
their vertex centroids, a leaf's box its masked-on rows' vertices),
counted in ``triangle_tree_launches`` as well. The packed rows hold no
vertices, so the wrapper cannot build that tree: past the threshold it
raises without one, and the callers that hold the vertices build it
(``render/stages.hit_tables``, ``closest_hit``, ``triangle_search``).
``triangle_walk_reference`` is the walk's plain version.

A stage pass builds each tree once (``pass_sphere_tree``,
``pass_triangle_tree``): on the card by one launch of
``csrc/sphere_tree.cu`` up to ``MK.TREE_BUILD_MAX`` rows
(``MK.sphere_tree_build``, ``triangle_tree_build``; counted in
``MK.tree_build_launches`` and ``triangle_build_launches``), past it by
the torch build on the card (``sphere_tree``, ``triangle_tree``; counted
in ``torch_tree_builds``), the row count alone choosing before anything
is launched; on the CPU by the torch build.

``sphere_search`` / ``triangle_search`` take the JAX launchers' arguments
and pack the rows (and build the tree) themselves. None of it is
differentiable: the callers run it under ``torch.no_grad()`` and
recompute the champions.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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
# kernel 5: tables of up to TRIANGLE_BRUTE_MAX rows take the brute loop,
# larger ones the walk of a box tree over leaves of TRIANGLE_LEAF rows
# (csrc/hit_kernels.cu triangle_tree_kernel). Both measured on one H100
# (PERF.md section 6, row 5): the walk overtakes the brute loop between
# 16 and 32 rows, on random rays over soups and on a stage pass's
# searches over a room and a torus alike (below 32 rows either search is
# paced by its wrapper's host work); leaves of 1 row beat 2 and 4 on the
# soup of 4096 and the torus scene's 1,002, 2 ran a few % faster at 32-128
TRIANGLE_BRUTE_MAX = 16
TRIANGLE_LEAF = 1

sphere_launches = 0
sphere_tree_launches = 0     # of sphere_launches, the tree instance's
triangle_launches = 0
triangle_tree_launches = 0   # of triangle_launches, the tree instance's
triangle_build_launches = 0  # triangle_tree_build's kernel
torch_tree_builds = 0        # a pass's trees built by torch on the card


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
    a = dot3(d, d)
    inv2a = torch.full_like(a, 0.5) / a
    return _walk("sph", o, d, a, inv2a, None, mint, maxt, False, tree, work)


def _walk(kind: str, o, d, a, inv2a, oxd, mint, maxt, two_sided: bool,
          tree, work: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Each ray's walk of ``tree`` from no champion (``MK._walk_tree``):
    (t, idx int32)."""
    n = o.shape[0]
    champ = (torch.full((n,), INF, device=o.device),
             torch.full((n,), -1, dtype=torch.int64, device=o.device))
    out = {} if work is None else work
    bt, bi = MK._walk_tree(kind, MK._tree_stream(tree), o, d, a, inv2a, oxd,
                           mint, maxt, two_sided, 0, True, champ, out, 32)
    return bt, bi.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel 5's box tree
# ---------------------------------------------------------------------------

class TriangleTree(NamedTuple):
    """A box tree over a triangle table of T rows (``triangle_tree``),
    which kernel 5's tree instance walks: ``rows`` (N, 20) float32, the
    packed rows in the stable order of their vertex centroids' Morton
    codes, padded with zero rows to N, whole leaves; ``perm`` (N,) int32,
    the original row of each sorted row, -1 for padding; ``tree`` the
    walk's layout over the sorted rows (``MK.StreamTree``)."""
    rows: torch.Tensor
    perm: torch.Tensor
    tree: MK.StreamTree


def triangle_tree(v: torch.Tensor, rows: torch.Tensor,
                  leaf: int | None = None) -> TriangleTree:
    """The box tree of the packed triangle rows ``rows`` (T >= 1, 20) and
    their vertices ``v`` (T, 3, 3) over leaves of ``leaf`` rows
    (``TRIANGLE_LEAF``), on their device, with no host synchronisation.

    A row is masked on where its mask column (17) is set, as the brute
    loop tests it. A masked-on row's box is its vertices' min / max; the
    rows' own box (over those boxes) gives the Morton codes' frame (the
    codes of the vertex centroids (v0 + v1 + v2) / 3, JAX's order of
    ``render/mega.tri_chunk_tables``), the loose rule's room (its longest
    side: a room's walls are loose) and the pad's scale (its largest
    |coordinate|): every box is widened by ``MK.CHUNK_PAD`` of it. Needs
    no scene, as ``MK.sphere_tree``; masked-off rows take part in no box,
    mask or loose list. ``triangle_tree_build`` is the same build on the
    card in one launch."""
    leaf = TRIANGLE_LEAF if leaf is None else leaf
    with torch.no_grad():
        v, rows = v.detach().to(torch.float32), rows.detach()
        t, dev = rows.shape[0], rows.device
        n = -(-t // leaf) * leaf
        on = rows[:, 17:18] > 0.0
        lo = torch.where(on, v.amin(1), INF)
        hi = torch.where(on, v.amax(1), -INF)
        pmin, pmax = lo.amin(0), hi.amax(0)
        tot = v[:, 0] + v[:, 1] + v[:, 2]
        # a tensor divisor: PyTorch's CUDA build multiplies by the
        # reciprocal of a scalar one, which rounds apart from a true
        # division (the build kernel's, and the CPU's)
        cen = tot / torch.full_like(tot, 3.0)
        order = torch.argsort(MK.morton_codes(cen, pmin, pmax), stable=True)
        pad = n - t
        inf = torch.full((pad, 3), INF, device=dev)
        srows = torch.cat([rows[order], rows.new_zeros((pad, TRI_ROW))])
        perm = torch.cat([order.to(torch.int32),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=dev)])
        lo, hi = torch.cat([lo[order], inf]), torch.cat([hi[order], -inf])
        scale = torch.where(on, v.abs().amax(1), 0.0).amax()
        tree = MK.box_tree(lo, hi, (perm >= 0) & (lo <= hi).all(1), leaf,
                           MK.CHUNK_PAD * scale, (pmax - pmin).amax())
    return TriangleTree(rows=srows.contiguous(), perm=perm, tree=tree)


def triangle_tree_build(v: torch.Tensor, rows: torch.Tensor,
                        leaf: int | None = None) -> TriangleTree:
    """``triangle_tree(v, rows, leaf)`` built on the card by one launch of
    ``csrc/sphere_tree.cu``'s triangle instance (counted in
    ``triangle_build_launches``; no host synchronisation), equal to it
    element for element; on CPU tensors ``triangle_tree`` itself. rows
    (T, 20) float32, contiguous, v (T, 3, 3) on its device, 1 <= T <=
    ``MK.TREE_BUILD_MAX`` on the card; leaf a power of two up to 32."""
    global triangle_build_launches
    leaf = TRIANGLE_LEAF if leaf is None else leaf
    t = rows.shape[0] if rows.dim() == 2 else 0
    if (rows.dim() != 2 or rows.shape[1] != TRI_ROW
            or rows.dtype != torch.float32 or not rows.is_contiguous()):
        raise ValueError(f"rows must be contiguous (T, {TRI_ROW}) float32, "
                         f"got {tuple(rows.shape)} {rows.dtype}")
    if tuple(v.shape) != (t, 3, 3) or v.device != rows.device:
        raise ValueError(f"v must be ({t}, 3, 3) on {rows.device}, got "
                         f"{tuple(v.shape)} on {v.device}")
    if not 0 < leaf <= 32 or leaf & (leaf - 1):
        raise ValueError(f"triangle tree leaves of {leaf} rows: a power of "
                         "two up to 32")
    if t < 1:
        raise ValueError("a triangle tree needs at least one row")
    if rows.device.type == "cpu":
        return triangle_tree(v, rows, leaf)
    if t > MK.TREE_BUILD_MAX:
        raise ValueError(f"the tree's build kernel takes at most "
                         f"{MK.TREE_BUILD_MAX} rows, got {t}")
    v = v.detach().to(torch.float32).contiguous()
    rows = rows.detach()
    lib = _build.load("sphere_tree", MK._TREE_SIGNATURES)
    dev = rows.device
    srows, perm, st = MK.tree_outputs(-(-t // leaf) * leaf, TRI_ROW, leaf,
                                      dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_triangle_tree(
            rows.data_ptr(), v.data_ptr(), t, leaf, st.n_slots,
            MK.CHUNK_PAD, MK.LOOSE_SHARE, st.loose.shape[0],
            srows.data_ptr(), perm.data_ptr(), st.nodes.data_ptr(),
            st.masks.data_ptr(), st.loose.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rt_triangle_tree launch failed with CUDA error "
                           f"{err}")
    triangle_build_launches += 1
    return TriangleTree(rows=srows, perm=perm, tree=st)


def triangle_walk_reference(o, d, mint, maxt, tree: TriangleTree,
                            two_sided: bool, work: dict | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel 5's tree instance, as
    ``sphere_walk_reference`` is kernel 4's: returns
    ``triangle_search_reference``'s (t, idx); ``work`` gets the walk's
    counts (``node_tests``, ``leaf_visits``, ``tri_tests``,
    ``loose_tests``, ``union_leaves``, ``union_tri_tests``)."""
    return _walk("tri", o, d, None, None, cross3(o, d), mint, maxt,
                 two_sided, tree, work)


# ---------------------------------------------------------------------------
# the trees a stage pass builds
# ---------------------------------------------------------------------------

def _torch_build_on_card(rows: torch.Tensor) -> bool:
    """Whether a pass's tree over ``rows`` is the torch build's on the card
    (past ``MK.TREE_BUILD_MAX`` rows); counted in ``torch_tree_builds``."""
    global torch_tree_builds
    past = rows.device.type != "cpu" and rows.shape[0] > MK.TREE_BUILD_MAX
    torch_tree_builds += int(past)
    return past


def pass_sphere_tree(rows: torch.Tensor) -> SphereTree | None:
    """Kernel 4's tree over the sphere rows as a stage pass builds it once
    per pass: None up to ``SPHERE_BRUTE_MAX`` rows (the brute loop), else
    ``MK.sphere_tree_build`` (one launch) up to ``MK.TREE_BUILD_MAX`` rows
    and the torch build ``sphere_tree`` past it, by the row count alone."""
    if rows.shape[0] <= SPHERE_BRUTE_MAX:
        return None
    if _torch_build_on_card(rows):
        return sphere_tree(rows)
    return MK.sphere_tree_build(rows, SPHERE_LEAF)


def pass_triangle_tree(v: torch.Tensor, rows: torch.Tensor
                       ) -> TriangleTree | None:
    """Kernel 5's tree over the triangle rows and their vertices as a
    stage pass builds it, as ``pass_sphere_tree``: None up to
    ``TRIANGLE_BRUTE_MAX`` rows, else ``triangle_tree_build`` up to
    ``MK.TREE_BUILD_MAX`` rows and ``triangle_tree`` past it."""
    if rows.shape[0] <= TRIANGLE_BRUTE_MAX:
        return None
    if _torch_build_on_card(rows):
        return triangle_tree(v, rows)
    return triangle_tree_build(v, rows)


def _check_tree(tree, rows: torch.Tensor) -> None:
    """A tree's shapes, types and device against the table ``rows`` it
    was built from (a ``SphereTree`` over sphere rows, a ``TriangleTree``
    over triangle rows): the sorted rows and perm over whole leaves of at
    most 32 rows that hold the table, the rows 16-byte aligned (the walks
    read them in float4s), and the walk's layout over them
    (``MK._check_tree``)."""
    cols = rows.shape[1]
    cls, kind = ((SphereTree, "sphere") if cols == SPH_ROW
                 else (TriangleTree, "triangle"))
    if not isinstance(tree, cls):
        raise ValueError(f"tree must be a {cls.__name__}, got {type(tree)}")
    leaf = tree.tree.leaf
    if not 0 < leaf <= 32 or leaf & (leaf - 1):
        raise ValueError(f"{kind} tree leaves of {leaf} rows: a power of "
                         "two up to 32")
    n = -(-rows.shape[0] // leaf) * leaf
    for what, t, shape, dtype in (
            ("rows", tree.rows, (n, cols), torch.float32),
            ("perm", tree.perm, (n,), torch.int32)):
        if (t.device != rows.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{kind} tree {what} must be a contiguous {shape} {dtype} "
                f"tensor on {rows.device}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")
    if tree.rows.data_ptr() % 16:
        raise ValueError(f"{kind} tree rows must be 16-byte aligned")
    MK._check_tree(kind, tree.tree, n, rows.device)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # o, d, mint, maxt, rows, n_obj, the tree (sorted rows, perm, nodes,
    # masks, loose, rows, leaf, slots, loose count), the instance (0 brute,
    # 1 tree), [two_sided,] t_out, i_out, n_rays, stream
    "rt_sphere_search": (ctypes.c_int, [_VP, _VP, _VP, _VP, _VP, _I,
                                        _VP, _VP, _VP, _VP, _VP, _I, _I,
                                        _I, _I, _I, _VP, _VP, _I, _VP]),
    "rt_triangle_search": (ctypes.c_int, [_VP, _VP, _VP, _VP, _VP, _I,
                                          _VP, _VP, _VP, _VP, _VP, _I, _I,
                                          _I, _I, _I, _I, _VP, _VP, _I,
                                          _VP]),
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


def _tree_args(tree) -> tuple:
    """The C entries' tree arguments and instance flag (brute: none, 0)."""
    if tree is None:
        return (None,) * 5 + (0,) * 5
    st = tree.tree
    return (tree.rows.data_ptr(), tree.perm.data_ptr(), st.nodes.data_ptr(),
            st.masks.data_ptr(), st.loose.data_ptr(), tree.rows.shape[0],
            st.leaf, st.n_slots, st.loose.shape[0], 1)


def sphere_search_rows(o, d, mint, maxt, rows,
                       tree: SphereTree | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest sphere (t, idx) per ray: kernel 4 on CUDA tensors, the plain
    version on CPU tensors. o, d (R, 3), mint, maxt (R,), rows (S, 8), all
    float32 and contiguous on one device. Past ``SPHERE_BRUTE_MAX`` rows
    the kernel walks ``tree`` (``pass_sphere_tree(rows)``, built here when
    None); a tree that is passed is checked on every device, and raises
    ValueError where malformed."""
    global sphere_launches, sphere_tree_launches
    _check_args(o, d, mint, maxt, rows, SPH_ROW)
    if tree is not None:
        _check_tree(tree, rows)
    if o.device.type == "cpu":
        return sphere_search_reference(o, d, mint, maxt, rows)
    walk = rows.shape[0] > SPHERE_BRUTE_MAX
    if walk and tree is None:
        tree = pass_sphere_tree(rows)
    out = _launch("rt_sphere_search", o, d, mint, maxt, rows,
                  *_tree_args(tree if walk else None))
    sphere_launches += 1
    sphere_tree_launches += int(walk)
    return out


def triangle_search_rows(o, d, mint, maxt, rows, two_sided: bool = False,
                         tree: TriangleTree | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest triangle (t, idx) per ray: kernel 5 on CUDA tensors, the
    plain version on CPU tensors; rows (T, 20). Past
    ``TRIANGLE_BRUTE_MAX`` rows the kernel walks ``tree``, which the
    caller builds from the vertices (``pass_triangle_tree(v, rows)``):
    without one it raises ValueError, on every device. A tree that is
    passed is checked on every device, and raises ValueError where
    malformed."""
    global triangle_launches, triangle_tree_launches
    _check_args(o, d, mint, maxt, rows, TRI_ROW)
    if tree is not None:
        _check_tree(tree, rows)
    walk = rows.shape[0] > TRIANGLE_BRUTE_MAX
    if walk and tree is None:
        raise ValueError(
            f"{rows.shape[0]} triangle rows take kernel 5's tree instance "
            f"(past TRIANGLE_BRUTE_MAX = {TRIANGLE_BRUTE_MAX}) and no tree "
            "was passed: the packed rows hold no vertices, so build it "
            "with hit_kernels.pass_triangle_tree(v, rows)")
    if o.device.type == "cpu":
        return triangle_search_reference(o, d, mint, maxt, rows, two_sided)
    out = _launch("rt_triangle_search", o, d, mint, maxt, rows,
                  *_tree_args(tree if walk else None), int(two_sided))
    triangle_launches += 1
    triangle_tree_launches += int(walk)
    return out


def sphere_search(o, d, mint, maxt, center, radius, mask
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sphere_search_pallas``'s arguments: packs the rows, then
    ``sphere_search_rows`` (which builds the tree it walks)."""
    return sphere_search_rows(o, d, mint, maxt,
                              sphere_rows(center, radius, mask))


def triangle_search(o, d, mint, maxt, v, mask, two_sided: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``triangle_search_pallas``'s arguments: packs the rows and builds
    the tree past ``TRIANGLE_BRUTE_MAX`` rows (``pass_triangle_tree``),
    then ``triangle_search_rows``."""
    rows = triangle_rows(v, mask)
    return triangle_search_rows(o, d, mint, maxt, rows, two_sided,
                                pass_triangle_tree(v, rows))
