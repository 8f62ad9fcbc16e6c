"""Uniform grid (n^3 cells), build side: ``raytracing_tpu.accel.grid``.

Each object is binned into every cell its AABB overlaps, ``floor((aabb -
pmin) / cell_width)`` clipped to ``[0, n - 1]`` per axis (a point on a
cell boundary goes to the upper cell); cells are iz-major (cell = iz n^2
+ iy n + ix); ``cell_offsets`` is the CSR prefix array of C + 1 entries
and ``item_indices`` its payload, item ids ascending within a cell; an
object spanning several cells is listed in each (hits are idempotent).
``items`` is the same lists as a dense (C, K) table padded with -1.

The binning is numpy, vectorised (``np.repeat`` over each item's cell
range, then a stable sort by cell), and gives the JAX package's
``_bin_csr_python`` exactly, in the same dtypes (a float64 cell width, as
numpy promotes it). The build runs on the host; the grid's tensors then
live on the scene's device, its bounds stay host floats.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import _OnDevice


@dataclasses.dataclass(frozen=True, eq=False)
class Grid(_OnDevice):
    """One uniform grid. ``start`` is the first index of the folded
    triangle table that the grid covers (kernel 1's grid mode: indices
    below it run the brute loop); item ids of such a grid are absolute
    into the fold."""
    cell_offsets: torch.Tensor  # (C + 1,) int32 CSR
    item_indices: torch.Tensor  # (total refs,) int32 CSR payload
    items: torch.Tensor         # (C, K) int32 padded with -1
    pmin: np.ndarray            # (3,) float32, host
    pmax: np.ndarray            # (3,) float32, host
    n: tuple = (1, 1, 1)        # (nx, ny, nz)
    max_per_cell: int = 0
    start: int = 0

    @property
    def n_cells(self) -> int:
        return self.n[0] * self.n[1] * self.n[2]

    def width(self) -> np.ndarray:
        """Cell width per axis in float32, 1e-30 on a degenerate axis."""
        w = (self.pmax - self.pmin) / np.asarray(self.n, np.float32)
        return np.where(w <= 0, np.float32(1e-30), w).astype(np.float32)

    def shifted(self, offset: int) -> "Grid":
        """The grid with ``offset`` added to every item id (and ``start`` =
        offset): ids absolute into a folded table."""
        return dataclasses.replace(
            self, item_indices=self.item_indices + offset,
            items=torch.where(self.items >= 0, self.items + offset,
                              self.items),
            start=offset)


def _n3(n) -> tuple[int, int, int]:
    """int -> cubic; a 3-sequence -> per axis ((n, 1, 1) is the 1-D slab
    scheme)."""
    if isinstance(n, (tuple, list)):
        nx, ny, nz = (int(v) for v in n)
        return (nx, ny, nz)
    return (int(n),) * 3


def bin_csr(lo: np.ndarray, hi: np.ndarray, pmin: np.ndarray,
            pmax: np.ndarray, n) -> tuple[np.ndarray, np.ndarray]:
    """(offsets (C + 1,), payload) int32 CSR arrays of the AABBs [lo, hi]
    (O, 3) over the grid [pmin, pmax] at resolution n."""
    nx, ny, nz = _n3(n)
    nv = np.asarray([nx, ny, nz])
    ncells = nx * ny * nz
    width = (pmax - pmin) / nv
    width = np.where(width <= 0, 1e-30, width)
    min_box = np.clip(np.floor((lo - pmin[None, :]) / width[None, :]),
                      0, nv - 1).astype(np.int64)
    max_box = np.clip(np.floor((hi - pmin[None, :]) / width[None, :]),
                      0, nv - 1).astype(np.int64)
    ext = np.maximum(max_box - min_box + 1, 0)          # (O, 3)
    counts = ext.prod(1)
    item = np.repeat(np.arange(lo.shape[0], dtype=np.int64), counts)
    # k-th cell of an item's box, ix fastest (the reference's loop order)
    first = np.cumsum(counts) - counts
    k = np.arange(item.shape[0], dtype=np.int64) - np.repeat(first, counts)
    ex, ey = ext[item, 0], ext[item, 1]
    ix = min_box[item, 0] + k % ex
    iy = min_box[item, 1] + (k // ex) % ey
    iz = min_box[item, 2] + k // (ex * ey)
    cell = iz * (ny * nx) + iy * nx + ix
    order = np.argsort(cell, kind="stable")   # ids stay ascending per cell
    offsets = np.zeros(ncells + 1, np.int32)
    np.cumsum(np.bincount(cell, minlength=ncells), out=offsets[1:])
    return offsets, item[order].astype(np.int32)


def grid_from_csr(offsets: np.ndarray, payload: np.ndarray, pmin, pmax, n,
                  start: int = 0, device=None) -> Grid:
    """A Grid of CSR arrays, with its dense (C, K) table."""
    offsets = np.array(offsets, np.int32)
    payload = np.array(payload, np.int32)
    counts = np.diff(offsets)
    ncells = counts.shape[0]
    k_max = max(int(counts.max()) if counts.size else 0, 1)
    items = np.full((ncells, k_max), -1, np.int32)
    cell = np.repeat(np.arange(ncells), counts)
    slot = np.arange(payload.shape[0]) - np.repeat(offsets[:-1], counts)
    items[cell, slot] = payload
    return Grid(cell_offsets=torch.as_tensor(offsets, device=device),
                item_indices=torch.as_tensor(payload, device=device),
                items=torch.as_tensor(items, device=device),
                pmin=np.array(pmin, np.float32).reshape(3),
                pmax=np.array(pmax, np.float32).reshape(3),
                n=_n3(n), max_per_cell=k_max, start=start)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_grid(lo, hi, pmin, pmax, n, device=None) -> Grid:
    """Build from object AABBs lo/hi (O, 3) over [pmin, pmax]; n: int
    (cubic) or (nx, ny, nz)."""
    pmin = _host(pmin).astype(np.float32).reshape(3)
    pmax = _host(pmax).astype(np.float32).reshape(3)
    lo = _host(lo).astype(np.float32).reshape(-1, 3)
    hi = _host(hi).astype(np.float32).reshape(-1, 3)
    offsets, payload = bin_csr(lo, hi, pmin, pmax, n)
    return grid_from_csr(offsets, payload, pmin, pmax, n, device=device)


def sphere_aabbs(centers, radii) -> tuple[np.ndarray, np.ndarray]:
    c = _host(centers).astype(np.float32)
    r = _host(radii).astype(np.float32)[:, None]
    return c - r, c + r


def triangle_aabbs(v) -> tuple[np.ndarray, np.ndarray]:
    v = _host(v).astype(np.float32)
    return v.min(1), v.max(1)


def build_sphere_grid(spheres, pmin, pmax, n) -> Grid:
    """The reference's splitSphereData (item ids index the sphere batch)."""
    lo, hi = sphere_aabbs(spheres.center, spheres.radius)
    return build_grid(lo, hi, pmin, pmax, n, spheres.center.device)


def build_triangle_grid(tris, pmin, pmax, n) -> Grid:
    """The reference's splitTriangleData / splitMeshData."""
    lo, hi = triangle_aabbs(tris.v)
    return build_grid(lo, hi, pmin, pmax, n, tris.v.device)
