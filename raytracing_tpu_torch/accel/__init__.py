"""Uniform grids: the host-side build (``accel.grid``), the DDA traversal
(``accel.traverse``) and ``prepare_grids``, which attaches every grid a
scene's renders read (``raytracing_tpu.accel``)."""
from __future__ import annotations

import dataclasses

from ..core.types import Scene
from .grid import Grid, build_sphere_grid, build_triangle_grid

__all__ = ["Grid", "auto_slabs", "build_sphere_grid", "build_triangle_grid",
           "prepare_grids"]

# meshes of at most this many triangles join the walls in kernel 1's brute
# prefix (JAX's UNROLL_OBJECTS)
SMALL_MESH = 64


def auto_slabs(n_objects: int) -> int:
    """The JAX package's grid resolution from its measured cost model:
    n ~ cbrt(objects / 40), at least 1."""
    return max(1, round((max(n_objects, 1) / 40.0) ** (1.0 / 3.0)))


def prepare_grids(scene: Scene, n_slabs: int | tuple | str = 1,
                  mesh_slabs: int | str = "xml") -> Scene:
    """The scene with its grids built on the host (the reference's
    preRender splitSphereData / splitTriangleData calls), as the JAX
    package's ``prepare_grids`` builds them, without its front-to-back
    cell order (kernel 1 walks each ray's cells in order):

    * the stage route's grids: ``sphere_grid`` and ``triangle_grid`` at
      ``n_slabs`` (``"auto"``: ``auto_slabs`` of all triangles) and each
      mesh's own ``grid`` at its ``nslabs``;
    * kernel 1's triangle grids ``folded_tri_grid``: one per mesh of more
      than 64 triangles over that mesh's bounds, at ``mesh_slabs`` ("xml":
      the mesh's own nslabs unless 1, then ``n_slabs``; "auto":
      ``auto_slabs`` of its triangles; an int), item ids absolute into the
      fold from ``start`` on; with no such mesh, one grid at ``n_slabs``
      over the whole fold;
    * kernel 1's sphere grid ``mega_sph_grid`` at ``auto_slabs`` of the
      spheres, only past ``ops.megakernel.SPH_RESIDENT_MAX`` spheres."""
    from ..ops import megakernel as MK
    from ..render.stages import _all_triangles
    from .grid import triangle_aabbs
    if n_slabs == "auto":
        n_slabs = auto_slabs(scene.triangles.count
                             + sum(m.tris.count for m in scene.meshes))
    sp, tr = scene.spheres, scene.triangles
    sphere_grid = (build_sphere_grid(sp, scene.sphere_bounds_min,
                                     scene.sphere_bounds_max, n_slabs)
                   if sp.count else None)
    triangle_grid = (build_triangle_grid(tr, scene.triangle_bounds_min,
                                         scene.triangle_bounds_max, n_slabs)
                     if tr.count else None)
    meshes = tuple(dataclasses.replace(
        m, grid=build_triangle_grid(m.tris, m.bounds_min, m.bounds_max,
                                    m.nslabs)) for m in scene.meshes)
    folded = None
    large = [m for m in meshes if m.tris.count > SMALL_MESH]
    if large:
        off = tr.count + sum(m.tris.count for m in meshes
                             if m.tris.count <= SMALL_MESH)
        folded = []
        for m in large:
            if mesh_slabs == "xml":
                res = m.nslabs if (m.nslabs and m.nslabs != 1) else n_slabs
            elif mesh_slabs == "auto":
                res = auto_slabs(m.tris.count)
            else:
                res = int(mesh_slabs)
            folded.append(build_triangle_grid(
                m.tris, m.bounds_min, m.bounds_max, res).shifted(off))
            off += m.tris.count
        folded = tuple(folded)
    elif tr.count + sum(m.tris.count for m in meshes):
        fold = _all_triangles(dataclasses.replace(scene, meshes=meshes))
        lo, hi = triangle_aabbs(fold.v)
        folded = (build_triangle_grid(fold, lo.min(0), hi.max(0), n_slabs),)
    mega_sph = None
    if sp.count > MK.SPH_RESIDENT_MAX:
        mega_sph = build_sphere_grid(sp, scene.sphere_bounds_min,
                                     scene.sphere_bounds_max,
                                     auto_slabs(sp.count))
    return dataclasses.replace(scene, sphere_grid=sphere_grid,
                               triangle_grid=triangle_grid, meshes=meshes,
                               folded_tri_grid=folded,
                               mega_sph_grid=mega_sph)
