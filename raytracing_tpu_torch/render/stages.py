"""The wavefront stage pipeline (``raytracing_tpu.render.stages``): closest
hit over every geometry type with the champion merge, any-hit occlusion,
emitter hits, next-event estimation, bounce rays, Russian roulette, and
the accumulator-to-image tonemap.

Each stage is eager PyTorch over the whole ray batch and differentiable
through autograd, as the JAX package's stages are through ``jax.grad``.
With ``cfg.use_pallas`` every closest-hit and any-hit search runs in the
hit kernels (``ops/hit_kernels.py``: kernels 4 and 5 on the card), over
object rows packed once per pass (``hit_tables``); otherwise in chunked
all-pairs scans. With ``cfg.use_grid`` (after ``accel.prepare_grids``)
spheres, scene triangles and each mesh are searched through their own
grids by the DDA of ``accel/traverse.py`` (plain PyTorch, as the JAX
package's runs in XLA), as the JAX package's grid branch does; a scene
without its grids raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.config import RenderConfig
from ..core.sampling import cosine_hemisphere, sample_disk_point
from ..core.types import Hits, Lights, Rays, Scene, Triangles, at_least, \
    clip, dot3, replace, safe_normalize
from ..ops import hit_kernels as HK
from ..ops import intersect as I
from ..ops.megakernel import survival_p
from ..ops.closest_hit import (anyhit_spheres, anyhit_triangles,
                               closest_hit_spheres, closest_hit_triangles,
                               palette_lookup, sphere_hit_attrs,
                               triangle_hit_attrs)

INF = math.inf


def _all_triangles(scene: Scene) -> Triangles:
    """Every triangle the brute-force path traces, in the JAX package's
    fold order: the scene triangles, then meshes of at most 64 triangles,
    then the larger meshes (whose suffix kernel 1's grid mode covers)."""
    small = [m.tris for m in scene.meshes if m.tris.count <= 64]
    large = [m.tris for m in scene.meshes if m.tris.count > 64]
    parts = [p for p in [scene.triangles] + small + large if p.count]
    if len(parts) <= 1:
        return parts[0] if parts else scene.triangles
    return Triangles(*(torch.cat([getattr(p, f) for p in parts])
                       for f in ("v", "vn", "mat_id", "mask")))


class HitTables(NamedTuple):
    """Object rows of the hit kernels, packed once per pass; None where
    ``cfg.use_pallas`` is off or the scene has no objects of the type.
    ``sph_tree`` / ``tri_tree``: kernel 4's / kernel 5's box tree over
    ``sph`` / ``tri``, built once per pass where the table takes the tree
    instance (past ``HK.SPHERE_BRUTE_MAX`` / ``HK.TRIANGLE_BRUTE_MAX``
    rows), else None."""
    sph: torch.Tensor | None
    tri: torch.Tensor | None
    sph_tree: HK.SphereTree | None = None
    tri_tree: HK.TriangleTree | None = None


def hit_tables(scene: Scene, cfg: RenderConfig) -> HitTables:
    """The pass's packed rows and trees (``HK.pass_sphere_tree``,
    ``HK.pass_triangle_tree``: on the card one launch each up to
    ``MK.TREE_BUILD_MAX`` rows, the torch build past it)."""
    if not cfg.use_pallas:
        return HitTables(None, None)
    tris = _all_triangles(scene)
    with torch.no_grad():
        sp = scene.spheres
        sph = (HK.sphere_rows(sp.center, sp.radius, sp.mask)
               if sp.count else None)
        tri = HK.triangle_rows(tris.v, tris.mask) if tris.count else None
        return HitTables(
            sph, tri, HK.pass_sphere_tree(sph) if sp.count else None,
            HK.pass_triangle_tree(tris.v, tri) if tris.count else None)


def _check_grids(scene: Scene) -> None:
    """The grid branch reads grids that ``accel.prepare_grids`` built;
    without them it raises rather than search brute force."""
    if ((scene.spheres.count and scene.sphere_grid is None)
            or (scene.triangles.count and scene.triangle_grid is None)
            or any(m.grid is None for m in scene.meshes)):
        raise ValueError("use_grid needs the scene's grids: call "
                         "accel.prepare_grids(scene, ...) first")


def _grid_batches(scene: Scene):
    """The triangle batches of the grid branch with their grids: the scene
    triangles, then each mesh."""
    out = [(scene.triangles, scene.triangle_grid)] if scene.triangles.count \
        else []
    return out + [(m.tris, m.grid) for m in scene.meshes]


def trace_all(rays: Rays, hits: Hits, scene: Scene, cfg: RenderConfig,
              tables: HitTables | None = None) -> tuple[Rays, Hits]:
    """Closest hit over spheres, then triangles, merged by champion t
    (strict ``<``). Returns the rays with maxt shrunk to the champion's t
    and the merged hits; ``hits`` carries the incoming throughput and, with
    ``cfg.replicate_stale_poi``, the previous hit kept on lanes that miss
    (the reference's stale-POI quirk)."""
    if cfg.use_grid:
        from ..accel.traverse import grid_closest_spheres, \
            grid_closest_triangles
        _check_grids(scene)
    if tables is None:
        tables = hit_tables(scene, cfg)
    n, dev = rays.n, rays.o.device
    bt = torch.full((n,), INF, device=dev)
    bp = torch.zeros((n, 3), device=dev)
    bn = torch.zeros((n, 3), device=dev)
    bm = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def merge(ch, p, nrm, mat):
        nonlocal bt, bp, bn, bm
        better = ch.valid & (ch.t < bt)
        bt = torch.where(better, ch.t, bt)
        bp = torch.where(better[:, None], p, bp)
        bn = torch.where(better[:, None], nrm, bn)
        bm = torch.where(better, mat, bm)

    if scene.spheres.count:
        if cfg.use_grid:
            ch = grid_closest_spheres(rays, scene.spheres, scene.sphere_grid)
        else:
            ch = closest_hit_spheres(rays, scene.spheres,
                                     obj_chunk=cfg.obj_chunk,
                                     use_pallas=cfg.use_pallas,
                                     rows=tables.sph, tree=tables.sph_tree)
        merge(ch, *sphere_hit_attrs(rays, scene.spheres, ch))
    ts = cfg.two_sided_triangles
    if cfg.use_grid:
        # per batch (the reference's per-mesh dispatch); ids are local to
        # the batch, which the attributes below read
        for tris, grid in _grid_batches(scene):
            ch = grid_closest_triangles(rays, tris, grid, two_sided=ts)
            merge(ch, *triangle_hit_attrs(rays, tris, ch))
    elif _all_triangles(scene).count:
        tris = _all_triangles(scene)
        ch = closest_hit_triangles(rays, tris, obj_chunk=cfg.obj_chunk,
                                   two_sided=ts, use_pallas=cfg.use_pallas,
                                   rows=tables.tri, tree=tables.tri_tree)
        merge(ch, *triangle_hit_attrs(rays, tris, ch))

    found = bm >= 0
    new_rays = replace(rays, maxt=torch.where(found, bt, rays.maxt))
    if cfg.replicate_stale_poi:
        bp = torch.where(found[:, None], bp, hits.p)
        bn = torch.where(found[:, None], bn, hits.n)
        bm = torch.where(found, bm, hits.mat_id)
        bt = torch.where(found, bt, hits.t)
    return new_rays, Hits(p=bp, n=bn, throughput=hits.throughput,
                          mat_id=bm, t=bt)


def occluded_any(rays: Rays, scene: Scene, cfg: RenderConfig,
                 tables: HitTables | None = None) -> torch.Tensor:
    """Any-hit over every geometry type: (R,) bool. With ``cfg.use_grid``
    each batch is searched through its grid (its closest hit, as the JAX
    package's grid branch does)."""
    if cfg.use_grid:
        from ..accel.traverse import grid_closest_spheres, \
            grid_closest_triangles
        _check_grids(scene)
    if tables is None:
        tables = hit_tables(scene, cfg)
    occ = torch.zeros((rays.n,), dtype=torch.bool, device=rays.o.device)
    if scene.spheres.count:
        if cfg.use_grid:
            occ = occ | grid_closest_spheres(rays, scene.spheres,
                                             scene.sphere_grid).valid
        else:
            occ = occ | anyhit_spheres(rays, scene.spheres,
                                       obj_chunk=cfg.obj_chunk,
                                       use_pallas=cfg.use_pallas,
                                       rows=tables.sph, tree=tables.sph_tree)
    ts = cfg.two_sided_triangles
    if cfg.use_grid:
        for tris, grid in _grid_batches(scene):
            occ = occ | grid_closest_triangles(rays, tris, grid,
                                               two_sided=ts).valid
    elif _all_triangles(scene).count:
        occ = occ | anyhit_triangles(rays, _all_triangles(scene),
                                     obj_chunk=cfg.obj_chunk, two_sided=ts,
                                     use_pallas=cfg.use_pallas,
                                     rows=tables.tri, tree=tables.tri_tree)
    return occ


def light_render(acc: torch.Tensor, rays: Rays, hits: Hits, lights: Lights,
                 light_idx: int, cfg: RenderConfig
                 ) -> tuple[torch.Tensor, Rays, Hits]:
    """Credit rays that see light ``light_idx`` before the geometry
    champion (t inside [mint, maxt), strict at maxt) with its irradiance
    (normalized: a reference quirk behind ``cfg.normalize_emitter``), and
    end them."""
    pos = lights.position[light_idx]
    nrm = lights.normal[light_idx]
    irr = lights.irradiance[light_idx]
    if cfg.normalize_emitter:
        irr = irr / at_least(torch.linalg.norm(irr), 1e-20)
    t = I.light_disk_t(rays.o, rays.d, pos, nrm, lights.radius[light_idx])
    hit = rays.alive & torch.isfinite(t) & (t >= rays.mint) & (t < rays.maxt)
    acc = acc + torch.where(hit[:, None], irr[None, :], 0.0)
    rays = replace(rays, mint=torch.where(hit, INF, rays.mint),
                   maxt=torch.where(hit, INF, rays.maxt))
    hits = replace(hits, mat_id=torch.where(hit, -1, hits.mat_id))
    return acc, rays, hits


def nee_shade(acc: torch.Tensor, hits: Hits, scene: Scene, light_idx: int,
              u: torch.Tensor, cfg: RenderConfig,
              tables: HitTables | None = None
              ) -> tuple[torch.Tensor, Hits]:
    """One light's direct-lighting estimate for every valid hit: a shadow
    ray to the disk point of ``u`` (R, 2), any-hit, then the reference's
    shading, quirks kept (the geometric term uses the distance to the light
    centre; the contribution uses the throughput before ``*= albedo``, once
    per light)."""
    lights = scene.lights
    pos = lights.position[light_idx]
    nrm = lights.normal[light_idx]
    irr = lights.irradiance[light_idx]
    area = lights.area[light_idx]
    t_ax, b_ax = lights.frames()
    t_ax, b_ax = t_ax[light_idx], b_ax[light_idx]
    valid = hits.valid

    target = sample_disk_point(pos[None, :], t_ax[None, :], b_ax[None, :],
                               lights.radius[light_idx][None], u)
    origin = hits.p + cfg.shadow_eps * hits.n
    delta = target - origin
    d2 = dot3(delta, delta)
    dist = torch.sqrt(torch.where(d2 > 0.0, d2, 1.0))
    dist = torch.where(d2 > 0.0, dist, 0.0)
    sdir = safe_normalize(delta)
    # invalid lanes get dead rays
    shadow = Rays(o=origin, d=sdir, mint=torch.where(valid, 0.0, INF),
                  maxt=torch.where(valid, dist, INF))
    occ = occluded_any(shadow, scene, cfg, tables)

    r2 = dot3(hits.p - pos[None, :], hits.p - pos[None, :])
    cosx = clip(dot3(sdir, hits.n), 0.0, 1.0)
    cosy = clip(dot3(-sdir, nrm[None, :]), 0.0, 1.0)
    geom = area * cosx * cosy / at_least(r2, 1e-20)
    free = valid & ~occ
    shade = torch.where(free[:, None], geom[:, None] * irr[None, :], 0.0)

    albedo = palette_lookup(scene.materials[:, :3], hits.mat_id)
    acc = acc + torch.where(valid[:, None],
                            hits.throughput * albedo * shade, 0.0)
    tp = torch.where(valid[:, None], hits.throughput * albedo,
                     hits.throughput)
    return acc, replace(hits, throughput=tp)


def bounce_paths(hits: Hits, u: torch.Tensor, cfg: RenderConfig) -> Rays:
    """Cosine-hemisphere continuation rays from valid hits, origins offset
    by ``cfg.shadow_eps`` along the normal; dead rays elsewhere."""
    valid = hits.valid
    up = torch.zeros((3,), device=hits.n.device)
    up[2] = 1.0      # filled on the device: a list copy would synchronise
    safe_n = torch.where(valid[:, None], hits.n, up)
    d = cosine_hemisphere(safe_n, u)
    o = hits.p + cfg.shadow_eps * hits.n
    return Rays(o=o, d=d, mint=torch.where(valid, 0.0, INF),
                maxt=torch.full_like(hits.t, INF))


def apply_russian_roulette(hits: Hits, u: torch.Tensor, depth: int,
                           cfg: RenderConfig) -> Hits:
    """Russian roulette from ``cfg.rr_start_depth`` on: survive with
    p = max throughput component, clipped to [0.05, 1], and divide the
    throughput by p; ``u`` (R,) is a column of the pass's draws."""
    if not cfg.russian_roulette or depth < cfg.rr_start_depth:
        return hits
    tp = hits.throughput
    # kernel 1's clip: on tied channels and at a bound its gradient splits
    # as the JAX package's does
    p = survival_p(tp)
    survive = u < p
    return replace(hits,
                   throughput=torch.where(survive[:, None], tp / p[:, None],
                                          0.0),
                   mat_id=torch.where(survive, hits.mat_id, -1))


def copy_to_pixel(acc: torch.Tensor, passes: int,
                  cfg: RenderConfig) -> torch.Tensor:
    """Mean over spp sub-rays and passes, times exposure, clamped to
    [0, 1]. Returns the float image (H, W, 3)."""
    img = acc.reshape(cfg.height, cfg.width, cfg.spp, 3).sum(2)
    img = img * (cfg.exposure / (cfg.spp * passes))
    return clip(img, 0.0, 1.0)
