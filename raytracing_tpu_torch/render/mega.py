"""The megakernel pass: Scene -> packed tables -> one kernel launch per
call (``raytracing_tpu.render.mega``).

``supported`` is True only for what the port covers: path mode, no
Russian roulette, no grid, no blocked layout, no stale-POI replication, at
most 64 spheres and 64 triangles and fewer than 2^24 rays. Anything else
raises, naming the ROADMAP item that will cover it; nothing falls back to
another path.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.config import RenderConfig
from ..core.types import Scene, tangent_frame
from ..ops import intersect as I
from ..ops import megakernel as MK
from .stages import _all_triangles


def scene_tables(scene: Scene, cfg: RenderConfig
                 ) -> tuple[torch.Tensor, ...]:
    """(par (26,), sph (S, 8), tri (T, 32), mat (M, 4), lig (L, 20)) float32
    on the scene's device, packed as the JAX package packs them."""
    cam = scene.camera
    dev = scene.device

    def f32(x):
        return x.to(torch.float32).reshape(1)

    def const(*vals):
        # filled on the device: a tensor built from a Python list would be
        # a pageable host-to-device copy, which synchronises the stream
        return torch.cat([torch.full((1,), float(v), device=dev)
                          for v in vals])

    par = torch.cat([
        cam.eye, cam.u, cam.v, cam.w,
        f32(cam.width), f32(cam.height), const(cfg.width, cfg.height),
        f32(scene.focal_length), f32(scene.lens_radius),
        scene.bounds_min, scene.bounds_max,
        const(cfg.shadow_eps, cfg.ambient),
    ]).to(torch.float32)
    assert par.shape[0] == MK.NPAR

    sp = scene.spheres
    sph = torch.cat([
        sp.center, sp.radius[:, None],
        sp.mat_id[:, None].to(torch.float32),
        sp.mask[:, None].to(torch.float32),
        torch.zeros((sp.count, 2), device=dev),
    ], -1).to(torch.float32).contiguous()

    tris = _all_triangles(scene)
    tc = I.tri_constants(tris.v)
    n = tris.count
    tri = torch.cat([
        tc.n_geo, tc.c1, tc.c2, tc.e1, tc.e2, tc.k[:, None],
        tris.mat_id[:, None].to(torch.float32),
        tris.mask[:, None].to(torch.float32),
        tris.vn.reshape(n, 9),
        torch.zeros((n, 5), device=dev),
    ], -1).to(torch.float32).contiguous()

    mat = scene.materials.to(torch.float32).contiguous()

    lg = scene.lights
    t_ax, b_ax = tangent_frame(lg.normal)
    irr_n = lg.irradiance / torch.clamp(
        torch.linalg.norm(lg.irradiance, dim=-1, keepdim=True), min=1e-20)
    lig = torch.cat([
        lg.position, lg.normal, lg.irradiance, irr_n,
        lg.radius[:, None], lg.area[:, None], t_ax, b_ax,
    ], -1).to(torch.float32).contiguous()
    return par, sph, tri, mat, lig


def supported(scene: Scene | None, cfg: RenderConfig) -> bool:
    """True when the port renders this scene and config; raises
    NotImplementedError naming the ROADMAP Queue 1 item otherwise. With
    ``scene=None`` only the config is checked."""
    if cfg.russian_roulette:
        raise NotImplementedError(
            "Russian roulette is not ported yet (ROADMAP Queue 1 item 7)")
    if cfg.use_grid:
        raise NotImplementedError(
            "uniform grids are not ported yet (ROADMAP Queue 1 item 11)")
    if cfg.use_pallas or cfg.replicate_stale_poi:
        raise NotImplementedError(
            "the stage pipeline (use_pallas, replicate_stale_poi) is not "
            "ported yet (ROADMAP Queue 1 item 9)")
    if cfg.mega_block:
        raise NotImplementedError(
            "the blocked pixel layout is not ported yet (ROADMAP Queue 1 "
            "item 10)")
    if cfg.total_rays >= (1 << 24):
        raise NotImplementedError(
            f"{cfg.total_rays} rays: the kernel takes fewer than 2^24 per "
            "call; sharding is ROADMAP Queue 1 item 14")
    if scene is None:
        return True
    n_sph, n_tri = scene.spheres.count, _all_triangles(scene).count
    if max(n_sph, n_tri) > MK.UNROLL_OBJECTS:
        raise NotImplementedError(
            f"{n_sph} spheres / {n_tri} triangles: more than "
            f"{MK.UNROLL_OBJECTS} objects per type stream in Morton chunks, "
            "not ported yet (ROADMAP Queue 1 item 10)")
    return True


def u_planes_for_pass(key: torch.Tensor, passes: int, cfg: RenderConfig,
                      n_lights: int, device=None) -> torch.Tensor:
    """The pass-wide uniforms in the kernel's plane layout, (2 * n_draws, R):
    exactly the JAX package's ``u_planes_for_pass``."""
    from .pathtracer import pass_draw_count
    return MK.draw_planes(rng.pass_key(key, passes), cfg.total_rays,
                          pass_draw_count(cfg, n_lights), 0, device)


def render_pass_mega(scene: Scene, state: dict, cfg: RenderConfig,
                     u_planes: torch.Tensor | None = None,
                     n_passes: int = 1) -> dict:
    """``n_passes`` progressive passes; same state contract as the JAX
    ``render_pass_mega``. ``state["acc"]`` is updated in place (no second
    accumulator) and returned in the new state.

    Without ``u_planes`` the draws of pass ``p`` are keyed by
    ``fold_in(PRNGKey(cfg.seed), p)``, which is ``state["key"]`` as
    ``init_state`` makes it; another key raises rather than render
    different draws than the state names."""
    supported(scene, cfg)
    if u_planes is None and not torch.equal(
            state["key"].to(torch.int64),
            rng.base_key(cfg.seed).to(torch.int64)):
        raise ValueError("state['key'] is not PRNGKey(cfg.seed): the kernel "
                         "keys its draws by cfg.seed")
    par, sph, tri, mat, lig = scene_tables(scene, cfg)
    ipar = torch.tensor([int(state["passes"]), 0], dtype=torch.int32)
    acc = MK.pathtrace_pass(par, ipar, sph, tri, mat, lig, state["acc"],
                            u_planes, spp=cfg.spp, width=cfg.width,
                            bounces=cfg.bounces,
                            two_sided=cfg.two_sided_triangles,
                            normalize_emitter=cfg.normalize_emitter,
                            seed=cfg.seed, n_passes=n_passes)
    return {"acc": acc, "key": state["key"],
            "passes": int(state["passes"]) + n_passes}
