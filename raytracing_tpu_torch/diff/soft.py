"""Edge-aware differentiable rendering via soft visibility: the toy soft
renderers of ``raytracing_tpu.diff.soft``, in eager PyTorch as they are
eager JAX there (no hand-written kernel: they are oracles and small-scale
experiments, not the production path).

The hard renderer's gradients are exact almost everywhere but miss the
silhouette terms. Here every object contributes a smooth coverage instead
of a binary hit (spheres: sigmoid of the discriminant; triangles: sigmoid
of the barycentric margin), depth resolves by a softmin over t (temperature
``tau``), and shadows see the product of per-occluder transmittances. As
bandwidth and tau go to 0 the images converge to the hard ones.

* ``render_fake_shade_soft`` -- the Assign02 toy (spheres, fake shade);
* ``render_direct_soft`` -- the Assign08/09 direct-lighting schedule;
* ``render_pathtrace_soft`` -- the whole Assign10 pass (emitter hits, NEE,
  bounces) with the draws of pass 0 of ``cfg.seed``.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.config import RenderConfig
from ..core.sampling import concentric_disk, sample_disk_point
from ..core.types import Camera, Scene, Spheres, replace, safe_normalize
from ..core.types import tangent_frame
from ..ops.closest_hit import palette_lookup
from ..render.camera import pinhole_rays, pixel_grid


def _sum3(x: torch.Tensor) -> torch.Tensor:
    return x.sum(-1)


def render_fake_shade_soft(cam: Camera, spheres: Spheres,
                           colors: torch.Tensor, bandwidth: float = 1e-2,
                           tau: float = 1e-2) -> torch.Tensor:
    """Soft Assign02 fake-shade render, differentiable wrt sphere centres,
    radii, colours and camera. Returns (rows, cols, 3)."""
    col, row = pixel_grid(cam)
    rays = pinhole_rays(cam, col, row)
    o, d = rays.o, rays.d
    omc = o[None, :, :] - spheres.center[:, None, :]           # (S, R, 3)
    b = _sum3(omc * d[None, :, :])
    c = _sum3(omc * omc) - (spheres.radius ** 2)[:, None]
    dis = b * b - c
    alpha = torch.sigmoid(dis / bandwidth)
    alpha = alpha * spheres.mask.to(alpha.dtype)[:, None]
    alpha = alpha * torch.sigmoid(-b / bandwidth)              # in front
    sq = torch.sqrt(torch.clamp(dis, min=1e-12))
    t = -b - sq
    w = alpha * torch.softmax(-t / tau + torch.log(torch.clamp(alpha,
                                                               min=1e-20)), 0)
    p = o[None, :, :] + t[..., None] * d[None, :, :]
    n = p - spheres.center[:, None, :]
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-20)
    shade = torch.einsum("j,srj->sr", cam.w, n)
    rgb = colors[:, None, :3] * shade[..., None]
    return torch.sum(w[..., None] * rgb, 0).reshape(cam.rows, cam.cols, 3)


def _soft_sphere_hits(o, d, spheres, bandwidth):
    """Per-sphere soft coverage, depth, point, normal: (S, R) and (S, R,
    3)."""
    omc = o[None, :, :] - spheres.center[:, None, :]
    b = _sum3(omc * d[None, :, :])
    c = _sum3(omc * omc) - (spheres.radius ** 2)[:, None]
    dis = b * b - c
    alpha = torch.sigmoid(dis / bandwidth)
    alpha = alpha * spheres.mask.to(alpha.dtype)[:, None]
    alpha = alpha * torch.sigmoid(-b / bandwidth)
    pos = dis > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, dis, 1.0)), 0.0)
    t = -b - sq
    p = o[None, :, :] + t[..., None] * d[None, :, :]
    return alpha, t, p, safe_normalize(p - spheres.center[:, None, :])


def _soft_triangle_hits(o, d, tris, bandwidth, two_sided):
    """Per-triangle soft coverage (sigmoid of the barycentric margin),
    depth, plane point and interpolated normal."""
    v = tris.v
    p0 = v[:, 0][:, None, :]
    e1 = (v[:, 1] - v[:, 0])[:, None, :]
    e2 = (v[:, 2] - v[:, 0])[:, None, :]
    n_geo = torch.linalg.cross(e2, e1)
    dd = d[None, :, :]
    oo = o[None, :, :]
    div = _sum3(n_geo * dd)
    side = div.abs() > 1e-12 if two_sided else div > 1e-12
    # double where: near-parallel planes park at t = 1e6
    idiv = 1.0 / torch.where(side, div, 1.0)
    t = torch.where(side, _sum3((p0 - oo) * n_geo) * idiv, 1e6)
    ph = oo + torch.where(side, t, 0.0)[..., None] * dd
    q = ph - p0
    d11, d12, d22 = _sum3(e1 * e1), _sum3(e1 * e2), _sum3(e2 * e2)
    q1, q2 = _sum3(q * e1), _sum3(q * e2)
    det = torch.clamp(d11 * d22 - d12 * d12, min=1e-20)
    beta = (d22 * q1 - d12 * q2) / det
    gamma = (d11 * q2 - d12 * q1) / det
    margin = torch.minimum(torch.minimum(beta, gamma), 1.0 - beta - gamma)
    alpha = torch.sigmoid(margin / bandwidth)
    alpha = alpha * tris.mask.to(alpha.dtype)[:, None] * side.to(alpha.dtype)
    alpha = alpha * torch.sigmoid(t / bandwidth)
    zero = torch.zeros_like(beta)
    one = torch.ones_like(beta)

    def clip(x):
        return torch.minimum(torch.maximum(x, zero), one)[..., None]

    n = safe_normalize(clip(1.0 - beta - gamma) * tris.vn[:, 0][:, None, :]
                       + clip(beta) * tris.vn[:, 1][:, None, :]
                       + clip(gamma) * tris.vn[:, 2][:, None, :])
    return alpha, t, ph, n


def _gather_soft(o, d, scene: Scene, bandwidth, two_sided):
    """Every object's soft hypotheses stacked on axis 0, and albedos."""
    from ..render.stages import _all_triangles
    parts = []
    if scene.spheres.count:
        parts.append((*_soft_sphere_hits(o, d, scene.spheres, bandwidth),
                      palette_lookup(scene.materials[:, :3],
                                     scene.spheres.mat_id)))
    tris = _all_triangles(scene)
    if tris.count:
        parts.append((*_soft_triangle_hits(o, d, tris, bandwidth, two_sided),
                      palette_lookup(scene.materials[:, :3], tris.mat_id)))
    return tuple(torch.cat([p[k] for p in parts]) for k in range(5))


def _soft_transmittance(o, d, dist, scene: Scene, bandwidth, two_sided):
    """Smooth shadow-ray visibility: the product over occluders of 1 -
    coverage inside [0, dist]. o, d (..., 3), dist (...)."""
    lead = o.shape[:-1]
    a, t, _, _, _ = _gather_soft(o.reshape(-1, 3), d.reshape(-1, 3), scene,
                                 bandwidth, two_sided)
    distf = dist.reshape(-1)
    inside = a * torch.sigmoid((distf[None, :] - t) / bandwidth) \
        * torch.sigmoid(t / bandwidth)
    return torch.prod(1.0 - inside, 0).reshape(lead)


def _clip01(x):
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.ones_like(x))


def _softmin_weights(alpha, t, tau):
    """alpha * softmax(-t / tau + log alpha) over hypotheses, with uncovered
    hypotheses parked at t = 1e6 so they cannot win the depth race."""
    t_eff = torch.where(alpha > 1e-6, t, 1e6)
    return alpha * torch.softmax(
        -t_eff / tau + torch.log(torch.clamp(alpha, min=1e-20)), 0)


def render_direct_soft(scene: Scene, cfg: RenderConfig,
                       bandwidth: float = 5e-3,
                       tau: float = 5e-3) -> torch.Tensor:
    """Soft twin of render/direct.py (Assign08): pinhole rays, soft closest
    hit over spheres and triangles, per light a sampled disk point (key
    from ``cfg.seed``), soft shadow transmittance, ambient + clamped cosine,
    softmin depth composition. Returns (H, W, 3) in [0, 1]."""
    cam = replace(scene.camera, cols=cfg.width, rows=cfg.height)
    col, row = pixel_grid(cam)
    rays = pinhole_rays(cam, col, row)
    o, d = rays.o, rays.d
    R = o.shape[0]
    alpha, t, p, n, alb = _gather_soft(o, d, scene, bandwidth,
                                       cfg.two_sided_triangles)
    w = _softmin_weights(alpha, t, tau)
    key = rng.base_key(cfg.seed)
    t_ax, b_ax = scene.lights.frames()
    acc = torch.zeros((R, 3), device=o.device)
    for li in range(scene.lights.count):
        u = rng.uniform2(rng.draw_key(key, rng.LIGHT, 0, li), R, o.device)
        target = sample_disk_point(scene.lights.position[li][None, :],
                                   t_ax[li][None, :], b_ax[li][None, :],
                                   scene.lights.radius[li][None], u)
        origin = p + cfg.shadow_eps * n
        delta = target[None, :, :] - origin
        dist = torch.sqrt(torch.clamp(_sum3(delta * delta), min=1e-20))
        sdir = delta / dist[..., None]
        vis = _soft_transmittance(origin, sdir, dist, scene, bandwidth,
                                  cfg.two_sided_triangles)
        cosx = _clip01(_sum3(sdir * n))
        shade = _clip01(cfg.ambient + vis * cosx)
        acc = acc + torch.sum(w[..., None] * (alb[:, None, :]
                                              * shade[..., None]), 0)
    n_lights = max(scene.lights.count, 1)
    return _clip01(acc.reshape(cfg.height, cfg.width, 3) / n_lights)


def render_pathtrace_soft(scene: Scene, cfg: RenderConfig,
                          bandwidth: float = 5e-3,
                          tau: float = 5e-3) -> torch.Tensor:
    """Edge-aware twin of the whole path-tracing pass (Assign10): emitter
    hits on the primary segment as a soft race against the blended
    surface, NEE with soft shadow transmittance, cfg.bounces cosine bounces
    from the blended surface; the closest hit is a softmin blend of every
    hypothesis, coverage the sum of its weights, path aliveness the
    product of coverages. Draws are pass 0's (``rng.pass_key(PRNGKey(
    cfg.seed), 0)``, the hard pipeline's slot order). Returns the raw
    accumulator (H, W, 3), one sample per pixel."""
    from ..render.pathtracer import pass_draw_count
    cam = replace(scene.camera, cols=cfg.width, rows=cfg.height)
    col, row = pixel_grid(cam)
    rays = pinhole_rays(cam, col, row)
    o, d = rays.o, rays.d
    R, dev = o.shape[0], o.device
    L = scene.lights.count
    kp = rng.pass_key(rng.base_key(cfg.seed), 0)
    n_draws = pass_draw_count(cfg, L)
    u_all = rng.uniform(kp, (R, n_draws, 2), dev)
    draw = iter(range(n_draws))
    next(draw)                                   # lens slot (pinhole here)
    t_ax, b_ax = scene.lights.frames()
    irr = scene.lights.irradiance
    irr_emit = (irr / torch.clamp(torch.linalg.norm(irr, dim=-1,
                                                    keepdim=True), min=1e-20)
                if cfg.normalize_emitter else irr)
    acc = torch.zeros((R, 3), device=dev)
    tp = torch.ones((R, 3), device=dev)
    path_w = torch.ones(R, device=dev)
    for depth in range(cfg.bounces + 1):
        alpha, t, p, n, alb = _gather_soft(o, d, scene, bandwidth,
                                           cfg.two_sided_triangles)
        w = _softmin_weights(alpha, t, tau)
        cov = _clip01(w.sum(0))
        goodc = cov > 1e-6
        wn = torch.where(goodc, w / torch.where(goodc, cov, 1.0), 0.0)
        pbar = torch.einsum("nr,nrk->rk", wn, p)
        nraw = torch.einsum("nr,nrk->rk", wn, n)
        n2 = _sum3(nraw * nraw)
        good = n2 > 1e-8
        nbar = torch.where(good[:, None], nraw,
                           torch.tensor([0.0, 0.0, 1.0], device=dev)) \
            * torch.rsqrt(torch.where(good, n2, 1.0))[:, None]
        albbar = torch.einsum("nr,nk->rk", wn, alb)
        tbar = torch.sum(wn * t, 0)
        if depth == 0:
            for li in range(L):
                lp = scene.lights.position[li]
                ln = scene.lights.normal[li]
                den = d @ ln
                num = (lp - o) @ ln
                goodl = den.abs() > 1e-12
                idiv = 1.0 / torch.where(goodl, den, 1.0)
                t_l = torch.where(goodl, num * idiv, 1e6)
                q = o + t_l[:, None] * d - lp
                rad = scene.lights.radius[li]
                on_disk = torch.sigmoid((rad * rad - _sum3(q * q))
                                        / bandwidth)
                front = torch.sigmoid(t_l / bandwidth)
                before = cov * torch.sigmoid((tbar - t_l) / bandwidth) \
                    + (1.0 - cov)
                lw = on_disk * front * before * goodl.to(den.dtype)
                acc = acc + (path_w * lw)[:, None] * irr_emit[li]
                path_w = path_w * (1.0 - lw)
        for li in range(L):
            lp = scene.lights.position[li]
            ln = scene.lights.normal[li]
            u = u_all[:, next(draw)]
            target = sample_disk_point(lp[None, :], t_ax[li][None, :],
                                       b_ax[li][None, :],
                                       scene.lights.radius[li][None], u)
            origin = pbar + cfg.shadow_eps * nbar
            delta = target - origin
            dist = torch.sqrt(torch.clamp(_sum3(delta * delta), min=1e-20))
            sdir = delta / dist[:, None]
            vis = _soft_transmittance(origin, sdir, dist, scene, bandwidth,
                                      cfg.two_sided_triangles)
            r2 = _sum3((pbar - lp) ** 2)
            cosx = _clip01(_sum3(sdir * nbar))
            cosy = _clip01(-(sdir @ ln))
            geom = scene.lights.area[li] * cosx * cosy \
                / torch.clamp(r2, min=1e-20)
            gain = (path_w * cov * vis * geom)[:, None]
            acc = acc + gain * tp * albbar * irr[li]
            tp = tp * albbar                  # per-light multiply (quirk)
        if depth < cfg.bounces:
            u = u_all[:, next(draw)]
            cd = concentric_disk(u)
            s2 = 1.0 - _sum3(cd * cd)
            pos = s2 > 0.0
            cz = torch.where(pos, torch.sqrt(torch.where(pos, s2, 1.0)), 0.0)
            ta, ba = tangent_frame(nbar)
            d = safe_normalize(cd[:, 0:1] * ta + cd[:, 1:2] * ba
                               + cz[:, None] * nbar)
            o = pbar + cfg.shadow_eps * nbar
            path_w = path_w * cov
    return acc.reshape(cfg.height, cfg.width, 3)
