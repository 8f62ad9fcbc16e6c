"""The whole progressive path-tracing pass: the counterpart of
``raytracing_tpu/ops/pallas/megakernel.py`` (path mode, unrolled tables).

Two versions of one function:

* ``pathtrace_pass_reference`` -- the plain PyTorch version, vectorised
  over rays and looping over objects. Its math and its draw-slot order
  (lens, NEE per light, then per depth: bounce, NEE per light) follow
  ``_render_pass_kernel`` (``megakernel.py:404-1528``) line for line. The
  CPU tests hold it against the JAX package.
* ``pathtrace_pass`` -- the wrapper, with the signature of
  ``pathtrace_pass_pallas``. On CUDA tensors it launches the hand-written
  kernel ``csrc/megakernel.cu`` or raises; on CPU tensors it runs the plain
  version. It updates ``acc`` in place (the kernel reads and writes the
  same buffer, as the Pallas call aliases it) and counts its launches in
  the module integer ``launches``.

Draws: with ``u_planes`` (``(2 * n_draws, R)``, plane ``2j + c`` for slot
``j``, component ``c``) both versions read them; without, both make the
draws of ``jax.random.uniform(pass_key, (R, n_draws, 2))`` themselves,
keyed by ``fold_in(PRNGKey(seed), pass)`` -- the kernel in-kernel, bit for
bit the same (``csrc/threefry.cuh``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import rng
from ..core.sampling import cosine_hemisphere, sample_disk_point
from ..core.types import AABB, Camera, cross3, dot3, safe_normalize
from ..render.camera import (clip_to_bounds, focal_points,
                             stratified_lens_uv, thin_lens_rays)
from . import _build
from . import intersect as I

INF = math.inf

# the kernel keeps every table in shared memory and loops over objects;
# larger tables are ROADMAP Queue 1 item 10 (streaming)
UNROLL_OBJECTS = 64
SMEM_BYTES_MAX = 48 * 1024
# pass keys ride in the kernel's parameter block (csrc/megakernel.cu
# kMaxPasses); longer runs take several launches
MAX_PASSES_PER_LAUNCH = 64

# par (26,): eye, u, v, w, film width, film height, cols, rows, focal
# length, lens radius, scene pmin, pmax, shadow eps, ambient (the JAX
# kernel's _PAR layout)
NPAR = 26
SPH_COLS, TRI_COLS, MAT_COLS, LIG_COLS = 8, 32, 4, 20

launches = 0


def n_draws_of(n_lights: int, bounces: int) -> int:
    """Draw slots of one pass: lens, NEE per light, then per depth:
    bounce and NEE per light."""
    return 1 + n_lights + bounces * (1 + n_lights)


def draw_planes(key: torch.Tensor, n_rays: int, n_draws: int,
                ray_offset: int = 0, device=None) -> torch.Tensor:
    """Rows ``[ray_offset, ray_offset + n_rays)`` of
    ``jax.random.uniform(key, (N, n_draws, 2))`` in plane layout
    ``(2 * n_draws, n_rays)``: element (r, j, c) has flat index
    ``(r * n_draws + j) * 2 + c``."""
    r = torch.arange(ray_offset, ray_offset + n_rays, dtype=torch.int64,
                     device=device)
    plane = torch.arange(2 * n_draws, dtype=torch.int64, device=device)
    idx = r[None, :] * (2 * n_draws) + plane[:, None]
    y0, y1 = rng.threefry2x32(*rng.key_words(key), idx >> 32,
                              idx & rng.MASK32)
    return rng.bits_to_uniform(y0 ^ y1)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _trace(o, d, mint, maxt, sph, tri, two_sided):
    """Closest hit over spheres then triangles (champion loops with a
    strict ``t < best``). Returns (new maxt, hit point, shading normal,
    material id as float, -1 on a miss)."""
    n = o.shape[0]
    alive = mint != maxt
    a = dot3(d, d)
    inv2a = 0.5 / a
    bt = torch.full((n,), INF, device=o.device)
    bn = torch.zeros((n, 3), device=o.device)
    bm = torch.full((n,), -1.0, device=o.device)
    for i in range(sph.shape[0]):
        row = sph[i]
        ok, t = I.sphere_hit(o, d, a, inv2a, mint, maxt, row)
        t = torch.where(ok & alive, t, INF)
        better = t < bt
        ts = torch.where(better, t, 0.0)
        hn = safe_normalize(o + ts[:, None] * d - row[0:3])
        bt = torch.where(better, t, bt)
        bn = torch.where(better[:, None], hn, bn)
        bm = torch.where(better, row[4], bm)
    oxd = cross3(o, d)          # loop-invariant over triangles
    for i in range(tri.shape[0]):
        row = tri[i]
        ok, t, beta, gamma = I.triangle_hit(o, d, oxd, mint, maxt, row,
                                            two_sided)
        t = torch.where(ok & alive, t, INF)
        better = t < bt
        alpha = 1.0 - beta - gamma
        hn = safe_normalize(alpha[:, None] * row[18:21]
                            + beta[:, None] * row[21:24]
                            + gamma[:, None] * row[24:27])
        bt = torch.where(better, t, bt)
        bn = torch.where(better[:, None], hn, bn)
        bm = torch.where(better, row[16], bm)
    found = bm >= 0.0
    ts = torch.where(found, bt, 0.0)
    return torch.where(found, bt, maxt), o + ts[:, None] * d, bn, bm


def _anyhit(o, d, mint, maxt, sph, tri, two_sided):
    """Occlusion of the segments [mint, maxt] by any object."""
    alive = mint != maxt
    a = dot3(d, d)
    inv2a = 0.5 / a
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for i in range(sph.shape[0]):
        occ = occ | I.sphere_hit(o, d, a, inv2a, mint, maxt, sph[i])[0]
    oxd = cross3(o, d)
    for i in range(tri.shape[0]):
        occ = occ | I.triangle_hit(o, d, oxd, mint, maxt, tri[i],
                                   two_sided)[0]
    return occ & alive


def _albedo(mat, matf):
    """materials[mat_id].rgb, zeros for ids outside the table."""
    m = matf.to(torch.int64)
    ok = (matf >= 0.0) & (m < mat.shape[0])
    rgb = mat[m.clamp(0, mat.shape[0] - 1), 0:3]
    return torch.where(ok[:, None], rgb, 0.0)


def _pass_reference(par, sph, tri, mat, lig, acc, u, ray_offset: int, *,
                    spp: int, width: int, bounces: int, two_sided: bool,
                    normalize_emitter: bool) -> torch.Tensor:
    """One pass of ``_render_pass_kernel`` (path mode) over every ray;
    returns the new accumulator."""
    n, dev = acc.shape[0], acc.device
    n_lig = lig.shape[0]
    slots = iter(range(u.shape[0] // 2))

    def draw():
        j = next(slots)
        return u[2 * j:2 * j + 2].t()

    # pixel decode from the global ray id (integer; the kernel's float
    # decode is exact in its < 2^24 range)
    rid = torch.arange(n, dtype=torch.int64, device=dev) + ray_offset
    pix = torch.div(rid, spp, rounding_mode="floor")
    samp = rid - pix * spp
    row = torch.div(pix, width, rounding_mode="floor")
    col = pix - row * width
    # the camera as the kernel reads it from par (cols/rows as f32 scalars)
    cam = Camera(eye=par[0:3], u=par[3:6], v=par[6:9], w=par[9:12],
                 width=par[12], height=par[13], cols=par[14], rows=par[15])
    fp = focal_points(cam, col.to(torch.float32), row.to(torch.float32),
                      par[16])
    if spp > 1:
        next(slots)          # slot 0 reserved: stratified lens, no draw
        uv = stratified_lens_uv(samp, spp)
    else:
        uv = draw()
    rays = clip_to_bounds(thin_lens_rays(cam, fp, par[17], uv),
                          AABB(pmin=par[18:21], pmax=par[21:24]))
    o, d, mint, maxt = rays.o, rays.d, rays.mint, rays.maxt
    eps = par[24]

    maxt, hp, hn, matf = _trace(o, d, mint, maxt, sph, tri, two_sided)

    # emitter hits on the primary segment only
    for li in range(n_lig):
        lr = lig[li]
        irr = lr[9:12] if normalize_emitter else lr[6:9]
        alive = mint != maxt
        t = I.light_disk_t(o, d, lr[0:3], lr[3:6], lr[12])
        hitl = alive & (t < INF) & (t >= mint) & (t < maxt)
        acc = acc + torch.where(hitl[:, None], irr, 0.0)
        mint = torch.where(hitl, INF, mint)
        maxt = torch.where(hitl, INF, maxt)
        matf = torch.where(hitl, -1.0, matf)

    def nee(li, acc, tp, u):
        lr = lig[li]
        lp, ln, irr = lr[0:3], lr[3:6], lr[6:9]
        valid = matf >= 0.0
        tgt = sample_disk_point(lp, lr[14:17], lr[17:20], lr[12], u)
        so = hp + eps * hn
        dl = tgt - so
        d2 = dot3(dl, dl)
        dist = torch.sqrt(torch.where(d2 > 0.0, d2, 1.0))
        dist = torch.where(d2 > 0.0, dist, 0.0)
        sd = safe_normalize(dl)
        occ = _anyhit(so, sd, torch.where(valid, 0.0, INF),
                      torch.where(valid, dist, INF), sph, tri, two_sided)
        # geometric term uses the distance to the light CENTER (reference
        # quirk, kept)
        q = hp - lp
        r2 = dot3(q, q)
        cosx = torch.clamp(dot3(sd, hn), 0.0, 1.0)
        cosy = torch.clamp(-dot3(sd, ln), 0.0, 1.0)
        geom = lr[13] * cosx * cosy / torch.clamp(r2, min=1e-20)
        free = valid & ~occ
        alb = _albedo(mat, matf)
        sh = torch.where(free[:, None], geom[:, None] * irr, 0.0)
        acc = acc + torch.where(valid[:, None], tp * alb * sh, 0.0)
        tp = torch.where(valid[:, None], tp * alb, tp)
        return acc, tp

    tp = torch.ones((n, 3), device=dev)
    for li in range(n_lig):
        acc, tp = nee(li, acc, tp, draw())
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    for _depth in range(bounces):
        valid = matf >= 0.0
        sn = torch.where(valid[:, None], hn, up)
        d = cosine_hemisphere(sn, draw())
        o = hp + eps * hn
        mint = torch.where(valid, 0.0, INF)
        maxt = torch.full((n,), INF, device=dev)
        maxt, hp, hn, matf = _trace(o, d, mint, maxt, sph, tri, two_sided)
        for li in range(n_lig):
            acc, tp = nee(li, acc, tp, draw())
    return acc


def pathtrace_pass_reference(par, ipar, sph, tri, mat, lig, acc, u_planes,
                             *, spp: int, width: int, bounces: int,
                             two_sided: bool, normalize_emitter: bool,
                             seed: int, n_passes: int = 1) -> torch.Tensor:
    """The plain version of ``pathtrace_pass`` on any device; returns a new
    accumulator (``acc`` is not modified)."""
    pass0, roff = (int(x) for x in ipar.tolist())
    n = acc.shape[0]
    n_draws = n_draws_of(lig.shape[0], bounces)
    base = rng.base_key(seed)
    for p in range(n_passes):
        u = u_planes
        if u is None:
            u = draw_planes(rng.pass_key(base, pass0 + p), n, n_draws, roff,
                            acc.device)
        acc = _pass_reference(par, sph, tri, mat, lig, acc, u, roff,
                              spp=spp, width=width, bounces=bounces,
                              two_sided=two_sided,
                              normalize_emitter=normalize_emitter)
    return acc


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rt_pathtrace_pass": (ctypes.c_int, [
        _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _I,     # par, sph, tri, mat, lig
        _VP, _I, _I,                                  # acc, n_rays, ray_offset
        _VP, _VP, _I,                         # u_planes, host keys, n_passes
        _I, _I, _I, _I, _I,                           # spp, width, bounces,
                                                      # two_sided, normalize
        _VP]),                                        # stream
}


def _check_args(par, ipar, sph, tri, mat, lig, acc, u_planes, spp, width,
                bounces, n_passes):
    dev = acc.device
    if acc.dtype != torch.float32 or acc.dim() != 2 or acc.shape[1] != 3:
        raise ValueError(f"acc must be (R, 3) float32, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    n = acc.shape[0]
    shapes = {"par": (par, (NPAR,)), "sph": (sph, (None, SPH_COLS)),
              "tri": (tri, (None, TRI_COLS)), "mat": (mat, (None, MAT_COLS)),
              "lig": (lig, (None, LIG_COLS)), "acc": (acc, (n, 3))}
    n_draws = n_draws_of(lig.shape[0], bounces)
    if u_planes is not None:
        shapes["u_planes"] = (u_planes, (2 * n_draws, n))
    for name, (t, shape) in shapes.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, acc on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != ts for s, ts in zip(shape, t.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (ipar.device.type != "cpu" or ipar.dtype != torch.int32
            or tuple(ipar.shape) != (2,)):
        raise ValueError("ipar must be a (2,) int32 CPU tensor "
                         "[pass index, ray offset]")
    k = int(round(spp ** 0.5))
    if spp < 1 or k * k != spp:
        raise ValueError(f"spp must be a perfect square, got {spp}")
    if n % (spp * width):
        raise ValueError(f"{n} rays are not whole rows of {width} pixels "
                         f"x {spp} spp")
    if max(sph.shape[0], tri.shape[0]) > UNROLL_OBJECTS:
        raise ValueError(f"at most {UNROLL_OBJECTS} spheres and triangles")
    smem = 4 * (NPAR + sph.numel() + tri.numel() + mat.numel() + lig.numel())
    if smem > SMEM_BYTES_MAX:
        raise ValueError(f"scene tables take {smem} B of shared memory, "
                         f"more than {SMEM_BYTES_MAX}")
    roff = int(ipar[1])
    if roff < 0 or roff + n >= (1 << 24):
        raise ValueError("pixel math is exact below 2^24 rays")
    if (roff + n) * n_draws * 2 >= (1 << 32):
        raise ValueError("draw counters must stay below 2^32")
    if n_passes < 1:
        raise ValueError(f"n_passes must be >= 1, got {n_passes}")
    if n_passes != 1 and u_planes is not None:
        raise ValueError("a u_planes tensor carries one pass of draws; "
                         "multi-pass launches use the in-kernel PRNG")


def _ptr(t: torch.Tensor | None):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def pathtrace_pass(par, ipar, sph, tri, mat, lig, acc, u_planes, *,
                   spp: int, width: int, bounces: int, two_sided: bool,
                   normalize_emitter: bool, seed: int,
                   n_passes: int = 1) -> torch.Tensor:
    """``n_passes`` progressive passes over ``acc`` (R, 3), in place.

    par (26,) f32 scalars; ipar (2,) int32 CPU tensor [pass index, global
    ray offset]; sph (S, 8) [center xyz, radius, mat, mask, pad2]; tri
    (T, 32) [n_geo, c1, c2, e1, e2, k, mat, mask, vn0, vn1, vn2, pad5];
    mat (M, 4) rgba; lig (L, 20) [pos, normal, irr, irr_normalized,
    radius, area, tangent, bitangent]; u_planes (2 * n_draws, R) or None.
    """
    global launches
    _check_args(par, ipar, sph, tri, mat, lig, acc, u_planes, spp, width,
                bounces, n_passes)
    kw = dict(spp=spp, width=width, bounces=bounces, two_sided=two_sided,
              normalize_emitter=normalize_emitter, seed=seed,
              n_passes=n_passes)
    if acc.device.type == "cpu":
        acc.copy_(pathtrace_pass_reference(par, ipar, sph, tri, mat, lig,
                                           acc, u_planes, **kw))
        return acc
    if acc.device.type != "cuda":
        raise ValueError(f"no kernel for device {acc.device}")
    lib = _build.load("megakernel", _SIGNATURES)
    pass0, roff = (int(x) for x in ipar.tolist())
    base = rng.base_key(seed)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        for first in range(0, n_passes, MAX_PASSES_PER_LAUNCH):
            k = min(MAX_PASSES_PER_LAUNCH, n_passes - first)
            # host-computed pass keys, copied into the kernel's parameters
            keys = (ctypes.c_uint32 * (2 * k))(*(
                w for p in range(k)
                for w in rng.key_words(rng.pass_key(base, pass0 + first + p))))
            err = lib.rt_pathtrace_pass(
                _ptr(par), _ptr(sph), sph.shape[0], _ptr(tri), tri.shape[0],
                _ptr(mat), mat.shape[0], _ptr(lig), lig.shape[0],
                _ptr(acc), acc.shape[0], roff, _ptr(u_planes),
                ctypes.addressof(keys), k, spp, width, bounces,
                int(two_sided), int(normalize_emitter), stream)
            if err != 0:
                raise RuntimeError(
                    f"megakernel launch failed with CUDA error {err}")
            launches += 1
    return acc
