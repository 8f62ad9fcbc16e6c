// Kernel 2s: the adjoint of one edge-aware pass as one CUDA kernel for
// Hopper (sm_90a): the parameter cotangents of sum_rays <g, soft_delta>,
// where soft_delta is the soft program's accumulator delta.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel_grad.py::_bwd_kernel
// (launcher _bwd_pallas, :2152) on its soft route, soft_bandwidth > 0: what
// jax.vjp of _tile_program_soft (:1516-2144) gives, path mode, with or
// without Russian roulette, and direct mode (kDirect, direct_adjoint below:
// the direct branch :2039-2075), u-planes or PRNG draws, spp >= 1: at most 64
// objects per type (rt_pathtrace_bwd_soft, the group layout below), and
// past that up to DIFF_TABLE_MAX = 4096 per type, JAX's two-level composite
// over every SOFT_CHUNK span (soft_trace :1883-1938;
// rt_pathtrace_bwd_soft_large, a thread per ray in `namespace large` with
// pathtrace_soft_span.cuh). Past 64 the warp composites sparsely: it
// skips every hypothesis whose soft coverage is exactly 0 for all its live
// rays (a factor of alpha exactly 0: the sigmoid 1 / (1 + exp(-x)) is 0
// below x = -88.72), and every span left empty. A skipped hypothesis
// contributes factors of exactly 1, terms of exactly 0 and a zero adjoint,
// so each ray's values keep the dense composite's bits (only the atomic
// order of the row sums changes); pathtrace_soft_span.cuh says why. The
// replay evaluates every row once per segment and shadow ray; the sweep
// and the adjoints run over the live rows only. The forward value of the
// pass is kernel 1's hard pass; only the backward is the soft program's.
// The plain version is
// ops/megakernel_soft.pathtrace_pass_bwd_soft_reference (dense: the
// oracle).
//
// One adjoint for both entries (ray_adjoint, direct_adjoint), on a
// composite that the entry supplies (Comp, below). Up to 64 objects per
// type one group of G lanes per ray (GroupComp, pathtrace_soft_adj.cuh);
// past that one thread per ray (large::SpanComp,
// pathtrace_soft_span.cuh). Replay the soft forward and tape bounces + 1
// segments (the segment's origin, direction, window start, throughput and
// path weight at its start, its soft surface and its draws; the group
// layout also tapes, past 64 hypotheses, each span's coverage, blend and
// outer exclusive product; the span kernel each span's 64-bit mask of the
// rows live for its warp), then sweep the segments in reverse: the
// bounce to the next segment, the roulette's 1 / p (rr_adj, on the soft
// throughput), NEE per light in reverse with the shadow transmittance's
// adjoint, the emitter race on the primary segment, the composite's
// adjoint into every hypothesis, and last the camera chain and the
// scene-AABB clip (mint is differentiable here, unlike the hard route)
// into par. A path ends early only by the roulette; a ray that leaves the
// scene box has path weight 0 and adds nothing.
//
// Draws: u-planes or in-kernel threefry at the forward's counters
// (pathtrace.cuh Draws), bit-equal to u_planes_for_pass; the replay
// computes each segment's draws (a word a lane) and tapes them.
//
// What bounds it: up to 64 objects the composite's ordered pairs (a
// sigmoid, two MUFU operations, per pair and pass), FP32 operations and
// their latency, not bytes (PERF.md §6, rows 2s, 2sd; §7); past 64 the
// live spans' adjoint chains, then the replay's pass over every row per
// segment and shadow ray (row 2s'). The
// launcher picks G from the widest composite (group_for) and the block
// size with the most resident warps per SM (the occupancy API).
//
// Float atomics (the flush) and the groups' sums make results
// order-dependent: they agree with the plain version to float tolerance,
// never bitwise.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace_soft_adj.cuh"
#include "pathtrace_soft_span.cuh"

namespace {

using namespace rt;
using namespace rt::soft;

constexpr int kMaxBlock = 128;

// One build holds the instances of one mode, RT_SOFT_MODE: 0 path, 1 path
// with Russian roulette, 2 direct (ops/megakernel_soft.soft_flags), so that
// the three builds compile at the same time; a C entry called in another
// mode returns cudaErrorInvalidValue.
#ifndef RT_SOFT_MODE
#define RT_SOFT_MODE 0
#endif
constexpr bool kBuildRR = RT_SOFT_MODE == 1;
constexpr bool kBuildDirect = RT_SOFT_MODE == 2;

// Adjoint of the primary ray's scene-AABB clip, mint = max(max(n0, max(n1,
// n2)), 0) with n_ax = min(t0, t1), t = (p - o) / d (d = 0 read as 1e-30):
// from gmint into the ray's (go, gd) and par's pmin and pmax.
__device__ void clip_adj(const float* P, V3 o, V3 d, float gmint, V3& go,
                         V3& gd, float (&gp)[kNPar]) {
  const float ox[3] = {o.x, o.y, o.z}, dx[3] = {d.x, d.y, d.z};
  float t0[3], t1[3], sd[3], nr[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    sd[ax] = dx[ax] == 0.0f ? 1e-30f : dx[ax];
    t0[ax] = (P[kPmin + ax] - ox[ax]) / sd[ax];
    t1[ax] = (P[kPmax + ax] - ox[ax]) / sd[ax];
    nr[ax] = fminf(t0[ax], t1[ax]);
  }
  const float m12 = fmaxf(nr[1], nr[2]);
  const float m = fmaxf(nr[0], m12);
  const float gm = gmint * hmax(m, 0.0f);
  const float gm12 = gm * hmax(m12, nr[0]);
  const float gn[3] = {gm * hmax(nr[0], m12), gm12 * hmax(nr[1], nr[2]),
                       gm12 * hmax(nr[2], nr[1])};
  float gox[3] = {0.0f, 0.0f, 0.0f}, gdx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float g0 = gn[ax] * hmin(t0[ax], t1[ax]);
    const float g1 = gn[ax] * hmin(t1[ax], t0[ax]);
    gp[kPmin + ax] += g0 / sd[ax];
    gp[kPmax + ax] += g1 / sd[ax];
    gox[ax] = -(g0 + g1) / sd[ax];
    if (dx[ax] != 0.0f) gdx[ax] = -(g0 * t0[ax] + g1 * t1[ax]) / sd[ax];
  }
  go = go + mk(gox[0], gox[1], gox[2]);
  gd = gd + mk(gdx[0], gdx[1], gdx[2]);
}

__device__ __forceinline__ V3 mul3(V3 a, V3 b) {
  return mk(a.x * b.x, a.y * b.y, a.z * b.z);
}

// The adjoints below run on either of two composites, Comp:
//   * GroupComp<G> (up to 64 objects per type): the ray's group of G lanes,
//     its tape, scratch and gradient buffer in the group's shared slice;
//     the sweep reads the replay's taped surface;
//   * large::SpanComp (past 64): one thread per ray, its tape and span
//     scratch in local memory, its warp's span masks in shared memory, row
//     cotangents of the warp's live rows summed over the warp and added
//     atomically; the sweep reads the taped surface, its adjoint runs the
//     live rows' composites again.
// Comp gives: kLanes (lanes per ray) and kDraw (where a segment's draws
// start in its tape); lane(), wrt(), sync() (between a lane's tape writes
// and another lane's reads), seg(s) (segment s's tape), pwc() (the path
// weights before each emitter term); trace_fwd / surface / trace_adj (the
// soft surface of segment s: the replay's, the sweep's, its adjoint),
// vis_fwd / vis_adj (the shadow transmittance) and add_light (a light's row
// cotangents). `live` says whether the lane's ray is live (the large
// entry's warp skips what no live lane needs).

// The whole adjoint of ray rid_g for acc cotangent g on composite cm;
// warp-uniform (every lane calls it, `active` false for a lane without a
// ray).
template <bool kRR, class Comp>
__device__ __forceinline__ void ray_adjoint(Comp& cm, const Tables& T,
                                            const Cfg& C, const Draws& D,
                                            bool active, int rid_g, int spp,
                                            int width, int bounces,
                                            int rr_start,
                                            bool normalize_emitter, V3 g,
                                            float (&gp)[kNPar]) {
  constexpr int kU = Comp::kDraw;
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  const V3 zero = mk(0.0f, 0.0f, 0.0f), up = mk(0.0f, 0.0f, 1.0f);
  int col = 0, row = 0, samp = 0, nseg = 0;
  V3 o = zero, d = up, tp = mk(1.0f, 1.0f, 1.0f);
  float mint = 0.0f, pw = 1.0f;
  bool alive = false;
  if (active) {
    pixel_of(rid_g, spp, width, col, row, samp);
    float maxt;
    camera_ray(T.par, D, col, row, samp, spp, o, d, mint, maxt);
    // a ray outside the scene box has path weight 0: no segment
    alive = mint < inf_f();
  }
  for (int s = 0; s <= bounces; ++s) {
    if (!__any_sync(kFull, alive)) break;
    float* seg = cm.seg(s);
    if (alive) {
      nseg = s + 1;
      if (cm.lane() == 0) {
        const float w[kTapeRay] = {o.x,  o.y,  o.z,  d.x,  d.y, d.z,
                                   mint, tp.x, tp.y, tp.z, pw};
#pragma unroll
        for (int k = 0; k < kTapeRay; ++k) seg[k] = w[k];
      }
      // the segment's draws, a word a lane, for the replay and the sweep:
      // the bounce's pair (before the last depth), each light's NEE pair
      for (int k = cm.lane(); k < 2 + 2 * L; k += Comp::kLanes) {
        float v = 0.0f;
        if (k >= 2)
          v = draw(D, nee_slot(s, (k - 2) >> 1, L, kRR), k & 1);
        else if (s < bounces)
          v = draw(D, bounce_slot(s, L, kRR), k);
        seg[kU + k] = v;
      }
    }
    cm.sync();
    const SRay r = alive ? sray(o, d, mint) : sray(zero, up, 0.0f);
    Surf sf;
    cm.trace_fwd(T, C, alive, s, r, sf);
    if (!alive) continue;
    if (s == 0)
      for (int li = 0; li < L; ++li)
        pw = pw * (1.0f - emit_fwd(T, C, li, r, sf.cov, sf.tbar).lw);
    for (int li = 0; li < L; ++li) tp = mul3(tp, sf.alb);
    // the roulette on the soft throughput; a path it ends adds nothing
    if (s == bounces || (kRR && s >= rr_start && !rr_survive(D, s, L, tp))) {
      alive = false;
      continue;
    }
    Hit h;
    h.p = sf.pbar;
    h.n = sf.nbar;
    float cx, cy, cz;
    bounce_ray_uv(seg[kU], seg[kU + 1], h, eps, cx, cy, cz, o, d);
    mint = 0.0f;
    pw = pw * sf.cov;
  }

  // the reverse sweep, warp-uniform: cotangents of the next segment's
  // origin, direction, throughput and path weight
  float* pwc = cm.pwc();
  V3 gO = zero, gD = zero, gTP = zero;
  float gPW = 0.0f;
  for (int s = __reduce_max_sync(kFull, nseg) - 1; s >= 0; --s) {
    const bool live = s < nseg;
    const float* w = cm.seg(s);
    const V3 o = live ? mk(w[0], w[1], w[2]) : zero;
    const V3 d = live ? mk(w[3], w[4], w[5]) : up;
    const float mint = live ? w[6] : 0.0f;
    const V3 tp0 = live ? mk(w[7], w[8], w[9]) : zero;
    const float pw0 = live ? w[10] : 0.0f;
    const SRay r = sray(o, d, mint);
    const Surf sf = cm.surface(T, C, s, r);
    const V3 alb = sf.alb;
    // the path weight through the emitter terms (primary segment)
    float pwE = pw0;
    if (s == 0) {
      for (int li = 0; li < L; ++li) {
        if (cm.lane() == 0) pwc[li] = pwE;
        pwE = pwE * (1.0f - emit_fwd(T, C, li, r, sf.cov, sf.tbar).lw);
      }
      cm.sync();
    }
    float gCov = 0.0f, gTbar = 0.0f, gMint = 0.0f, gPwE = 0.0f;
    V3 gPbar = zero, gNbar = zero, gAlb = zero, go = zero, gd = zero;
    V3 gTPc = zero;  // of the throughput after the current light's NEE
    if (live && s + 1 < nseg) {
      // segment s + 1 started with pw' = pwE cov, tp' = tp (/ p), from
      // o' = pbar + eps nbar, d' = normalize(cx t + cy b + cz nbar)
      gPwE += gPW * sf.cov;
      gCov += gPW * pwE;
      V3 tpA = tp0;
      for (int li = 0; li < L; ++li) tpA = mul3(tpA, alb);
      gTPc = (kRR && s >= rr_start) ? rr_adj(tpA, gTP) : gTP;
      Hit h;
      h.p = sf.pbar;
      h.n = sf.nbar;
      float cx, cy, cz;
      V3 o2, d2, tx, bx;
      bounce_ray_uv(w[kU], w[kU + 1], h, eps, cx, cy, cz, o2, d2);
      tangent_frame(sf.nbar, tx, bx);
      const V3 gdr = normalize_adj(cx * tx + cy * bx + cz * sf.nbar, gD);
      gNbar = gNbar + cz * gdr + tangent_frame_adj(sf.nbar, cx * gdr, cy * gdr);
      gPbar = gPbar + gO;
      gNbar = gNbar + eps * gO;
      gp[kEps] += dot(gO, sf.nbar);
    }
    // NEE in reverse light order
    for (int li = L - 1; li >= 0; --li) {
      const float* l = T.lig + li * kLig;
      float gl[kLig] = {};
      V3 tpb = tp0;  // throughput before this light's NEE
      for (int k = 0; k < li; ++k) tpb = mul3(tpb, alb);
      const float u0 = live ? w[kU + 2 + 2 * li] : 0.5f;
      const float u1 = live ? w[kU + 3 + 2 * li] : 0.5f;
      const Nee nr = nee_ray(T, li, u0, u1, sf.pbar, sf.nbar, eps);
      const SRay sr = sray(nr.so, nr.sd, 0.0f);
      const float vis = cm.vis_fwd(T, C, live, sr, nr.dist);
      const V3 lp = ld3(l), ln = ld3(l + 3), irr = ld3(l + 6);
      const float area = l[13], rad = l[12];
      const V3 q = sf.pbar - lp;
      const float r2 = dot(q, q);
      const float rr = fmaxf(r2, 1e-20f);
      const float cxv = dot(nr.sd, sf.nbar), cyv = -dot(nr.sd, ln);
      const float cosx = clip01(cxv), cosy = clip01(cyv);
      const float geom = area * cosx * cosy / rr;
      const float gain = pwE * sf.cov * vis * geom;
      // acc += ((gain tpb) alb) irr; tp = tpb alb
      const V3 gtb = mk(gain * tpb.x, gain * tpb.y, gain * tpb.z);
      gAlb = gAlb + mul3(gTPc, tpb) + mul3(mul3(g, gtb), irr);
      const float ggain = dot(g, mul3(mul3(tpb, alb), irr));
      gl[6] += g.x * (gtb.x * alb.x);
      gl[7] += g.y * (gtb.y * alb.y);
      gl[8] += g.z * (gtb.z * alb.z);
      gTPc = mul3(gTPc, alb) + gain * mul3(mul3(g, alb), irr);
      gPwE += ggain * sf.cov * vis * geom;
      gCov += ggain * pwE * vis * geom;
      const float gvis = ggain * pwE * sf.cov * geom;
      const float ggeom = ggain * pwE * sf.cov * vis;
      gl[13] += ggeom * cosx * cosy / rr;
      const float gcx = ggeom * area * cosy / rr * clip01_d(cxv);
      const float gcy = ggeom * area * cosx / rr * clip01_d(cyv);
      const float gr2 = -ggeom * geom / rr * hmax(r2, 1e-20f);
      V3 gsd = gcx * sf.nbar - gcy * ln;
      gNbar = gNbar + gcx * nr.sd;
      V3 gln = (-gcy) * nr.sd;
      const V3 gq = (2.0f * gr2) * q;
      gPbar = gPbar + gq;
      V3 glp = mk(-gq.x, -gq.y, -gq.z);
      V3 gso = zero;
      float gdist = 0.0f;
      cm.vis_adj(T, C, live, sr, nr.dist, gvis, gso, gsd, gdist);
      const float gd2 = gdist * 0.5f / nr.dist * hmax(nr.d2, 1e-20f);
      const V3 gdl = normalize_adj(nr.dl, gsd) + (2.0f * gd2) * nr.dl;
      gso = gso - gdl;
      // tgt = lp + (sx rad) ta + (sy rad) ba
      glp = glp + gdl;
      const V3 ta = ld3(l + 14), ba = ld3(l + 17);
      gl[12] += nr.sx * dot(gdl, ta) + nr.sy * dot(gdl, ba);
      const V3 gta = (nr.sx * rad) * gdl, gba = (nr.sy * rad) * gdl;
      gPbar = gPbar + gso;
      gNbar = gNbar + eps * gso;
      if (live) gp[kEps] += dot(gso, sf.nbar);
      const V3 v[4] = {glp, gln, gta, gba};
      const int at[4] = {0, 3, 14, 17};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        gl[at[k]] += v[k].x;
        gl[at[k] + 1] += v[k].y;
        gl[at[k] + 2] += v[k].z;
      }
      cm.add_light(live, li, gl);
    }
    // the emitter terms in reverse: acc += (pw lw) irr, pw' = pw (1 - lw)
    float gPW0 = gPwE;
    if (s == 0) {
      const int ce = normalize_emitter ? 9 : 6;
      for (int li = L - 1; li >= 0; --li) {
        const Emit e = emit_fwd(T, C, li, r, sf.cov, sf.tbar);
        const V3 irr = ld3(T.lig + li * kLig + ce);
        const float pw = pwc[li];
        const float gai = dot(g, irr);
        const float glw = gai * pw - gPW0 * pw;
        float gl[kLig] = {};
        const V3 gi = mk(g.x * (pw * e.lw), g.y * (pw * e.lw),
                         g.z * (pw * e.lw));
        // irradiance words 6-8, or 9-11 normalized (static indices)
        if (normalize_emitter) {
          gl[9] += gi.x;
          gl[10] += gi.y;
          gl[11] += gi.z;
        } else {
          gl[6] += gi.x;
          gl[7] += gi.y;
          gl[8] += gi.z;
        }
        gPW0 = gPW0 * (1.0f - e.lw) + gai * e.lw;
        emit_adj(T, C, li, r, sf.cov, e, glw, go, gd, gMint, gCov, gTbar, gl);
        cm.add_light(live, li, gl);
      }
    }
    // the soft surface into every hypothesis
    cm.trace_adj(T, C, live, s, r, sf, gCov, gTbar, gPbar, gNbar, gAlb, go,
                 gd, gMint);
    if (live && s == 0 && (cm.wrt() & kWPar)) {
      clip_adj(T.par, o, d, gMint, go, gd, gp);
      camera_adj(T.par, D, col, row, samp, spp, go, gd, gp);
    }
    gO = go;
    gD = gd;
    gPW = gPW0;
    gTP = gTPc;
  }
}

// The soft adjoint of ray rid_g in direct mode (JAX's _tile_program_soft
// direct branch, megakernel_grad.py:2039-2075) on composite cm: the
// primary segment's blended surface, shaded per light by clip(ambient +
// vis clip(cos)) with vis the shadow ray's soft transmittance over [0,
// sqrt(max(d2, 1e-20))], weighted by the path weight (1 inside the scene
// box) times the coverage, times the blended albedo. One segment (tape
// segment 0 holds its draws); the pieces are path mode's. Warp-uniform, as
// ray_adjoint.
template <class Comp>
__device__ __forceinline__ void direct_adjoint(Comp& cm, const Tables& T,
                                               const Cfg& C,
                                               const DirectSlots& DS,
                                               bool active, int rid_g,
                                               int spp, int width, V3 g,
                                               float (&gp)[kNPar]) {
  constexpr int kU = Comp::kDraw;
  const int L = T.n_lig;
  const float eps = T.par[kEps], ambient = T.par[kAmbient];
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  int col = 0, row = 0, samp = 0;
  V3 o = zero, d = mk(0.0f, 0.0f, 1.0f);
  float mint = 0.0f;
  bool live = false;
  if (active) {
    pixel_of(rid_g, spp, width, col, row, samp);
    float maxt;
    camera_ray(T.par, DS.lens(), col, row, samp, spp, o, d, mint, maxt);
    // a ray outside the scene box has path weight 0
    live = mint < inf_f();
    if (!live) {
      o = zero;
      d = mk(0.0f, 0.0f, 1.0f);
      mint = 0.0f;
    }
  }
  if (!__any_sync(kFull, live)) return;
  const SRay r = sray(o, d, mint);
  float* seg = cm.seg(0);
  // the shadow rays' draws, a word a lane (slot 1 + li: DirectSlots::pair)
  for (int k = cm.lane(); k < 2 * L; k += Comp::kLanes) {
    const int j = 1 + (k >> 1), c = k & 1;
    float v = 0.5f;
    if (live)
      v = DS.D.u != nullptr
              ? draw(DS.D, j, c)
              : threefry_uniform(DS.keys[2 * j], DS.keys[2 * j + 1],
                                 DS.base + static_cast<uint32_t>(c));
    seg[kU + 2 + k] = v;
  }
  cm.sync();
  Surf sf;
  cm.trace_fwd(T, C, live, 0, r, sf);
  const V3 alb = sf.alb;
  float gCov = 0.0f, gMint = 0.0f;
  V3 gPbar = zero, gNbar = zero, gAlb = zero, go = zero, gd = zero;
  for (int li = 0; li < L; ++li) {
    const float* l = T.lig + li * kLig;
    float gl[kLig] = {};
    const float u0 = seg[kU + 2 + 2 * li];
    const float u1 = seg[kU + 3 + 2 * li];
    const Nee nr = nee_ray(T, li, u0, u1, sf.pbar, sf.nbar, eps);
    const SRay sr = sray(nr.so, nr.sd, 0.0f);
    const float vis = cm.vis_fwd(T, C, live, sr, nr.dist);
    const float cxv = dot(nr.sd, sf.nbar);
    const float cosx = clip01(cxv);
    const float x = ambient + vis * cosx;
    const float shade = clip01(x);
    // acc += ((cov alb) shade)
    const float ga = dot(g, alb);
    gCov += ga * shade;
    gAlb = gAlb + (sf.cov * shade) * g;
    const float gx = sf.cov * ga * clip01_d(x);
    if (live) gp[kAmbient] += gx;
    const float gc = gx * vis * clip01_d(cxv);
    V3 gsd = gc * sf.nbar;
    gNbar = gNbar + gc * nr.sd;
    V3 gso = zero;
    float gdist = 0.0f;
    cm.vis_adj(T, C, live, sr, nr.dist, gx * cosx, gso, gsd, gdist);
    const float gd2 = gdist * 0.5f / nr.dist * hmax(nr.d2, 1e-20f);
    const V3 gdl = normalize_adj(nr.dl, gsd) + (2.0f * gd2) * nr.dl;
    gso = gso - gdl;
    // tgt = lp + (sx rad) ta + (sy rad) ba
    const float rad = l[12];
    const V3 ta = ld3(l + 14), ba = ld3(l + 17);
    gl[12] += nr.sx * dot(gdl, ta) + nr.sy * dot(gdl, ba);
    const V3 v[3] = {gdl, (nr.sx * rad) * gdl, (nr.sy * rad) * gdl};
    const int at[3] = {0, 14, 17};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gl[at[k]] += v[k].x;
      gl[at[k] + 1] += v[k].y;
      gl[at[k] + 2] += v[k].z;
    }
    gPbar = gPbar + gso;
    gNbar = gNbar + eps * gso;
    if (live) gp[kEps] += dot(gso, sf.nbar);
    cm.add_light(live, li, gl);
  }
  // the soft surface into every hypothesis
  cm.trace_adj(T, C, live, 0, r, sf, gCov, 0.0f, gPbar, gNbar, gAlb, go,
               gd, gMint);
  if (live && (cm.wrt() & kWPar)) {
    clip_adj(T.par, o, d, gMint, go, gd, gp);
    camera_adj(T.par, DS.lens(), col, row, samp, spp, go, gd, gp);
  }
}

// ---------------------------------------------------------------------------
// Up to 64 objects per type: the group layout (pathtrace_soft_adj.cuh)
// ---------------------------------------------------------------------------

// The group layout's composite for the adjoints above: the ray's group of
// G lanes, its tape, scratch and gradient buffer in the group's slice.
template <int G>
struct GroupComp {
  static constexpr int kLanes = G;
  static constexpr int kDraw = kTapeSeg;
  Grp<G> gr;
  SGrads SG;
  __device__ __forceinline__ int lane() const { return gr.lane; }
  __device__ __forceinline__ int wrt() const { return SG.wrt; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ float* seg(int s) const { return gr.seg(s); }
  __device__ __forceinline__ float* pwc() const { return gr.s + gr.L->pwc; }
  __device__ __forceinline__ void trace_fwd(const Tables& T, const Cfg& C,
                                            bool, int s, const SRay& r,
                                            Surf& sf) const {
    trace_fwd_g(gr, T, C, r, gr.seg(s), sf);
  }
  // the sweep's surface: the one the replay taped
  __device__ __forceinline__ Surf surface(const Tables&, const Cfg&, int s,
                                          const SRay&) const {
    return surf_of(gr.seg(s));
  }
  __device__ __forceinline__ void trace_adj(
      const Tables& T, const Cfg& C, bool live, int s, const SRay& r,
      const Surf& sf, float gcov, float gtbar, V3 gpbar, V3 gnbar, V3 galb,
      V3& go, V3& gd, float& gmint) const {
    trace_adj_g(gr, T, C, SG, live, r, gr.seg(s), sf, gcov, gtbar, gpbar,
                gnbar, galb, go, gd, gmint);
  }
  __device__ __forceinline__ float vis_fwd(const Tables& T, const Cfg& C,
                                           bool, const SRay& r,
                                           float dist) const {
    return vis_fwd_g(gr, T, C, r, dist);
  }
  __device__ __forceinline__ void vis_adj(const Tables& T, const Cfg& C,
                                          bool live, const SRay& r,
                                          float dist, float gvis, V3& go,
                                          V3& gd, float& gdist) const {
    vis_adj_g(gr, T, C, SG, live, r, dist, gvis, go, gd, gdist);
  }
  // light li's row cotangents gl: lane 0's plain adds, where live
  __device__ __forceinline__ void add_light(bool live, int li,
                                            const float (&gl)[kLig]) const {
    if (!(SG.wrt & kWLig) || !live || gr.lane != 0) return;
#pragma unroll
    for (int w = 0; w < kLig; ++w)
      if (gl[w] != 0.0f) SG.lig[li * kLig + w] += gl[w];
  }
};

// One launch: the pass's parameters, the groups' layout and the staged
// tables' floats.
struct SoftParams {
  AdjParams p;
  Layout L;
  int n_tab;
};

// The block's groups take rays in a grid-stride loop, a warp's 32 / G
// groups consecutive rays and in step; each group's buffer collects its
// rays' cotangents, and the block adds its groups' buffers into the outputs
// at the end.
template <int G, bool kRR, bool kDirect>
__global__ void __launch_bounds__(kMaxBlock)
    pathtrace_bwd_soft_kernel(const __grid_constant__ SoftParams q) {
  const AdjParams& p = q.p;
  const Layout& L = q.L;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const Tables T = stage_tables(smem, p.par, p.sph, p.n_sph, p.tri, p.n_tri,
                                p.mat, p.n_mat, p.lig, p.n_lig,
                                p.two_sided != 0);
  const int groups = blockDim.x / G;
  float* slices = smem + q.n_tab;
  zero(slices, groups * L.size);
  GroupComp<G> cm;
  Grp<G>& gr = cm.gr;
  gr.lane = threadIdx.x & (G - 1);
  gr.gq = (threadIdx.x & 31) / G;
  gr.s = slices + (threadIdx.x / G) * L.size;
  gr.L = &L;
  // the group's row buffers, after its par
  float* rb = gr.s + L.grad + kParPad;
  SGrads& SG = cm.SG;
  SG.sph = rb + (L.w_sph >= 0 ? L.w_sph : 0);
  SG.tri = rb + (L.w_tri >= 0 ? L.w_tri : 0);
  SG.mat = L.w_mat >= 0 ? rb + L.w_mat : nullptr;
  SG.lig = L.w_lig >= 0 ? rb + L.w_lig : nullptr;
  SG.wrt = p.wrt;
  __syncthreads();

  Cfg C;
  C.ibw = 1.0f / p.bw;
  C.itau = 1.0f / p.tau;
  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  const int per_warp = 32 / G;
  const int n_draws = n_draws_of(p.n_lig, p.bounces, kRR);
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int base = warp * per_warp; base < p.n_rays;
       base += n_warps * per_warp) {
    const int rid = base + gr.gq;
    V3 g = mk(0.0f, 0.0f, 0.0f);
    if (rid < p.n_rays) {
      const float* gg = p.g + 3 * static_cast<size_t>(rid);
      g = mk(gg[0], gg[1], gg[2]);
    }
    const bool active = g.x != 0.0f || g.y != 0.0f || g.z != 0.0f;
    const int rid_g = rid + p.ray_offset;
    Draws D;
    D.u = p.u;
    D.n_rays = p.n_rays;
    D.rid = rid;
    D.k0 = p.k0;
    D.k1 = p.k1;
    D.base = static_cast<uint32_t>(rid_g) * static_cast<uint32_t>(2 * n_draws);
    if constexpr (kDirect)
      direct_adjoint(cm, T, C, direct_slots(D, p.dkeys, rid_g), active, rid_g,
                     p.spp, p.width, g, gp);
    else
      ray_adjoint<kRR>(cm, T, C, D, active, rid_g, p.spp, p.width, p.bounces,
                       p.rr_start, p.normalize_emitter != 0, g, gp);
  }
  if ((p.wrt & kWPar) && gr.lane == 0)
    for (int i = 0; i < kNPar; ++i) gr.s[L.grad + i] += gp[i];
  __syncthreads();
  if (p.wrt & kWPar) flush(p.dpar, slices + L.grad, kNPar, L.size, groups);
  const float* rb0 = slices + L.grad + kParPad;
  if (L.w_sph >= 0)
    flush(p.dsph, rb0 + L.w_sph, kSph * p.n_sph, L.size, groups);
  if (L.w_tri >= 0)
    flush(p.dtri, rb0 + L.w_tri, kTri * p.n_tri, L.size, groups);
  if (L.w_mat >= 0)
    flush(p.dmat, rb0 + L.w_mat, kMat * p.n_mat, L.size, groups);
  if (L.w_lig >= 0)
    flush(p.dlig, rb0 + L.w_lig, kLig * p.n_lig, L.size, groups);
}

using Kernel = void (*)(SoftParams);

Kernel kernel_for(int G) {
  return G == 4   ? pathtrace_bwd_soft_kernel<4, kBuildRR, kBuildDirect>
         : G == 8 ? pathtrace_bwd_soft_kernel<8, kBuildRR, kBuildDirect>
                  : pathtrace_bwd_soft_kernel<32, kBuildRR, kBuildDirect>;
}

// What the last launch took (rt_soft_last).
int g_last[8] = {};

// ---------------------------------------------------------------------------
// Past 64 objects per type: the span kernel (pathtrace_soft_span.cuh), one
// thread per ray, the warp compositing only the rows and spans that are
// live for its 32 rays (exact: the header says why). The group layout took
// 9.57 s here against the dense thread per ray's 7.29 s at the main path's
// 1024^2 (PERF.md §6 row 2s'), so the span kernel keeps a thread per ray.
// ---------------------------------------------------------------------------

namespace large {

using namespace rt::soft::span;

constexpr int kBlock = 128;

// The span kernel's composite for the adjoints above: one thread per ray,
// its tape (the ray's words, its soft surface, then its draws), path
// weights and span scratch in local memory, its warp's span masks in
// shared memory (Warp), its live spans' words in global memory (SpanTape,
// nc slots per segment); row cotangents summed over the warp and added
// atomically (wadd; zero where !live). The sweep reads the taped surface.
struct SpanComp {
  static constexpr int kLanes = 1;
  static constexpr int kDraw = kTapeSeg;
  SpanScratch S;
  Grads G;
  Warp W;
  SpanTape spans;  // segment 0's; segment s is s nc slots on
  int tw;  // tape words per segment: kDraw + 2 + 2 n_lig
  float tape[kMaxSeg * (kDraw + 2 + 2 * kMaxLights)];
  float pw[kMaxLights + 1];
  __device__ __forceinline__ int lane() const { return 0; }
  __device__ __forceinline__ int wrt() const { return G.wrt; }
  __device__ __forceinline__ void sync() const {}
  __device__ __forceinline__ float* seg(int s) { return tape + s * tw; }
  __device__ __forceinline__ float* pwc() { return pw; }
  __device__ __forceinline__ uint64_t* masks(int s) const {
    return W.seg + s * W.nc;
  }
  __device__ __forceinline__ SpanTape span_tape(int s) const {
    SpanTape t = spans;
    t.p += static_cast<size_t>(s) * W.nc * kSpanWords * t.stride;
    return t;
  }
  // the replay's surface of segment s, taped (words 11-23) with its masks
  __device__ __forceinline__ void trace_fwd(const Tables& T, const Cfg& C,
                                            bool live, int s, const SRay& r,
                                            Surf& sf) {
    span::trace_fwd(T, C, r, live, S, W, masks(s), span_tape(s), sf);
    float* w = seg(s);
    w[11] = sf.cov_raw;
    w[12] = sf.icov;
    w[13] = sf.good ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < 10; ++k) w[14 + k] = sf.f[k];
  }
  // the sweep's surface: the one the replay taped
  __device__ __forceinline__ Surf surface(const Tables&, const Cfg&, int s,
                                          const SRay&) {
    return surf_of(seg(s));
  }
  __device__ __forceinline__ void trace_adj(
      const Tables& T, const Cfg& C, bool live, int s, const SRay& r,
      const Surf& sf, float gcov, float gtbar, V3 gpbar, V3 gnbar, V3 galb,
      V3& go, V3& gd, float& gmint) {
    span::trace_adj(T, C, G, live, r, S, W, masks(s), span_tape(s), sf, gcov,
                    gtbar, gpbar, gnbar, galb, go, gd, gmint);
  }
  __device__ __forceinline__ float vis_fwd(const Tables& T, const Cfg& C,
                                           bool live, const SRay& r,
                                           float dist) {
    return span::vis_fwd(T, C, r, dist, live, S, W);
  }
  __device__ __forceinline__ void vis_adj(const Tables& T, const Cfg& C,
                                          bool live, const SRay& r, float,
                                          float gvis, V3& go, V3& gd,
                                          float& gdist) {
    span::vis_adj(T, C, G, live, r, gvis, S, W, go, gd, gdist);
  }
  __device__ __forceinline__ void add_light(bool live, int li,
                                            const float (&gl)[kLig]) {
    if (!(G.wrt & kWLig)) return;
#pragma unroll
    for (int w = 0; w < kLig; ++w)
      wadd(G.lig + li * kLig + w, live ? gl[w] : 0.0f);
  }
};

// Past 64 objects per type (rt_pathtrace_bwd_soft_large), up to
// DIFF_TABLE_MAX = 4096 per type: JAX's two-level composite over every
// SOFT_CHUNK span (pathtrace_soft_span.cuh). Soft cotangents reach every
// live hypothesis on every segment, so the block keeps one gradient
// buffer, which its warps add into atomically (wadd), where the sphere and
// triangle tables and their buffers fit in kResidentBytes (tables staged
// as the group layout's); past that the sphere and triangle tables are read
// from global memory (every lane of a warp reads the same row: one L1
// line) and their cotangents are added into the global outputs (warp sums,
// one atomicAdd per word, row and warp), par, mat and lig staying in the
// block's buffer. After the buffer, each warp's words (Warp: its segments'
// span masks). The live spans' words (SpanTape) go to a global buffer the
// caller allocates (rt_soft_large_tape gives its size).

constexpr size_t kResidentBytes = 48 * 1024;  // sphere and triangle rows

struct LargeParams {
  AdjParams p;
  int resident;  // sphere and triangle tables and buffers in shared memory
  int nseg;      // segments a ray's tape holds
  int warp_at;   // byte offset of the warps' words in shared memory
  float* spans;  // the live spans' words: nseg nc kSpanWords per thread
};

template <bool kRR, bool kDirect>
__global__ void __launch_bounds__(kBlock)
    pathtrace_bwd_soft_large_kernel(const __grid_constant__ LargeParams q) {
  const AdjParams& p = q.p;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int ns = q.resident ? p.n_sph : 0, nt = q.resident ? p.n_tri : 0;
  Tables T = stage_tables(smem, p.par, p.sph, ns, p.tri, nt, p.mat, p.n_mat,
                          p.lig, p.n_lig, p.two_sided != 0);
  T.n_sph = p.n_sph;
  T.n_tri = p.n_tri;
  if (!q.resident) {
    T.sph = p.sph;
    T.tri = p.tri;
  }
  // the block's gradient buffer, in the staged tables' layout
  const int n_tab = tables_floats(ns, nt, p.n_mat, p.n_lig);
  float* g_par = smem + n_tab;
  SpanComp cm;
  Grads& G = cm.G;
  G.sph = q.resident ? g_par + kParPad : p.dsph;
  G.tri = q.resident ? g_par + kParPad + kSph * ns : p.dtri;
  G.mat = g_par + kParPad + kSph * ns + kTri * nt;
  G.lig = G.mat + kMat * p.n_mat;
  G.wrt = p.wrt;
  cm.tw = SpanComp::kDraw + 2 + 2 * p.n_lig;
  const int nc = n_spans_of(p.n_sph, p.n_tri);
  cm.W = warp_at(reinterpret_cast<uint8_t*>(smem4) + q.warp_at +
                     (threadIdx.x >> 5) * warp_bytes(q.nseg, nc),
                 q.nseg, nc);
  cm.spans.stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  cm.spans.p = q.spans + blockIdx.x * blockDim.x + threadIdx.x;
  zero(g_par, n_tab);
  __syncthreads();

  Cfg C;
  C.ibw = 1.0f / p.bw;
  C.itau = 1.0f / p.tau;
  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  for_rays<kRR>(p, [&](const Draws& D, bool active, int rid_g, V3 g) {
    if constexpr (kDirect)
      direct_adjoint(cm, T, C, direct_slots(D, p.dkeys, rid_g), active, rid_g,
                     p.spp, p.width, g, gp);
    else
      ray_adjoint<kRR>(cm, T, C, D, active, rid_g, p.spp, p.width, p.bounces,
                       p.rr_start, p.normalize_emitter != 0, g, gp);
  });
  if (p.wrt & kWPar) add_par(g_par, gp);
  __syncthreads();
  if (p.wrt & kWPar) flush(p.dpar, g_par, kNPar);
  if (q.resident && (p.wrt & kWSph)) flush(p.dsph, G.sph, kSph * ns);
  if (q.resident && (p.wrt & kWTri)) flush(p.dtri, G.tri, kTri * nt);
  if (p.wrt & kWMat) flush(p.dmat, G.mat, kMat * p.n_mat);
  if (p.wrt & kWLig) flush(p.dlig, G.lig, kLig * p.n_lig);
}

// The launch's shape on a pass's sizes: the staged tables and the block's
// gradient buffer in their layout, then the warps' words; the grid; and
// the floats of the live spans' tape (kSpanWords per span, segment and
// launched thread), which the caller allocates.
struct Plan {
  LargeParams q;  // without the pass and the tape
  size_t smem;
  int grid;
  long long tape;
};

cudaError_t plan(int n_sph, int n_tri, int n_mat, int n_lig, int bounces,
                 int n_rays, Plan& P) {
  LargeParams& q = P.q;
  q.resident = sizeof(float) * (kSph * static_cast<size_t>(n_sph) +
                                kTri * static_cast<size_t>(n_tri)) <=
               kResidentBytes;
  q.nseg = kBuildDirect ? 1 : bounces + 1;
  const size_t tab =
      2 * sizeof(float) *
      tables_floats(q.resident ? n_sph : 0, q.resident ? n_tri : 0, n_mat,
                    n_lig);
  q.warp_at = static_cast<int>((tab + 15) / 16 * 16);
  const int nc = n_spans_of(n_sph, n_tri);
  P.smem = q.warp_at +
           static_cast<size_t>(kBlock / 32) * warp_bytes(q.nseg, nc);
  P.grid = 0;
  const cudaError_t err =
      fit_grid(pathtrace_bwd_soft_large_kernel<kBuildRR, kBuildDirect>,
               kBlock, P.smem, n_rays, P.grid);
  P.tape = static_cast<long long>(kSpanWords) * q.nseg * nc * P.grid * kBlock;
  return err;
}

// Launches it on the pass p (the C entry's arguments checked) with the
// live spans' tape `spans` of `spans_floats` floats (at least plan's).
int launch(const AdjParams& p, int n_sph, int n_tri, int n_mat, int n_lig,
           float* spans, long long spans_floats, void* stream) {
  Plan P;
  cudaError_t err =
      plan(n_sph, n_tri, n_mat, n_lig, p.bounces, p.n_rays, P);
  if (err == cudaSuccess && (spans == nullptr || spans_floats < P.tape))
    err = cudaErrorInvalidValue;
  LargeParams q = P.q;
  q.p = p;
  q.spans = spans;
  void (*kernel)(LargeParams) =
      pathtrace_bwd_soft_large_kernel<kBuildRR, kBuildDirect>;
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, P.smem);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int last[8] = {1, kBlock / 32, q.resident, static_cast<int>(P.smem),
                       !q.resident && (p.wrt & (kWSph | kWTri)) ? 1 : 0,
                       per_sm * kBlock / 32, fa.numRegs,
                       static_cast<int>(fa.localSizeBytes)};
  for (int k = 0; k < 8; ++k) g_last[k] = last[k];
  kernel<<<P.grid, kBlock, P.smem, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace large

// The group size for the widest composite w. Each lane runs its ray's
// scalar work, so fewer lanes are cheaper (cornell's 12 hypotheses: 31.5
// ms at G = 4, 46.8 at 8, 138.2 at 32; PERF.md §6 row 2s), while a group's
// slice grows as w^2: wider composites take more lanes per ray so that the
// slices of a block still fit in shared memory. The thresholds 16 and 32
// come from that fit, not from a timing: no scene of 17-64 objects has
// been timed at another G.
int group_for(int w) { return w <= 16 ? 4 : w <= 32 ? 8 : 32; }

// Launches kernel 2s's group layout on the pass p (at most 64 objects per
// type: the tables staged in shared memory) in the block size with the
// most resident warps per SM (the occupancy API, which counts shared
// memory and registers; on a tie the larger block).
int launch(const AdjParams& p, void* stream) {
  const int nseg = kBuildDirect ? 1 : p.bounces + 1;
  const int w =
      make_layout(32, p.n_sph, p.n_tri, p.n_mat, p.n_lig, nseg, p.wrt).w;
  const int G = group_for(w);
  const Kernel kernel = kernel_for(G);
  int dev = 0, opt = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&opt, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, opt);
  if (err != cudaSuccess) return static_cast<int>(err);
  SoftParams q;
  q.p = p;
  q.L = make_layout(G, p.n_sph, p.n_tri, p.n_mat, p.n_lig, nseg, p.wrt);
  q.n_tab = tables_floats(p.n_sph, p.n_tri, p.n_mat, p.n_lig);
  int best = 0, threads = 0;
  size_t smem = 0;
  for (int warps = 4; warps >= 1; warps /= 2) {
    const int t = 32 * warps;
    const size_t bytes =
        sizeof(float) * (q.n_tab + static_cast<size_t>(t / G) * q.L.size);
    if (bytes > static_cast<size_t>(opt)) continue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, t,
                                                        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * warps > best) {
      best = per_sm * warps;
      threads = t;
      smem = bytes;
    }
  }
  if (best == 0) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  // fit_grid counts one ray per thread: a group takes one
  err = fit_grid(kernel, threads, smem, p.n_rays * G, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int last[8] = {G,    threads / 32, 1, static_cast<int>(smem), 0,
                       best, fa.numRegs,   static_cast<int>(fa.localSizeBytes)};
  for (int k = 0; k < 8; ++k) g_last[k] = last[k];
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes). Adds the soft program's cotangents of
// one pass into dpar (26,), dsph (S, 8), dtri (T, 32), dmat (M, 4), dlig
// (L, 20), which the caller zeroes; `wrt` is a bit set of the groups (1 par,
// 2 sph, 4 tri, 8 mat, 16 lig); bw and tau the soft bandwidth and the depth
// order's temperature. Other arguments as rt_pathtrace_bwd (direct != 0:
// direct mode's soft shade); rr and direct are the build's RT_SOFT_MODE.
// At most 64 objects per type. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int rt_pathtrace_bwd_soft(
    const float* par, const float* sph, int n_sph, const float* tri,
    int n_tri, const float* mat, int n_mat, const float* lig, int n_lig,
    const float* g, int n_rays, int ray_offset, const float* u_planes,
    unsigned int k0, unsigned int k1, int spp, int width, int bounces, int rr,
    int rr_start_depth, int direct, int two_sided, int normalize_emitter,
    int wrt, float bw, float tau, float* dpar, float* dsph, float* dtri,
    float* dmat, float* dlig, void* stream) {
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      n_sph > kUnroll || n_tri > kUnroll || !(bw > 0.0f) || !(tau > 0.0f) ||
      (direct && (bounces || rr)) || (rr != 0) != kBuildRR ||
      (direct != 0) != kBuildDirect)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
  AdjParams p = adj_params(par, sph, n_sph, tri, n_tri, mat, n_mat, lig,
                           n_lig, g, n_rays, ray_offset, u_planes, k0, k1,
                           spp, width, bounces, rr_start_depth, two_sided,
                           normalize_emitter, wrt, dpar, dsph, dtri, dmat,
                           dlig);
  p.bw = bw;
  p.tau = tau;
  if (direct) set_direct_keys(p);
  return launch(p, stream);
}

// The floats of the live spans' tape that rt_pathtrace_bwd_soft_large
// needs on a pass of these sizes, into *floats (0 without rays).
extern "C" int rt_soft_large_tape(int n_sph, int n_tri, int n_mat, int n_lig,
                                  int bounces, int n_rays, long long* floats) {
  *floats = 0;
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      n_spans_of(n_sph, n_tri) > kMaxSpans)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  large::Plan P;
  const cudaError_t err =
      large::plan(n_sph, n_tri, n_mat, n_lig, bounces, n_rays, P);
  if (err == cudaSuccess) *floats = P.tape;
  return static_cast<int>(err);
}

// C interface past 64 objects per type: rt_pathtrace_bwd_soft's
// arguments, at most kMaxSpans spans of kSpan rows (64 of each type:
// DIFF_TABLE_MAX), the rows composited in the order given, and before
// `stream` the live spans' tape: a device buffer of `spans_floats` floats,
// at least rt_soft_large_tape's (48 bytes per span, segment and launched
// thread), which the kernel overwrites; it must stay allocated until the
// launch has run on `stream`.
extern "C" int rt_pathtrace_bwd_soft_large(
    const float* par, const float* sph, int n_sph, const float* tri,
    int n_tri, const float* mat, int n_mat, const float* lig, int n_lig,
    const float* g, int n_rays, int ray_offset, const float* u_planes,
    unsigned int k0, unsigned int k1, int spp, int width, int bounces, int rr,
    int rr_start_depth, int direct, int two_sided, int normalize_emitter,
    int wrt, float bw, float tau, float* dpar, float* dsph, float* dtri,
    float* dmat, float* dlig, float* spans, long long spans_floats,
    void* stream) {
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      n_spans_of(n_sph, n_tri) > kMaxSpans || !(bw > 0.0f) ||
      !(tau > 0.0f) || (direct && (bounces || rr)) ||
      (rr != 0) != kBuildRR || (direct != 0) != kBuildDirect)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
  AdjParams p = adj_params(par, sph, n_sph, tri, n_tri, mat, n_mat, lig,
                           n_lig, g, n_rays, ray_offset, u_planes, k0, k1,
                           spp, width, bounces, rr_start_depth, two_sided,
                           normalize_emitter, wrt, dpar, dsph, dtri, dmat,
                           dlig);
  p.bw = bw;
  p.tau = tau;
  if (direct) set_direct_keys(p);
  return large::launch(p, n_sph, n_tri, n_mat, n_lig, spans, spans_floats,
                       stream);
}

// What the last launch took, into out[8]: the lanes per ray (1: the
// large-table kernel's thread per ray), warps per block, staged sphere and
// triangle tables (1/0), dynamic shared memory bytes per block, sphere and
// triangle rows into global memory (1/0), resident warps per SM, and the
// kernel's registers and local memory bytes per thread.
extern "C" void rt_soft_last(int* out) {
  for (int k = 0; k < 8; ++k) out[k] = g_last[k];
}
