// Kernel 2s: the adjoint of one edge-aware pass as one CUDA kernel for
// Hopper (sm_90a): the parameter cotangents of sum_rays <g, soft_delta>,
// where soft_delta is the soft program's accumulator delta.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel_grad.py::_bwd_kernel
// (launcher _bwd_pallas, :2152) on its soft route, soft_bandwidth > 0: what
// jax.vjp of _tile_program_soft (:1516-2144) gives, path mode, with or
// without Russian roulette, u-planes or PRNG draws, spp >= 1: at most 64
// objects per type (the tables and per-warp gradient buffers stay in
// shared memory; rt_pathtrace_bwd_soft), and past that up to
// DIFF_TABLE_MAX = 4096 per type, JAX's two-level composite over every
// SOFT_CHUNK span (soft_trace :1883-1938; rt_pathtrace_bwd_soft_large,
// below). The forward value of the pass is kernel 1's hard pass; only the
// backward is the soft program's. The plain version is
// ops/megakernel_soft.pathtrace_pass_bwd_soft_reference.
//
// Per ray, one thread (a grid-stride loop in steps of whole warps, as
// kernel 2): replay the soft forward and keep a tape of bounces + 1
// segments (the segment's origin, direction, window start, throughput and
// path weight at its start; pathtrace_soft_adj.cuh recomputes the rest),
// then sweep the segments in reverse: the bounce to the next segment, the
// roulette's 1 / p (rr_adj, on the soft throughput), NEE per light in
// reverse with the shadow transmittance's adjoint, the emitter race on the
// primary segment, the composite's adjoint into every hypothesis, and last
// the camera chain and the scene-AABB clip (mint is differentiable here,
// unlike the hard route) into par. A path ends early only by the roulette;
// a ray that leaves the scene box has path weight 0 and adds nothing.
//
// Draws: u-planes or in-kernel threefry at the forward's counters
// (pathtrace.cuh Draws), bit-equal to u_planes_for_pass.
//
// Row cotangents: each warp sums a word over its lanes and adds it into its
// own gradient buffer in shared memory (no atomics there); the block adds
// its warps' buffers into the outputs with one global atomicAdd per nonzero
// word. The per-thread scratch (Scratch, kMaxHyp hypotheses) lives in
// local memory.
//
// Float atomics and warp sums make results order-dependent: they agree
// with the plain version to float tolerance, never bitwise.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace_soft_adj.cuh"

namespace {

using namespace rt;
using namespace rt::soft;

constexpr int kBlock = 128;
constexpr int kTapeWords = 11;  // o, d, mint, tp, path weight

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

// Adds light li's row cotangents gl warp-wide (zero where !live).
template <bool kAtomic>
__device__ __forceinline__ void add_light(const Grads& G, bool live, int li,
                                          const float (&gl)[kLig]) {
  if (!(G.wrt & kWLig)) return;
#pragma unroll
  for (int w = 0; w < kLig; ++w)
    wadd<kAtomic>(G.lig + li * kLig + w, live ? gl[w] : 0.0f);
}

// The whole adjoint of ray rid_g for acc cotangent g; warp-uniform (every
// lane calls it, `active` false for a lane without a ray). Scr: Scratch
// (one composite, at most 64 objects per type) or SpanScratch (JAX's
// two-level composite over every span), whose trace_fwd, trace_adj,
// vis_fwd and vis_adj run.
template <bool kRR, class Scr>
__device__ void ray_adjoint(const Tables& T, const Cfg& C, const Draws& D,
                            bool active, int rid_g, int spp, int width,
                            int bounces, int rr_start, bool normalize_emitter,
                            V3 g, const Grads& G, Scr& S,
                            float (&gp)[kNPar]) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  int col = 0, row = 0, samp = 0, nseg = 0;
  float tape[kMaxSeg][kTapeWords];
  if (active) {
    pixel_of(rid_g, spp, width, col, row, samp);
    V3 o, d;
    float mint, maxt;
    camera_ray(T.par, D, col, row, samp, spp, o, d, mint, maxt);
    V3 tp = mk(1.0f, 1.0f, 1.0f);
    float pw = 1.0f;
    // a ray outside the scene box has path weight 0: no segment
    for (int s = 0; s <= bounces && mint < inf_f(); ++s) {
      const float w[kTapeWords] = {o.x,  o.y,  o.z,  d.x,  d.y, d.z,
                                   mint, tp.x, tp.y, tp.z, pw};
      for (int k = 0; k < kTapeWords; ++k) tape[s][k] = w[k];
      nseg = s + 1;
      const SRay r = sray(o, d, mint);
      Surf sf;
      trace_fwd(T, C, r, S, sf);
      if (s == 0)
        for (int li = 0; li < L; ++li)
          pw = pw * (1.0f - emit_fwd(T, C, li, r, sf.cov, sf.tbar).lw);
      for (int li = 0; li < L; ++li) tp = mul3(tp, sf.alb);
      if (s == bounces) break;
      // the roulette on the soft throughput; a path it ends adds nothing
      if (kRR && s >= rr_start && !rr_survive(D, s, L, tp)) break;
      Hit h;
      h.p = sf.pbar;
      h.n = sf.nbar;
      float cx, cy, cz;
      bounce_ray(D, bounce_slot(s, L, kRR), h, eps, cx, cy, cz, o, d);
      mint = 0.0f;
      pw = pw * sf.cov;
    }
  }

  // the reverse sweep, warp-uniform: cotangents of the next segment's
  // origin, direction, throughput and path weight
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  V3 gO = zero, gD = zero, gTP = zero;
  float gPW = 0.0f;
  for (int s = __reduce_max_sync(kFull, nseg) - 1; s >= 0; --s) {
    const bool live = s < nseg;
    const float* w = tape[live ? s : 0];
    const V3 o = live ? mk(w[0], w[1], w[2]) : zero;
    const V3 d = live ? mk(w[3], w[4], w[5]) : mk(0.0f, 0.0f, 1.0f);
    const float mint = live ? w[6] : 0.0f;
    const V3 tp0 = live ? mk(w[7], w[8], w[9]) : zero;
    const float pw0 = live ? w[10] : 0.0f;
    const SRay r = sray(o, d, mint);
    Surf sf;
    trace_fwd(T, C, r, S, sf);
    const V3 alb = sf.alb;
    // the path weight through the emitter terms (primary segment)
    float pwc[kMaxLights + 1];
    float pwE = pw0;
    if (s == 0)
      for (int li = 0; li < L; ++li) {
        pwc[li] = pwE;
        pwE = pwE * (1.0f - emit_fwd(T, C, li, r, sf.cov, sf.tbar).lw);
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
      bounce_ray(D, bounce_slot(s, L, kRR), h, eps, cx, cy, cz, o2, d2);
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
      float u0 = 0.5f, u1 = 0.5f;
      if (live) D.pair(nee_slot(s, li, L, kRR), u0, u1);
      const Nee nr = nee_ray(T, li, u0, u1, sf.pbar, sf.nbar, eps);
      const SRay sr = sray(nr.so, nr.sd, 0.0f);
      const float vis = vis_fwd(T, C, sr, nr.dist, S);
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
      vis_adj(T, C, G, live, sr, gvis, S, gso, gsd, gdist);
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
      for (int k = 0; k < 4; ++k) {
        gl[at[k]] += v[k].x;
        gl[at[k] + 1] += v[k].y;
        gl[at[k] + 2] += v[k].z;
      }
      add_light<Scr::kAtomic>(G, live, li, gl);
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
        gl[ce] += g.x * (pw * e.lw);
        gl[ce + 1] += g.y * (pw * e.lw);
        gl[ce + 2] += g.z * (pw * e.lw);
        gPW0 = gPW0 * (1.0f - e.lw) + gai * e.lw;
        emit_adj(T, C, li, r, sf.cov, e, glw, go, gd, gMint, gCov, gTbar, gl);
        add_light<Scr::kAtomic>(G, live, li, gl);
      }
    }
    // the soft surface into every hypothesis
    trace_adj(T, C, G, live, r, S, sf, gCov, gTbar, gPbar, gNbar, gAlb, go,
              gd, gMint);
    if (live && s == 0 && (G.wrt & kWPar)) {
      clip_adj(T.par, o, d, gMint, go, gd, gp);
      camera_adj(T.par, D, col, row, samp, spp, go, gd, gp);
    }
    gO = go;
    gD = gd;
    gPW = gPW0;
    gTP = gTPc;
  }
}

// The block's rays (for_rays): each ray's adjoint adds into G and gp.
template <bool kRR, class Scr>
__device__ __forceinline__ void rays(const AdjParams& p, const Tables& T,
                                     const Cfg& C, const Grads& G, Scr& S,
                                     float (&gp)[kNPar]) {
  for_rays<kRR>(p, [&](const Draws& D, bool active, int rid_g, V3 g) {
    ray_adjoint<kRR, Scr>(T, C, D, active, rid_g, p.spp, p.width, p.bounces,
                          p.rr_start, p.normalize_emitter != 0, g, G, S, gp);
  });
}

template <bool kRR>
__global__ void __launch_bounds__(kBlock)
    pathtrace_bwd_soft_kernel(const __grid_constant__ AdjParams p) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const Tables T = stage_tables(smem, p.par, p.sph, p.n_sph, p.tri, p.n_tri,
                                p.mat, p.n_mat, p.lig, p.n_lig,
                                p.two_sided != 0);
  // one gradient buffer per warp, in the tables' layout
  const int n_tab = tables_floats(p.n_sph, p.n_tri, p.n_mat, p.n_lig);
  const int warps = (blockDim.x + 31) / 32;
  float* g_all = smem + n_tab;
  float* g_par = g_all + (threadIdx.x >> 5) * n_tab;
  Grads G;
  G.sph = g_par + kParPad;
  G.tri = G.sph + kSph * p.n_sph;
  G.mat = G.tri + kTri * p.n_tri;
  G.lig = G.mat + kMat * p.n_mat;
  G.wrt = p.wrt;
  zero(g_all, warps * n_tab);
  __syncthreads();

  Cfg C;
  C.ibw = 1.0f / p.bw;
  C.itau = 1.0f / p.tau;
  Scratch S;
  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  rays<kRR>(p, T, C, G, S, gp);
  if (p.wrt & kWPar) add_par(g_par, gp);
  __syncthreads();
  const int o_sph = kParPad, o_tri = o_sph + kSph * p.n_sph,
            o_mat = o_tri + kTri * p.n_tri, o_lig = o_mat + kMat * p.n_mat;
  if (p.wrt & kWPar) flush(p.dpar, g_all, kNPar, n_tab, warps);
  if (p.wrt & kWSph) flush(p.dsph, g_all + o_sph, kSph * p.n_sph, n_tab, warps);
  if (p.wrt & kWTri) flush(p.dtri, g_all + o_tri, kTri * p.n_tri, n_tab, warps);
  if (p.wrt & kWMat) flush(p.dmat, g_all + o_mat, kMat * p.n_mat, n_tab, warps);
  if (p.wrt & kWLig) flush(p.dlig, g_all + o_lig, kLig * p.n_lig, n_tab, warps);
}

// ---------------------------------------------------------------------------
// Past 64 objects per type (rt_pathtrace_bwd_soft_large), up to DIFF_TABLE_MAX
// = 4096 per type: JAX's two-level composite over every SOFT_CHUNK span
// (pathtrace_soft_adj.cuh, SpanScratch). Soft cotangents reach every live
// hypothesis on every segment, so the per-warp gradient buffers of the instance
// above (four copies of the tables) do not fit: the block keeps one buffer,
// which its warps add into atomically (wadd<true>), where the tables and it fit
// in kResidentBytes each (tables staged as above); past that the sphere and
// triangle tables are read from global memory (every lane of a warp reads the
// same row: one L1 line) and their cotangents are added into the global outputs
// (warp sums, one atomicAdd per word, row and warp), par, mat and lig staying
// in the block's buffer.
// ---------------------------------------------------------------------------

constexpr size_t kResidentBytes = 48 * 1024;  // sphere and triangle rows

struct LargeParams {
  AdjParams p;
  int resident;  // sphere and triangle tables and buffers in shared memory
};

template <bool kRR>
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
  Grads G;
  G.sph = q.resident ? g_par + kParPad : p.dsph;
  G.tri = q.resident ? g_par + kParPad + kSph * ns : p.dtri;
  G.mat = g_par + kParPad + kSph * ns + kTri * nt;
  G.lig = G.mat + kMat * p.n_mat;
  G.wrt = p.wrt;
  zero(g_par, n_tab);
  __syncthreads();

  Cfg C;
  C.ibw = 1.0f / p.bw;
  C.itau = 1.0f / p.tau;
  SpanScratch S;
  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  rays<kRR>(p, T, C, G, S, gp);
  if (p.wrt & kWPar) add_par(g_par, gp);
  __syncthreads();
  if (p.wrt & kWPar) flush(p.dpar, g_par, kNPar);
  if (q.resident && (p.wrt & kWSph)) flush(p.dsph, G.sph, kSph * ns);
  if (q.resident && (p.wrt & kWTri)) flush(p.dtri, G.tri, kTri * nt);
  if (p.wrt & kWMat) flush(p.dmat, G.mat, kMat * p.n_mat);
  if (p.wrt & kWLig) flush(p.dlig, G.lig, kLig * p.n_lig);
}
}  // namespace

// C interface (bound with ctypes). Adds the soft program's cotangents of
// one pass into dpar (26,), dsph (S, 8), dtri (T, 32), dmat (M, 4), dlig
// (L, 20), which the caller zeroes; `wrt` is a bit set of the groups (1 par,
// 2 sph, 4 tri, 8 mat, 16 lig); bw and tau the soft bandwidth and the depth
// order's temperature. Other arguments as rt_pathtrace_bwd. At most 64
// objects per type. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch.
extern "C" int rt_pathtrace_bwd_soft(
    const float* par, const float* sph, int n_sph, const float* tri,
    int n_tri, const float* mat, int n_mat, const float* lig, int n_lig,
    const float* g, int n_rays, int ray_offset, const float* u_planes,
    unsigned int k0, unsigned int k1, int spp, int width, int bounces, int rr,
    int rr_start_depth, int two_sided, int normalize_emitter, int wrt,
    float bw, float tau, float* dpar, float* dsph, float* dtri, float* dmat,
    float* dlig, void* stream) {
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      n_sph > kUnroll || n_tri > kUnroll || !(bw > 0.0f) || !(tau > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
  AdjParams p = adj_params(par, sph, n_sph, tri, n_tri, mat, n_mat, lig,
                           n_lig, g, n_rays, ray_offset, u_planes, k0, k1,
                           spp, width, bounces, rr_start_depth, two_sided,
                           normalize_emitter, wrt, dpar, dsph, dtri, dmat,
                           dlig);
  p.bw = bw;
  p.tau = tau;
  // the tables and one gradient buffer per warp
  const size_t smem = (1 + kBlock / 32) * sizeof(float) *
                      tables_floats(n_sph, n_tri, n_mat, n_lig);
  void (*kernel)(AdjParams) = rr ? pathtrace_bwd_soft_kernel<true>
                                  : pathtrace_bwd_soft_kernel<false>;
  int grid = 0;
  const cudaError_t err = fit_grid(kernel, kBlock, smem, n_rays, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// C interface past 64 objects per type: rt_pathtrace_bwd_soft's
// arguments, at most kMaxSpans spans of kSpan rows (64 of each type:
// DIFF_TABLE_MAX), the rows composited in the order given.
extern "C" int rt_pathtrace_bwd_soft_large(
    const float* par, const float* sph, int n_sph, const float* tri,
    int n_tri, const float* mat, int n_mat, const float* lig, int n_lig,
    const float* g, int n_rays, int ray_offset, const float* u_planes,
    unsigned int k0, unsigned int k1, int spp, int width, int bounces, int rr,
    int rr_start_depth, int two_sided, int normalize_emitter, int wrt,
    float bw, float tau, float* dpar, float* dsph, float* dtri, float* dmat,
    float* dlig, void* stream) {
  const int spans = (n_sph + kSpan - 1) / kSpan + (n_tri + kSpan - 1) / kSpan;
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      spans > kMaxSpans || !(bw > 0.0f) || !(tau > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
  LargeParams q;
  q.p = adj_params(par, sph, n_sph, tri, n_tri, mat, n_mat, lig, n_lig, g,
                   n_rays, ray_offset, u_planes, k0, k1, spp, width, bounces,
                   rr_start_depth, two_sided, normalize_emitter, wrt, dpar,
                   dsph, dtri, dmat, dlig);
  q.p.bw = bw;
  q.p.tau = tau;
  q.resident = sizeof(float) * (kSph * static_cast<size_t>(n_sph) +
                                kTri * static_cast<size_t>(n_tri)) <=
               kResidentBytes;
  // the staged tables and the block's gradient buffer in their layout
  const size_t smem =
      2 * sizeof(float) *
      tables_floats(q.resident ? n_sph : 0, q.resident ? n_tri : 0, n_mat,
                    n_lig);
  void (*kernel)(LargeParams) = rr ? pathtrace_bwd_soft_large_kernel<true>
                                    : pathtrace_bwd_soft_large_kernel<false>;
  int grid = 0;
  const cudaError_t err = fit_grid(kernel, kBlock, smem, n_rays, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}
