// Kernel 2s past 64 objects per type (rt_pathtrace_bwd_soft_large): one
// thread per ray, JAX's two-level composite over every SOFT_CHUNK span
// (soft_trace megakernel_grad.py:1883-1938, _chunk_ranges :1838-1846) and
// the per-span shadow product (soft_vis :1940), composited sparsely: the
// warp's 32 rays (consecutive ray ids) composite only the rows that are
// live for the warp. The hypotheses, the composite's scalar forward and
// adjoint, the lights and Cfg are pathtrace_soft_adj.cuh's.
//
// What is skipped, and why it is exact. A hypothesis's alpha is a product
// of factors: sigmoid(silhouette) * mask * sigmoid(depth past mint) (times
// the triangle's side). A row is dead for a ray when one of those factors
// is exactly 0 (the sigmoid 1 / (1 + exp(-x)) is exactly 0 below x =
// -88.72, i.e. a silhouette or depth coordinate below -88.72 bw), and dead
// for the warp when it is dead for every live ray of the warp. A dead
// row's alpha is exactly 0, so in the composite each factor 1 - a_j s_ij it
// puts on another row is exactly 1, its weight a_i tr_i and its blend
// terms are exactly 0, and in the adjoint every path out of it is
// multiplied by its zero factor (gs1 = ga msk s2 meets s1 (1 - s1) = 0 or
// msk s2 = 0, gs2 = ga (s1 msk) meets s1 msk = 0 or s2 (1 - s2) = 0, the
// blend's cotangent a_i tr_i / cov = 0): its row cotangents and what it
// adds to the ray's are exactly +-0. Dropping every factor of exactly 1,
// every addend of exactly +-0 and every zero row adjoint, the rows that
// stay kept in order, leaves each lane's products, sums and cotangents with
// the same bits as the dense composite (an accumulator that starts at +0
// never becomes -0, so adding +-0 never changes it), where every
// intermediate is finite. A row whose alpha is 0 only because the product
// of its nonzero factors underflowed stays live: its dense adjoint is
// denormal, not zero. A span with no live row has coverage exactly 0 for
// every live ray, so it is dead in the outer composite by the same rule;
// the zero padding rows of the Morton order (mask 0) are dead at their
// first word. Only the atomic order of the row sums changes.
//
// The pieces, per segment of a ray:
//   * the replay (trace_fwd) evaluates every row once (hyp_vote: the
//     factors in turn, each only while some live lane's product so far is
//     nonzero), ballots each row's liveness into the span's 64-bit mask,
//     keeps the live rows' alpha and t in slot order, composites each live
//     span over its slots and the live spans' blends as the outer
//     composite, and tapes the segment's surface (in the ray's tape), its
//     span masks (in the warp's words of shared memory) and each live
//     span's coverage, outer exclusive product and blend (SpanTape);
//   * the sweep reads the taped surface; trace_adj runs the outer
//     composite's adjoint over the taped live spans and, for each live
//     span, evaluates its live rows again (nothing else: no dense span),
//     composites them and runs their adjoint;
//   * a shadow ray (vis_fwd) evaluates every row once, multiplies only the
//     live rows' factors and keeps each live span's product and the masks;
//     vis_adj then walks the live rows only;
//   * row cotangents only for live rows (hyp_adj_warp: each row word summed
//     over the warp, added atomically where nonzero).
// Per-lane scratch sits in local memory at warp-uniform indices (one
// coalesced line per access); the warp-uniform masks and slot lists in
// shared memory (Warp).
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace_soft_adj.cuh"

namespace rt {
namespace soft {
namespace span {

// Adds v summed over the warp into *p, a word of a buffer that other warps
// add into too (the block's in shared memory, or the outputs in global
// memory): lane 0 adds atomically. All 32 lanes call.
__device__ __forceinline__ void wadd(float* p, float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0 && v != 0.0f) atomicAdd(p, v);
}

// hyp_adj (pathtrace_soft_adj.cuh) for the warp's lanes, each on its own
// ray with the same object k: every row word summed over the warp (zero
// where !live), the material row's too. Warp-uniform.
template <bool kFields>
__device__ void hyp_adj_warp(const Tables& T, const Cfg& C, const Grads& G,
                             bool live, int k, const SRay& r, float ga,
                             float gt, const float* gf, V3& go, V3& gd,
                             float& gmint) {
  auto add = [&](bool tri, int row, int w, float v) {
    wadd((tri ? G.tri + row * kTri : G.sph + row * kSph) + w,
         live ? v : 0.0f);
  };
  float gm[3];
  hyp_adj<kFields>(T, C, G.wrt, add, k, r, ga, gt, gf, go, gd, gmint, gm);
  if (kFields && (G.wrt & kWMat)) {
    const int mr = mat_row(T, k < T.n_sph ? T.sph[k * kSph + 4]
                                          : T.tri[(k - T.n_sph) * kTri + 16]);
    if (mr >= 0)  // uniform: the object's material
      for (int w = 0; w < 3; ++w)
        wadd(G.mat + mr * kMat + w, live ? gm[w] : 0.0f);
  }
}

// hyp_fwd<false>'s alpha and t of object k for ray r, and whether the row
// is live for the warp: some lane whose ray is live (`live`) has no factor
// of alpha exactly 0. A factor is evaluated only while some live lane's
// product so far is nonzero, so a row that is dead for the warp costs its
// first factors only (its a is then 0). Warp-uniform.
__device__ __forceinline__ bool hyp_vote(const Tables& T, const Cfg& C,
                                         int k, const SRay& r, bool live,
                                         float& a, float& t) {
  return hyp_fwd<false>(T, C, k, r, a, t, nullptr, [live](bool p) {
    return __any_sync(kFull, live && p) != 0;
  });
}

// The span kernel's per-thread scratch (local memory, indexed by
// warp-uniform slots): one span's live rows (a, t, tr and the adjoint's A,
// ga, gt, sf, sc; the shadow adjoint's a, t, s, a s and suffix in ga, gt,
// A, sc, sf); per live span of the segment its clipped coverage ca,
// blended depth ct and fields cf, the outer composite's exclusive products
// ctr and its adjoint's sums (cA, cga, cgt, csf, csc); a shadow ray's
// live span products in cA and their suffix in csf (the outer adjoint
// holds them only inside trace_adj, which never meets a shadow ray's
// pair), and the shadow ray's length.
struct SpanScratch {
  float a[kSpan], t[kSpan], tr[kSpan];
  float A[kSpan], ga[kSpan], gt[kSpan], sf[kSpan], sc[kSpan];
  float ca[kMaxSpans], ct[kMaxSpans], ctr[kMaxSpans];
  float cf[kMaxSpans][10];
  float cA[kMaxSpans], cga[kMaxSpans], cgt[kMaxSpans], csf[kMaxSpans],
      csc[kMaxSpans];
  float dist;  // the shadow ray's length (vis_fwd's)
};

// A warp's words in the block's shared memory, warp-uniform values that
// lane 0 writes (a __syncwarp before another lane reads them): per segment
// the mask of every span (bit i: row lo + i live), the current shadow
// ray's masks, the current span's live rows in slot order and the current
// segment's live spans in slot order.
struct Warp {
  uint64_t* seg;   // [nseg][nc]
  uint64_t* vis;   // [nc]
  uint8_t* rows;   // [kSpan]
  uint8_t* spans;  // [kMaxSpans]
  int nc;
};

// The bytes of a warp's words for nseg segments and nc spans, a multiple
// of 16.
__host__ __device__ inline int warp_bytes(int nseg, int nc) {
  const int b = 8 * (nseg + 1) * nc + kSpan + kMaxSpans;
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ Warp warp_at(uint8_t* base, int nseg, int nc) {
  Warp W;
  W.seg = reinterpret_cast<uint64_t*>(base);
  W.vis = W.seg + nseg * nc;
  W.rows = reinterpret_cast<uint8_t*>(W.vis + nc);
  W.spans = W.rows + kSpan;
  W.nc = nc;
  return W;
}

__device__ __forceinline__ bool lane0() { return (threadIdx.x & 31) == 0; }

// A segment's live spans on the tape, per lane: for live span slot j the
// outer composite's inputs, its clipped coverage ca, its exclusive product
// ctr and its blend cf (10), in global memory that the caller allocates
// (each word of a slot `stride` floats from the next: the launched
// threads', so a warp's 32 words are one line). The replay writes them,
// the sweep reads them instead of compositing every live span again.
constexpr int kSpanWords = 12;
struct SpanTape {
  float* p;  // this thread's words of this segment
  size_t stride;
  __device__ __forceinline__ float& at(int j, int k) const {
    return p[static_cast<size_t>(j * kSpanWords + k) * stride];
  }
};

// The live rows of mask mk of the span starting at row lo again (every
// lane evaluates each; the row is live for the warp): alpha and t into
// S.a, S.t in slot order, the rows into W.rows; returns their count.
// Warp-uniform.
__device__ __forceinline__ int load_live(const Tables& T, const Cfg& C,
                                         const SRay& r, int lo, uint64_t mk,
                                         SpanScratch& S, const Warp& W) {
  __syncwarp();  // every lane is done with the previous span's rows
  int n = 0;
  for (uint64_t b = mk; b != 0; b &= b - 1) {
    const int i = __ffsll(static_cast<long long>(b)) - 1;
    hyp_fwd<false>(T, C, lo + i, r, S.a[n], S.t[n], nullptr);
    if (lane0()) W.rows[n] = static_cast<uint8_t>(i);
    ++n;
  }
  __syncwarp();
  return n;
}

// The soft surface for ray r over every span, only the rows and spans live
// for the warp composited; the span masks into masks[] (lane 0) and the
// live spans' words onto tp. `live`: this lane's ray is live (its votes
// count). Warp-uniform.
__device__ void trace_fwd(const Tables& T, const Cfg& C, const SRay& r,
                          bool live, SpanScratch& S, const Warp& W,
                          uint64_t* masks, const SpanTape& tp, Surf& sf) {
  int m = 0;  // live spans
  for (int c = 0; c < W.nc; ++c) {
    int lo, hi;
    span_of(T, c, lo, hi);
    __syncwarp();
    uint64_t mk = 0;
    int n = 0;
    for (int i = 0; i < hi - lo; ++i) {
      float a, t;
      if (hyp_vote(T, C, lo + i, r, live, a, t)) {
        S.a[n] = a;
        S.t[n] = t;
        if (lane0()) W.rows[n] = static_cast<uint8_t>(i);
        ++n;
        mk |= 1ull << i;
      }
    }
    if (lane0()) masks[c] = mk;
    __syncwarp();
    if (n == 0) continue;
    auto fields = [&](int j, float* f) {
      float a, t;
      hyp_fwd<true>(T, C, lo + W.rows[j], r, a, t, f);
    };
    float craw, icov;
    bool good;
    comp_fwd(S.a, S.t, S.tr, 0, n, C.itau, 1e-9f, fields, craw, icov, good,
             S.cf[m]);
    S.ca[m] = clip01(craw);
    S.ct[m] = S.cf[m][0];
    ++m;
  }
  auto chunk = [&](int j, float* f) {
    for (int k = 0; k < 10; ++k) f[k] = S.cf[j][k];
  };
  comp_fwd(S.ca, S.ct, S.ctr, 0, m, C.itau, 1e-6f, chunk, sf.cov_raw,
           sf.icov, sf.good, sf.f);
  for (int j = 0; j < m; ++j) {
    tp.at(j, 0) = S.ca[j];
    tp.at(j, 1) = S.ctr[j];
#pragma unroll
    for (int k = 0; k < 10; ++k) tp.at(j, 2 + k) = S.cf[j][k];
  }
  finish(sf);
}

// Adjoint of trace_fwd for the segment whose span masks are masks[] and
// live spans' words tp (its surface sf, from the tape): the outer
// composite's adjoint over the taped live spans, and each live span's,
// its live rows evaluated and composited again, their adjoints.
// Warp-uniform.
__device__ void trace_adj(const Tables& T, const Cfg& C, const Grads& G,
                          bool live, const SRay& r, SpanScratch& S,
                          const Warp& W, const uint64_t* masks,
                          const SpanTape& tp, const Surf& sf, float gcov,
                          float gtbar, V3 gpbar, V3 gnbar, V3 galb, V3& go,
                          V3& gd, float& gmint) {
  const V3 gnr = sf.goodn ? sf.ninv * (gnbar - dot(gnbar, sf.nbar) * sf.nbar)
                          : mk(0.0f, 0.0f, 0.0f);
  const float gb[10] = {gtbar,  gpbar.x, gpbar.y, gpbar.z, gnr.x,
                        gnr.y,  gnr.z,   galb.x,  galb.y,  galb.z};
  auto fields_at = [&](int lo) {
    return [&, lo](int j, float* f) {
      float a, t;
      hyp_fwd<true>(T, C, lo + W.rows[j], r, a, t, f);
    };
  };
  // the live spans as the replay composited them, from the tape
  __syncwarp();  // every lane is done with the last segment's spans
  int m = 0;
  for (int c = 0; c < W.nc; ++c) {
    if (masks[c] == 0) continue;
    if (lane0()) W.spans[m] = static_cast<uint8_t>(c);
    S.ca[m] = tp.at(m, 0);
    S.ctr[m] = tp.at(m, 1);
#pragma unroll
    for (int k = 0; k < 10; ++k) S.cf[m][k] = tp.at(m, 2 + k);
    S.ct[m] = S.cf[m][0];
    ++m;
  }
  __syncwarp();
  auto chunk = [&](int j, float* f) {
    for (int k = 0; k < 10; ++k) f[k] = S.cf[j][k];
  };
  // a span is a hypothesis of the outer composite: alpha its clipped
  // coverage, t and fields its blend
  auto span_adj = [&](int j, float ga, float gt, const float* gf) {
    float gbc[10];
    for (int k = 0; k < 10; ++k) gbc[k] = gf[k];
    gbc[0] += gt;
    const int c = W.spans[j];
    int lo, hi;
    span_of(T, c, lo, hi);
    const int n = load_live(T, C, r, lo, masks[c], S, W);
    auto obj_adj = [&](int i, float ga_i, float gt_i, const float* gf_i) {
      hyp_adj_warp<true>(T, C, G, live, lo + W.rows[i], r, ga_i, gt_i, gf_i,
                         go, gd, gmint);
    };
    float craw, icov, blend[10];
    bool good;
    comp_fwd<false>(S.a, S.t, S.tr, 0, n, C.itau, 1e-9f, fields_at(lo), craw,
                    icov, good, blend);
    comp_adj(S.a, S.t, S.tr, 0, n, C.itau, craw, icov, good, ga, gbc,
             fields_at(lo), obj_adj, S.A, S.ga, S.gt, S.sf, S.sc);
  };
  comp_adj(S.ca, S.ct, S.ctr, 0, m, C.itau, sf.cov_raw, sf.icov, sf.good,
           gcov, gb, chunk, span_adj, S.cA, S.cga, S.cgt, S.csf, S.csc);
}

// The shadow transmittance over every span, only the rows live for the
// warp multiplied in (a dead row's factor is exactly 1); keeps each live
// span's product and the spans' masks. Warp-uniform.
__device__ float vis_fwd(const Tables& T, const Cfg& C, const SRay& r,
                         float dist, bool live, SpanScratch& S,
                         const Warp& W) {
  __syncwarp();  // every lane is done with the last shadow ray's masks
  float vis = 1.0f;
  S.dist = dist;
  int m = 0;
  for (int c = 0; c < W.nc; ++c) {
    int lo, hi;
    span_of(T, c, lo, hi);
    uint64_t mk = 0;
    float prod = 1.0f;
    for (int i = 0; i < hi - lo; ++i) {
      float a, t;
      if (hyp_vote(T, C, lo + i, r, live, a, t)) {
        prod = prod * (1.0f - a * sigm((dist - t) * C.ibw));
        mk |= 1ull << i;
      }
    }
    if (lane0()) W.vis[c] = mk;
    if (mk == 0) continue;
    S.cA[m++] = prod;
    vis = vis * prod;
  }
  __syncwarp();
  return vis;
}

// Adjoint of vis_fwd (after it, on the same scratch and masks): each live
// span's live rows again, their exclusive products (the other live spans'
// product, a suffix and a running prefix over the span's live rows: no
// factor is ever divided out) and their adjoints. Warp-uniform.
__device__ void vis_adj(const Tables& T, const Cfg& C, const Grads& G,
                        bool live, const SRay& r, float gvis, SpanScratch& S,
                        const Warp& W, V3& go, V3& gd, float& gdist) {
  int m = 0;
  for (int c = 0; c < W.nc; ++c) m += W.vis[c] != 0 ? 1 : 0;
  float run = 1.0f;
  for (int j = m - 1; j >= 0; --j) {
    S.csf[j] = run;
    run = run * S.cA[j];
  }
  float pre = 1.0f, gmint = 0.0f;
  int j = 0;
  for (int c = 0; c < W.nc; ++c) {
    const uint64_t mk = W.vis[c];
    if (mk == 0) continue;
    const float other = pre * S.csf[j];  // the other spans' product
    pre = pre * S.cA[j];
    ++j;
    int lo, hi;
    span_of(T, c, lo, hi);
    __syncwarp();
    int w = 0;
    for (uint64_t b = mk; b != 0; b &= b - 1) {
      const int i = __ffsll(static_cast<long long>(b)) - 1;
      float a, t;
      hyp_fwd<false>(T, C, lo + i, r, a, t, nullptr);
      const float s = sigm((S.dist - t) * C.ibw);
      S.ga[w] = a;
      S.gt[w] = t;
      S.A[w] = s;
      S.sc[w] = a * s;
      if (lane0()) W.rows[w] = static_cast<uint8_t>(i);
      ++w;
    }
    __syncwarp();
    float srun = 1.0f;
    for (int i = w - 1; i >= 0; --i) {
      S.sf[i] = srun;
      srun = srun * (1.0f - S.sc[i]);
    }
    float spre = 1.0f;
    for (int i = 0; i < w; ++i) {
      const float gin = -gvis * (other * (spre * S.sf[i]));
      spre = spre * (1.0f - S.sc[i]);
      const float s = S.A[i];
      const float gx = gin * S.ga[i] * s * (1.0f - s) * C.ibw;
      gdist += gx;
      hyp_adj_warp<false>(T, C, G, live, lo + W.rows[i], r, gin * s, -gx,
                          nullptr, go, gd, gmint);
    }
  }
}

}  // namespace span
}  // namespace soft
}  // namespace rt
