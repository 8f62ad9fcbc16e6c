// Kernel 2s past 64 objects per type (rt_pathtrace_bwd_soft_large): one
// thread per ray, kept because the group layout of
// pathtrace_soft_adj.cuh measured slower here at the main path's 1024^2
// (PERF.md §6, row 2s'). JAX's two-level composite over every SOFT_CHUNK
// span (soft_trace megakernel_grad.py:1883-1938) with each thread's span
// scratch in local memory; the hypotheses, the composite's scalar forward
// and adjoint, the lights and Cfg are pathtrace_soft_adj.cuh's.
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

// ---------------------------------------------------------------------------
// past kUnroll objects of a type (kernel 2s's large instance)
// ---------------------------------------------------------------------------
//
// JAX's two-level composite over every SOFT_CHUNK span (soft_trace
// megakernel_grad.py:1883-1938, _chunk_ranges :1838-1846): the sphere
// table's spans of kSpan rows, then the triangle table's, each in the
// order the rows are given (the caller hands triangles in Morton order,
// padded with zero rows, which are value-neutral: alpha 0). Each span
// composites locally (first_good 1e-9); each span's blend is then one
// hypothesis of the outer composite (alpha its clipped coverage, t its
// blended depth). The adjoint recomputes a span's hypotheses and local
// composite when the outer adjoint reaches it, as JAX's _make_ck
// checkpoint does, so a thread keeps one span's hypotheses and the spans'
// blends, not every hypothesis. The shadow transmittance is a product over
// every row, kept per span: a row's exclusive product is the other spans'
// (a suffix and a running prefix over spans) times its own span's
// exclusive product, so no factor is ever divided out. Row cotangents go
// into buffers other warps add into as well (wadd).


// The span kernel's per-thread scratch (local memory, 12.8 KB): one span's
// hypotheses (kSpan entries, reused span by span: a, t, tr and the
// adjoint's A, ga, gt, sf, sc); per span its raw coverage craw, clipped
// coverage ca, blended depth ct and fields cf, the outer composite's
// exclusive products ctr and its adjoint's sums (cA, cga, cgt, csf, csc),
// and the transmittance's span products vp and the shadow ray's length.
struct SpanScratch {
  float a[kSpan], t[kSpan], tr[kSpan];
  float A[kSpan], ga[kSpan], gt[kSpan], sf[kSpan], sc[kSpan];
  float craw[kMaxSpans], ca[kMaxSpans], ct[kMaxSpans], ctr[kMaxSpans];
  float cf[kMaxSpans][10];
  float cA[kMaxSpans], cga[kMaxSpans], cgt[kMaxSpans], csf[kMaxSpans],
      csc[kMaxSpans];
  float vp[kMaxSpans];
  float dist;  // the shadow ray's length (vis_fwd's)
};

// The soft surface for ray r over every span; fills the spans' blends.
__device__ void trace_fwd(const Tables& T, const Cfg& C, const SRay& r,
                          SpanScratch& S, Surf& sf) {
  const int nc = n_spans_of(T.n_sph, T.n_tri);
  for (int c = 0; c < nc; ++c) {
    int lo, hi;
    span_of(T, c, lo, hi);
    for (int i = 0; i < hi - lo; ++i)
      hyp_fwd<false>(T, C, lo + i, r, S.a[i], S.t[i], nullptr);
    auto fields = [&](int i, float* f) {
      float a, t;
      hyp_fwd<true>(T, C, lo + i, r, a, t, f);
    };
    float icov;
    bool good;
    comp_fwd(S.a, S.t, S.tr, 0, hi - lo, C.itau, 1e-9f, fields, S.craw[c],
             icov, good, S.cf[c]);
    S.ca[c] = clip01(S.craw[c]);
    S.ct[c] = S.cf[c][0];
  }
  auto chunk = [&](int c, float* f) {
    for (int k = 0; k < 10; ++k) f[k] = S.cf[c][k];
  };
  comp_fwd(S.ca, S.ct, S.ctr, 0, nc, C.itau, 1e-6f, chunk, sf.cov_raw,
           sf.icov, sf.good, sf.f);
  finish(sf);
}

// Adjoint of the two-level trace_fwd (after it, on the same scratch):
// the outer composite's adjoint, and each span's, recomputed, as the outer
// one reaches it. Warp-uniform.
__device__ void trace_adj(const Tables& T, const Cfg& C, const Grads& G,
                          bool live, const SRay& r, SpanScratch& S,
                          const Surf& sf, float gcov, float gtbar, V3 gpbar,
                          V3 gnbar, V3 galb, V3& go, V3& gd, float& gmint) {
  const V3 gnr = sf.goodn ? sf.ninv * (gnbar - dot(gnbar, sf.nbar) * sf.nbar)
                          : mk(0.0f, 0.0f, 0.0f);
  const float gb[10] = {gtbar,  gpbar.x, gpbar.y, gpbar.z, gnr.x,
                        gnr.y,  gnr.z,   galb.x,  galb.y,  galb.z};
  auto chunk = [&](int c, float* f) {
    for (int k = 0; k < 10; ++k) f[k] = S.cf[c][k];
  };
  // a span is a hypothesis of the outer composite: alpha its clipped
  // coverage, t and fields its blend
  auto span_adj = [&](int c, float ga, float gt, const float* gf) {
    float gbc[10];
    for (int k = 0; k < 10; ++k) gbc[k] = gf[k];
    gbc[0] += gt;
    int lo, hi;
    span_of(T, c, lo, hi);
    for (int i = 0; i < hi - lo; ++i)
      hyp_fwd<false>(T, C, lo + i, r, S.a[i], S.t[i], nullptr);
    auto fields = [&](int i, float* f) {
      float a, t;
      hyp_fwd<true>(T, C, lo + i, r, a, t, f);
    };
    auto obj_adj = [&](int i, float ga_i, float gt_i, const float* gf_i) {
      hyp_adj_warp<true>(T, C, G, live, lo + i, r, ga_i, gt_i, gf_i, go, gd,
                         gmint);
    };
    float craw, icov, blend[10];
    bool good;
    comp_fwd<false>(S.a, S.t, S.tr, 0, hi - lo, C.itau, 1e-9f, fields, craw,
                    icov, good, blend);
    comp_adj(S.a, S.t, S.tr, 0, hi - lo, C.itau, craw, icov, good, ga, gbc,
             fields, obj_adj, S.A, S.ga, S.gt, S.sf, S.sc);
  };
  comp_adj(S.ca, S.ct, S.ctr, 0, n_spans_of(T.n_sph, T.n_tri), C.itau, sf.cov_raw, sf.icov,
           sf.good, gcov, gb, chunk, span_adj, S.cA, S.cga, S.cgt, S.csf,
           S.csc);
}

// The shadow transmittance over every span; keeps each span's product.
__device__ float vis_fwd(const Tables& T, const Cfg& C, const SRay& r,
                         float dist, SpanScratch& S) {
  const int nc = n_spans_of(T.n_sph, T.n_tri);
  float vis = 1.0f;
  S.dist = dist;
  for (int c = 0; c < nc; ++c) {
    int lo, hi;
    span_of(T, c, lo, hi);
    float prod = 1.0f;
    for (int k = lo; k < hi; ++k) {
      float a, t;
      hyp_fwd<false>(T, C, k, r, a, t, nullptr);
      prod = prod * (1.0f - a * sigm((dist - t) * C.ibw));
    }
    S.vp[c] = prod;
    vis = vis * prod;
  }
  return vis;
}

// Adjoint of the spans' vis_fwd (after it, on the same scratch). Each
// span's occluders are recomputed into its scratch. Warp-uniform.
__device__ void vis_adj(const Tables& T, const Cfg& C, const Grads& G,
                        bool live, const SRay& r, float gvis, SpanScratch& S,
                        V3& go, V3& gd, float& gdist) {
  const int nc = n_spans_of(T.n_sph, T.n_tri);
  float run = 1.0f;
  for (int c = nc - 1; c >= 0; --c) {
    S.csf[c] = run;
    run = run * S.vp[c];
  }
  float pre = 1.0f, gmint = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const float other = pre * S.csf[c];  // the other spans' product
    pre = pre * S.vp[c];
    int lo, hi;
    span_of(T, c, lo, hi);
    const int w = hi - lo;
    for (int i = 0; i < w; ++i) {
      float a, t;
      hyp_fwd<false>(T, C, lo + i, r, a, t, nullptr);
      const float s = sigm((S.dist - t) * C.ibw);
      S.ga[i] = a;
      S.gt[i] = t;
      S.A[i] = s;
      S.sc[i] = a * s;
    }
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
      hyp_adj_warp<false>(T, C, G, live, lo + i, r, gin * s, -gx, nullptr,
                          go, gd, gmint);
    }
  }
}

}  // namespace span
}  // namespace soft
}  // namespace rt
