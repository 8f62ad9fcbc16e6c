// The soft (edge-aware) pass and its hand-written adjoint, for kernel 2s
// (megakernel_soft.cu): the counterpart of _tile_program_soft
// (raytracing_tpu/ops/pallas/megakernel_grad.py:1516-2144), path mode.
// The plain version is ops/megakernel_soft.py; the arithmetic below follows
// it operation for operation (built with --fmad=false, as kernels 2 and 3).
//
// The pieces, each with its forward and its adjoint:
//   * a hypothesis: one object's soft coverage alpha and depth t for a ray
//     (sphere: sigmoid of the discriminant; triangle: sigmoid of the
//     barycentric margin; both times a sigmoid of t past the window's
//     start), and its fields (t, hit point, normal, albedo);
//   * the composite: w_i = alpha_i prod_{j != i} (1 - alpha_j s_ij),
//     s_ij = sigmoid((t_i - t_j) / tau), cov = clip(sum w_i, 0, 1), the
//     fields blended by w_i / cov where cov > first_good. Its adjoint never
//     divides by (1 - alpha_j s_ij), which is 0 behind a near, fully covering
//     surface: the exclusive products prod_{k != i, j} come from a suffix
//     pass and a running prefix over j, O(N) per i as the forward. Past
//     kUnroll hypotheses the spheres and the triangles each composite as one
//     chunk (first_good 1e-9) and the two chunks' blends composite again;
//     past kUnroll objects of a type, every kSpan span of a type does
//     (SpanScratch, the large instance's section at the end);
//   * the shadow transmittance vis = prod_k (1 - alpha_k sigmoid((dist -
//     t_k) / bw)) and its adjoint, by the same exclusive products;
//   * the emitter race of the primary segment, NEE per light, and the
//     bounce from the blended surface.
// The gradient of JAX's jnp.maximum / jnp.minimum / jnp.clip splits at a tie
// (hmax, hmin, clip01_d); the guards are the forward's double wheres.
//
// Row cotangents are dense: every hypothesis adds into its object's row on
// every segment. All lanes of a warp walk the same objects in the same order
// (the soft program has no early exit, so the sweep is converged by
// construction), and each row word is summed over the warp by a shuffle
// butterfly and added by lane 0 (wadd) into its warp's own gradient buffer,
// a plain add with no atomic (shared-memory float atomics are
// compare-and-swap loops on this card, PR 5's finding for kernel 2); the
// block sums its warps' buffers once at the end (the large instance: one
// buffer per block or the outputs, added into atomically). A lane without
// a live segment takes part with its adds masked to zero.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace_adj.cuh"

namespace rt {
namespace soft {

constexpr int kUnroll = 64;            // JAX's UNROLL_OBJECTS (and SOFT_CHUNK)
constexpr int kMaxHyp = 2 * kUnroll;   // at most kUnroll per type

// The reciprocals of the bandwidth and of the depth order's temperature:
// a sigmoid's argument is x * (1 / bw), not x / bw (one IEEE division
// fewer per sigmoid; the plain version computes it the same way, so the
// two take the same branch where a ray sits at a tie).
struct Cfg {
  float ibw, itau;
};

// 1 / (1 + exp(-x)): 0 at x -> -inf, 1 at x -> +inf, never NaN
__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}
// d max(a, b) / da and d min(a, b) / da, half at a tie (JAX's rule)
__device__ __forceinline__ float hmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float hmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
// jnp.clip(x, 0, 1) = min(1, max(0, x)) and its derivative
__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float clip01_d(float x) {
  return hmax(x, 0.0f) * hmin(fmaxf(x, 0.0f), 1.0f);
}

// Adds v summed over the warp into *p, a word of the warp's own gradient
// buffer (lane 0 adds, no other lane or warp writes it; all 32 lanes call).
// kAtomic: a buffer that other warps add into too (a block's in shared
// memory, or the outputs in global memory), so lane 0 adds atomically.
template <bool kAtomic = false>
__device__ __forceinline__ void wadd(float* p, float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0 && v != 0.0f) {
    if (kAtomic)
      atomicAdd(p, v);
    else
      *p += v;
  }
}

// One segment's rays.
struct SRay {
  V3 o, d, oxd;
  float mint;
};
__device__ __forceinline__ SRay sray(V3 o, V3 d, float mint) {
  SRay r;
  r.o = o;
  r.d = d;
  r.oxd = cross(o, d);
  r.mint = mint;
  return r;
}

// Material row of a float id, or -1 when it names no row (JAX's mat_rgb).
__device__ __forceinline__ int mat_row(const Tables& T, float mf) {
  if (!(mf >= 0.0f && mf < static_cast<float>(T.n_mat))) return -1;
  const int m = static_cast<int>(mf);
  return static_cast<float>(m) == mf ? m : -1;
}

// Per-thread scratch of one segment, indexed by hypothesis (objects:
// spheres, then triangles): the composite's alpha, t and exclusive
// products (trans), then the adjoint's per-hypothesis sums; the shadow
// transmittance reuses the adjoint's arrays while it runs. It lives in
// local memory (4 KB a thread); a scene uses the first n_sph + n_tri words
// of each array. A 16-entry instance for small scenes took as long on
// cornell's 1024^2 b5 step cotangent (profile_kernels in turns on an
// NVIDIA H100 80GB HBM3 at 700 W: 39.2-40.4 ms against 40.2-40.4 ms for
// this one): local memory interleaves a word across a warp's lanes, so the
// lines a scene touches are the same.
struct Scratch {
  static constexpr bool kAtomic = false;  // adds into per-warp buffers
  float a[kMaxHyp], t[kMaxHyp], tr[kMaxHyp];
  float A[kMaxHyp], ga[kMaxHyp], gt[kMaxHyp], sf[kMaxHyp], sc[kMaxHyp];
};

// ---------------------------------------------------------------------------
// hypotheses
// ---------------------------------------------------------------------------

// alpha and t of object k for ray r; with f (10 floats) also its fields
// (t, hit point, normal, albedo).
template <bool kFields>
__device__ __forceinline__ void hyp_fwd(const Tables& T, const Cfg& C, int k,
                                        const SRay& r, float& a, float& t,
                                        float* f) {
  float mf;
  V3 n;
  if (k < T.n_sph) {
    const float* s = T.sph + k * kSph;
    const V3 c = ld3(s);
    const float rad = s[3];
    const V3 m = r.o - c;
    const float b = dot(m, r.d);
    const float cq = dot(m, m) - rad * rad;
    const float dis = b * b - cq;
    const float msk = s[5] > 0.0f ? 1.0f : 0.0f;
    const float sq = dis > 0.0f ? sqrtf(dis) : 0.0f;
    t = -b - sq;
    a = sigm(dis * C.ibw) * msk * sigm((t - r.mint) * C.ibw);
    if (!kFields) return;
    n = normalize(r.o + t * r.d - c);
    mf = s[4];
  } else {
    const float* q = T.tri + (k - T.n_sph) * kTri;
    const V3 ng = ld3(q);
    const float div = dot(ng, r.d);
    const bool side = T.two_sided ? div != 0.0f : div > 0.0f;
    const float idiv = 1.0f / (div == 0.0f ? 1.0f : div);
    const float beta = (dot(ld3(q + 12), r.oxd) - dot(ld3(q + 6), r.d)) * idiv;
    const float gamma = (dot(ld3(q + 3), r.d) - dot(ld3(q + 9), r.oxd)) * idiv;
    t = side ? (q[15] - dot(ng, r.o)) * idiv : 1e6f;
    const float w3 = 1.0f - beta - gamma;
    const float margin = fminf(fminf(beta, gamma), w3);
    a = sigm(margin * C.ibw) * (q[17] > 0.0f ? 1.0f : 0.0f) *
        (side ? 1.0f : 0.0f) * sigm((t - r.mint) * C.ibw);
    if (!kFields) return;
    n = normalize(clip01(w3) * ld3(q + 18) + clip01(beta) * ld3(q + 21) +
                  clip01(gamma) * ld3(q + 24));
    mf = q[16];
  }
  const V3 p = r.o + t * r.d;
  const int m = mat_row(T, mf);
  const V3 al = m >= 0 ? ld3(T.mat + m * kMat) : mk(0.0f, 0.0f, 0.0f);
  f[0] = t;
  f[1] = p.x;
  f[2] = p.y;
  f[3] = p.z;
  f[4] = n.x;
  f[5] = n.y;
  f[6] = n.z;
  f[7] = al.x;
  f[8] = al.y;
  f[9] = al.z;
}

// Adjoint of hyp_fwd for object k: from the cotangents ga (alpha), gt (t)
// and, with kFields, gf (the 10 fields) to those of the ray (go, gd,
// gmint) and of the object's rows (added warp-wide, zero where !live).
// Warp-uniform: every lane calls it with the same k.
template <bool kFields, bool kAtomic = false>
__device__ void hyp_adj(const Tables& T, const Cfg& C, const Grads& G,
                        bool live, int k, const SRay& r, float ga, float gt,
                        const float* gf, V3& go, V3& gd, float& gmint) {
  const float ibw = C.ibw;
  const V3 o = r.o, d = r.d;
  if (k < T.n_sph) {
    const float* s = T.sph + k * kSph;
    const V3 c = ld3(s);
    const float rad = s[3];
    const V3 m = o - c;
    const float b = dot(m, d);
    const float cq = dot(m, m) - rad * rad;
    const float dis = b * b - cq;
    const float msk = s[5] > 0.0f ? 1.0f : 0.0f;
    const float s1 = sigm(dis * ibw);
    const float sq = dis > 0.0f ? sqrtf(dis) : 0.0f;
    const float t = -b - sq;
    const float s2 = sigm((t - r.mint) * ibw);
    float gT = gt;
    V3 gO = mk(0.0f, 0.0f, 0.0f), gD = gO, gC = gO;
    if (kFields) {
      gT += gf[0];
      const V3 nr = o + t * d - c;
      V3 gp = mk(gf[1], gf[2], gf[3]);
      const V3 gnr = normalize_adj(nr, mk(gf[4], gf[5], gf[6]));
      gp = gp + gnr;
      gC = gC - gnr;
      gO = gO + gp;
      gD = gD + t * gp;
      gT += dot(gp, d);
      if (G.wrt & kWMat) {
        const int mr = mat_row(T, s[4]);
        if (mr >= 0)  // uniform: the object's material
          for (int w = 0; w < 3; ++w)
            wadd<kAtomic>(G.mat + mr * kMat + w, live ? gf[7 + w] : 0.0f);
      }
    }
    const float gs1 = ga * msk * s2;
    const float gs2 = ga * (s1 * msk);
    const float gx2 = gs2 * s2 * (1.0f - s2) * ibw;
    gT += gx2;
    gmint -= gx2;
    float gb = -gT;
    float gdis = dis > 0.0f ? -gT * 0.5f / sq : 0.0f;
    gdis += gs1 * s1 * (1.0f - s1) * ibw;
    gb += 2.0f * b * gdis;
    const float gcq = -gdis;
    const V3 gm = (2.0f * gcq) * m + gb * d;
    gD = gD + gb * m;
    gO = gO + gm;
    gC = gC - gm;
    go = go + gO;
    gd = gd + gD;
    if (G.wrt & kWSph) {
      float* row = G.sph + k * kSph;
      wadd<kAtomic>(row + 0, live ? gC.x : 0.0f);
      wadd<kAtomic>(row + 1, live ? gC.y : 0.0f);
      wadd<kAtomic>(row + 2, live ? gC.z : 0.0f);
      wadd<kAtomic>(row + 3, live ? -2.0f * rad * gcq : 0.0f);
    }
    return;
  }
  const int j = k - T.n_sph;
  const float* q = T.tri + j * kTri;
  const V3 ng = ld3(q), c1 = ld3(q + 3), c2 = ld3(q + 6), e1 = ld3(q + 9),
           e2 = ld3(q + 12);
  const float div = dot(ng, d);
  const bool side = T.two_sided ? div != 0.0f : div > 0.0f;
  const float idiv = 1.0f / (div == 0.0f ? 1.0f : div);
  const float nb = dot(e2, r.oxd) - dot(c2, d);
  const float ngm = dot(c1, d) - dot(e1, r.oxd);
  const float nt = q[15] - dot(ng, o);
  const float beta = nb * idiv, gamma = ngm * idiv;
  const float t = side ? nt * idiv : 1e6f;
  const float w3 = 1.0f - beta - gamma;
  const float m1 = fminf(beta, gamma);
  const float margin = fminf(m1, w3);
  const float msk = q[17] > 0.0f ? 1.0f : 0.0f;
  const float sd = side ? 1.0f : 0.0f;
  const float s1 = sigm(margin * ibw);
  const float s2 = sigm((t - r.mint) * ibw);
  float gT = gt, gbeta = 0.0f, ggamma = 0.0f, gw3 = 0.0f;
  V3 gO = mk(0.0f, 0.0f, 0.0f), gD = gO;
  float vn[9] = {};
  if (kFields) {
    gT += gf[0];
    const V3 v0 = ld3(q + 18), v1 = ld3(q + 21), v2 = ld3(q + 24);
    const float al = clip01(w3), be = clip01(beta), gm = clip01(gamma);
    const V3 nr = al * v0 + be * v1 + gm * v2;
    const V3 gnr = normalize_adj(nr, mk(gf[4], gf[5], gf[6]));
    const V3 g0 = al * gnr, g1 = be * gnr, g2 = gm * gnr;
    vn[0] = g0.x; vn[1] = g0.y; vn[2] = g0.z;
    vn[3] = g1.x; vn[4] = g1.y; vn[5] = g1.z;
    vn[6] = g2.x; vn[7] = g2.y; vn[8] = g2.z;
    gw3 = dot(gnr, v0) * clip01_d(w3);
    gbeta = dot(gnr, v1) * clip01_d(beta);
    ggamma = dot(gnr, v2) * clip01_d(gamma);
    const V3 gp = mk(gf[1], gf[2], gf[3]);
    gO = gO + gp;
    gD = gD + t * gp;
    gT += dot(gp, d);
    if (G.wrt & kWMat) {
      const int mr = mat_row(T, q[16]);
      if (mr >= 0)
        for (int w = 0; w < 3; ++w)
          wadd<kAtomic>(G.mat + mr * kMat + w, live ? gf[7 + w] : 0.0f);
    }
  }
  const float gs1 = ga * msk * sd * s2;
  const float gs2 = ga * (s1 * msk * sd);
  const float gx2 = gs2 * s2 * (1.0f - s2) * ibw;
  gT += gx2;
  gmint -= gx2;
  const float gmargin = gs1 * s1 * (1.0f - s1) * ibw;
  const float gm1 = gmargin * hmin(m1, w3);
  gw3 += gmargin * hmin(w3, m1);
  gbeta += gm1 * hmin(beta, gamma) - gw3;
  ggamma += gm1 * hmin(gamma, beta) - gw3;
  const float gtr = side ? gT : 0.0f;
  const float gidiv = gbeta * nb + ggamma * ngm + gtr * nt;
  const float gnb = gbeta * idiv, gng = ggamma * idiv, gnt = gtr * idiv;
  const float gdiv = div != 0.0f ? -gidiv * idiv * idiv : 0.0f;
  const V3 goxd = gnb * e2 - gng * e1;
  gD = gD + gdiv * ng - gnb * c2 + gng * c1 + cross(goxd, o);
  gO = gO - gnt * ng + cross(d, goxd);
  go = go + gO;
  gd = gd + gD;
  if (G.wrt & kWTri) {
    const V3 v3[5] = {gdiv * d - gnt * o, gng * d, -gnb * d, -gng * r.oxd,
                      gnb * r.oxd};
    float* row = G.tri + j * kTri;
#pragma unroll
    for (int w = 0; w < 5; ++w) {  // n_geo, c1, c2, e1, e2
      wadd<kAtomic>(row + 3 * w, live ? v3[w].x : 0.0f);
      wadd<kAtomic>(row + 3 * w + 1, live ? v3[w].y : 0.0f);
      wadd<kAtomic>(row + 3 * w + 2, live ? v3[w].z : 0.0f);
    }
    wadd<kAtomic>(row + 15, live ? gnt : 0.0f);  // k
    if (kFields)
      for (int w = 0; w < 9; ++w) wadd<kAtomic>(row + 18 + w, live ? vn[w] : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// the composite
// ---------------------------------------------------------------------------

// Composite of hypotheses [lo, hi) with alpha a[] and t t[]: fills tr[]
// (each w_i / alpha_i) and returns the raw coverage, 1 / cov, the guard
// and the blend of the fields fields(i, f).
template <bool kBlend = true, class Fields>
__device__ __forceinline__ void comp_fwd(const float* a, const float* t,
                                         float* tr, int lo, int hi,
                                         float itau, float first_good,
                                         Fields fields, float& cov_raw,
                                         float& icov, bool& good,
                                         float (&blend)[10]) {
  cov_raw = 0.0f;
  for (int i = lo; i < hi; ++i) {
    float trans = 1.0f;
    for (int j = lo; j < hi; ++j)
      if (j != i) trans = trans * (1.0f - a[j] * sigm((t[i] - t[j]) * itau));
    tr[i] = trans;
    cov_raw = cov_raw + a[i] * trans;
  }
  const float cov = clip01(cov_raw);
  good = cov > first_good;
  icov = 1.0f / (good ? cov : 1.0f);
#pragma unroll
  for (int k = 0; k < 10; ++k) blend[k] = 0.0f;
  if (!kBlend || !good) return;
  for (int i = lo; i < hi; ++i) {
    const float wn = a[i] * tr[i] * icov;
    float f[10];
    fields(i, f);
#pragma unroll
    for (int k = 0; k < 10; ++k) blend[k] = blend[k] + wn * f[k];
  }
}

// Adjoint of comp_fwd: from the cotangents of the clipped coverage (gcov)
// and of the blend (gb) to each hypothesis's alpha, t and fields, handed to
// adj(i, ga_i, gt_i, gf_i) in order (warp-uniform). A, ga, gt, sf and sc
// are scratch indexed like a[].
template <class Fields, class Adj>
__device__ void comp_adj(const float* a, const float* t, const float* tr,
                         int lo, int hi, float itau, float cov_raw, float icov,
                         bool good, float gcov, const float (&gb)[10],
                         Fields fields, Adj adj, float* A, float* ga,
                         float* gt, float* sf, float* sc) {
  // the blend: A_i = gb . f_i, and through 1 / cov
  float gicov = 0.0f;
  for (int i = lo; i < hi; ++i) {
    float Ai = 0.0f;
    if (good) {
      float f[10];
      fields(i, f);
#pragma unroll
      for (int k = 0; k < 10; ++k) Ai += gb[k] * f[k];
      gicov += Ai * (a[i] * tr[i]);
    }
    A[i] = Ai;
    ga[i] = 0.0f;
    gt[i] = 0.0f;
  }
  if (good) gcov -= gicov * icov * icov;
  const float gcr = gcov * clip01_d(cov_raw);
  // w_i = a_i tr_i, tr_i = prod_{j != i} (1 - a_j s_ij)
  for (int i = lo; i < hi; ++i) {
    const float gw = (good ? A[i] * icov : 0.0f) + gcr;
    ga[i] += gw * tr[i];
    const float gtr = gw * a[i];
    if (gtr == 0.0f) continue;
    // suffix products over j > k (k != i), with s_ij kept in sc[]
    float run = 1.0f;
    for (int j = hi - 1; j >= lo; --j) {
      sf[j] = run;
      if (j == i) continue;
      sc[j] = sigm((t[i] - t[j]) * itau);
      run = run * (1.0f - a[j] * sc[j]);
    }
    float pre = 1.0f;
    for (int j = lo; j < hi; ++j) {
      if (j == i) continue;
      const float go_ij = -gtr * (pre * sf[j]);
      ga[j] += go_ij * sc[j];
      const float gx = go_ij * a[j] * sc[j] * (1.0f - sc[j]) * itau;
      gt[i] += gx;
      gt[j] -= gx;
      pre = pre * (1.0f - a[j] * sc[j]);
    }
  }
  for (int i = lo; i < hi; ++i) {
    const float wn = good ? a[i] * tr[i] * icov : 0.0f;
    float gf[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) gf[k] = gb[k] * wn;
    adj(i, ga[i], gt[i], gf);
  }
}

// The soft surface of one segment: JAX's soft_trace and _finish_surface.
struct Surf {
  float cov_raw, icov;
  bool good;
  float f[10];  // blend: tbar, pbar, nraw, albedo
  // two levels (n_sph + n_tri > kUnroll): the two chunks
  bool two;
  float ca[2], ct[2], ctr[2], craw[2], cicov[2];
  bool cgood[2];
  float cf[2][10];
  // the finished surface
  float cov, tbar;
  V3 pbar, nraw, nbar, alb;
  bool goodn;
  float ninv;
};

__device__ __forceinline__ void finish(Surf& s) {
  s.cov = clip01(s.cov_raw);
  s.tbar = s.f[0];
  s.pbar = mk(s.f[1], s.f[2], s.f[3]);
  s.nraw = mk(s.f[4], s.f[5], s.f[6]);
  s.alb = mk(s.f[7], s.f[8], s.f[9]);
  const float n2 = dot(s.nraw, s.nraw);
  s.goodn = n2 > 1e-8f;
  s.ninv = rsqrtf(s.goodn ? n2 : 1.0f);
  s.nbar = s.goodn ? s.ninv * s.nraw : mk(0.0f, 0.0f, 1.0f);
}

// The soft surface for ray r; fills S.a, S.t, S.tr.
__device__ void trace_fwd(const Tables& T, const Cfg& C, const SRay& r,
                          Scratch& S, Surf& sf) {
  const int n = T.n_sph + T.n_tri;
  for (int k = 0; k < n; ++k)
    hyp_fwd<false>(T, C, k, r, S.a[k], S.t[k], nullptr);
  auto fields = [&](int k, float* f) {
    float a, t;
    hyp_fwd<true>(T, C, k, r, a, t, f);
  };
  sf.two = n > kUnroll;
  if (!sf.two) {
    comp_fwd(S.a, S.t, S.tr, 0, n, C.itau, 1e-6f, fields, sf.cov_raw, sf.icov,
             sf.good, sf.f);
  } else {
    const int bounds[3] = {0, T.n_sph, n};
    for (int c = 0; c < 2; ++c) {
      comp_fwd(S.a, S.t, S.tr, bounds[c], bounds[c + 1], C.itau, 1e-9f, fields,
               sf.craw[c], sf.cicov[c], sf.cgood[c], sf.cf[c]);
      sf.ca[c] = clip01(sf.craw[c]);
      sf.ct[c] = sf.cf[c][0];
    }
    auto chunk = [&](int c, float* f) {
      for (int k = 0; k < 10; ++k) f[k] = sf.cf[c][k];
    };
    comp_fwd(sf.ca, sf.ct, sf.ctr, 0, 2, C.itau, 1e-6f, chunk, sf.cov_raw,
             sf.icov, sf.good, sf.f);
  }
  finish(sf);
}

// Adjoint of trace_fwd from the cotangents of cov, tbar, pbar, nbar and the
// albedo to the ray's (go, gd, gmint) and the rows. Warp-uniform.
__device__ void trace_adj(const Tables& T, const Cfg& C, const Grads& G,
                          bool live, const SRay& r, Scratch& S,
                          const Surf& sf, float gcov, float gtbar, V3 gpbar,
                          V3 gnbar, V3 galb, V3& go, V3& gd, float& gmint) {
  const V3 gnr = sf.goodn ? sf.ninv * (gnbar - dot(gnbar, sf.nbar) * sf.nbar)
                          : mk(0.0f, 0.0f, 0.0f);
  const float gb[10] = {gtbar,  gpbar.x, gpbar.y, gpbar.z, gnr.x,
                        gnr.y,  gnr.z,   galb.x,  galb.y,  galb.z};
  auto fields = [&](int k, float* f) {
    float a, t;
    hyp_fwd<true>(T, C, k, r, a, t, f);
  };
  auto obj_adj = [&](int k, float ga, float gt, const float* gf) {
    hyp_adj<true>(T, C, G, live, k, r, ga, gt, gf, go, gd, gmint);
  };
  const int n = T.n_sph + T.n_tri;
  if (!sf.two) {
    comp_adj(S.a, S.t, S.tr, 0, n, C.itau, sf.cov_raw, sf.icov, sf.good, gcov,
             gb, fields, obj_adj, S.A, S.ga, S.gt, S.sf, S.sc);
    return;
  }
  const int bounds[3] = {0, T.n_sph, n};
  float A2[2], ga2[2], gt2[2], sf2[2], sc2[2];
  auto chunk = [&](int c, float* f) {
    for (int k = 0; k < 10; ++k) f[k] = sf.cf[c][k];
  };
  // a chunk is a hypothesis of the outer composite: alpha its clipped
  // coverage, t and fields its blend
  auto chunk_adj = [&](int c, float ga, float gt, const float* gf) {
    float gbc[10];
    for (int k = 0; k < 10; ++k) gbc[k] = gf[k];
    gbc[0] += gt;
    comp_adj(S.a, S.t, S.tr, bounds[c], bounds[c + 1], C.itau, sf.craw[c],
             sf.cicov[c], sf.cgood[c], ga, gbc, fields, obj_adj, S.A, S.ga,
             S.gt, S.sf, S.sc);
  };
  comp_adj(sf.ca, sf.ct, sf.ctr, 0, 2, C.itau, sf.cov_raw, sf.icov, sf.good,
           gcov, gb, chunk, chunk_adj, A2, ga2, gt2, sf2, sc2);
}

// ---------------------------------------------------------------------------
// the shadow transmittance
// ---------------------------------------------------------------------------

// vis = prod_k (1 - alpha_k sigmoid((dist - t_k) / bw)) on the shadow ray
// (so, sd) with mint 0; keeps alpha in S.ga, t in S.gt, the sigmoid in S.A
// and each occluder's coverage in S.sc.
__device__ float vis_fwd(const Tables& T, const Cfg& C, const SRay& r,
                         float dist, Scratch& S) {
  const int n = T.n_sph + T.n_tri;
  float vis = 1.0f;
  for (int k = 0; k < n; ++k) {
    float a, t;
    hyp_fwd<false>(T, C, k, r, a, t, nullptr);
    const float s = sigm((dist - t) * C.ibw);
    S.ga[k] = a;
    S.gt[k] = t;
    S.A[k] = s;
    S.sc[k] = a * s;
    vis = vis * (1.0f - S.sc[k]);
  }
  return vis;
}

// Adjoint of vis_fwd (after it, on the same scratch) for the cotangent
// gvis: into the shadow ray's (go, gd), gdist and the rows. Warp-uniform.
__device__ void vis_adj(const Tables& T, const Cfg& C, const Grads& G,
                        bool live, const SRay& r, float gvis, Scratch& S,
                        V3& go, V3& gd, float& gdist) {
  const int n = T.n_sph + T.n_tri;
  float run = 1.0f;
  for (int k = n - 1; k >= 0; --k) {
    S.sf[k] = run;
    run = run * (1.0f - S.sc[k]);
  }
  float pre = 1.0f, gmint = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float gin = -gvis * (pre * S.sf[k]);
    pre = pre * (1.0f - S.sc[k]);
    const float s = S.A[k];
    const float gx = gin * S.ga[k] * s * (1.0f - s) * C.ibw;
    gdist += gx;
    hyp_adj<false>(T, C, G, live, k, r, gin * s, -gx, nullptr, go, gd, gmint);
  }
}

// ---------------------------------------------------------------------------
// the light pieces
// ---------------------------------------------------------------------------

// The emitter race of light li on the primary segment: lw, and what its
// adjoint needs.
struct Emit {
  float den, num, idiv, tl, on, fr, s3, before, lw;
  bool goodl;
  V3 q;
};
__device__ __forceinline__ Emit emit_fwd(const Tables& T, const Cfg& C,
                                         int li, const SRay& r, float cov,
                                         float tbar) {
  const float* l = T.lig + li * kLig;
  const V3 lp = ld3(l), ln = ld3(l + 3);
  const float rad = l[12];
  Emit e;
  e.den = dot(r.d, ln);
  e.num = dot(lp - r.o, ln);
  e.goodl = fabsf(e.den) > 1e-12f;
  e.idiv = 1.0f / (e.goodl ? e.den : 1.0f);
  e.tl = e.goodl ? e.num * e.idiv : 1e6f;
  e.q = r.o + e.tl * r.d - lp;
  e.on = sigm((rad * rad - dot(e.q, e.q)) * C.ibw);
  e.fr = sigm((e.tl - r.mint) * C.ibw);
  e.s3 = sigm((tbar - e.tl) * C.ibw);
  e.before = cov * e.s3 + (1.0f - cov);
  e.lw = e.on * e.fr * e.before * (e.goodl ? 1.0f : 0.0f);
  return e;
}

// Adjoint of emit_fwd for the cotangent glw: into the ray's (go, gd,
// gmint), gcov, gtbar and light li's row cotangents gl (20 words).
__device__ __forceinline__ void emit_adj(const Tables& T, const Cfg& C,
                                         int li, const SRay& r, float cov,
                                         const Emit& e, float glw, V3& go,
                                         V3& gd, float& gmint, float& gcov,
                                         float& gtbar, float (&gl)[kLig]) {
  const float* l = T.lig + li * kLig;
  const V3 lp = ld3(l), ln = ld3(l + 3);
  const float rad = l[12];
  const float gg = e.goodl ? 1.0f : 0.0f;
  const float gon = glw * e.fr * e.before * gg;
  const float gfr = glw * e.on * e.before * gg;
  const float gbefore = glw * e.on * e.fr * gg;
  gcov += gbefore * (e.s3 - 1.0f);
  const float gx3 = gbefore * cov * e.s3 * (1.0f - e.s3) * C.ibw;
  gtbar += gx3;
  float gtl = -gx3;
  const float gx2 = gfr * e.fr * (1.0f - e.fr) * C.ibw;
  gtl += gx2;
  gmint -= gx2;
  const float gx1 = gon * e.on * (1.0f - e.on) * C.ibw;
  gl[12] += 2.0f * rad * gx1;
  const V3 gq = (-2.0f * gx1) * e.q;
  go = go + gq;
  gd = gd + e.tl * gq;
  gtl += dot(gq, r.d);
  V3 glp = mk(-gq.x, -gq.y, -gq.z), gln = mk(0.0f, 0.0f, 0.0f);
  if (e.goodl) {
    const float gnum = gtl * e.idiv;
    const float gden = -(gtl * e.num) * e.idiv * e.idiv;
    glp = glp + gnum * ln;
    go = go - gnum * ln;
    gln = gln + gnum * (lp - r.o) + gden * r.d;
    gd = gd + gden * ln;
  }
  gl[0] += glp.x;
  gl[1] += glp.y;
  gl[2] += glp.z;
  gl[3] += gln.x;
  gl[4] += gln.y;
  gl[5] += gln.z;
}

// The NEE shadow ray of light li from the blended surface (pbar, nbar) with
// the draw (u0, u1): JAX's nee_soft up to the transmittance.
struct Nee {
  float sx, sy, d2, dist;
  V3 so, dl, sd;
};
__device__ __forceinline__ Nee nee_ray(const Tables& T, int li, float u0,
                                       float u1, V3 pbar, V3 nbar,
                                       float eps) {
  const float* l = T.lig + li * kLig;
  Nee s;
  concentric(u0, u1, s.sx, s.sy);
  const float rad = l[12];
  const V3 tgt = ld3(l) + (s.sx * rad) * ld3(l + 14) + (s.sy * rad) * ld3(l + 17);
  s.so = pbar + eps * nbar;
  s.dl = tgt - s.so;
  s.d2 = dot(s.dl, s.dl);
  s.dist = sqrtf(fmaxf(s.d2, 1e-20f));
  s.sd = normalize(s.dl);
  return s;
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
// into buffers other warps add into as well (SpanScratch::kAtomic).

constexpr int kSpan = kUnroll;   // JAX's SOFT_CHUNK
constexpr int kMaxSpans = 128;   // DIFF_TABLE_MAX / kSpan of each type

// The large instance's per-thread scratch (local memory, 12.8 KB): one
// span's hypotheses in Scratch's arrays (kSpan entries, reused span by
// span); per span its raw coverage craw, clipped coverage ca, blended
// depth ct and fields cf, the outer composite's exclusive products ctr and
// its adjoint's sums (cA, cga, cgt, csf, csc), and the transmittance's
// span products vp and the shadow ray's length.
struct SpanScratch {
  static constexpr bool kAtomic = true;
  float a[kSpan], t[kSpan], tr[kSpan];
  float A[kSpan], ga[kSpan], gt[kSpan], sf[kSpan], sc[kSpan];
  float craw[kMaxSpans], ca[kMaxSpans], ct[kMaxSpans], ctr[kMaxSpans];
  float cf[kMaxSpans][10];
  float cA[kMaxSpans], cga[kMaxSpans], cgt[kMaxSpans], csf[kMaxSpans],
      csc[kMaxSpans];
  float vp[kMaxSpans];
  float dist;  // the shadow ray's length (vis_fwd's)
};

__device__ __forceinline__ int n_spans(const Tables& T) {
  return (T.n_sph + kSpan - 1) / kSpan + (T.n_tri + kSpan - 1) / kSpan;
}

// Objects [lo, hi) of span c (objects: spheres, then triangles).
__device__ __forceinline__ void span_of(const Tables& T, int c, int& lo,
                                        int& hi) {
  const int ns = (T.n_sph + kSpan - 1) / kSpan;
  if (c < ns) {
    lo = c * kSpan;
    hi = min(T.n_sph, lo + kSpan);
  } else {
    const int j = (c - ns) * kSpan;
    lo = T.n_sph + j;
    hi = T.n_sph + min(T.n_tri, j + kSpan);
  }
}

// The soft surface for ray r over every span; fills the spans' blends.
__device__ void trace_fwd(const Tables& T, const Cfg& C, const SRay& r,
                          SpanScratch& S, Surf& sf) {
  const int nc = n_spans(T);
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
  sf.two = false;
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
      hyp_adj<true, true>(T, C, G, live, lo + i, r, ga_i, gt_i, gf_i, go, gd,
                          gmint);
    };
    float craw, icov, blend[10];
    bool good;
    comp_fwd<false>(S.a, S.t, S.tr, 0, hi - lo, C.itau, 1e-9f, fields, craw,
                    icov, good, blend);
    comp_adj(S.a, S.t, S.tr, 0, hi - lo, C.itau, craw, icov, good, ga, gbc,
             fields, obj_adj, S.A, S.ga, S.gt, S.sf, S.sc);
  };
  comp_adj(S.ca, S.ct, S.ctr, 0, n_spans(T), C.itau, sf.cov_raw, sf.icov,
           sf.good, gcov, gb, chunk, span_adj, S.cA, S.cga, S.cgt, S.csf,
           S.csc);
}

// The shadow transmittance over every span; keeps each span's product.
__device__ float vis_fwd(const Tables& T, const Cfg& C, const SRay& r,
                         float dist, SpanScratch& S) {
  const int nc = n_spans(T);
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
  const int nc = n_spans(T);
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
      hyp_adj<false, true>(T, C, G, live, lo + i, r, gin * s, -gx, nullptr,
                           go, gd, gmint);
    }
  }
}

}  // namespace soft
}  // namespace rt
