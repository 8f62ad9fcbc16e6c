// The soft (edge-aware) pass and its hand-written adjoint, for kernel 2s
// (megakernel_soft.cu): the counterpart of _tile_program_soft
// (raytracing_tpu/ops/pallas/megakernel_grad.py:1516-2144), path and direct
// mode. The plain version is ops/megakernel_soft.py; the arithmetic of each
// hypothesis and of each ordered pair follows it operation for operation
// (built with --fmad=false, as kernels 2 and 3); sums over hypotheses run
// in another order.
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
//     pass and a running prefix over j, O(N) per i as the forward. Up to
//     kUnroll hypotheses one composite; past that JAX's two levels: every
//     kSpan span of a type composites (first_good 1e-9), and the spans'
//     blends composite again as hypotheses;
//   * the shadow transmittance vis = prod_k (1 - alpha_k sigmoid((dist -
//     t_k) / bw)) and its adjoint, by the same exclusive products (past
//     kUnroll a product per span, then over the spans);
//   * the emitter race of the primary segment, NEE per light, and the
//     bounce from the blended surface.
// The gradient of JAX's jnp.maximum / jnp.minimum / jnp.clip splits at a tie
// (hmax, hmin, clip01_d, pathtrace_adj.cuh); the guards are the forward's
// double wheres.
//
// The layout for the H100 (PERF.md §6 has the attribution that ranked
// it). A group of G lanes (G a template parameter:
// 4, 8 or 32, from the widest composite) takes one ray; the groups of a
// warp step through their rays together (the soft program has no early exit
// but the roulette and the scene box, so every group runs the same loops;
// a group without a live segment runs them with its adds masked off). The
// ray's scalar work (camera, bounce, NEE geometry, the emitter race) runs
// in every lane of its group alike, so the group's lanes hold the same
// values; the hypotheses of a composite are split over the lanes (lane l
// owns i = l, l + G, ...), whose pair loops read alpha and t from shared
// memory (one word for the group). Everything a lane indexes lives in its
// group's slice of dynamic shared memory (Layout): the composite's alpha,
// t, exclusive products, the pair sigmoids s_ij of the composite being
// differentiated (S, kept from its forward for its adjoint), each lane's
// row of suffix products and pair cotangents (GO), the two-level
// composite's per-span arrays, and the ray's tape (per segment the ray, its
// soft surface and, past kUnroll, every span's coverage, blend and outer
// exclusive product, so that the sweep runs no forward composite besides
// the one whose s_ij its adjoint reads). Sums over hypotheses are the
// lanes' partial sums added by an xor butterfly over the group (the same
// bits in every lane). Row cotangents go into the group's own gradient
// buffer, in the tables' layout but holding only the groups in `wrt`: the
// lane that owns a hypothesis adds its object's row words with a plain add
// (no other lane of the block writes them, no atomic); the group's lanes
// whose objects share a material row sum their words first by
// pathtrace_adj.cuh's rows_of and add_rows' shuffle tree over those lanes
// (add_rows_plain); lane 0 adds the light rows and par, which come from the
// scalar work. The block sums its groups' buffers into the outputs once, at
// the end (pathtrace_adj.cuh flush). This layout serves the entry of at
// most 64 objects per type; past that the span kernel of
// pathtrace_soft_span.cuh runs (PERF.md §6 says why).
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace_adj.cuh"

namespace rt {
namespace soft {

constexpr int kUnroll = 64;   // JAX's UNROLL_OBJECTS: one composite up to this
constexpr int kSpan = kUnroll;  // JAX's SOFT_CHUNK: rows per span past it
constexpr int kMaxSpans = 128;  // DIFF_TABLE_MAX / kSpan of each type

// The reciprocals of the bandwidth and of the depth order's temperature:
// a sigmoid's argument is x * (1 / bw), not x / bw (one IEEE division
// fewer per sigmoid; the plain version computes it the same way, so the
// two take the same branch where a ray sits at a tie).
struct Cfg {
  float ibw, itau;
};

// 1 / (1 + exp(-x)): 0 at x -> -inf, 1 at x -> +inf, never NaN. On sm_90a
// it is two MUFU operations (EX2 inside expf, RCP inside the IEEE
// division), beside the FP32 ones.
__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// Component c of draw slot j of this ray (Draws::pair's u0 or u1; the
// u-planes or threefry).
__device__ __forceinline__ float draw(const Draws& D, int j, int c) {
  if (D.u != nullptr)
    return __ldg(D.u + static_cast<size_t>(2 * j + c) * D.n_rays + D.rid);
  return threefry_uniform(D.k0, D.k1,
                          D.base + 2u * static_cast<uint32_t>(j) +
                              static_cast<uint32_t>(c));
}

// A group's gradient buffers in shared memory, laid out like the tables.
struct SGrads {
  float* sph;
  float* tri;
  float* mat;
  float* lig;
  int wrt;
};

// hyp_adj's adder for the group layout: word w of sphere (tri false) or
// triangle row k of the group's buffer, the owning lane's plain add where
// live.
struct OwnerAdd {
  const SGrads& G;
  bool live;
  __device__ __forceinline__ void operator()(bool tri, int k, int w,
                                             float v) const {
    if (live && v != 0.0f)
      (tri ? G.tri : G.sph)[k * (tri ? kTri : kSph) + w] += v;
  }
};


// add_rows (pathtrace_adj.cuh) into a buffer that no other group writes:
// the lanes of a row's group sum by the same shuffle tree, the lowest adds
// with a plain add. Warp-uniform.
template <int N>
__device__ __forceinline__ void add_rows_plain(const Rows& r, float* p,
                                               float (&v)[N]) {
  if (!r.any) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = r.peers & ((1u << lane) - 1u);
  unsigned higher = r.peers & ~below & ~(1u << lane);
  int rank = __popc(below);
  while (__any_sync(kFull, higher != 0u)) {
    const int src = higher != 0u ? __ffs(higher) - 1 : lane;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x = __shfl_sync(kFull, v[k], src);
      if (higher != 0u) v[k] += x;
    }
    higher &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  if (r.peers != 0u && below == 0u) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (v[k] != 0.0f) p[k] += v[k];
  }
}

// ---------------------------------------------------------------------------
// hypotheses
// ---------------------------------------------------------------------------

// hyp_fwd's default vote: every factor is evaluated.
struct NoVote {
  __device__ __forceinline__ bool operator()(bool) const { return true; }
};

// alpha and t of object k for ray r; with f (10 floats) also its fields
// (t, hit point, normal, albedo). Without fields, vote(p) is asked after
// each factor of alpha whether to go on (p: this lane's product so far is
// nonzero); where it says no, a is 0 and t unset. Returns the last vote
// (NoVote: true), taken on whether no factor of alpha is 0.
template <bool kFields, class Vote = NoVote>
__device__ __forceinline__ bool hyp_fwd(const Tables& T, const Cfg& C, int k,
                                        const SRay& r, float& a, float& t,
                                        float* f, Vote vote = {}) {
  float mf;
  V3 n;
  a = 0.0f;
  if (k < T.n_sph) {
    const float* s = T.sph + k * kSph;
    const float msk = s[5] > 0.0f ? 1.0f : 0.0f;
    if (!kFields && !vote(msk != 0.0f)) return false;
    const V3 c = ld3(s);
    const float rad = s[3];
    const V3 m = r.o - c;
    const float b = dot(m, r.d);
    const float cq = dot(m, m) - rad * rad;
    const float dis = b * b - cq;
    const float s1 = sigm(dis * C.ibw);
    if (!kFields && !vote(s1 * msk != 0.0f)) return false;
    const float sq = dis > 0.0f ? sqrtf(dis) : 0.0f;
    t = -b - sq;
    const float s2 = sigm((t - r.mint) * C.ibw);
    a = s1 * msk * s2;
    if (!kFields) return vote(s1 * msk != 0.0f && s2 != 0.0f);
    n = normalize(r.o + t * r.d - c);
    mf = s[4];
  } else {
    const float* q = T.tri + (k - T.n_sph) * kTri;
    const float msk = q[17] > 0.0f ? 1.0f : 0.0f;
    if (!kFields && !vote(msk != 0.0f)) return false;
    const V3 ng = ld3(q);
    const float div = dot(ng, r.d);
    const bool side = T.two_sided ? div != 0.0f : div > 0.0f;
    if (!kFields && !vote(msk != 0.0f && side)) return false;
    const float idiv = 1.0f / (div == 0.0f ? 1.0f : div);
    const float beta = (dot(ld3(q + 12), r.oxd) - dot(ld3(q + 6), r.d)) * idiv;
    const float gamma = (dot(ld3(q + 3), r.d) - dot(ld3(q + 9), r.oxd)) * idiv;
    const float w3 = 1.0f - beta - gamma;
    const float margin = fminf(fminf(beta, gamma), w3);
    const float m1 = sigm(margin * C.ibw) * msk * (side ? 1.0f : 0.0f);
    if (!kFields && !vote(m1 != 0.0f)) return false;
    t = side ? (q[15] - dot(ng, r.o)) * idiv : 1e6f;
    const float s2 = sigm((t - r.mint) * C.ibw);
    a = m1 * s2;
    if (!kFields) return vote(m1 != 0.0f && s2 != 0.0f);
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
  return true;
}

// Adjoint of hyp_fwd for object k: from the cotangents ga (alpha), gt (t)
// and, with kFields, gf (the 10 fields) to those of the ray (go, gd,
// gmint) and of the object's rows: each word of its sphere or triangle row
// (where that group is in wrt) to add(tri, row, word, v), and with kFields
// the material row's three words to gmat (the caller adds them). The group
// layout adds by the owning lane (OwnerAdd), the span kernel warp-wide
// (pathtrace_soft_span.cuh).
template <bool kFields, class Add>
__device__ __forceinline__ void hyp_adj(const Tables& T, const Cfg& C,
                                        int wrt, const Add& add, int k,
                                        const SRay& r, float ga, float gt,
                                        const float* gf, V3& go, V3& gd,
                                        float& gmint, float (&gmat)[3]) {
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
#pragma unroll
      for (int w = 0; w < 3; ++w) gmat[w] = gf[7 + w];
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
    if (wrt & kWSph) {
      add(false, k, 0, gC.x);
      add(false, k, 1, gC.y);
      add(false, k, 2, gC.z);
      add(false, k, 3, -2.0f * rad * gcq);
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
#pragma unroll
    for (int w = 0; w < 3; ++w) gmat[w] = gf[7 + w];
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
  if (wrt & kWTri) {
    const V3 v3[5] = {gdiv * d - gnt * o, gng * d, -gnb * d, -gng * r.oxd,
                      gnb * r.oxd};
#pragma unroll
    for (int w = 0; w < 5; ++w) {  // n_geo, c1, c2, e1, e2
      add(true, j, 3 * w, v3[w].x);
      add(true, j, 3 * w + 1, v3[w].y);
      add(true, j, 3 * w + 2, v3[w].z);
    }
    add(true, j, 15, gnt);  // k
    if (kFields) {
#pragma unroll
      for (int w = 0; w < 9; ++w) add(true, j, 18 + w, vn[w]);
    }
  }
}

// ---------------------------------------------------------------------------
// the composite
// ---------------------------------------------------------------------------

// The spans' composite (two levels), run by one lane of a group: the
// composite of hypotheses [lo, hi) with alpha a[] and t t[]: fills tr[]
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

// Adjoint of comp_fwd (one lane): from the cotangents of the clipped
// coverage (gcov) and of the blend (gb) to each hypothesis's alpha, t and
// fields, handed to adj(i, ga_i, gt_i, gf_i) in order. A, ga, gt, sf and
// sc are scratch indexed like a[].
template <class Fields, class Adj>
__device__ __forceinline__ void comp_adj(const float* a, const float* t, const float* tr,
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


// ---------------------------------------------------------------------------
// a group's shared slice
// ---------------------------------------------------------------------------

constexpr int kTapeRay = 11;   // per segment: o, d, mint, tp, path weight;
constexpr int kTapeSeg = 24;   // then cov_raw, 1 / cov, good, the blend (13);
                               // then its draws (the bounce's pair, each
                               // light's NEE pair), then the spans
constexpr int kTapeSpan = 12;  // per span: craw, its blend, the outer tr
// per span of the outer composite: alpha, t, tr, its adjoint's A, ga, gt,
// sf, sc, the shadow ray's span product, and what the outer adjoint hands
// the span (its alpha's cotangent and its blend's, kSpanOut words)
constexpr int kSpanOut = 11;
constexpr int kCsWords = 9 + kSpanOut;
enum { kCa, kCt, kCtr, kCA, kCga, kCgt, kCsf, kCsc, kVp };

// Offsets (in floats) of a group's slice of dynamic shared memory, and the
// composites it holds: one of w <= kUnroll hypotheses (nc = 0), or nc
// spans of at most w each. The host computes it for the launch.
struct Layout {
  int w, nc, sp, tw, tspan;  // tspan: the spans' words in a segment
  int a, t, tr, A, ga, gt, f, s, go, pwc, cs, tape, grad, size;
  // the group's row buffers, at grad + kParPad: offsets, -1 where not held
  int w_sph, w_tri, w_mat, w_lig;
};

__host__ __device__ inline int n_spans_of(int n_sph, int n_tri) {
  return (n_sph + kSpan - 1) / kSpan + (n_tri + kSpan - 1) / kSpan;
}

__host__ __device__ inline Layout make_layout(int G, int n_sph, int n_tri,
                                              int n_mat, int n_lig,
                                              int nseg, int wrt) {
  Layout L = {};
  const int n = n_sph + n_tri;
  if (n <= kUnroll) {
    L.nc = 0;
    L.w = n > 0 ? n : 1;
  } else {
    L.nc = n_spans_of(n_sph, n_tri);
    const int ws = n_sph < kSpan ? n_sph : kSpan;
    const int wt = n_tri < kSpan ? n_tri : kSpan;
    L.w = ws > wt ? ws : wt;
  }
  L.sp = L.w | 1;  // odd: a column and a row of S both spread over the banks
  L.tspan = kTapeSeg + 2 + 2 * n_lig;
  L.tw = L.tspan + kTapeSpan * L.nc;
  int o = 0;
  L.a = o;
  o += L.w;
  L.t = o;
  o += L.w;
  L.tr = o;
  o += L.w;
  L.A = o;
  o += L.w;
  L.ga = o;
  o += L.w;
  L.gt = o;
  o += L.w;
  // S; the replay's fields (one composite) share its words: a composite
  // that keeps its s_ij gathers no fields
  L.s = L.f = o;
  o += L.nc == 0 && 10 > L.sp ? 10 * L.w : L.w * L.sp;
  L.go = o;
  o += L.w * (G + 1);
  L.pwc = o;
  o += n_lig + 1;
  L.cs = o;
  o += kCsWords * L.nc;
  L.tape = o;
  o += nseg * L.tw;
  L.grad = o;  // par
  o += kParPad;
  int g = 0;
  L.w_sph = L.w_tri = L.w_mat = L.w_lig = -1;
  if (wrt & kWSph) {
    L.w_sph = g;
    g += kSph * n_sph;
  }
  if (wrt & kWTri) {
    L.w_tri = g;
    g += kTri * n_tri;
  }
  if (wrt & kWMat) {
    L.w_mat = g;
    g += kMat * n_mat;
  }
  if (wrt & kWLig) {
    L.w_lig = g;
    g += kLig * n_lig;
  }
  o += g;
  // a multiple of 32 words plus G: the groups of a warp start on
  // different banks (G < 32)
  L.size = (o + 31) / 32 * 32 + (G < 32 ? G : 0);
  return L;
}

// One lane's view of its group: its lane index, its group's index in the
// warp, and the group's slice.
template <int G>
struct Grp {
  int lane, gq;
  float* s;
  const Layout* L;
  __device__ __forceinline__ float* a() const { return s + L->a; }
  __device__ __forceinline__ float* t() const { return s + L->t; }
  __device__ __forceinline__ float* tr() const { return s + L->tr; }
  __device__ __forceinline__ float* A() const { return s + L->A; }
  __device__ __forceinline__ float* ga() const { return s + L->ga; }
  __device__ __forceinline__ float* gt() const { return s + L->gt; }
  __device__ __forceinline__ float* f() const { return s + L->f; }
  __device__ __forceinline__ float* cs(int k) const {
    return s + L->cs + k * L->nc;
  }
  __device__ __forceinline__ float* seg(int i) const {
    return s + L->tape + i * L->tw;
  }
  // s_ij of the composite being differentiated, column-major
  __device__ __forceinline__ float& S(int i, int j) const {
    return s[L->s + j * L->sp + i];
  }
  // word j of lane q's row (suffix products, then pair cotangents)
  __device__ __forceinline__ float& GO(int j, int q) const {
    return s[L->go + j * (G + 1) + q];
  }
  __device__ __forceinline__ bool owns(int k) const {
    return (k & (G - 1)) == lane;
  }
  // v summed over the group's lanes: the same bits in every lane (each
  // level adds two equal pairs). Warp-uniform.
  __device__ __forceinline__ float sum(float v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off, G);
    return v;
  }
  __device__ __forceinline__ V3 sum(V3 v) const {
    return mk(sum(v.x), sum(v.y), sum(v.z));
  }
  // the group's lanes for which p holds, as bits 0..G-1. Warp-uniform.
  __device__ __forceinline__ unsigned ballot(bool p) const {
    const unsigned b = __ballot_sync(kFull, p);
    if constexpr (G == 32)
      return b;
    else
      return (b >> (gq * G)) & ((1u << G) - 1u);
  }
};


// ---------------------------------------------------------------------------
// the group's composite
// ---------------------------------------------------------------------------

// The spans: span c holds objects [lo, hi) (spheres, then triangles), the
// sphere table's kSpan-row spans first, each in the order the rows are
// given (the caller hands triangles in Morton order past kUnroll, padded
// with zero rows, which are value-neutral: alpha 0).
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

// alpha and t of objects [lo, hi) for ray r into the group's a[], t[]
// (each lane its own), then __syncwarp.
template <int G>
__device__ __forceinline__ void load_hyps(const Grp<G>& gr, const Tables& T,
                                          const Cfg& C, const SRay& r, int lo,
                                          int hi) {
  float* a = gr.a();
  float* t = gr.t();
  for (int i = gr.lane; i < hi - lo; i += G)
    hyp_fwd<false>(T, C, lo + i, r, a[i], t[i], nullptr);
  __syncwarp();
}

// The composite of the group's hypotheses [0, w) (a[], t[] in place): each
// lane composites its own, tr[i] = prod_{j != i} (1 - a_j s_ij) in the
// order of j, keeping s_ij in S with kKeepS; returns in every lane the raw
// coverage, 1 / cov, the guard and, with kBlend, the blend of fields(i, f).
// One composite (nc = 0) sums the coverage and the blend in hypothesis
// order, as the plain version's _composite (each lane alike, the fields
// gathered in f()): the replay's throughput, and so the roulette, then
// round as there. A span's sums are the lanes' (the plain version sums a
// span as a vector). The caller syncs before another lane writes a, t,
// tr, S or f. Warp-uniform.
template <int G, bool kKeepS, bool kBlend, class Fields>
__device__ __forceinline__ void comp_fwd_g(const Grp<G>& gr, int w, float itau,
                           float first_good, Fields fields, float& cov_raw,
                           float& icov, bool& good, float (&blend)[10]) {
  const float* a = gr.a();
  const float* t = gr.t();
  float* tr = gr.tr();
  float part = 0.0f;
  for (int i = gr.lane; i < w; i += G) {
    const float ti = t[i];
    float trans = 1.0f;
    // j = i is a factor 1 (exact): the sigmoids of an unrolled step are
    // independent, only the product waits
#pragma unroll 4
    for (int j = 0; j < w; ++j) {
      const float s = sigm((ti - t[j]) * itau);
      if (kKeepS) gr.S(i, j) = s;
      trans = trans * (j == i ? 1.0f : 1.0f - a[j] * s);
    }
    tr[i] = trans;
    part = part + a[i] * trans;
  }
  const bool ordered = gr.L->nc == 0;
  if (ordered) {
    __syncwarp();
    cov_raw = 0.0f;
    for (int i = 0; i < w; ++i) cov_raw = cov_raw + a[i] * tr[i];
  } else {
    cov_raw = gr.sum(part);
  }
  const float cov = clip01(cov_raw);
  good = cov > first_good;
  icov = 1.0f / (good ? cov : 1.0f);
  if (kBlend && ordered) {
    float* F = gr.f();
    if (good)
      for (int i = gr.lane; i < w; i += G) fields(i, F + 10 * i);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 10; ++k) blend[k] = 0.0f;
    if (good)
      for (int i = 0; i < w; ++i) {
        const float wn = a[i] * tr[i] * icov;
#pragma unroll
        for (int k = 0; k < 10; ++k) blend[k] = blend[k] + wn * F[10 * i + k];
      }
    return;
  }
  float b[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) b[k] = 0.0f;
  if (kBlend && good)
    for (int i = gr.lane; i < w; i += G) {
      const float wn = a[i] * tr[i] * icov;
      float f[10];
      fields(i, f);
#pragma unroll
      for (int k = 0; k < 10; ++k) b[k] = b[k] + wn * f[k];
    }
#pragma unroll
  for (int k = 0; k < 10; ++k) blend[k] = kBlend ? gr.sum(b[k]) : 0.0f;
}

// Adjoint of comp_fwd_g (after it with kKeepS and a __syncwarp): from the
// cotangents of the clipped coverage (gcov) and of the blend (gb) to each
// hypothesis's alpha, t and fields, handed to adj(has, i, ga_i, gt_i, gf_i)
// by the owning lane in rounds of G hypotheses (every lane of the warp
// calls it in every round, has false past w, so adj may hold warp
// collectives). In each round every lane runs its hypothesis's suffix and
// prefix passes over j (the serial version's operations, s_ij read from S)
// and leaves the pair cotangents in its GO row; then the owner of j sums
// the round's rows into ga[j] and gt[j]. Warp-uniform.
template <int G, class Fields, class Adj>
__device__ __forceinline__ void comp_adj_g(const Grp<G>& gr, int w, float itau,
                           float cov_raw, float icov, bool good, float gcov,
                           const float (&gb)[10], Fields fields, Adj adj) {
  const float* a = gr.a();
  const float* tr = gr.tr();
  float* A = gr.A();
  float* ga = gr.ga();
  float* gt = gr.gt();
  // the blend: A_i = gb . f_i, and through 1 / cov
  float part = 0.0f;
  for (int i = gr.lane; i < w; i += G) {
    float Ai = 0.0f;
    if (good) {
      float f[10];
      fields(i, f);
#pragma unroll
      for (int k = 0; k < 10; ++k) Ai += gb[k] * f[k];
      part += Ai * (a[i] * tr[i]);
    }
    A[i] = Ai;
    ga[i] = 0.0f;
    gt[i] = 0.0f;
  }
  const float gicov = gr.sum(part);
  if (good) gcov -= gicov * icov * icov;
  const float gcr = gcov * clip01_d(cov_raw);
  // w_i = a_i tr_i, tr_i = prod_{j != i} (1 - a_j s_ij)
  for (int k0 = 0; k0 < w; k0 += G) {
    const int i = k0 + gr.lane;
    bool row = false;
    if (i < w) {
      const float gw = (good ? A[i] * icov : 0.0f) + gcr;
      ga[i] += gw * tr[i];
      const float gtr = gw * a[i];
      if (gtr != 0.0f) {
        row = true;
        // suffix products over j > k (k != i)
        float run = 1.0f;
#pragma unroll 4
        for (int j = w - 1; j >= 0; --j) {
          gr.GO(j, gr.lane) = run;
          run = run * (j == i ? 1.0f : 1.0f - a[j] * gr.S(i, j));
        }
        float pre = 1.0f, gti = 0.0f;
#pragma unroll 4
        for (int j = 0; j < w; ++j) {
          const float sc = gr.S(i, j);
          const float go_ij = -gtr * (pre * gr.GO(j, gr.lane));
          gr.GO(j, gr.lane) = go_ij;
          const float gx = go_ij * a[j] * sc * (1.0f - sc) * itau;
          gti += j == i ? 0.0f : gx;
          pre = pre * (j == i ? 1.0f : 1.0f - a[j] * sc);
        }
        gt[i] += gti;
      }
    }
    const unsigned rows = gr.ballot(row);
    __syncwarp();
    // the round's pair cotangents into their columns
    for (int j = gr.lane; j < w; j += G) {
      float gaj = 0.0f, gtj = 0.0f;
#pragma unroll 4
      for (int q = 0; q < G; ++q) {
        const bool use = ((rows >> q) & 1u) && k0 + q != j;
        const float sc = gr.S(k0 + q, j);
        const float go_ij = gr.GO(j, q);
        gaj += use ? go_ij * sc : 0.0f;
        gtj -= use ? go_ij * a[j] * sc * (1.0f - sc) * itau : 0.0f;
      }
      ga[j] += gaj;
      gt[j] += gtj;
    }
    __syncwarp();
  }
  for (int k0 = 0; k0 < w; k0 += G) {
    const int i = k0 + gr.lane;
    const bool has = i < w;
    const float wn = has && good ? a[i] * tr[i] * icov : 0.0f;
    float gf[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) gf[k] = gb[k] * wn;
    adj(has, i, has ? ga[i] : 0.0f, has ? gt[i] : 0.0f, gf);
  }
}


// The soft surface of one segment: JAX's soft_trace and _finish_surface.
struct Surf {
  float cov_raw, icov;
  bool good;
  float f[10];  // blend: tbar, pbar, nraw, albedo
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

// The surface a tape segment holds (words 11-23).
__device__ __forceinline__ Surf surf_of(const float* seg) {
  Surf s;
  s.cov_raw = seg[11];
  s.icov = seg[12];
  s.good = seg[13] != 0.0f;
#pragma unroll
  for (int k = 0; k < 10; ++k) s.f[k] = seg[14 + k];
  finish(s);
  return s;
}

// The soft surface for ray r, into tape segment seg (words 11-23 and, past
// kUnroll, each span's words) by lane 0, and into sf in every lane.
// Warp-uniform.
template <int G>
__device__ __forceinline__ void trace_fwd_g(const Grp<G>& gr, const Tables& T, const Cfg& C,
                            const SRay& r, float* seg, Surf& sf) {
  const int nc = gr.L->nc;
  auto fields_at = [&](int lo) {
    return [&, lo](int i, float* f) {
      float a, t;
      hyp_fwd<true>(T, C, lo + i, r, a, t, f);
    };
  };
  if (nc == 0) {
    const int n = T.n_sph + T.n_tri;
    load_hyps(gr, T, C, r, 0, n);
    comp_fwd_g<G, false, true>(gr, n, C.itau, 1e-6f, fields_at(0),
                               sf.cov_raw, sf.icov, sf.good, sf.f);
    __syncwarp();
  } else {
    float* ca = gr.cs(kCa);
    float* ct = gr.cs(kCt);
    for (int c = 0; c < nc; ++c) {
      int lo, hi;
      span_of(T, c, lo, hi);
      load_hyps(gr, T, C, r, lo, hi);
      float craw, icov, cf[10];
      bool good;
      comp_fwd_g<G, false, true>(gr, hi - lo, C.itau, 1e-9f, fields_at(lo),
                                 craw, icov, good, cf);
      if (gr.lane == 0) {
        float* w = seg + gr.L->tspan + kTapeSpan * c;
        w[0] = craw;
#pragma unroll
        for (int k = 0; k < 10; ++k) w[1 + k] = cf[k];
        ca[c] = clip01(craw);
        ct[c] = cf[0];
      }
      __syncwarp();
    }
    // the spans' blends composite again (one lane)
    if (gr.lane == 0) {
      float* ctr = gr.cs(kCtr);
      auto chunk = [&](int c, float* f) {
        for (int k = 0; k < 10; ++k) f[k] = seg[gr.L->tspan + kTapeSpan * c + 1 + k];
      };
      comp_fwd(ca, ct, ctr, 0, nc, C.itau, 1e-6f, chunk, sf.cov_raw, sf.icov,
               sf.good, sf.f);
      for (int c = 0; c < nc; ++c) seg[gr.L->tspan + kTapeSpan * c + 11] = ctr[c];
      seg[11] = sf.cov_raw;
      seg[12] = sf.icov;
      seg[13] = sf.good ? 1.0f : 0.0f;
      for (int k = 0; k < 10; ++k) seg[14 + k] = sf.f[k];
    }
    __syncwarp();
    sf = surf_of(seg);
    return;
  }
  if (gr.lane == 0) {
    seg[11] = sf.cov_raw;
    seg[12] = sf.icov;
    seg[13] = sf.good ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < 10; ++k) seg[14 + k] = sf.f[k];
  }
  finish(sf);
}

// Adjoint of trace_fwd_g for the segment taped at seg (its surface sf), from
// the cotangents of cov, tbar, pbar, nbar and the albedo to the ray's (go,
// gd, gmint) and the rows: the outer composite's adjoint by lane 0 (two
// levels), then each composite's forward again (its s_ij kept) and its
// adjoint, the hypotheses' adjoints by their owners, the material rows
// summed over the group. Warp-uniform.
template <int G>
__device__ __forceinline__ void trace_adj_g(const Grp<G>& gr, const Tables& T, const Cfg& C,
                            const SGrads& SG, bool live, const SRay& r,
                            const float* seg, const Surf& sf, float gcov,
                            float gtbar, V3 gpbar, V3 gnbar, V3 galb, V3& go,
                            V3& gd, float& gmint) {
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  const V3 gnr = sf.goodn ? sf.ninv * (gnbar - dot(gnbar, sf.nbar) * sf.nbar)
                          : zero;
  const float gb[10] = {gtbar,  gpbar.x, gpbar.y, gpbar.z, gnr.x,
                        gnr.y,  gnr.z,   galb.x,  galb.y,  galb.z};
  V3 gop = zero, gdp = zero;
  float gmp = 0.0f;
  auto fields_at = [&](int lo) {
    return [&, lo](int i, float* f) {
      float a, t;
      hyp_fwd<true>(T, C, lo + i, r, a, t, f);
    };
  };
  auto adj_at = [&](int lo) {
    return [&, lo](bool has, int i, float ga, float gt, const float* gf) {
      float gm[3] = {0.0f, 0.0f, 0.0f};
      int mr = -1;
      if (has) {
        hyp_adj<true>(T, C, SG.wrt, OwnerAdd{SG, live}, lo + i, r, ga, gt,
                      gf, gop, gdp, gmp, gm);
        const int k = lo + i;
        if (live)
          mr = mat_row(T, k < T.n_sph ? T.sph[k * kSph + 4]
                                      : T.tri[(k - T.n_sph) * kTri + 16]);
      }
      // the group's lanes whose objects share a material row sum first
      if (SG.wrt & kWMat)
        add_rows_plain(rows_of(mr < 0 ? -1 : (gr.gq << 24) + mr),
                       SG.mat + (mr < 0 ? 0 : mr) * kMat, gm);
    };
  };
  const int nc = gr.L->nc;
  if (nc == 0) {
    const int n = T.n_sph + T.n_tri;
    float craw, icov, blend[10];
    bool good;
    load_hyps(gr, T, C, r, 0, n);
    comp_fwd_g<G, true, false>(gr, n, C.itau, 1e-6f, fields_at(0), craw,
                               icov, good, blend);
    __syncwarp();
    comp_adj_g(gr, n, C.itau, craw, icov, good, gcov, gb, fields_at(0),
               adj_at(0));
    __syncwarp();
  } else {
    float* out = gr.cs(kCsWords - kSpanOut);  // kSpanOut words per span
    if (gr.lane == 0) {
      // a span is a hypothesis of the outer composite: alpha its clipped
      // coverage, t and fields its blend
      float* ca = gr.cs(kCa);
      float* ct = gr.cs(kCt);
      float* ctr = gr.cs(kCtr);
      for (int c = 0; c < nc; ++c) {
        const float* w = seg + gr.L->tspan + kTapeSpan * c;
        ca[c] = clip01(w[0]);
        ct[c] = w[1];
        ctr[c] = w[11];
      }
      auto chunk = [&](int c, float* f) {
        for (int k = 0; k < 10; ++k) f[k] = seg[gr.L->tspan + kTapeSpan * c + 1 + k];
      };
      auto span_out = [&](int c, float ga, float gt, const float* gf) {
        float* o = out + c * kSpanOut;
        o[0] = ga;
        for (int k = 0; k < 10; ++k) o[1 + k] = gf[k];
        o[1] += gt;
      };
      comp_adj(ca, ct, ctr, 0, nc, C.itau, sf.cov_raw, sf.icov, sf.good, gcov,
               gb, chunk, span_out, gr.cs(kCA), gr.cs(kCga), gr.cs(kCgt),
               gr.cs(kCsf), gr.cs(kCsc));
    }
    __syncwarp();
    for (int c = 0; c < nc; ++c) {
      int lo, hi;
      span_of(T, c, lo, hi);
      const float* o = out + c * kSpanOut;
      float gbc[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) gbc[k] = o[1 + k];
      float craw, icov, blend[10];
      bool good;
      load_hyps(gr, T, C, r, lo, hi);
      comp_fwd_g<G, true, false>(gr, hi - lo, C.itau, 1e-9f, fields_at(lo),
                                 craw, icov, good, blend);
      __syncwarp();
      comp_adj_g(gr, hi - lo, C.itau, craw, icov, good, o[0], gbc,
                 fields_at(lo), adj_at(lo));
      __syncwarp();
    }
  }
  go = go + gr.sum(gop);
  gd = gd + gr.sum(gdp);
  gmint += gr.sum(gmp);
}

// ---------------------------------------------------------------------------
// the shadow transmittance
// ---------------------------------------------------------------------------

// Objects [lo, hi)'s occluders of the shadow ray r with length dist: alpha
// in a[], t in t[], the sigmoid in tr[] and the coverage alpha s in ga[]
// (each lane its own, then __syncwarp); returns prod (1 - alpha s) in
// object order, the same in every lane.
template <int G>
__device__ __forceinline__ float vis_span(const Grp<G>& gr, const Tables& T, const Cfg& C,
                          const SRay& r, float dist, int lo, int hi) {
  float* a = gr.a();
  float* t = gr.t();
  float* s = gr.tr();
  float* sc = gr.ga();
  for (int i = gr.lane; i < hi - lo; i += G) {
    hyp_fwd<false>(T, C, lo + i, r, a[i], t[i], nullptr);
    s[i] = sigm((dist - t[i]) * C.ibw);
    sc[i] = a[i] * s[i];
  }
  __syncwarp();
  float prod = 1.0f;
  for (int i = 0; i < hi - lo; ++i) prod = prod * (1.0f - sc[i]);
  return prod;
}

// vis = prod_k (1 - alpha_k sigmoid((dist - t_k) / bw)) on the shadow ray
// r with mint 0: one product up to kUnroll objects (its occluders stay in
// the group's arrays for vis_adj_g), past that one per span (kept in the
// span arrays), then over the spans. Warp-uniform.
template <int G>
__device__ __forceinline__ float vis_fwd_g(const Grp<G>& gr, const Tables& T, const Cfg& C,
                           const SRay& r, float dist) {
  const int nc = gr.L->nc;
  if (nc == 0) return vis_span(gr, T, C, r, dist, 0, T.n_sph + T.n_tri);
  float vis = 1.0f;
  for (int c = 0; c < nc; ++c) {
    int lo, hi;
    span_of(T, c, lo, hi);
    const float prod = vis_span(gr, T, C, r, dist, lo, hi);
    if (gr.lane == 0) gr.cs(kVp)[c] = prod;
    vis = vis * prod;
    __syncwarp();
  }
  return vis;
}

// The adjoint of one product's occluders (in the group's arrays): each
// occluder's exclusive product other * (prefix * suffix) (one product:
// prefix * suffix) by chains every lane runs, each keeping its own
// occluders' words; then the owners' hypothesis adjoints.
template <int G>
__device__ __forceinline__ void vis_adj_span(const Grp<G>& gr, const Tables& T, const Cfg& C,
                             const SGrads& SG, bool live, const SRay& r,
                             float gvis, int lo, int hi, bool one,
                             float other, V3& gop, V3& gdp, float& gdistp) {
  const float* a = gr.a();
  const float* s = gr.tr();
  const float* sc = gr.ga();
  float* ex = gr.gt();
  const int w = hi - lo;
  float run = 1.0f;
  for (int i = w - 1; i >= 0; --i) {
    if (gr.owns(i)) ex[i] = run;
    run = run * (1.0f - sc[i]);
  }
  float pre = 1.0f;
  for (int i = 0; i < w; ++i) {
    if (gr.owns(i)) ex[i] = one ? pre * ex[i] : other * (pre * ex[i]);
    pre = pre * (1.0f - sc[i]);
  }
  float gmint = 0.0f, gm[3];
  for (int i = gr.lane; i < w; i += G) {
    const float gin = -gvis * ex[i];
    const float si = s[i];
    const float gx = gin * a[i] * si * (1.0f - si) * C.ibw;
    gdistp += gx;
    hyp_adj<false>(T, C, SG.wrt, OwnerAdd{SG, live}, lo + i, r, gin * si,
                   -gx, nullptr, gop, gdp, gmint, gm);
  }
  __syncwarp();
}

// Adjoint of vis_fwd_g (after it) for the cotangent gvis: into the shadow
// ray's (go, gd), gdist and the rows. Past kUnroll each span's occluders
// are computed again. Warp-uniform.
template <int G>
__device__ __forceinline__ void vis_adj_g(const Grp<G>& gr, const Tables& T, const Cfg& C,
                          const SGrads& SG, bool live, const SRay& r,
                          float dist, float gvis, V3& go, V3& gd,
                          float& gdist) {
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  V3 gop = zero, gdp = zero;
  float gdistp = 0.0f;
  const int nc = gr.L->nc;
  if (nc == 0) {
    vis_adj_span(gr, T, C, SG, live, r, gvis, 0, T.n_sph + T.n_tri, true,
                 1.0f, gop, gdp, gdistp);
  } else {
    const float* vp = gr.cs(kVp);
    float* csf = gr.cs(kCsf);
    if (gr.lane == 0) {
      float run = 1.0f;
      for (int c = nc - 1; c >= 0; --c) {
        csf[c] = run;
        run = run * vp[c];
      }
    }
    __syncwarp();
    float pre = 1.0f;
    for (int c = 0; c < nc; ++c) {
      const float other = pre * csf[c];  // the other spans' product
      pre = pre * vp[c];
      int lo, hi;
      span_of(T, c, lo, hi);
      vis_span(gr, T, C, r, dist, lo, hi);
      vis_adj_span(gr, T, C, SG, live, r, gvis, lo, hi, false, other, gop,
                   gdp, gdistp);
    }
  }
  go = go + gr.sum(gop);
  gd = gd + gr.sum(gdp);
  gdist += gr.sum(gdistp);
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

}  // namespace soft
}  // namespace rt
