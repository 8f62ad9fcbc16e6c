// The adjoint of one path, shared by kernel 2 (megakernel_grad.cu, which
// fills the tape by tracing the tables) and kernel 3 (megakernel_champ.cu,
// which fills it from kernel 1's champion record): the tape segment, the
// adjoints of the forward's pieces (safe normalize, tangent frame, the
// champion surface, the closest hit's champion row, the camera chain) and
// the reverse sweep over a filled tape. Hard-gradient convention and
// guards as described in megakernel_grad.cu.
//
// The sweep is warp-uniform and its adds into gradient rows are
// warp-aggregated (add_rows): every lane of a warp calls reverse_sweep
// (nseg = 0 without a path), walks segments max(nseg) - 1 ... 0 under the
// predicate s < nseg, and computes each row's contribution inside its
// branch but adds it after, where all 32 lanes meet. A first version that
// matched rows over whichever lanes reached an add site together
// (__activemask) measured slower than the plain atomics it replaced (10.7
// against 6.3 ms for kernel 2 on cornell 1024^2, one H100 80GB HBM3, 700
// W): the lanes arrived diverged and the warp collectives took their
// divergent path. The tape (Tape) sits in a shared-memory slab sized at
// launch for bounces + 1 segments.
//
// Both kernels are built with --fmad=false (ops/megakernel_grad.ADJ_FLAGS):
// no contracted multiply-adds, so each computes its plain version's
// float32 arithmetic. The sphere root's discriminant b^2 - 4ac cancels
// near a silhouette, where the hard gradient (~1/sqrt(dis)) is largest,
// so a few grazing rays carry most of the sphere and camera cotangents and
// their rounding decides them. Measured on one H100 80GB HBM3 (700 W),
// contracted builds against their plain versions: kernel 3 on
// sphere_field(1024) at 1024^2 b5, sph cosine 0.068; kernel 2 on
// sphere_field(64) at 256x192 b5, sph cosine 0.22 and par -0.80, and on
// cornell at 1024^2 b5, par and tri norm ratios 1.042-1.043. Uncontracted,
// every group agrees to ~1e-5 of scale or better. The cost, measured on
// the earlier design with per-lane atomics: kernel 2 6.2 ms against 5.5 ms
// on cornell 1024^2, kernel 3 1.60 ms against 1.40 ms on
// sphere_field(1024).
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace.cuh"

namespace rt {

constexpr int kMaxSeg = 16;     // bounces <= 15
constexpr int kMaxLights = 32;  // occlusion bits per segment
constexpr int kSegWords = 14;   // words of one tape segment
// diff_wrt groups
constexpr int kWPar = 1, kWSph = 2, kWTri = 4, kWMat = 8, kWLig = 16;

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

// Adjoint of safe normalize y = v / |v| for cotangent gy.
__device__ __forceinline__ V3 normalize_adj(V3 v, V3 gy) {
  const float n2 = dot(v, v);
  if (!(n2 > 0.0f)) return gy;
  const float inv = rsqrtf(n2);
  const V3 y = inv * v;
  return inv * (gy - dot(gy, y) * y);
}

// Adjoint of tangent_frame(n) -> (t, b) for cotangents gt, gb; returns gn.
__device__ __forceinline__ V3 tangent_frame_adj(V3 n, V3 gt, V3 gb) {
  const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  const float mn = fminf(ax, fminf(ay, az));
  const bool fx = ax == mn;
  const bool fy = (ay == mn) && !fx;
  const bool fz = (az == mn) && !fx && !fy;
  const V3 vr = mk(fx ? 1.0f : n.x, fy ? 1.0f : n.y, fz ? 1.0f : n.z);
  const V3 v = normalize(vr);
  const V3 tr = cross(v, n);
  const V3 t = normalize(tr);
  const V3 br = cross(n, t);
  // b = normalize(cross(n, t))
  const V3 gbr = normalize_adj(br, gb);
  V3 gn = cross(t, gbr);
  gt = gt + cross(gbr, n);
  // t = normalize(cross(v, n))
  const V3 gtr = normalize_adj(tr, gt);
  gn = gn + cross(gtr, v);
  const V3 gv = cross(n, gtr);
  // v = normalize(n with its smallest component replaced by 1)
  const V3 gvr = normalize_adj(vr, gv);
  return gn + mk(fx ? 0.0f : gvr.x, fy ? 0.0f : gvr.y, fz ? 0.0f : gvr.z);
}

// Warp-aggregated adds. A float atomicAdd on shared memory compiles to a
// compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN), and the lanes of a warp
// mostly add into the same few rows (cornell: 2 spheres, 5 materials), so
// one add per lane and word retried up to 32 times per warp (74% of kernel
// 2's time). Here every add site is reached by all 32 lanes of the warp
// together (the sweep is warp-uniform: reverse_sweep); the lanes group by
// row (__match_any_sync, row -1: nothing to add), each group sums its
// values in registers by a shuffle tree over its members (log2 of the
// group's size rounds; group_sum), and its lowest lane adds the sums.
// add_rows adds them word by word: one atomic per word, row and warp,
// never a zero; kernel 2's sphere and triangle rows (TableAdds) and every
// kernel's material, light and par rows. Kernel 3's sphere and triangle
// rows go to global memory, where those scalar atomics queued on the rows
// most champions name (one H100 80GB HBM3, 700.00 W: 1.47-1.52 of the
// torus sweep's 2.81-2.86 ms went to sending them); there the lowest lane
// adds a hot triangle row into its warp's shared slab and sends every
// other row as 16- and 8-byte reductions (megakernel_champ.cu HotAdds:
// 1.27-1.29 ms).
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  unsigned peers;  // the lanes adding into this lane's row
  bool any;        // some lane of the warp adds (uniform)
};

__device__ __forceinline__ Rows rows_of(int row) {
  Rows r;
  r.any = __any_sync(kFull, row >= 0);
  r.peers = r.any ? __match_any_sync(kFull, row) : 0u;
  if (row < 0) r.peers = 0u;  // never the lowest lane of a group that adds
  return r;
}

// Sums v over each group of r by the shuffle tree; true on the lowest lane
// of a group that adds, which then holds the group's sums. Warp-uniform.
template <int N>
__device__ __forceinline__ bool group_sum(const Rows& r, float (&v)[N]) {
  if (!r.any) return false;
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
    // the odd ranks have been read for the last time
    higher &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  return r.peers != 0u && below == 0u;
}

template <int N>
__device__ __forceinline__ void add_rows(const Rows& r, float* p,
                                         float (&v)[N]) {
  if (group_sum(r, v)) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (v[k] != 0.0f) atomicAdd(p + k, v[k]);
  }
}

// Adds g into the 3 words at p of row `row` (-1: none), warp-uniform.
__device__ __forceinline__ void add_row3(float* p, int row, V3 g) {
  float v[3] = {g.x, g.y, g.z};
  add_rows(rows_of(row), p, v);
}

// The par cotangents of the warp's lanes into g_par, warp-uniform.
__device__ __forceinline__ void add_par(float* g_par, float (&gp)[kNPar]) {
  add_rows(rows_of(0), g_par, gp);
}

// Gradient buffers laid out like the tables: all in shared memory in
// kernel 2; kernel 2s points sph and tri at the global outputs past 64
// objects. The sweeps add the sphere and triangle rows through their
// `Adds` argument (kernel 3's HotAdds keeps its own pointers), the
// material, light and par rows here.
struct Grads {
  float* sph;
  float* tri;
  float* mat;
  float* lig;
  int wrt;
};

// Kernel 2's sphere and triangle row adds: add_rows into G.sph and G.tri.
// An Adds type has these two members, each called by all 32 lanes of the
// warp together with the lane's row (-1: none) and its cotangent words:
// sphere words 0-3 (centre, radius), triangle words 0-15 (n_geo, c1, c2,
// e1, e2, k) and 18-26 (vn0, vn1, vn2); and kLdg, how the sweep reads a
// triangle row (tri_row).
struct TableAdds {
  static constexpr bool kLdg = false;
  float* sph;
  float* tri;
  __device__ __forceinline__ void sphere(int row, float (&v)[4]) const {
    add_rows(rows_of(row), sph + row * kSph, v);
  }
  __device__ __forceinline__ void triangle(int row, float (&vt)[16],
                                           float (&vn)[9]) const {
    const Rows r = rows_of(row);
    add_rows(r, tri + row * kTri, vt);
    add_rows(r, tri + row * kTri + 18, vn);
  }
};

// One trace segment of the tape.
struct Seg {
  V3 o, d;
  V3 tp;  // throughput at the segment's start
  float t, beta, gamma;
  int obj;  // champion (sphere i, n_sph + triangle j); -1: no valid hit
  int m;    // material id (not stored: the champion row's)
  uint32_t occ;  // bit li: light li's shadow ray was occluded
};

// The tape of bounces + 1 segments, in a slab of shared memory sized at
// launch: kSegWords words per segment, laid out (segment, word, thread) so
// that the lanes of a warp touch consecutive words (no bank conflicts).
struct Tape {
  float* col;  // this thread's column of the block's slab
  int stride;  // threads per block
  __device__ __forceinline__ float& w(int s, int k) const {
    return col[(s * kSegWords + k) * stride];
  }
  __device__ __forceinline__ void put(int s, const Seg& q) const {
    w(s, 0) = q.o.x;
    w(s, 1) = q.o.y;
    w(s, 2) = q.o.z;
    w(s, 3) = q.d.x;
    w(s, 4) = q.d.y;
    w(s, 5) = q.d.z;
    w(s, 6) = q.tp.x;
    w(s, 7) = q.tp.y;
    w(s, 8) = q.tp.z;
    w(s, 9) = q.t;
    w(s, 10) = q.beta;
    w(s, 11) = q.gamma;
    w(s, 12) = __int_as_float(q.obj);
    w(s, 13) = __uint_as_float(q.occ);
  }
  __device__ __forceinline__ Seg get(const Tables& T, int s) const {
    Seg q;
    q.o = mk(w(s, 0), w(s, 1), w(s, 2));
    q.d = mk(w(s, 3), w(s, 4), w(s, 5));
    q.tp = mk(w(s, 6), w(s, 7), w(s, 8));
    q.t = w(s, 9);
    q.beta = w(s, 10);
    q.gamma = w(s, 11);
    q.obj = __float_as_int(w(s, 12));
    q.occ = __float_as_uint(w(s, 13));
    q.m = static_cast<int>(q.obj < T.n_sph
                               ? T.sph[q.obj * kSph + 4]
                               : T.tri[(q.obj - T.n_sph) * kTri + 16]);
    return q;
  }
};

// Shared-memory bytes of the tape slab of a block of `threads`.
__host__ __device__ inline size_t tape_bytes(int bounces, int threads) {
  return sizeof(float) * kSegWords * static_cast<size_t>(bounces + 1) *
         threads;
}

// Adjoint of Russian roulette's tp' = tp * (1 / p), p = clip(max(tp), 0.05,
// 1) (rr_survive, on a path that survived): from the cotangent gy of tp'
// to that of tp. dp/dtp follows JAX's rule at ties, which decides the main
// path (cornell's white and yellow albedos make tied channels common):
// jnp.maximum gives each of two equal arguments half the cotangent, and
// jnp.clip, a minimum of a maximum, half at a bound. So max(x, max(y, z))
// at x = y = z splits as (1/2, 1/4, 1/4).
__device__ __forceinline__ V3 rr_adj(V3 tp, V3 gy) {
  auto half = [](float a, float b) {  // d max(a, b) / da
    return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
  };
  const float m12 = fmaxf(tp.y, tp.z);
  const float m = fmaxf(tp.x, m12);
  const float lo = fmaxf(m, 0.05f);
  const float inv_p = 1.0f / fminf(lo, 1.0f);
  // dp/dm through max(m, 0.05) and min(lo, 1)
  const float dp = half(m, 0.05f) * half(1.0f, lo);
  const float w12 = half(m12, tp.x);
  // inv_p = 1 / p: d inv_p / dp = -inv_p^2
  const float gm = -dot(gy, tp) * inv_p * inv_p * dp;
  return mk(gy.x * inv_p + gm * half(tp.x, m12),
            gy.y * inv_p + gm * w12 * half(tp.y, tp.z),
            gy.z * inv_p + gm * w12 * half(tp.z, tp.y));
}

// A triangle row's words at r: n_geo, c1, c2, e1, e2 and k (0-15), and
// the vertex normals vn0, vn1, vn2 (18-26). kLdg: the row lies in global
// memory, 16-byte aligned (kernel 3), and is read in 16-byte loads through
// the read-only cache; else word by word (kernel 2's rows in shared
// memory).
struct TriRow {
  V3 ng, c1, c2, e1, e2;
  float k;
  V3 vn0, vn1, vn2;
};

template <bool kLdg>
__device__ __forceinline__ void tri_normals(const float* r, V3& vn0, V3& vn1,
                                            V3& vn2) {
  if constexpr (kLdg) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const float4 a4 = __ldg(r4 + 4), a5 = __ldg(r4 + 5), a6 = __ldg(r4 + 6);
    vn0 = mk(a4.z, a4.w, a5.x);
    vn1 = mk(a5.y, a5.z, a5.w);
    vn2 = mk(a6.x, a6.y, a6.z);
  } else {
    vn0 = ld3(r + 18);
    vn1 = ld3(r + 21);
    vn2 = ld3(r + 24);
  }
}

template <bool kLdg>
__device__ __forceinline__ TriRow tri_row(const float* r) {
  TriRow w;
  if constexpr (kLdg) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const float4 a0 = __ldg(r4), a1 = __ldg(r4 + 1), a2 = __ldg(r4 + 2),
                 a3 = __ldg(r4 + 3);
    w.ng = mk(a0.x, a0.y, a0.z);
    w.c1 = mk(a0.w, a1.x, a1.y);
    w.c2 = mk(a1.z, a1.w, a2.x);
    w.e1 = mk(a2.y, a2.z, a2.w);
    w.e2 = mk(a3.x, a3.y, a3.z);
    w.k = a3.w;
  } else {
    w.ng = ld3(r);
    w.c1 = ld3(r + 3);
    w.c2 = ld3(r + 6);
    w.e1 = ld3(r + 9);
    w.e2 = ld3(r + 12);
    w.k = r[15];
  }
  tri_normals<kLdg>(r, w.vn0, w.vn1, w.vn2);
  return w;
}

// Surface of a tape segment: hit point, unnormalised and unit normal.
template <bool kLdg>
__device__ __forceinline__ void surface(const Tables& T, const Seg& q, V3& hp,
                                        V3& nraw, V3& hn) {
  hp = q.o + q.t * q.d;
  if (q.obj < T.n_sph) {
    nraw = hp - ld3(T.sph + q.obj * kSph);
  } else {
    V3 vn0, vn1, vn2;
    tri_normals<kLdg>(T.tri + (q.obj - T.n_sph) * kTri, vn0, vn1, vn2);
    const float alpha = 1.0f - q.beta - q.gamma;
    nraw = alpha * vn0 + q.beta * vn1 + q.gamma * vn2;
  }
  hn = normalize(nraw);
}

// The champion rows' cotangents of one segment, added after the
// branches so that all lanes reach the add: ks the sphere (-1: none) with
// vs = (c, r); kt the triangle (-1: none) with vt = [n_geo, c1, c2, e1,
// e2, k] and vn = [vn0, vn1, vn2].
struct RowGrads {
  int ks, kt;
  float vs[4];
  float vt[16];
  float vn[9];
};

// Adjoint of the closest hit of segment q: from the cotangents of the hit
// point and unit normal to those of the segment's origin and direction,
// and the champion row's cotangent into R (groups in `wrt`); kLdg as
// tri_row's.
template <bool kLdg>
__device__ void trace_adj(const Tables& T, const Seg& q, V3 nraw, V3 ghp,
                          V3 ghn, int wrt, V3& go, V3& gd, RowGrads& R) {
  const V3 o = q.o, d = q.d;
  const float t = q.t;
  // hp = o + t d
  go = ghp;
  gd = t * ghp;
  float gt = dot(ghp, d);
  const V3 gnr = normalize_adj(nraw, ghn);
  if (q.obj < T.n_sph) {
    const float* s = T.sph + q.obj * kSph;
    const V3 c = ld3(s);
    const float r = s[3];
    // nraw = o + t d - c
    go = go + gnr;
    gd = gd + t * gnr;
    gt += dot(gnr, d);
    V3 gc = mk(-gnr.x, -gnr.y, -gnr.z);
    // t = (-b -+ sq) / (2a): sq = sqrt(dis), dis = b^2 - 4 a cq,
    // b = 2 m.d, cq = m.m - r^2, m = o - c, a = d.d
    const float a = dot(d, d);
    const float inv2a = 0.5f / a;
    const V3 m = o - c;
    const float b = 2.0f * dot(m, d);
    const float cq = dot(m, m) - r * r;
    const float dis = b * b - 4.0f * a * cq;
    const float sq = dis > 0.0f ? sqrtf(dis) : 0.0f;
    const float sgn = q.beta > 0.5f ? 1.0f : -1.0f;  // far root: +sq
    const float ginv2a = gt * (-b + sgn * sq);
    const float gsq = gt * sgn * inv2a;
    float gb = -gt * inv2a;
    const float gdis = dis > 0.0f ? gsq * 0.5f / sq : 0.0f;
    gb += gdis * 2.0f * b;
    const float ga = -4.0f * cq * gdis - ginv2a * 0.5f / (a * a);
    const float gcq = -4.0f * a * gdis;
    const V3 gm = (2.0f * gcq) * m + (2.0f * gb) * d;
    gd = gd + (2.0f * gb) * m + (2.0f * ga) * d;
    go = go + gm;
    gc = gc - gm;
    if (wrt & kWSph) {
      R.ks = q.obj;
      R.vs[0] = gc.x;
      R.vs[1] = gc.y;
      R.vs[2] = gc.z;
      R.vs[3] = -2.0f * r * gcq;
    }
    return;
  }
  const int j = q.obj - T.n_sph;
  const TriRow w = tri_row<kLdg>(T.tri + j * kTri);
  const V3 ng = w.ng, c1 = w.c1, c2 = w.c2, e1 = w.e1, e2 = w.e2;
  const V3 vn0 = w.vn0, vn1 = w.vn1, vn2 = w.vn2;
  const float beta = q.beta, gamma = q.gamma, alpha = 1.0f - beta - gamma;
  // nraw = alpha vn0 + beta vn1 + gamma vn2, alpha = 1 - beta - gamma
  const float g0 = dot(gnr, vn0);
  const float gbeta = dot(gnr, vn1) - g0;
  const float ggamma = dot(gnr, vn2) - g0;
  // beta = Nb / div, gamma = Ng / div, t = Nt / div
  const V3 oxd = cross(o, d);
  const float div = dot(ng, d);
  const float idiv = 1.0f / div;
  const float nb = dot(e2, oxd) - dot(c2, d);
  const float ngm = dot(c1, d) - dot(e1, oxd);
  const float nt = w.k - dot(ng, o);
  const float gidiv = gbeta * nb + ggamma * ngm + gt * nt;
  const float gnb = gbeta * idiv, gng = ggamma * idiv, gnt = gt * idiv;
  const float gdiv = -gidiv * idiv * idiv;
  const V3 goxd = gnb * e2 - gng * e1;
  gd = gd + gdiv * ng - gnb * c2 + gng * c1 + cross(goxd, o);
  go = go - gnt * ng + cross(d, goxd);
  if (wrt & kWTri) {
    const V3 v3[8] = {gdiv * d - gnt * o, gng * d,     -gnb * d,
                      -gng * oxd,         gnb * oxd,   alpha * gnr,
                      beta * gnr,         gamma * gnr};
    R.kt = j;
#pragma unroll
    for (int k = 0; k < 5; ++k) {  // n_geo, c1, c2, e1, e2
      R.vt[3 * k] = v3[k].x;
      R.vt[3 * k + 1] = v3[k].y;
      R.vt[3 * k + 2] = v3[k].z;
    }
    R.vt[15] = gnt;  // k
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // vn0, vn1, vn2
      R.vn[3 * k] = v3[5 + k].x;
      R.vn[3 * k + 1] = v3[5 + k].y;
      R.vn[3 * k + 2] = v3[5 + k].z;
    }
  }
}

// Adjoint of the camera chain (film point -> focal point -> thin lens ->
// normalize) from the primary ray's origin and direction cotangents into
// the par cotangents gp.
__device__ void camera_adj(const float* P, const Draws& D, int col, int row,
                           int samp, int spp, V3 go, V3 gd,
                           float (&gp)[kNPar]) {
  const V3 e = ld3(P + kEye), U = ld3(P + kU), V = ld3(P + kV),
           W = ld3(P + kW);
  const float colf = static_cast<float>(col) + 0.5f;
  const float rowf = static_cast<float>(row) + 0.5f;
  const float au = -0.5f + colf / P[kCols];
  const float av = 0.5f - rowf / P[kRows];
  const float su = au * P[kFilmW], sv = av * P[kFilmH];
  const V3 cr = su * U + sv * V - W;
  const V3 pd = normalize(cr);
  const float fl = P[kFocal];
  const V3 pip = e - fl * W;
  const float pipd = -dot(pip, W);
  const float den = dot(pd, W);
  const float tf = -(dot(e, W) + pipd) / den;
  const V3 fp = e + tf * pd;
  float u0, u1, lx, ly;
  lens_uv(D, samp, spp, u0, u1);
  concentric(u0, u1, lx, ly);
  const float lr = P[kLensR];
  const V3 lo = lx * U + ly * V;
  const V3 o = e + lr * lo;

  // d = normalize(fp - o)
  const V3 gdr = normalize_adj(fp - o, gd);
  go = go - gdr;
  // o = e + lr (lx U + ly V)
  V3 ge = go;
  const float glr = dot(go, lo);
  V3 gU = (lr * lx) * go, gV = (lr * ly) * go;
  // fp = e + tf pd
  ge = ge + gdr;
  const float gtf = dot(gdr, pd);
  V3 gpd = tf * gdr;
  // tf = num / den, num = -(e.W + pipd)
  const float gnum = gtf / den;
  const float gden = -gtf * tf / den;
  ge = ge - gnum * W;
  V3 gW = mk(-gnum * e.x, -gnum * e.y, -gnum * e.z);
  const float gpipd = -gnum;
  // pipd = -pip.W, pip = e - fl W
  const V3 gpip = mk(-gpipd * W.x, -gpipd * W.y, -gpipd * W.z);
  gW = gW - gpipd * pip - fl * gpip;
  ge = ge + gpip;
  const float gfl = -dot(gpip, W);
  // den = pd.W
  gpd = gpd + gden * W;
  gW = gW + gden * pd;
  // pd = normalize(su U + sv V - W)
  const V3 gcr = normalize_adj(cr, gpd);
  const float gsu = dot(gcr, U), gsv = dot(gcr, V);
  gU = gU + su * gcr;
  gV = gV + sv * gcr;
  gW = gW - gcr;
  gp[kEye + 0] += ge.x;
  gp[kEye + 1] += ge.y;
  gp[kEye + 2] += ge.z;
  gp[kU + 0] += gU.x;
  gp[kU + 1] += gU.y;
  gp[kU + 2] += gU.z;
  gp[kV + 0] += gV.x;
  gp[kV + 1] += gV.y;
  gp[kV + 2] += gV.z;
  gp[kW + 0] += gW.x;
  gp[kW + 1] += gW.y;
  gp[kW + 2] += gW.z;
  gp[kFilmW] += gsu * au;
  gp[kFilmH] += gsv * av;
  gp[kCols] += -gsu * P[kFilmW] * colf / (P[kCols] * P[kCols]);
  gp[kRows] += gsv * P[kFilmH] * rowf / (P[kRows] * P[kRows]);
  gp[kFocal] += gfl;
  gp[kLensR] += glr;
}

// The reverse sweep over a tape of nseg segments (segment 0 is the
// primary hit) for the accumulator cotangent g: per segment in reverse,
// the next segment's origin and direction through the bounce, the
// roulette's 1 / p (kRR, from depth rr_start on), the NEE terms and the
// albedo, then the closest hit into its champion row; last the camera
// chain into gp. Nothing here depends on how the tape was filled.
// Warp-uniform: every lane of the warp calls it (nseg = 0 for a lane
// without a path) and walks segments max(nseg) - 1 ... 0 under the
// predicate s < nseg, so all lanes reach every row add together.
template <bool kRR, class Adds>
__device__ void reverse_sweep(const Tables& T, const Draws& D, const Tape& tape,
                              int nseg, int col, int row, int samp, int spp,
                              int rr_start, V3 g, const Grads& G,
                              const Adds& A, float (&gp)[kNPar]) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  const bool geo = (G.wrt & (kWPar | kWSph | kWTri)) != 0;
  V3 gtp = mk(0.0f, 0.0f, 0.0f);   // cotangent of the throughput
  V3 go_n = gtp, gd_n = gtp;       // of the next segment's origin, direction
  for (int s = __reduce_max_sync(kFull, nseg) - 1; s >= 0; --s) {
    const bool live = s < nseg;
    Seg q;
    V3 hp, nraw, hn, al;
    V3 ghp = mk(0.0f, 0.0f, 0.0f), ghn = ghp, galb = ghp;
    Hit hq;
    if (live) {
      q = tape.get(T, s);
      surface<Adds::kLdg>(T, q, hp, nraw, hn);
      hq.p = hp;
      hq.n = hn;
      al = albedo(T, q.m);
    }
    if (live && geo && s + 1 < nseg) {
      // o' = hp + eps hn, d' = normalize(cx t + cy b + cz hn)
      float cx, cy, cz;
      V3 o2, d2, tx, bx;
      bounce_ray(D, bounce_slot(s, L, kRR), hq, eps, cx, cy, cz, o2, d2);
      tangent_frame(hn, tx, bx);
      const V3 gdr = normalize_adj(cx * tx + cy * bx + cz * hn, gd_n);
      ghn = ghn + cz * gdr + tangent_frame_adj(hn, cx * gdr, cy * gdr);
      ghp = ghp + go_n;
      ghn = ghn + eps * go_n;
      gp[kEps] += dot(go_n, hn);
    }
    if (kRR && live && s + 1 < nseg && s >= rr_start) {
      // segment s + 1 started from the throughput the roulette scaled:
      // gtp (of that) -> the cotangent of the throughput after the NEE
      V3 x = q.tp;
      for (int li = 0; li < L; ++li) x = mk(x.x * al.x, x.y * al.y, x.z * al.z);
      gtp = rr_adj(x, gtp);
    }
    // NEE terms in reverse light order
    for (int li = L - 1; li >= 0; --li) {
      const float* l = T.lig + li * kLig;
      // [pos, normal, irr] and [radius, area, tangent, bitangent]
      float v0[9] = {}, v1[8] = {};
      int key = -1;
      if (live) {
        V3 tpb = q.tp;  // throughput before this light's NEE
        for (int k = 0; k < li; ++k)
          tpb = mk(tpb.x * al.x, tpb.y * al.y, tpb.z * al.z);
        const bool free = ((q.occ >> li) & 1u) == 0u;
        float geom = 0.0f;
        const Shadow sh =
            shadow_ray(T, D, nee_slot(s, li, L, kRR), li, hq, eps);
        const V3 lp = ld3(l), ln = ld3(l + 3), irr = ld3(l + 6);
        const V3 qv = hp - lp;
        const float r2 = dot(qv, qv);
        const float rr = fmaxf(r2, 1e-20f);
        const float cxv = dot(sh.sd, hn), cyv = -dot(sh.sd, ln);
        const float cosx = fminf(fmaxf(cxv, 0.0f), 1.0f);
        const float cosy = fminf(fmaxf(cyv, 0.0f), 1.0f);
        if (free) geom = l[13] * cosx * cosy / rr;
        const V3 shd = geom * irr;
        // acc += tpb * al * shd; tp = tpb * al
        galb = galb + mk(gtp.x * tpb.x + g.x * tpb.x * shd.x,
                         gtp.y * tpb.y + g.y * tpb.y * shd.y,
                         gtp.z * tpb.z + g.z * tpb.z * shd.z);
        gtp = mk(gtp.x * al.x + g.x * al.x * shd.x,
                 gtp.y * al.y + g.y * al.y * shd.y,
                 gtp.z * al.z + g.z * al.z * shd.z);
        if (free && (geo || (G.wrt & kWLig))) {
          const V3 gsh = mk(g.x * tpb.x * al.x, g.y * tpb.y * al.y,
                            g.z * tpb.z * al.z);
          const float ggeom = dot(gsh, irr);
          const float garea = ggeom * cosx * cosy / rr;
          const float gcosx = ggeom * l[13] * cosy / rr;
          const float gcosy = ggeom * l[13] * cosx / rr;
          const float gr2 = r2 > 1e-20f ? -ggeom * geom / rr : 0.0f;
          const float gcx = (cxv > 0.0f && cxv < 1.0f) ? gcosx : 0.0f;
          const float gcy = (cyv > 0.0f && cyv < 1.0f) ? gcosy : 0.0f;
          const V3 gq = (2.0f * gr2) * qv;
          // sd = normalize(dl), dl = tgt - so, so = hp + eps hn
          const V3 gdl = normalize_adj(sh.dl, gcx * hn - gcy * ln);
          ghp = ghp + gq - gdl;
          ghn = ghn + gcx * sh.sd - eps * gdl;
          gp[kEps] -= dot(gdl, hn);
          if (G.wrt & kWLig) {
            // tgt = lp + rad (sx ta + sy ba)
            const float rad = l[12];
            const V3 ta = ld3(l + 14), ba = ld3(l + 17);
            const V3 v3[5] = {gdl - gq, -gcy * sh.sd, geom * gsh,
                              (sh.sx * rad) * gdl, (sh.sy * rad) * gdl};
#pragma unroll
            for (int k = 0; k < 3; ++k) {  // pos, normal, irr
              v0[3 * k] = v3[k].x;
              v0[3 * k + 1] = v3[k].y;
              v0[3 * k + 2] = v3[k].z;
            }
            v1[0] = dot(gdl, sh.sx * ta + sh.sy * ba);  // radius
            v1[1] = garea;
#pragma unroll
            for (int k = 0; k < 2; ++k) {  // tangent, bitangent
              v1[2 + 3 * k] = v3[3 + k].x;
              v1[3 + 3 * k] = v3[3 + k].y;
              v1[4 + 3 * k] = v3[3 + k].z;
            }
            key = li;
          }
        }
      }
      if (G.wrt & kWLig) {
        const Rows r = rows_of(key);
        add_rows(r, G.lig + li * kLig, v0);
        add_rows(r, G.lig + li * kLig + 12, v1);
      }
    }
    if (G.wrt & kWMat) {
      const bool add = live && q.m < T.n_mat;
      add_row3(G.mat + (add ? q.m : 0) * kMat, add ? q.m : -1, galb);
    }
    if (!geo) continue;
    RowGrads R = {};
    R.ks = R.kt = -1;
    if (live)
      trace_adj<Adds::kLdg>(T, q, nraw, ghp, ghn, G.wrt, go_n, gd_n, R);
    if (G.wrt & kWSph) A.sphere(R.ks, R.vs);
    if (G.wrt & kWTri) A.triangle(R.kt, R.vt, R.vn);
  }
  if (nseg > 0 && (G.wrt & kWPar))
    camera_adj(T.par, D, col, row, samp, spp, go_n, gd_n, gp);
}

// ---------------------------------------------------------------------------
// Direct mode (JAX's mode="direct": _tile_program's direct branch,
// megakernel_grad.py:795-829), which kernels 2 and 3 share: one segment,
// the primary hit, shaded per light by albedo * clip(ambient + (occluded ?
// 0 : clip(cos, 0, 1)), 0, 1) (no emitter term, throughput or bounce). Its
// adjoint has no tape: the segment's champion and occlusion bits stay in
// registers, and the sweep below runs once.
// ---------------------------------------------------------------------------

// Direct mode's draws of one ray, in u_planes_for_direct's layout (slot 0
// the lens, slot 1 + li light li): the u-planes, or threefry of slot j's
// key (direct_slot_key of the pass key) at counter 2 rid_g + c, as kernel
// 1's direct mode draws them.
struct DirectSlots {
  Draws D;               // the u-planes and this ray's column
  const uint32_t* keys;  // 2 words per slot (the PRNG route)
  uint32_t base;         // 2 rid_g
  __device__ __forceinline__ void pair(int j, float& u0, float& u1) const {
    if (D.u != nullptr) {
      D.pair(j, u0, u1);
      return;
    }
    u0 = threefry_uniform(keys[2 * j], keys[2 * j + 1], base);
    u1 = threefry_uniform(keys[2 * j], keys[2 * j + 1], base + 1u);
  }
  // Draws whose slot 0 is this ray's lens pair: what camera_ray and
  // camera_adj read
  __device__ __forceinline__ Draws lens() const {
    Draws L = D;
    if (D.u == nullptr) {
      L.k0 = keys[0];
      L.k1 = keys[1];
      L.base = base;
    }
    return L;
  }
};

__device__ __forceinline__ DirectSlots direct_slots(const Draws& D,
                                                    const uint32_t* keys,
                                                    int rid_g) {
  DirectSlots S;
  S.D = D;
  S.keys = keys;
  S.base = 2u * static_cast<uint32_t>(rid_g);
  return S;
}

// The adjoint of direct mode's shade of one ray for the accumulator
// cotangent g. q is the primary segment (o, d, champion, t, beta, gamma,
// material, one occlusion bit per light); live: the lane has a ray with a
// valid hit (a ray without one adds nothing). Per light: the albedo's
// cotangent, ambient's (the outer clip), and where the light is free the
// clipped cosine's through the shadow direction into the hit point, the
// normal, eps and the light's row (position, radius, tangent, bitangent);
// the shadow ray's length only selects, as in path mode. Then the albedo
// into the material row, the closest hit into its champion row and the
// camera chain into gp. Both clips split their cotangent at a bound as
// jnp.clip does (clip01_d): cornell's white albedo and an unoccluded cosine
// near 1 - ambient put rays there. Warp-uniform: every lane calls it.
template <class Adds>
__device__ void direct_sweep(const Tables& T, const DirectSlots& S,
                             const Seg& q, bool live, int col, int row,
                             int samp, int spp, V3 g, const Grads& G,
                             const Adds& A, float (&gp)[kNPar]) {
  const int L = T.n_lig;
  const float eps = T.par[kEps], ambient = T.par[kAmbient];
  const bool geo = (G.wrt & (kWPar | kWSph | kWTri)) != 0;
  V3 hp, nraw, hn, al;
  V3 ghp = mk(0.0f, 0.0f, 0.0f), ghn = ghp, galb = ghp;
  Hit hq;
  if (live) {
    surface<Adds::kLdg>(T, q, hp, nraw, hn);
    hq.p = hp;
    hq.n = hn;
    al = albedo(T, q.m);
  }
  for (int li = 0; li < L; ++li) {
    // [pos] and [radius, area, tangent, bitangent]
    float v0[3] = {}, v1[8] = {};
    int key = -1;
    if (live) {
      float u0, u1;
      S.pair(1 + li, u0, u1);
      const Shadow sh = shadow_ray_uv(T, u0, u1, li, hq, eps);
      const bool free = ((q.occ >> li) & 1u) == 0u;
      const float cxv = dot(sh.sd, hn);
      const float x = ambient + (free ? clip01(cxv) : 0.0f);
      const float shade = clip01(x);
      // acc += al * shade
      galb = galb + shade * g;
      const float gx = dot(g, al) * clip01_d(x);
      gp[kAmbient] += gx;
      if (free && (geo || (G.wrt & kWLig))) {
        // sd = normalize(dl), dl = tgt - so, so = hp + eps hn
        const float gc = gx * clip01_d(cxv);
        const V3 gdl = normalize_adj(sh.dl, gc * hn);
        ghp = ghp - gdl;
        ghn = ghn + gc * sh.sd - eps * gdl;
        gp[kEps] -= dot(gdl, hn);
        if (G.wrt & kWLig) {
          // tgt = lp + rad (sx ta + sy ba)
          const float* l = T.lig + li * kLig;
          const float rad = l[12];
          const V3 ta = ld3(l + 14), ba = ld3(l + 17);
          const V3 gta = (sh.sx * rad) * gdl, gba = (sh.sy * rad) * gdl;
          v0[0] = gdl.x;
          v0[1] = gdl.y;
          v0[2] = gdl.z;
          v1[0] = dot(gdl, sh.sx * ta + sh.sy * ba);
          v1[2] = gta.x;
          v1[3] = gta.y;
          v1[4] = gta.z;
          v1[5] = gba.x;
          v1[6] = gba.y;
          v1[7] = gba.z;
          key = li;
        }
      }
    }
    if (G.wrt & kWLig) {
      const Rows r = rows_of(key);
      add_rows(r, G.lig + li * kLig, v0);
      add_rows(r, G.lig + li * kLig + 12, v1);
    }
  }
  if (G.wrt & kWMat) {
    const bool add = live && q.m < T.n_mat;
    add_row3(G.mat + (add ? q.m : 0) * kMat, add ? q.m : -1, galb);
  }
  if (!geo) return;
  RowGrads R = {};
  R.ks = R.kt = -1;
  V3 go = mk(0.0f, 0.0f, 0.0f), gd = go;
  if (live) trace_adj<Adds::kLdg>(T, q, nraw, ghp, ghn, G.wrt, go, gd, R);
  if (G.wrt & kWSph) A.sphere(R.ks, R.vs);
  if (G.wrt & kWTri) A.triangle(R.kt, R.vt, R.vn);
  if (live && (G.wrt & kWPar))
    camera_adj(T.par, S.lens(), col, row, samp, spp, go, gd, gp);
}

// ---------------------------------------------------------------------------
// The launch side that kernels 2, 2s and 3 share.
// ---------------------------------------------------------------------------

// One adjoint launch's parameters: the tables, the cotangent g of acc, the
// draws, the pass's settings and the outputs. bw and tau are kernel 2s's
// soft bandwidth and depth temperature, ids and occs kernel 3's record of
// the pass (kernel 1's); each kernel reads only its own.
struct AdjParams {
  const float* par;
  const float* sph;
  const float* tri;
  const float* mat;
  const float* lig;
  int n_sph, n_tri, n_mat, n_lig;
  const float* g;  // (n_rays, 3) cotangent of acc
  const int* ids;  // (1 + bounces, n_rays)
  const uint8_t* occs;  // ((1 + bounces) * n_lig, n_rays)
  int n_rays;
  int ray_offset;
  const float* u;  // (2 * n_draws, n_rays) or nullptr
  uint32_t k0, k1;  // pass key of the PRNG route
  int spp, width, bounces;
  int rr_start;  // first depth of the roulette (instances with kRR)
  int two_sided, normalize_emitter;
  int wrt;
  float bw, tau;
  // direct mode's slot keys of the pass key (set_direct_keys): slot 0 the
  // lens, slot 1 + li light li
  uint32_t dkeys[2 * (1 + kMaxLights)];
  float* dpar;
  float* dsph;
  float* dtri;
  float* dmat;
  float* dlig;
};

// The launch's parameters from the C interfaces' common arguments (ids,
// occs, bw and tau zero).
inline AdjParams adj_params(const float* par, const float* sph, int n_sph,
                            const float* tri, int n_tri, const float* mat,
                            int n_mat, const float* lig, int n_lig,
                            const float* g, int n_rays, int ray_offset,
                            const float* u_planes, unsigned int k0,
                            unsigned int k1, int spp, int width, int bounces,
                            int rr_start_depth, int two_sided,
                            int normalize_emitter, int wrt, float* dpar,
                            float* dsph, float* dtri, float* dmat,
                            float* dlig) {
  AdjParams p = {};
  p.par = par;
  p.sph = sph;
  p.tri = tri;
  p.mat = mat;
  p.lig = lig;
  p.n_sph = n_sph;
  p.n_tri = n_tri;
  p.n_mat = n_mat;
  p.n_lig = n_lig;
  p.g = g;
  p.n_rays = n_rays;
  p.ray_offset = ray_offset;
  p.u = u_planes;
  p.k0 = k0;
  p.k1 = k1;
  p.spp = spp;
  p.width = width;
  p.bounces = bounces;
  p.rr_start = rr_start_depth;
  p.two_sided = two_sided;
  p.normalize_emitter = normalize_emitter;
  p.wrt = wrt;
  p.dpar = dpar;
  p.dsph = dsph;
  p.dtri = dtri;
  p.dmat = dmat;
  p.dlig = dlig;
  return p;
}

// Direct mode's slot keys into p.dkeys, derived on the host from the pass
// key (k0, k1) as kernel 1's direct mode derives them in-kernel.
inline void set_direct_keys(AdjParams& p) {
  for (int j = 0; j <= p.n_lig; ++j) {
    uint32_t k0 = p.k0, k1 = p.k1;
    direct_slot_key(k0, k1, j);
    p.dkeys[2 * j] = k0;
    p.dkeys[2 * j + 1] = k1;
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.0f;
}

// Adds the block's `copies` gradient buffers (`stride` floats apart) at
// src into dst: one atomicAdd per nonzero word.
__device__ __forceinline__ void flush(float* dst, const float* src, int n,
                                      int stride = 0, int copies = 1) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < copies; ++w) v += src[w * stride + i];
    if (v != 0.0f) atomicAdd(dst + i, v);
  }
}

// The block's rays in a grid-stride loop in steps of whole warps, so the
// lanes of a warp stay together (a lane past the end or with g = 0 runs
// inactive): f(D, active, rid_g, g) for each, with D the ray's draws
// (D.rid its index in the launch) and rid_g its index in the pass.
template <bool kRR, class F>
__device__ __forceinline__ void for_rays(const AdjParams& p, F&& f) {
  const int n_draws = n_draws_of(p.n_lig, p.bounces, kRR);
  const int lane = threadIdx.x & 31;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x - lane;
       base < p.n_rays; base += gridDim.x * blockDim.x) {
    const int rid = base + lane;
    V3 g = mk(0.0f, 0.0f, 0.0f);
    if (rid < p.n_rays) {
      const float* gr = p.g + 3 * static_cast<size_t>(rid);
      g = mk(gr[0], gr[1], gr[2]);
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
    f(D, active, rid_g, g);
  }
}

// Launch geometry of a grid-stride kernel of `block` threads: a grid the
// card holds at once (each block flushes its buffers once), after opting
// into `smem` bytes of dynamic shared memory.
template <class Kernel>
inline cudaError_t fit_grid(Kernel kernel, int block, size_t smem,
                            int n_rays, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        block, smem);
  const long long need = (static_cast<long long>(n_rays) + block - 1) / block;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  grid = static_cast<int>(need < fit ? need : fit);
  return err;
}

}  // namespace rt
