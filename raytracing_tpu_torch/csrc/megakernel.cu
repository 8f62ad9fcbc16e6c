// The whole progressive path-tracing pass as one CUDA kernel for Hopper
// (sm_90a), K passes per launch.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel.py::_render_pass_kernel
// (launcher pathtrace_pass_pallas), path mode over unrolled tables with
// u-planes or PRNG draws and spp >= 1. Its other modes (Russian roulette,
// direct, streamed chunks, grids, blocked layout, recording) are not here.
//
// Per ray it runs the same schedule as the Pallas kernel: pixel decode from
// the global ray id, film point -> focal point -> thin-lens ray, scene-AABB
// clip, closest hit over spheres and triangles (inline vertex-normal
// interpolation), emitter hit on the primary segment, next-event
// estimation with one shadow ray per disk light, then `bounces` rounds of
// cosine bounce + closest hit + NEE, accumulated into acc. The guarded
// values are those of the Pallas kernel's jnp.where guards (the
// safe-normalize guard, den == 0, d2 > 0, and the light-centre geometric
// term, a reference quirk kept).
//
// What bounds it on this card: FP32 ALU work, branches and warp
// divergence, not bytes. A launch moves 12 B/ray of accumulator each way
// (plus 8 B per draw slot in u-planes mode) against ~12 object tests of
// ~40 flops per segment and ~12 segments per pass. Measured on one H100
// 80GB HBM3 (700 W): 0.63 ms per cornell 1024x1024 b5 pass, at most 36%
// of the FP32 peak by the JAX tile program's op count, so instruction
// throughput and divergence, not the ALUs alone, set the pace (not yet
// profiled).
// The design follows from that:
//   * one thread per ray over a flat 1-D grid, no tiles: the TPU's
//     vector-wide masking becomes per-ray branches, so a dead path stops
//     at once and a shadow ray stops at its first hit;
//   * the scene tables (<= ~11 KB) are copied into shared memory once per
//     block; every thread of a warp reads the same word, a broadcast;
//   * acc lives in registers across the K passes of a launch;
//   * the draws are made in-kernel by threefry2x32 (threefry.cuh), so
//     PRNG mode reads no draw bytes and equals the JAX package's
//     u_planes_for_pass bit for bit.
// Built with nvcc's default --fmad=true: contracted multiply-adds round
// differently from the unfused plain PyTorch version, so the two agree to
// float tolerance except where a ray sits within rounding of a silhouette
// or seam and picks another surface.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMaxPasses = 64;  // pass keys carried in the parameter block
constexpr int kNPar = 26;
constexpr int kSph = 8;
constexpr int kTri = 32;
constexpr int kMat = 4;
constexpr int kLig = 20;
// par layout (the JAX kernel's _PAR)
constexpr int kEye = 0, kU = 3, kV = 6, kW = 9, kFilmW = 12, kFilmH = 13,
              kCols = 14, kRows = 15, kFocal = 16, kLensR = 17, kPmin = 18,
              kPmax = 21, kEps = 24;
constexpr float kPi4 = 0.785398163397448309616f;
constexpr float kPi2 = 1.57079632679489661923f;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r = {x, y, z};
  return r;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return mk(s * a.x, s * a.y, s * a.z);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }
// safe normalize: guard the squared norm before rsqrt
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n2 = dot(v, v);
  const float inv = rsqrtf(n2 > 0.0f ? n2 : 1.0f);
  return mk(v.x * inv, v.y * inv, v.z * inv);
}

// Shirley-Chiu concentric square -> disk; (0, 0) maps to itself.
__device__ __forceinline__ void concentric(float u0, float u1, float& x,
                                           float& y) {
  if (u0 == 0.0f && u1 == 0.0f) {
    x = u0;
    y = u1;
    return;
  }
  const float a = 2.0f * u0 - 1.0f;
  const float b = 2.0f * u1 - 1.0f;
  float radius, phi;
  if (a * a > b * b) {
    radius = a;
    phi = kPi4 * (b / (a == 0.0f ? 1.0f : a));
  } else {
    radius = b;
    phi = kPi2 - kPi4 * (a / (b == 0.0f ? 1.0f : b));
  }
  x = cosf(phi) * radius;
  y = sinf(phi) * radius;
}

// min-|component| tangent frame, ties toward x
__device__ __forceinline__ void tangent_frame(V3 n, V3& t, V3& b) {
  const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  const float mn = fminf(ax, fminf(ay, az));
  const bool fx = ax == mn;
  const bool fy = (ay == mn) && !fx;
  const bool fz = (az == mn) && !fx && !fy;
  const V3 v = normalize(mk(fx ? 1.0f : n.x, fy ? 1.0f : n.y,
                            fz ? 1.0f : n.z));
  t = normalize(cross(v, n));
  b = normalize(cross(n, t));
}

// The scene tables in shared memory.
struct Tables {
  const float* par;
  const float* sph;
  const float* tri;
  const float* mat;
  const float* lig;
  int n_sph, n_tri, n_mat, n_lig;
  bool two_sided;
};

struct Hit {
  V3 p, n;
  float m;  // material id as float, -1 = no hit
};

// Draw slot j of this ray: from the u-planes (plane 2j + c, column rid) or
// from threefry at counter (global_rid * n_draws + j) * 2 + c.
struct Draws {
  const float* u;
  int n_rays;
  int rid;
  uint32_t k0, k1;
  uint32_t base;  // global_rid * n_draws * 2
  __device__ __forceinline__ void pair(int j, float& u0, float& u1) const {
    if (u != nullptr) {
      u0 = __ldg(u + static_cast<size_t>(2 * j) * n_rays + rid);
      u1 = __ldg(u + static_cast<size_t>(2 * j + 1) * n_rays + rid);
    } else {
      const uint32_t c = base + 2u * static_cast<uint32_t>(j);
      u0 = rt::threefry_uniform(k0, k1, c);
      u1 = rt::threefry_uniform(k0, k1, c + 1u);
    }
  }
};

// Closest hit in [mint, maxt] (strict `t < best` champion); returns the
// new maxt (champion t, or maxt on a miss).
__device__ float trace(const Tables& T, V3 o, V3 d, float mint, float maxt,
                       Hit& h) {
  float bt = inf_f();
  V3 bn = mk(0.0f, 0.0f, 0.0f);
  float bm = -1.0f;
  if (mint != maxt) {
    const float a = dot(d, d);
    const float inv2a = 0.5f / a;
    for (int i = 0; i < T.n_sph; ++i) {
      const float* s = T.sph + i * kSph;
      if (!(s[5] > 0.0f)) continue;
      const V3 c = ld3(s);
      const float r = s[3];
      const V3 m = o - c;
      const float b = 2.0f * dot(m, d);
      const float cq = dot(m, m) - r * r;
      const float dis = b * b - 4.0f * a * cq;
      if (!(dis >= 0.0f)) continue;
      const float sq = sqrtf(dis);
      const float t0 = (-b - sq) * inv2a;
      const float t1 = (-b + sq) * inv2a;
      const float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
      float t;
      if (tmn >= mint && tmn <= maxt) {
        t = tmn;
      } else if (tmx >= mint && tmx <= maxt) {
        t = tmx;
      } else {
        continue;
      }
      if (t < bt) {
        bt = t;
        bn = normalize(o + t * d - c);
        bm = s[4];
      }
    }
    const V3 oxd = cross(o, d);  // loop-invariant over triangles
    for (int i = 0; i < T.n_tri; ++i) {
      const float* q = T.tri + i * kTri;
      if (!(q[17] > 0.0f)) continue;
      const V3 ng = ld3(q);
      const float div = dot(ng, d);
      if (T.two_sided ? !(div != 0.0f) : !(div > 0.0f)) continue;
      const float idiv = 1.0f / div;
      // constant-split Moller-Trumbore over [n_geo, c1, c2, e1, e2, k]
      const float beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
      const float gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
      const float t = (q[15] - dot(ng, o)) * idiv;
      if (beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
          beta + gamma <= 1.0f && t >= mint && t <= maxt && t < bt) {
        const float alpha = 1.0f - beta - gamma;
        bn = normalize(alpha * ld3(q + 18) + beta * ld3(q + 21) +
                       gamma * ld3(q + 24));
        bt = t;
        bm = q[16];
      }
    }
  }
  const bool found = bm >= 0.0f;
  const float ts = found ? bt : 0.0f;
  h.p = o + ts * d;
  h.n = bn;
  h.m = bm;
  return found ? bt : maxt;
}

// Occlusion of the segment [mint, maxt]; stops at the first hit.
__device__ bool anyhit(const Tables& T, V3 o, V3 d, float mint, float maxt) {
  if (mint == maxt) return false;
  const float a = dot(d, d);
  const float inv2a = 0.5f / a;
  for (int i = 0; i < T.n_sph; ++i) {
    const float* s = T.sph + i * kSph;
    if (!(s[5] > 0.0f)) continue;
    const V3 m = o - ld3(s);
    const float r = s[3];
    const float b = 2.0f * dot(m, d);
    const float cq = dot(m, m) - r * r;
    const float dis = b * b - 4.0f * a * cq;
    if (!(dis >= 0.0f)) continue;
    const float sq = sqrtf(dis);
    const float t0 = (-b - sq) * inv2a;
    const float t1 = (-b + sq) * inv2a;
    const float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
    if ((tmn >= mint && tmn <= maxt) || (tmx >= mint && tmx <= maxt))
      return true;
  }
  const V3 oxd = cross(o, d);
  for (int i = 0; i < T.n_tri; ++i) {
    const float* q = T.tri + i * kTri;
    if (!(q[17] > 0.0f)) continue;
    const V3 ng = ld3(q);
    const float div = dot(ng, d);
    if (T.two_sided ? !(div != 0.0f) : !(div > 0.0f)) continue;
    const float idiv = 1.0f / div;
    const float beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
    const float gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
    const float t = (q[15] - dot(ng, o)) * idiv;
    if (beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
        beta + gamma <= 1.0f && t >= mint && t <= maxt)
      return true;
  }
  return false;
}

struct Acc {
  float r, g, b;     // accumulated radiance
  float tr, tg, tb;  // path throughput of the current pass
};

// Next-event estimation for light li with draw slot `slot`: shadow ray to
// a sampled disk point, shade with the pre-update throughput, then
// throughput *= albedo. A hit with no valid material adds nothing.
__device__ __forceinline__ void nee(const Tables& T, const Draws& D, int slot,
                                    int li, const Hit& h, float eps, Acc& A) {
  if (!(h.m >= 0.0f)) return;
  const float* l = T.lig + li * kLig;
  float u0, u1;
  D.pair(slot, u0, u1);
  float sx, sy;
  concentric(u0, u1, sx, sy);
  const float rad = l[12];
  sx = sx * rad;
  sy = sy * rad;
  const V3 lp = ld3(l), ln = ld3(l + 3);
  const V3 tgt = lp + sx * ld3(l + 14) + sy * ld3(l + 17);
  const V3 so = h.p + eps * h.n;
  const V3 dl = tgt - so;
  const float d2 = dot(dl, dl);
  const float dist = d2 > 0.0f ? sqrtf(d2) : 0.0f;
  const V3 sd = normalize(dl);
  const bool occ = anyhit(T, so, sd, 0.0f, dist);
  // geometric term with the distance to the light CENTRE (reference quirk)
  const V3 q = h.p - lp;
  const float r2 = dot(q, q);
  const float cosx = fminf(fmaxf(dot(sd, h.n), 0.0f), 1.0f);
  const float cosy = fminf(fmaxf(-dot(sd, ln), 0.0f), 1.0f);
  const float geom = l[13] * cosx * cosy / fmaxf(r2, 1e-20f);
  const int m = static_cast<int>(h.m);
  float alr = 0.0f, alg = 0.0f, alb = 0.0f;
  if (m < T.n_mat) {
    alr = T.mat[m * kMat + 0];
    alg = T.mat[m * kMat + 1];
    alb = T.mat[m * kMat + 2];
  }
  if (!occ) {
    A.r = A.r + A.tr * alr * (geom * l[6]);
    A.g = A.g + A.tg * alg * (geom * l[7]);
    A.b = A.b + A.tb * alb * (geom * l[8]);
  }
  A.tr = A.tr * alr;
  A.tg = A.tg * alg;
  A.tb = A.tb * alb;
}

// One progressive pass of ray rid_g, added into A.r/g/b.
__device__ void one_pass(const Tables& T, const Draws& D, int rid_g, int spp,
                         int width, int bounces, bool normalize_emitter,
                         Acc& A) {
  const float* P = T.par;
  const int L = T.n_lig;
  const int pix = rid_g / spp;
  const int samp = rid_g - pix * spp;
  const int row = pix / width;
  const int col = pix - row * width;
  const V3 e = ld3(P + kEye), U = ld3(P + kU), V = ld3(P + kV),
           W = ld3(P + kW);
  const float eps = P[kEps];

  // film point -> pinhole direction -> focal point
  const float su = (-0.5f + (static_cast<float>(col) + 0.5f) / P[kCols]) *
                   P[kFilmW];
  const float sv = (0.5f - (static_cast<float>(row) + 0.5f) / P[kRows]) *
                   P[kFilmH];
  const V3 pd = normalize(su * U + sv * V - W);
  const float fl = P[kFocal];
  const float pipd = -dot(e - fl * W, W);
  const float tf = -(dot(e, W) + pipd) / dot(pd, W);
  const V3 fp = e + tf * pd;

  // thin-lens origin and direction; spp > 1 uses the stratified lens-cell
  // centre and leaves draw slot 0 unused
  float u0, u1;
  if (spp > 1) {
    const int k = static_cast<int>(sqrtf(static_cast<float>(spp)) + 0.5f);
    const int si = samp / k;
    const int sj = samp - si * k;
    u0 = (static_cast<float>(sj) + 0.5f) / static_cast<float>(k);
    u1 = (static_cast<float>(si) + 0.5f) / static_cast<float>(k);
  } else {
    D.pair(0, u0, u1);
  }
  float lx, ly;
  concentric(u0, u1, lx, ly);
  const float lr = P[kLensR];
  V3 o = e + lr * (lx * U + ly * V);
  V3 d = normalize(fp - o);

  // clip to the scene AABB
  const float ox[3] = {o.x, o.y, o.z}, dx[3] = {d.x, d.y, d.z};
  float nr[3], fr[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float sd = dx[ax] == 0.0f ? 1e-30f : dx[ax];
    const float t0 = (P[kPmin + ax] - ox[ax]) / sd;
    const float t1 = (P[kPmax + ax] - ox[ax]) / sd;
    nr[ax] = fminf(t0, t1);
    fr[ax] = fmaxf(t0, t1);
  }
  const float tmin = fmaxf(fmaxf(nr[0], fmaxf(nr[1], nr[2])), 0.0f);
  const float tmax = fminf(fr[0], fminf(fr[1], fr[2]));
  float mint = inf_f(), maxt = inf_f();
  if (tmin <= tmax) {
    mint = tmin;
    maxt = tmax;
  }

  Hit h;
  maxt = trace(T, o, d, mint, maxt, h);

  // emitter hits on the primary segment only; a hit ends the path
  for (int li = 0; li < L && mint != maxt; ++li) {
    const float* l = T.lig + li * kLig;
    const V3 lp = ld3(l), ln = ld3(l + 3);
    const float den = dot(d, ln);
    const float num = dot(lp - o, ln);
    const float t = num / (den == 0.0f ? 1.0f : den);
    const V3 q = o + t * d - lp;
    const bool on_disk = dot(q, q) <= l[12] * l[12];
    if (den != 0.0f && num != 0.0f && on_disk && t < inf_f() && t >= mint &&
        t < maxt) {
      const float* irr = l + (normalize_emitter ? 9 : 6);
      A.r = A.r + irr[0];
      A.g = A.g + irr[1];
      A.b = A.b + irr[2];
      mint = inf_f();
      maxt = inf_f();
      h.m = -1.0f;
    }
  }

  A.tr = A.tg = A.tb = 1.0f;
  for (int li = 0; li < L; ++li) nee(T, D, 1 + li, li, h, eps, A);

  for (int depth = 0; depth < bounces; ++depth) {
    // a path without a valid hit stays dead: nothing more accumulates
    if (!(h.m >= 0.0f)) break;
    const int slot = 1 + L + depth * (1 + L);
    V3 tx, bx;
    tangent_frame(h.n, tx, bx);
    D.pair(slot, u0, u1);
    float cx, cy;
    concentric(u0, u1, cx, cy);
    const float cz = sqrtf(fmaxf(0.0f, 1.0f - cx * cx - cy * cy));
    d = normalize(cx * tx + cy * bx + cz * h.n);
    o = h.p + eps * h.n;
    trace(T, o, d, 0.0f, inf_f(), h);
    for (int li = 0; li < L; ++li) nee(T, D, slot + 1 + li, li, h, eps, A);
  }
}

struct Params {
  const float* par;
  const float* sph;
  const float* tri;
  const float* mat;
  const float* lig;
  int n_sph, n_tri, n_mat, n_lig;
  float* acc;  // (n_rays, 3), read once and written once
  int n_rays;
  int ray_offset;
  const float* u;  // (2 * n_draws, n_rays) or nullptr
  int n_passes;
  uint32_t keys[2 * kMaxPasses];  // pass keys of the PRNG route
  int spp, width, bounces;
  int two_sided, normalize_emitter;
};

__device__ __forceinline__ void copy_table(float* dst, const float* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Params is __grid_constant__: the per-pass key reads index the parameter
// block in place instead of copying it to each thread's stack.
__global__ void __launch_bounds__(kBlock)
    pathtrace_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  float* s_par = smem;
  float* s_sph = s_par + kNPar;
  float* s_tri = s_sph + kSph * p.n_sph;
  float* s_mat = s_tri + kTri * p.n_tri;
  float* s_lig = s_mat + kMat * p.n_mat;
  copy_table(s_par, p.par, kNPar);
  copy_table(s_sph, p.sph, kSph * p.n_sph);
  copy_table(s_tri, p.tri, kTri * p.n_tri);
  copy_table(s_mat, p.mat, kMat * p.n_mat);
  copy_table(s_lig, p.lig, kLig * p.n_lig);
  __syncthreads();

  const int rid = blockIdx.x * blockDim.x + threadIdx.x;
  if (rid >= p.n_rays) return;

  Tables T;
  T.par = s_par;
  T.sph = s_sph;
  T.tri = s_tri;
  T.mat = s_mat;
  T.lig = s_lig;
  T.n_sph = p.n_sph;
  T.n_tri = p.n_tri;
  T.n_mat = p.n_mat;
  T.n_lig = p.n_lig;
  T.two_sided = p.two_sided != 0;

  const int rid_g = rid + p.ray_offset;
  const int n_draws = 1 + p.n_lig + p.bounces * (1 + p.n_lig);
  Draws D;
  D.u = p.u;
  D.n_rays = p.n_rays;
  D.rid = rid;
  D.k0 = D.k1 = 0u;
  D.base = static_cast<uint32_t>(rid_g) * static_cast<uint32_t>(2 * n_draws);

  float* a = p.acc + 3 * static_cast<size_t>(rid);
  Acc A;
  A.r = a[0];
  A.g = a[1];
  A.b = a[2];
  for (int k = 0; k < p.n_passes; ++k) {
    if (p.u == nullptr) {
      D.k0 = p.keys[2 * k];
      D.k1 = p.keys[2 * k + 1];
    }
    one_pass(T, D, rid_g, p.spp, p.width, p.bounces,
             p.normalize_emitter != 0, A);
  }
  a[0] = A.r;
  a[1] = A.g;
  a[2] = A.b;
}

}  // namespace

// C interface (bound with ctypes). `keys` is a HOST array of n_passes pass
// keys (ignored with u_planes), copied into the launch's parameters.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int rt_pathtrace_pass(const float* par, const float* sph, int n_sph,
                                 const float* tri, int n_tri, const float* mat,
                                 int n_mat, const float* lig, int n_lig,
                                 float* acc, int n_rays, int ray_offset,
                                 const float* u_planes, const uint32_t* keys,
                                 int n_passes, int spp, int width, int bounces,
                                 int two_sided, int normalize_emitter,
                                 void* stream) {
  if (n_passes < 1 || n_passes > kMaxPasses || (u_planes && n_passes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.par = par;
  p.sph = sph;
  p.tri = tri;
  p.mat = mat;
  p.lig = lig;
  p.n_sph = n_sph;
  p.n_tri = n_tri;
  p.n_mat = n_mat;
  p.n_lig = n_lig;
  p.acc = acc;
  p.n_rays = n_rays;
  p.ray_offset = ray_offset;
  p.u = u_planes;
  p.n_passes = n_passes;
  for (int i = 0; i < 2 * kMaxPasses; ++i)
    p.keys[i] = (keys != nullptr && i < 2 * n_passes) ? keys[i] : 0u;
  p.spp = spp;
  p.width = width;
  p.bounces = bounces;
  p.two_sided = two_sided;
  p.normalize_emitter = normalize_emitter;
  const size_t smem = sizeof(float) * (kNPar + kSph * n_sph + kTri * n_tri +
                                       kMat * n_mat + kLig * n_lig);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  pathtrace_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
