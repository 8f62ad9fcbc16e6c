// The whole progressive path-tracing pass as one CUDA kernel for Hopper
// (sm_90a), K passes per launch.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel.py::_render_pass_kernel
// (launcher pathtrace_pass_pallas), path mode over resident tables with
// u-planes or PRNG draws and spp >= 1, and its champion recording
// (record=True) for the cell backward. Its other modes (Russian roulette,
// direct, streamed chunks, grids, blocked layout) are not here.
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
//   * the scene tables are copied into shared memory once per block and
//     looped over; every thread of a warp reads the same word, a
//     broadcast. Up to 4608 spheres stay resident, as JAX's kernel keeps
//     36K floats in SMEM: sphere_field(1024) takes 32 KB, cornell ~1.4 KB.
//     Above 48 KB the launch opts into dynamic shared memory (at most
//     227 KB on the H100). The other choice, reading sphere rows through
//     __ldg from global memory and L1, was not taken: it adds a latency
//     per row to the loop that a broadcast from shared memory does not
//     have, while the large-table cost (~147 KB at 4608 spheres, one
//     128-thread block per SM) falls only on scenes past sphere_field's
//     size, which no main path runs;
//   * acc lives in registers across the K passes of a launch;
//   * the draws are made in-kernel by threefry2x32 (threefry.cuh), so
//     PRNG mode reads no draw bytes and equals the JAX package's
//     u_planes_for_pass bit for bit;
//   * recording (non-null ids) writes each segment's champion right after
//     its trace and each NEE occlusion bit, 4 B + L B per segment and ray,
//     coalesced across a warp; a path that dies still writes a miss into
//     its remaining slots, so no slot keeps a stale value. The arithmetic
//     is that of the non-recording launch (one binary, a runtime pointer),
//     so the two accumulators are bit-equal.
// Built with nvcc's default --fmad=true: contracted multiply-adds round
// differently from the unfused plain PyTorch version, so the two agree to
// float tolerance except where a ray sits within rounding of a silhouette
// or seam and picks another surface, or grazes a sphere, where the
// discriminant cancels: 0.002861% of rays beyond 2e-4 on cornell at
// 1024^2 b5, 1.35-2.32% on sphere fields (256 and 1024 spheres, 256x192
// and 1024^2 b5), where 0.07-0.35% of the recorded champions differ (on
// one H100 80GB HBM3, 700 W). A --fmad=false build equals the plain
// version there on every ray and champion, 11-15% slower (chip_smoke.py
// phase 11 checks both builds).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace.cuh"

namespace {

using namespace rt;

constexpr int kBlock = 128;
constexpr int kMaxPasses = 64;  // pass keys carried in the parameter block

struct Acc {
  float r, g, b;     // accumulated radiance
  float tr, tg, tb;  // path throughput of the current pass
};

// The champion record of one ray (null ids: not recording): ids (n_seg,
// n_rays) int32 and occs (n_seg * L, n_rays) bytes, in schedule order.
struct Rec {
  int* ids;
  uint8_t* occs;
  int n_rays, rid;
  __device__ __forceinline__ void id(int s, int obj) const {
    if (ids != nullptr) ids[static_cast<size_t>(s) * n_rays + rid] = obj;
  }
  __device__ __forceinline__ void occ(int k, bool o) const {
    if (occs != nullptr)
      occs[static_cast<size_t>(k) * n_rays + rid] = o ? 1 : 0;
  }
};

// Next-event estimation for light li with draw slot `slot`: shadow ray to
// a sampled disk point, shade with the pre-update throughput, then
// throughput *= albedo. A hit with no valid material adds nothing.
// Returns the occlusion bit (false without a valid hit, as JAX's dead
// window gives).
__device__ __forceinline__ bool nee(const Tables& T, const Draws& D, int slot,
                                    int li, const Hit& h, float eps, Acc& A) {
  if (!(h.m >= 0.0f)) return false;
  const float* l = T.lig + li * kLig;
  const Shadow s = shadow_ray(T, D, slot, li, h, eps);
  const bool occ = anyhit(T, s.so, s.sd, 0.0f, s.dist);
  // geometric term with the distance to the light CENTRE (reference quirk)
  const V3 lp = ld3(l), ln = ld3(l + 3);
  const V3 q = h.p - lp;
  const float r2 = dot(q, q);
  const float cosx = fminf(fmaxf(dot(s.sd, h.n), 0.0f), 1.0f);
  const float cosy = fminf(fmaxf(-dot(s.sd, ln), 0.0f), 1.0f);
  const float geom = l[13] * cosx * cosy / fmaxf(r2, 1e-20f);
  const V3 al = albedo(T, static_cast<int>(h.m));
  if (!occ) {
    A.r = A.r + A.tr * al.x * (geom * l[6]);
    A.g = A.g + A.tg * al.y * (geom * l[7]);
    A.b = A.b + A.tb * al.z * (geom * l[8]);
  }
  A.tr = A.tr * al.x;
  A.tg = A.tg * al.y;
  A.tb = A.tb * al.z;
  return occ;
}

// One progressive pass of ray rid_g, added into A.r/g/b.
__device__ void one_pass(const Tables& T, const Draws& D, const Rec& R,
                         int rid_g, int spp, int width, int bounces,
                         bool normalize_emitter, Acc& A) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  int col, row, samp;
  pixel_of(rid_g, spp, width, col, row, samp);
  V3 o, d;
  float mint, maxt;
  camera_ray(T.par, D, col, row, samp, spp, o, d, mint, maxt);

  Hit h;
  maxt = trace(T, o, d, mint, maxt, h);
  R.id(0, h.obj);  // before the emitter test, as JAX records it

  // emitter hits on the primary segment only; a hit ends the path
  const int emit = emitter_hit(T, o, d, mint, maxt);
  if (emit >= 0) {
    const float* irr = T.lig + emit * kLig + (normalize_emitter ? 9 : 6);
    A.r = A.r + irr[0];
    A.g = A.g + irr[1];
    A.b = A.b + irr[2];
    h.m = -1.0f;
  }

  A.tr = A.tg = A.tb = 1.0f;
  for (int li = 0; li < L; ++li)
    R.occ(li, nee(T, D, nee_slot(0, li, L), li, h, eps, A));

  int depth = 0;
  for (; depth < bounces; ++depth) {
    // a path without a valid hit stays dead: nothing more accumulates
    if (!(h.m >= 0.0f)) break;
    float cx, cy, cz;
    bounce_ray(D, bounce_slot(depth, L), h, eps, cx, cy, cz, o, d);
    trace(T, o, d, 0.0f, inf_f(), h);
    R.id(depth + 1, h.obj);
    for (int li = 0; li < L; ++li)
      R.occ((depth + 1) * L + li,
            nee(T, D, nee_slot(depth + 1, li, L), li, h, eps, A));
  }
  // the dead path's remaining segments: a miss and no occlusion, as JAX's
  // dead window (mint = maxt = inf) records them
  if (R.ids != nullptr) {
    for (; depth < bounces; ++depth) {
      R.id(depth + 1, -1);
      for (int li = 0; li < L; ++li) R.occ((depth + 1) * L + li, false);
    }
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
  int* ids;        // (1 + bounces, n_rays) or nullptr: not recording
  uint8_t* occs;   // ((1 + bounces) * n_lig, n_rays) or nullptr
};

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
  const int n_draws = n_draws_of(p.n_lig, p.bounces);
  Draws D;
  D.u = p.u;
  D.n_rays = p.n_rays;
  D.rid = rid;
  D.k0 = D.k1 = 0u;
  D.base = static_cast<uint32_t>(rid_g) * static_cast<uint32_t>(2 * n_draws);
  Rec R;
  R.ids = p.ids;
  R.occs = p.occs;
  R.n_rays = p.n_rays;
  R.rid = rid;

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
    one_pass(T, D, R, rid_g, p.spp, p.width, p.bounces,
             p.normalize_emitter != 0, A);
  }
  a[0] = A.r;
  a[1] = A.g;
  a[2] = A.b;
}

}  // namespace

// C interface (bound with ctypes). `keys` is a HOST array of n_passes pass
// keys (ignored with u_planes), copied into the launch's parameters.
// Non-null `ids` (and `occs` when n_lig > 0) record the champions and the
// occlusion bits of a one-pass launch. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the
// launch.
extern "C" int rt_pathtrace_pass(const float* par, const float* sph, int n_sph,
                                 const float* tri, int n_tri, const float* mat,
                                 int n_mat, const float* lig, int n_lig,
                                 float* acc, int n_rays, int ray_offset,
                                 const float* u_planes, const uint32_t* keys,
                                 int n_passes, int spp, int width, int bounces,
                                 int two_sided, int normalize_emitter,
                                 int* ids, uint8_t* occs, void* stream) {
  if (n_passes < 1 || n_passes > kMaxPasses || (u_planes && n_passes != 1) ||
      (ids && n_passes != 1) || (!ids && occs) ||
      (ids && n_lig > 0 && !occs))
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
  p.ids = ids;
  p.occs = occs;
  const size_t smem = sizeof(float) * (kNPar + kSph * n_sph + kTri * n_tri +
                                       kMat * n_mat + kLig * n_lig);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pathtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  pathtrace_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
