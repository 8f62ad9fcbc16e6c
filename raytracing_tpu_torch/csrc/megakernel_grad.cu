// The adjoint of one progressive pass as one CUDA kernel for Hopper
// (sm_90a): parameter cotangents of sum_rays <g, acc_delta>.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel_grad.py::_bwd_kernel
// (launcher _bwd_pallas), hard route (soft_bandwidth == 0) over unrolled
// tables, path mode, u-planes or PRNG draws, spp >= 1. It computes what
// jax.vjp of _tile_program gives: cotangents of par (26,), sph (S, 8),
// tri (T, 32), mat (M, 4) and lig (L, 20). The soft (edge-aware) route is
// not here.
//
// Hard-gradient convention, as in the JAX package: the cotangent of a
// closest hit flows to its champion only; occlusion is a step function
// (anyhit has no adjoint); the scene-AABB window, mint, maxt and the
// shadow-ray length only select, so pmin, pmax and ambient get none. The
// guards are those of the forward: the adjoint of sqrt is 0 where its
// argument is <= 0 (_safe_sqrt), safe normalize passes the cotangent
// through where n2 == 0, max(r2, 1e-20) passes it only above the floor, and
// clip(cos, 0, 1) only inside (0, 1).
//
// Per ray: replay the forward pass with the same functions as the forward
// kernel (pathtrace.cuh; draws from the u-planes or by threefry at the
// same counters), keeping a tape of at most bounces + 1 segments (origin,
// direction, champion, t, beta, gamma, material, occlusion bits, the
// throughput at the segment's start). Then a reverse sweep of
// hand-derived adjoints: NEE terms and albedo, the bounce (cosine lift,
// tangent frame, offset origin), the hit normal and hit point, the sphere
// root or the Moller-Trumbore t, beta and gamma, and last the camera chain
// into par. The emitter term goes to lig's irradiance columns. The tape,
// the adjoints and the reverse sweep live in pathtrace_adj.cuh, which
// kernel 3 (megakernel_champ.cu) shares: only the tape's fill is here.
//
// What bounds it on this card: not bytes (12 B/ray of cotangent in); it
// traces every segment and shadow ray once more and adds the adjoint.
// Measured on one H100 80GB HBM3 (700 W): 6.2 ms per cornell 1024x1024 b5
// backward with ("sph", "mat"), 9-10x kernel 1's pass over the same rays
// (5.5 ms contracted; it is built with --fmad=false, see
// pathtrace_adj.cuh); not yet profiled beyond that (candidates: a warp's shared-memory
// atomics on one address serialise, 25% occupancy at 128 registers, the
// 1 KB tape in local memory). The design: one thread
// per ray in a grid-stride loop over a grid sized to the card (SMs x
// resident blocks); tables and gradient buffers (laid out like the tables)
// in shared memory; champion rows, materials and lights gathered by
// shared-memory atomicAdd; par gradients in registers per thread; at the
// end one global atomicAdd per nonzero entry per block. Float atomics make
// the sums depend on order: results agree with the plain version to float
// tolerance, never bitwise.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace_adj.cuh"

namespace {

using namespace rt;

constexpr int kBlock = 128;

// The whole adjoint of ray rid_g for acc cotangent g.
__device__ void ray_adjoint(const Tables& T, const Draws& D, int rid_g,
                            int spp, int width, int bounces,
                            bool normalize_emitter, V3 g, const Grads& G,
                            float (&gp)[kNPar]) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  int col, row, samp;
  pixel_of(rid_g, spp, width, col, row, samp);

  // forward replay with the tape
  Seg tape[kMaxSeg];
  V3 o, d;
  float mint, maxt;
  camera_ray(T.par, D, col, row, samp, spp, o, d, mint, maxt);
  Hit h;
  maxt = trace(T, o, d, mint, maxt, h);
  const int emit = emitter_hit(T, o, d, mint, maxt);
  if (emit >= 0) {
    if (G.wrt & kWLig)
      add3(G.lig + emit * kLig + (normalize_emitter ? 9 : 6), g);
    return;  // the path ends; nothing else depends on the tables
  }
  int nseg = 0;
  V3 tp = mk(1.0f, 1.0f, 1.0f);
  for (int s = 0; s <= bounces; ++s) {
    if (!(h.m >= 0.0f)) break;
    Seg& q = tape[s];
    q.o = o;
    q.d = d;
    q.tp = tp;
    q.t = h.t;
    q.beta = h.beta;
    q.gamma = h.gamma;
    q.obj = h.obj;
    q.m = static_cast<int>(h.m);
    q.occ = 0u;
    const V3 al = albedo(T, q.m);
    for (int li = 0; li < L; ++li) {
      const Shadow sh = shadow_ray(T, D, nee_slot(s, li, L), li, h, eps);
      if (anyhit(T, sh.so, sh.sd, 0.0f, sh.dist)) q.occ |= 1u << li;
      tp = mk(tp.x * al.x, tp.y * al.y, tp.z * al.z);
    }
    nseg = s + 1;
    if (s == bounces) break;
    float cx, cy, cz;
    bounce_ray(D, bounce_slot(s, L), h, eps, cx, cy, cz, o, d);
    trace(T, o, d, 0.0f, inf_f(), h);
  }

  reverse_sweep(T, D, tape, nseg, col, row, samp, spp, g, G, gp);
}

struct Params {
  const float* par;
  const float* sph;
  const float* tri;
  const float* mat;
  const float* lig;
  int n_sph, n_tri, n_mat, n_lig;
  const float* g;  // (n_rays, 3) cotangent of acc
  int n_rays;
  int ray_offset;
  const float* u;  // (2 * n_draws, n_rays) or nullptr
  uint32_t k0, k1;  // pass key of the PRNG route
  int spp, width, bounces;
  int two_sided, normalize_emitter;
  int wrt;
  float* dpar;
  float* dsph;
  float* dtri;
  float* dmat;
  float* dlig;
};

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.0f;
}

__device__ __forceinline__ void flush(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (src[i] != 0.0f) atomicAdd(dst + i, src[i]);
}

__global__ void __launch_bounds__(kBlock)
    pathtrace_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const int n_par = kNPar, n_sph = kSph * p.n_sph, n_tri = kTri * p.n_tri,
            n_mat = kMat * p.n_mat, n_lig = kLig * p.n_lig;
  const int n_tab = n_par + n_sph + n_tri + n_mat + n_lig;
  float* s_par = smem;
  float* s_sph = s_par + n_par;
  float* s_tri = s_sph + n_sph;
  float* s_mat = s_tri + n_tri;
  float* s_lig = s_mat + n_mat;
  float* g_par = smem + n_tab;  // gradient buffers, same layout
  float* g_sph = g_par + n_par;
  float* g_tri = g_sph + n_sph;
  float* g_mat = g_tri + n_tri;
  float* g_lig = g_mat + n_mat;
  copy_table(s_par, p.par, n_par);
  copy_table(s_sph, p.sph, n_sph);
  copy_table(s_tri, p.tri, n_tri);
  copy_table(s_mat, p.mat, n_mat);
  copy_table(s_lig, p.lig, n_lig);
  zero(g_par, n_tab);
  __syncthreads();

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
  Grads G;
  G.sph = g_sph;
  G.tri = g_tri;
  G.mat = g_mat;
  G.lig = g_lig;
  G.wrt = p.wrt;

  const int n_draws = n_draws_of(p.n_lig, p.bounces);
  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  for (int rid = blockIdx.x * blockDim.x + threadIdx.x; rid < p.n_rays;
       rid += gridDim.x * blockDim.x) {
    const float* gr = p.g + 3 * static_cast<size_t>(rid);
    const V3 g = mk(gr[0], gr[1], gr[2]);
    if (g.x == 0.0f && g.y == 0.0f && g.z == 0.0f) continue;
    const int rid_g = rid + p.ray_offset;
    Draws D;
    D.u = p.u;
    D.n_rays = p.n_rays;
    D.rid = rid;
    D.k0 = p.k0;
    D.k1 = p.k1;
    D.base = static_cast<uint32_t>(rid_g) * static_cast<uint32_t>(2 * n_draws);
    ray_adjoint(T, D, rid_g, p.spp, p.width, p.bounces,
                p.normalize_emitter != 0, g, G, gp);
  }
  if (p.wrt & kWPar) {
#pragma unroll
    for (int i = 0; i < kNPar; ++i)
      if (gp[i] != 0.0f) atomicAdd(g_par + i, gp[i]);
  }
  __syncthreads();
  if (p.wrt & kWPar) flush(p.dpar, g_par, n_par);
  if (p.wrt & kWSph) flush(p.dsph, g_sph, n_sph);
  if (p.wrt & kWTri) flush(p.dtri, g_tri, n_tri);
  if (p.wrt & kWMat) flush(p.dmat, g_mat, n_mat);
  if (p.wrt & kWLig) flush(p.dlig, g_lig, n_lig);
}

}  // namespace

// C interface (bound with ctypes). Adds the cotangents of one pass into
// dpar (26,), dsph (S, 8), dtri (T, 32), dmat (M, 4), dlig (L, 20), which
// the caller zeroes; `wrt` is a bit set of the groups to compute (1 par,
// 2 sph, 4 tri, 8 mat, 16 lig). (k0, k1) is the pass key of the PRNG
// route (ignored with u_planes). Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int rt_pathtrace_bwd(const float* par, const float* sph, int n_sph,
                                const float* tri, int n_tri, const float* mat,
                                int n_mat, const float* lig, int n_lig,
                                const float* g, int n_rays, int ray_offset,
                                const float* u_planes, unsigned int k0,
                                unsigned int k1, int spp, int width,
                                int bounces, int two_sided,
                                int normalize_emitter, int wrt, float* dpar,
                                float* dsph, float* dtri, float* dmat,
                                float* dlig, void* stream) {
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
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
  p.g = g;
  p.n_rays = n_rays;
  p.ray_offset = ray_offset;
  p.u = u_planes;
  p.k0 = k0;
  p.k1 = k1;
  p.spp = spp;
  p.width = width;
  p.bounces = bounces;
  p.two_sided = two_sided;
  p.normalize_emitter = normalize_emitter;
  p.wrt = wrt;
  p.dpar = dpar;
  p.dsph = dsph;
  p.dtri = dtri;
  p.dmat = dmat;
  p.dlig = dlig;
  const size_t smem = 2 * sizeof(float) *
                      (kNPar + kSph * n_sph + kTri * n_tri + kMat * n_mat +
                       kLig * n_lig);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(pathtrace_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pathtrace_bwd_kernel, kBlock, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a grid-stride loop over a grid the card holds at once: each block
  // flushes its gradient buffers once
  const long long need = (static_cast<long long>(n_rays) + kBlock - 1) /
                         kBlock;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(need < fit ? need : fit);
  pathtrace_bwd_kernel<<<grid, kBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
