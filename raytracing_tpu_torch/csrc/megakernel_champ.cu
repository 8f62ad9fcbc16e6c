// The champion ("cell") adjoint of one progressive pass as one CUDA kernel
// for Hopper (sm_90a): the parameter cotangents of sum_rays <g, acc_delta>
// from kernel 1's record of the pass, without sweeping the tables.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel_grad.py::_bwd_champ_kernel
// (launcher _bwd_champ_pallas), path mode with or without Russian
// roulette, u-planes or PRNG draws, spp >= 1. It computes what jax.vjp of _tile_program_champ gives
// (_bwd_champion): the hard gradient flows only through each trace
// segment's champion row, and occlusion is a recorded constant. So once
// kernel 1 has recorded each segment's champion (sphere i, n_sph +
// triangle j, -1) and each NEE occlusion bit (megakernel.cu, record
// mode), the backward needs no object sweep at all.
//
// Per ray: replay the draws (u-planes, or threefry at the counters of
// kernels 1 and 2); for each segment load the recorded champion id and its
// row with an indexed load, and re-derive t, beta and gamma as
// _champ_surface does (the sphere root under the same [mint, maxt]
// window, the constant-split Moller-Trumbore terms), which fills kernel
// 2's tape; read the occlusion bits from the record; then run kernel 2's
// reverse sweep unchanged (pathtrace_adj.cuh). The TPU kernel's one-hot
// MXU gathers and scatters over champion chunks, its sublane picks and its
// on-core PRNG reseed are TPU workarounds and have no counterpart here.
//
// What bounds it on this card: it reads 4 B of id + L B of bits per
// segment and the 12 B cotangent per ray, and a 32 B sphere row (128 B
// triangle row) per segment from L2 or L1; the rest is the adjoint's
// arithmetic, independent of the table size, and its row adds. The design
// is kernel 2's: one thread per ray in a grid-stride loop in steps of
// whole warps over a grid sized to the card, the warp-uniform reverse
// sweep of pathtrace_adj.cuh with its tape in shared memory and its
// warp-aggregated row adds; par, mat and lig (small) in shared memory; the
// sphere and triangle tables stay in global memory (sphere_field(1024)'s
// 32 KB is read only at the champions' rows); par cotangents in registers
// per thread; mat and lig cotangents into shared memory, flushed once per
// block; sphere and triangle row cotangents by atomicAdd straight into the
// global outputs, one per warp, row and word -- with 1024+ rows a
// per-block shared table, flushed whole as kernel 2 does, would cost more
// than the rows a block touches. __launch_bounds__ asks for kMinBlocks = 4
// blocks of 128 threads per SM (128 registers, 72 B of stack, 132 B
// spilled). Measured (one H100 80GB
// HBM3, 700 W, python -m raytracing_tpu_torch.profile_kernels): 0.68 ms on
// sphere_field(1024) 1024^2 b5 ("sph", "mat") on a training step's
// cotangent, 0.96 ms with the earlier design's per-lane atomics. Float
// atomics make the sums depend on order: results agree with the plain
// version to float tolerance, never bitwise.
//
// Built with --fmad=false, as kernel 2 is (pathtrace_adj.cuh says why).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace_adj.cuh"

namespace {

using namespace rt;

constexpr int kBlock = 128;
// blocks per SM that __launch_bounds__ asks registers for: 4 caps them at
// 128 (measured on the H100 against 3 blocks at 168 and 5 at 96)
constexpr int kMinBlocks = 4;

// The recorded champion `obj` of a segment [mint, maxt] of ray (o, d), as
// _champ_surface re-derives it: t, the hit point, the normal and the
// material, and for the tape beta (the sphere's far-root flag, or the
// triangle's beta) and gamma. An id outside [0, n_sph + n_tri) is a miss.
// Returns the new maxt (the champion's t, or maxt on a miss).
__device__ float champ_trace(const Tables& T, V3 o, V3 d, float mint,
                             float maxt, int obj, Hit& h) {
  h.obj = -1;
  h.m = -1.0f;
  h.n = mk(0.0f, 0.0f, 0.0f);
  h.p = o;
  h.t = 0.0f;
  h.beta = 0.0f;
  h.gamma = 0.0f;
  if (obj < 0 || obj >= T.n_sph + T.n_tri) return maxt;
  float t;
  if (obj < T.n_sph) {
    const float* s = T.sph + obj * kSph;
    const V3 c = ld3(s);
    const float r = s[3];
    const float a = dot(d, d);
    const float inv2a = 0.5f / a;
    const V3 m = o - c;
    const float b = 2.0f * dot(m, d);
    const float cq = dot(m, m) - r * r;
    const float dis = b * b - 4.0f * a * cq;
    const float sq = dis > 0.0f ? sqrtf(dis) : 0.0f;
    const float t0 = (-b - sq) * inv2a;
    const float t1 = (-b + sq) * inv2a;
    const float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
    const bool in_mn = tmn >= mint && tmn <= maxt;
    t = in_mn ? tmn : tmx;
    h.n = normalize(o + t * d - c);
    h.m = s[4];
    h.beta = in_mn ? 0.0f : 1.0f;
  } else {
    const float* q = T.tri + (obj - T.n_sph) * kTri;
    const V3 ng = ld3(q);
    const V3 oxd = cross(o, d);
    const float div = dot(ng, d);
    const float idiv = 1.0f / (div == 0.0f ? 1.0f : div);
    const float beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
    const float gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
    t = (q[15] - dot(ng, o)) * idiv;
    const float alpha = 1.0f - beta - gamma;
    h.n = normalize(alpha * ld3(q + 18) + beta * ld3(q + 21) +
                    gamma * ld3(q + 24));
    h.m = q[16];
    h.beta = beta;
    h.gamma = gamma;
  }
  h.obj = obj;
  h.t = t;
  h.p = o + t * d;
  return t;
}

// The record of one ray: ids (n_seg, n_rays) int32, occs (n_seg * L,
// n_rays) bytes, in schedule order.
struct Rec {
  const int* ids;
  const uint8_t* occs;
  int n_rays, rid;
  __device__ __forceinline__ int id(int s) const {
    return __ldg(ids + static_cast<size_t>(s) * n_rays + rid);
  }
  __device__ __forceinline__ bool occ(int k) const {
    return __ldg(occs + static_cast<size_t>(k) * n_rays + rid) != 0;
  }
};

// The whole champion adjoint of ray rid_g for acc cotangent g;
// warp-uniform (every lane calls it, `active` false for a lane without a
// ray). kRR: the pass played Russian roulette from depth rr_start on (JAX's
// _tile_program_champ runs _tile_program's schedule, the roulette
// included).
template <bool kRR>
__device__ void ray_adjoint_champ(const Tables& T, const Draws& D,
                                  const Rec& R, bool active, int rid_g,
                                  int spp, int width, int bounces,
                                  int rr_start, bool normalize_emitter, V3 g,
                                  const Grads& G, const Tape& tape,
                                  float (&gp)[kNPar]) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  int col = 0, row = 0, samp = 0;
  int nseg = 0, emit = -1;
  if (active) {
    pixel_of(rid_g, spp, width, col, row, samp);

    // forward replay on the recorded champions, filling kernel 2's tape
    V3 o, d;
    float mint, maxt;
    camera_ray(T.par, D, col, row, samp, spp, o, d, mint, maxt);
    Hit h;
    maxt = champ_trace(T, o, d, mint, maxt, R.id(0), h);
    emit = emitter_hit(T, o, d, mint, maxt);
    V3 tp = mk(1.0f, 1.0f, 1.0f);
    for (int s = 0; s <= bounces && emit < 0; ++s) {
      if (!(h.m >= 0.0f)) break;
      Seg q;
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
        if (R.occ(s * L + li)) q.occ |= 1u << li;
        tp = mk(tp.x * al.x, tp.y * al.y, tp.z * al.z);
      }
      tape.put(s, q);
      nseg = s + 1;
      if (s == bounces) break;
      // the roulette as the forward played it (the record holds misses
      // after a path it ended)
      if (kRR && s >= rr_start && !rr_survive(D, s, L, tp)) break;
      float cx, cy, cz;
      bounce_ray(D, bounce_slot(s, L, kRR), h, eps, cx, cy, cz, o, d);
      champ_trace(T, o, d, 0.0f, inf_f(), R.id(s + 1), h);
    }
  }
  // an emitter hit ends the path; nothing else depends on the tables
  if (G.wrt & kWLig)
    add_row3(G.lig + max(emit, 0) * kLig + (normalize_emitter ? 9 : 6), emit,
             g);
  reverse_sweep<kRR>(T, D, tape, nseg, col, row, samp, spp, rr_start, g, G,
                     gp);
}

template <bool kRR>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    pathtrace_bwd_champ_kernel(const __grid_constant__ AdjParams p) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_mat = kMat * p.n_mat, n_lig = kLig * p.n_lig;
  const int n_tab = kParPad + n_mat + n_lig;
  float* s_par = smem;
  float* s_mat = s_par + kParPad;
  float* s_lig = s_mat + n_mat;
  float* g_par = smem + n_tab;  // gradient buffers, same layout
  float* g_mat = g_par + kParPad;
  float* g_lig = g_mat + n_mat;
  copy_table(s_par, p.par, kNPar);
  copy_table(s_mat, p.mat, n_mat);
  copy_table(s_lig, p.lig, n_lig);
  zero(g_par, n_tab);
  Tape tape;
  tape.col = smem + 2 * n_tab + threadIdx.x;  // then the tape slab
  tape.stride = blockDim.x;
  __syncthreads();

  Tables T;
  T.par = s_par;
  T.sph = p.sph;
  T.tri = p.tri;
  T.mat = s_mat;
  T.lig = s_lig;
  T.n_sph = p.n_sph;
  T.n_tri = p.n_tri;
  T.n_mat = p.n_mat;
  T.n_lig = p.n_lig;
  T.two_sided = p.two_sided != 0;
  Grads G;
  G.sph = p.dsph;
  G.tri = p.dtri;
  G.mat = g_mat;
  G.lig = g_lig;
  G.wrt = p.wrt;

  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  for_rays<kRR>(p, [&](const Draws& D, bool active, int rid_g, V3 g) {
    Rec R;
    R.ids = p.ids;
    R.occs = p.occs;
    R.n_rays = p.n_rays;
    R.rid = D.rid;
    ray_adjoint_champ<kRR>(T, D, R, active, rid_g, p.spp, p.width,
                           p.bounces, p.rr_start, p.normalize_emitter != 0,
                           g, G, tape, gp);
  });
  if (p.wrt & kWPar) add_par(g_par, gp);
  __syncthreads();
  if (p.wrt & kWPar) flush(p.dpar, g_par, kNPar);
  if (p.wrt & kWMat) flush(p.dmat, g_mat, n_mat);
  if (p.wrt & kWLig) flush(p.dlig, g_lig, n_lig);
}

}  // namespace

// C interface (bound with ctypes). Adds the cotangents of one pass into
// dpar (26,), dsph (S, 8), dtri (T, 32), dmat (M, 4), dlig (L, 20), which
// the caller zeroes; `wrt` is a bit set of the groups to compute (1 par,
// 2 sph, 4 tri, 8 mat, 16 lig). `ids` (1 + bounces, n_rays) int32 and
// `occs` ((1 + bounces) * n_lig, n_rays) bytes are kernel 1's record of
// the same pass (occs may be null when n_lig == 0). (k0, k1) is the pass
// key of the PRNG route (ignored with u_planes). rr != 0: the pass played
// Russian roulette from depth rr_start_depth on. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError()
// after the launch.
extern "C" int rt_pathtrace_bwd_champ(
    const float* par, const float* sph, int n_sph, const float* tri,
    int n_tri, const float* mat, int n_mat, const float* lig, int n_lig,
    const float* g, const int* ids, const uint8_t* occs, int n_rays,
    int ray_offset, const float* u_planes, unsigned int k0, unsigned int k1,
    int spp, int width, int bounces, int rr, int rr_start_depth,
    int two_sided, int normalize_emitter, int wrt, float* dpar, float* dsph,
    float* dtri, float* dmat, float* dlig, void* stream) {
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      ids == nullptr || (n_lig > 0 && occs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
  AdjParams p = adj_params(par, sph, n_sph, tri, n_tri, mat, n_mat, lig,
                           n_lig, g, n_rays, ray_offset, u_planes, k0, k1,
                           spp, width, bounces, rr_start_depth, two_sided,
                           normalize_emitter, wrt, dpar, dsph, dtri, dmat,
                           dlig);
  p.ids = ids;
  p.occs = occs;
  const size_t smem =
      2 * sizeof(float) * (kParPad + kMat * n_mat + kLig * n_lig) +
      tape_bytes(bounces, kBlock);
  void (*kernel)(AdjParams) = rr ? pathtrace_bwd_champ_kernel<true>
                                  : pathtrace_bwd_champ_kernel<false>;
  // a grid-stride loop over a grid the card holds at once: each block
  // flushes its mat / lig / par buffers once
  int grid = 0;
  const cudaError_t err = fit_grid(kernel, kBlock, smem, n_rays, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
