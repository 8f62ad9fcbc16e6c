// The adjoint of one progressive pass as one CUDA kernel for Hopper
// (sm_90a): parameter cotangents of sum_rays <g, acc_delta>.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel_grad.py::_bwd_kernel (launcher
// _bwd_pallas), hard route (soft_bandwidth == 0), path mode with or without
// Russian roulette, u-planes or PRNG draws, spp >= 1, over unrolled tables (at
// most 64 objects per type; rt_pathtrace_bwd). It computes what jax.vjp of
// _tile_program gives: cotangents of par (26,), sph (S, 8), tri (T, 32), mat
// (M, 4) and lig (L, 20). Past 64 objects, and over streamed Morton chunks
// and grids (_loop_diff's windows), the same cotangents come from two
// launches (ops/megakernel_grad.py pathtrace_pass_bwd_split): kernel 1's
// recording instance built with --fmad=false (megakernel.cu) records the
// pass at kernel 1's occupancy (6-8 blocks of 128 threads per SM), then
// kernel 3 (megakernel_champ.cu) sweeps the record; one launch that searched
// inside the sweep's 128 registers and shared memory held 3-4 (PERF.md §6,
// row 2′). The soft (edge-aware) route is kernel 2s (megakernel_soft.cu).
// Direct mode (mode="direct", _tile_program's direct branch :795-829;
// direct != 0 at the C entries) is an instance of its own (kDirect):
// direct_adjoint replays the primary trace and each light's shadow ray, then
// pathtrace_adj.cuh's direct_sweep differentiates the one segment; no tape.
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
// same counters), keeping a tape of bounces + 1 segments (origin,
// direction, throughput at the segment's start, champion, t, beta, gamma,
// occlusion bits; the material is re-read from the champion's row). Then a
// reverse sweep of hand-derived adjoints: NEE terms and albedo, the bounce
// (cosine lift, tangent frame, offset origin), the hit normal and hit
// point, the sphere root or the Moller-Trumbore t, beta and gamma, and
// last the camera chain into par. The emitter term goes to lig's
// irradiance columns. The tape, the adjoints and the reverse sweep live in
// pathtrace_adj.cuh, which kernel 3 (megakernel_champ.cu) shares: only the
// tape's fill is here.
//
// What bounded it (one H100 80GB HBM3, 700 W, python -m
// raytracing_tpu_torch.profile_kernels on the earlier design and on copies
// of it with one cost cut):
// the gradient tables' float atomicAdd on shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN, 71 sites), and a warp's lanes
// all add into cornell's 2 sphere and 5 material rows, so each add retried
// up to 32 times: 74% of the time (6.36 -> 1.68 ms on cornell 1024^2 b5,
// ("sph", "mat"), with the atomics made plain racy adds). A 6-segment tape
// in place of the 16-segment one changed nothing (1%).
// The design: one thread per ray in a grid-stride loop in steps of whole
// warps over a grid sized to the card (SMs x resident blocks), so the
// lanes of a warp stay together; the sweep is warp-uniform, and every add
// into a gradient row is warp-aggregated (pathtrace_adj.cuh): the warp's
// lanes group by row, sum in registers by shuffles, and one lane per row
// adds, so a row gets one atomic per warp and word, not one per lane. The
// tables, their gradient buffers (same layout) and the tape, (bounces +
// 1) x 14 words a thread laid out so that a warp's lanes touch consecutive
// words, live in shared memory; par gradients in registers per thread,
// summed over the warp at the end; one global atomicAdd per nonzero entry
// per block. __launch_bounds__ asks for kMinBlocks = 4 blocks of 128
// threads per SM: 128 registers, 80 B of stack, 164 B spilled (168
// registers unbounded: 2.03 ms; 96 at 5 blocks: 1.96 ms; 128: 1.82 ms). Measured: 1.8 ms on
// cornell 1024^2 b5 ("sph", "mat") on the training step's cotangent (6.4
// ms before), 3.2 ms with all five groups (11.6 ms before); about 3x
// kernel 1's pass over the same rays, from the replay, the sweep's
// recomputed draws and its divergent adjoint branches. With Russian
// roulette (the kRR instance) 2.11 ms: +0.08 ms for the instance's code
// with the roulette never played, +0.09 ms for the sweep's rr_adj, +0.11
// ms for the replay's roulette draws and ends (ablation copies timed with
// profile_kernels); the paths it ends save nothing here, since the
// warp-uniform sweep walks every lane to its warp's longest path. Float atomics and
// the shuffle sums make the results depend on order: they agree with the
// plain version to float tolerance, never bitwise.

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

// The whole adjoint of ray rid_g for acc cotangent g; warp-uniform (every
// lane calls it, `active` false for a lane without a ray). kRR: the pass
// plays Russian roulette from depth rr_start on. The replay traces T with
// kernel 1's brute loops (two sphere rows per iteration); the sweep reads
// the champions' rows from the same tables.
template <bool kRR>
__device__ void ray_adjoint(const Tables& T, const Draws& D, bool active,
                            int rid_g, int spp, int width, int bounces,
                            int rr_start, bool normalize_emitter, V3 g,
                            const Grads& G, const Tape& tape,
                            float (&gp)[kNPar]) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  int col = 0, row = 0, samp = 0;
  int nseg = 0, emit = -1;
  if (active) {
    pixel_of(rid_g, spp, width, col, row, samp);

    // forward replay with the tape
    V3 o, d;
    float mint, maxt;
    camera_ray(T.par, D, col, row, samp, spp, o, d, mint, maxt);
    Hit h;
    maxt = trace(T, o, d, mint, maxt, h);
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
        const Shadow sh =
            shadow_ray(T, D, nee_slot(s, li, L, kRR), li, h, eps);
        if (anyhit(T, sh.so, sh.sd, 0.0f, sh.dist)) q.occ |= 1u << li;
        tp = mk(tp.x * al.x, tp.y * al.y, tp.z * al.z);
      }
      tape.put(s, q);
      nseg = s + 1;
      if (s == bounces) break;
      // the roulette as the forward plays it; a path it ends has no more
      // segments
      if (kRR && s >= rr_start && !rr_survive(D, s, L, tp)) break;
      float cx, cy, cz;
      bounce_ray(D, bounce_slot(s, L, kRR), h, eps, cx, cy, cz, o, d);
      trace(T, o, d, 0.0f, inf_f(), h);
    }
  }
  // an emitter hit ends the path; nothing else depends on the tables
  if (G.wrt & kWLig)
    add_row3(G.lig + max(emit, 0) * kLig + (normalize_emitter ? 9 : 6), emit,
             g);
  reverse_sweep<kRR>(T, D, tape, nseg, col, row, samp, spp, rr_start, g, G,
                     TableAdds{G.sph, G.tri}, gp);
}

// The adjoint of ray rid_g in direct mode (pathtrace_adj.cuh direct_sweep):
// replay the primary trace and each light's shadow ray with kernel 1's
// loops, as ray_adjoint replays a path, then sweep the one segment.
// Warp-uniform, as ray_adjoint.
__device__ void direct_adjoint(const Tables& T, const DirectSlots& S,
                               bool active, int rid_g, int spp, int width,
                               V3 g, const Grads& G, float (&gp)[kNPar]) {
  const float eps = T.par[kEps];
  int col = 0, row = 0, samp = 0;
  bool live = false;
  Seg q;
  q.obj = -1;
  q.m = -1;
  q.occ = 0u;
  if (active) {
    pixel_of(rid_g, spp, width, col, row, samp);
    V3 o, d;
    float mint, maxt;
    camera_ray(T.par, S.lens(), col, row, samp, spp, o, d, mint, maxt);
    Hit h;
    trace(T, o, d, mint, maxt, h);
    live = h.m >= 0.0f;
    if (live) {
      q.o = o;
      q.d = d;
      q.t = h.t;
      q.beta = h.beta;
      q.gamma = h.gamma;
      q.obj = h.obj;
      q.m = static_cast<int>(h.m);
      for (int li = 0; li < T.n_lig; ++li) {
        float u0, u1;
        S.pair(1 + li, u0, u1);
        const Shadow sh = shadow_ray_uv(T, u0, u1, li, h, eps);
        if (anyhit(T, sh.so, sh.sd, 0.0f, sh.dist)) q.occ |= 1u << li;
      }
    }
  }
  direct_sweep(T, S, q, live, col, row, samp, spp, g, G,
               TableAdds{G.sph, G.tri}, gp);
}

template <bool kRR, bool kDirect>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    pathtrace_bwd_kernel(const __grid_constant__ AdjParams p) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const Tables T = stage_tables(smem, p.par, p.sph, p.n_sph, p.tri, p.n_tri,
                                p.mat, p.n_mat, p.lig, p.n_lig,
                                p.two_sided != 0);
  // gradient buffers in the tables' layout, then the tape slab
  const int n_tab = tables_floats(p.n_sph, p.n_tri, p.n_mat, p.n_lig);
  float* g_par = smem + n_tab;
  float* g_sph = g_par + kParPad;
  float* g_tri = g_sph + kSph * p.n_sph;
  float* g_mat = g_tri + kTri * p.n_tri;
  float* g_lig = g_mat + kMat * p.n_mat;
  zero(g_par, n_tab);
  Tape tape;
  tape.col = smem + 2 * n_tab + threadIdx.x;
  tape.stride = blockDim.x;
  __syncthreads();

  Grads G;
  G.sph = g_sph;
  G.tri = g_tri;
  G.mat = g_mat;
  G.lig = g_lig;
  G.wrt = p.wrt;

  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  // the block's rays (for_rays): each ray's adjoint adds into G and gp
  for_rays<kRR>(p, [&](const Draws& D, bool active, int rid_g, V3 g) {
    if constexpr (kDirect)
      direct_adjoint(T, direct_slots(D, p.dkeys, rid_g), active, rid_g,
                     p.spp, p.width, g, G, gp);
    else
      ray_adjoint<kRR>(T, D, active, rid_g, p.spp, p.width, p.bounces,
                       p.rr_start, p.normalize_emitter != 0, g, G, tape, gp);
  });
  if (p.wrt & kWPar) add_par(g_par, gp);
  __syncthreads();
  if (p.wrt & kWPar) flush(p.dpar, g_par, kNPar);
  if (p.wrt & kWSph) flush(p.dsph, g_sph, kSph * p.n_sph);
  if (p.wrt & kWTri) flush(p.dtri, g_tri, kTri * p.n_tri);
  if (p.wrt & kWMat) flush(p.dmat, g_mat, kMat * p.n_mat);
  if (p.wrt & kWLig) flush(p.dlig, g_lig, kLig * p.n_lig);
}

}  // namespace

// C interface (bound with ctypes). Adds the cotangents of one pass into
// dpar (26,), dsph (S, 8), dtri (T, 32), dmat (M, 4), dlig (L, 20), which
// the caller zeroes; `wrt` is a bit set of the groups to compute (1 par,
// 2 sph, 4 tri, 8 mat, 16 lig). (k0, k1) is the pass key of the PRNG
// route (ignored with u_planes). rr != 0: the pass played Russian roulette
// from depth rr_start_depth on. direct != 0: the pass is direct mode's
// (u_planes_for_direct's draws, or the slot keys of the pass key; bounces
// and rr must be 0). Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch.
extern "C" int rt_pathtrace_bwd(const float* par, const float* sph, int n_sph,
                                const float* tri, int n_tri, const float* mat,
                                int n_mat, const float* lig, int n_lig,
                                const float* g, int n_rays, int ray_offset,
                                const float* u_planes, unsigned int k0,
                                unsigned int k1, int spp, int width,
                                int bounces, int rr, int rr_start_depth,
                                int direct, int two_sided,
                                int normalize_emitter, int wrt, float* dpar,
                                float* dsph, float* dtri, float* dmat,
                                float* dlig, void* stream) {
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      (direct && (bounces || rr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
  AdjParams p = adj_params(par, sph, n_sph, tri, n_tri, mat, n_mat, lig,
                           n_lig, g, n_rays, ray_offset, u_planes, k0, k1,
                           spp, width, bounces, rr_start_depth, two_sided,
                           normalize_emitter, wrt, dpar, dsph, dtri, dmat,
                           dlig);
  if (direct) set_direct_keys(p);
  // direct mode keeps no tape
  const size_t smem =
      2 * sizeof(float) * tables_floats(n_sph, n_tri, n_mat, n_lig) +
      (direct ? 0 : tape_bytes(bounces, kBlock));
  void (*kernel)(AdjParams) =
      direct ? pathtrace_bwd_kernel<false, true>
      : rr   ? pathtrace_bwd_kernel<true, false>
             : pathtrace_bwd_kernel<false, false>;
  int grid = 0;
  const cudaError_t err = fit_grid(kernel, kBlock, smem, n_rays, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
