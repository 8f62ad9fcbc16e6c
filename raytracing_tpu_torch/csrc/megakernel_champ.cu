// The champion ("cell") adjoint of one progressive pass as one CUDA kernel
// for Hopper (sm_90a): the parameter cotangents of sum_rays <g, acc_delta>
// from kernel 1's record of the pass, without sweeping the tables.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel_grad.py::_bwd_champ_kernel
// (launcher _bwd_champ_pallas), path mode with or without Russian
// roulette and direct mode (kDirect: the recorded primary champion and
// occlusion bits into pathtrace_adj.cuh's direct_sweep), u-planes or PRNG
// draws, spp >= 1. It computes what jax.vjp of _tile_program_champ gives
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
// block. __launch_bounds__ asks for kMinBlocks = 4 blocks of 128 threads
// per SM.
//
// The sphere and triangle row cotangents (HotAdds). A whole table's
// gradient buffer in shared memory, flushed whole as kernel 2 does, would
// cost more than the rows a block touches (1024+ rows). Straight into the
// global outputs as one scalar atomicAdd per warp, row and word, they
// queued on the few rows that most champions name: cornell's ten walls take
// 93% of the torus scene's triangle champions, 25 words each, and the L2
// serves atomics on one line one after another. So the record is counted
// first (hot_count_kernel, hot_select_kernel: rt_champ_hot_rows, a memset
// and two small launches on the same stream): the kHot triangle rows that
// the record names most get a slot in a slab of shared memory per warp,
// which the group's lowest lane adds into without an atomic (its warp's
// lanes add distinct rows; __syncwarp orders one add site's writes before
// the next one's reads), and which the block flushes once. Every other row
// goes out as vector reductions: a sphere row's 4 words as one float4, a
// triangle row's 25 as four float4 (words 0-15), four float2 (18-25) and
// one float (26), 9 operations where there were 25. A
// triangle row is read in 16-byte loads (tri_row<true>).
//
// Measured on one H100 80GB HBM3 at 700.00 W (python -m
// raytracing_tpu_torch.profile_kernels --only champ, 1024^2 b5, each step's
// record and cotangent, the parent and this design in turns): the torus
// scene's record with ("sph", "mat", "tri") 2.81-2.86 -> 1.27-1.29 ms (the
// parent's sphere and triangle adds cost 1.72-1.77 ms there, 1.47-1.52 of
// it in sending them: without the sends it ran 1.34 ms, without the adds
// 1.09); sphere_field(1024) with ("sph", "mat") 0.67-0.69 -> 0.66-0.69 ms
// (its adds were never contended). Timed and dropped: a slab of 16 sphere
// rows (the sphere cases 5-8% slower, the torus no faster), 8 triangle
// rows (as 16 on the torus, 2% slower on cornell's), 32 (as 16) and 64 (3
// blocks per SM, 1.48-1.49 ms), one slab per block through the shared
// float atomic (1.34 ms), vector reductions alone (1.96-2.01 ms), the slab
// with scalar atomics for the rest (1.34-1.36 ms), word-by-word row loads
// (1.35-1.36 ms). The hot rows take ~20 us of device time on a 6.3M-id
// record (count 15.1, select 4.9); a launch without triangle rows counts
// nothing and keeps no slab. 128 registers, 104 B of stack, 244 B spilled
// (path; 256 B with the roulette, none in direct mode).
//
// The ray order (rt_champ_order, for_order; path mode and the roulette).
// In ray order a warp's lanes are 32 consecutive rays, and the sweep runs
// every lane to its warp's longest path (reverse_sweep's max over the
// warp; the replay waits for it too), while a lane with g == 0 runs idle.
// The record gives each path's length before the sweep starts, so the rays
// are sorted first: those with g != 0, the longest key (leading recorded
// ids inside the tables, at least the segments the sweep tapes) first,
// rays of one key in ray order, by a stable counting sort in three
// launches (order_count_kernel, order_scan_kernel, order_scatter_kernel),
// no host sync. On sphere_field(1024)'s step (1024^2 b5) 196,715 of
// 1,048,576 rays have g != 0 and the warps walked 4.24x the lane-segments
// their lanes need (MKG.champ_warp_work), 1.0001x in the order; the
// torus's and cornell's 1.65x and 1.66x. Measured on one H100 80GB HBM3 at
// 700.00 W (python -m raytracing_tpu_torch.profile_kernels --only champ,
// device time, the design before the order and this one in turns, the
// order included): sphere_field(1024) ("sph", "mat") 0.653-0.658 ->
// 0.117-0.118 ms, the roulette 0.672-0.703 -> 0.112-0.120, the torus's
// records ("sph", "mat", "tri") 1.25-1.29 -> 0.79-0.82, cornell with all
// five groups 1.50-1.55 -> 0.95-0.99; the order alone 17.2-17.7 us on
// sphere_field(1024), 26-28 us where every ray is live. Direct mode
// sweeps in ray order (for_rays): its one segment leaves nothing to even
// out, only the rays with g == 0 to drop. An ordered direct instance,
// timed in the same runs and dropped, won on sphere_field(1024)
// (0.0879-0.0914 -> 0.0737-0.0751 ms, 59% of its rays live) and lost on
// cornell (0.0910-0.0933 -> 0.106-0.119: every ray live, the order's
// 13.7-14.0 us and the indirection all cost). The ordered instances: 128
// registers, 236 B spilled (path), 232 (the roulette); direct 127
// registers, none spilled.
// Float atomics make the sums depend on order: results agree with the plain
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
constexpr int kWarps = kBlock / 32;
// blocks per SM that __launch_bounds__ asks registers for: 4 caps them at
// 128 (measured on the H100 against 3 blocks at 168 and 5 at 96)
constexpr int kMinBlocks = 4;

// The triangle rows that get a slot in each warp's slab (the kHot rows the
// record names most), and a slab row's words: row words 0-15, then 18-26
constexpr int kHot = 16;
constexpr int kTriWords = 25;
constexpr int kSlabWords = kHot * kTriWords;

// One vector reduction into global memory (sm_90's float4 / float2
// atomicAdd, 16- / 8-byte aligned), none where every word is zero.
__device__ __forceinline__ void red4(float* p, float a, float b, float c,
                                     float d) {
  if (a != 0.0f || b != 0.0f || c != 0.0f || d != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}
__device__ __forceinline__ void red2(float* p, float a, float b) {
  if (a != 0.0f || b != 0.0f)
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// A triangle row's 25 cotangent words at p (row words 0-15 and 18-26) as 9
// vector reductions.
__device__ __forceinline__ void red_tri(float* p, const float* v) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    red4(p + 4 * c, v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) red2(p + 18 + 2 * c, v[16 + 2 * c], v[17 + 2 * c]);
  if (v[24] != 0.0f) atomicAdd(p + 26, v[24]);
}

// Kernel 3's sphere and triangle row adds (pathtrace_adj.cuh's Adds): the
// lanes group and sum by row as add_rows does; the group's lowest lane
// sends a sphere row as one vector reduction, adds a hot triangle row's
// sums into this warp's slab and sends any other triangle row as vector
// reductions. `slot` maps each triangle row to its slot or -1.
struct HotAdds {
  static constexpr bool kLdg = true;  // the tables' rows in global memory
  float* sph;  // dsph (S, 8), 16-byte aligned
  float* tri;  // dtri (T, 32), 16-byte aligned
  const int* slot;
  float* slab;  // this warp's kHot triangle rows

  __device__ __forceinline__ void sphere(int row, float (&v)[4]) const {
    if (group_sum(rows_of(row), v))
      red4(sph + row * kSph, v[0], v[1], v[2], v[3]);
  }

  __device__ __forceinline__ void triangle(int row, float (&vt)[16],
                                           float (&vn)[9]) const {
    const int s = row >= 0 ? __ldg(slot + row) : -1;
    const Rows r = rows_of(row);
    if (!r.any) return;
    // the row's 25 words in one shuffle tree
    float v[kTriWords];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = vt[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[16 + k] = vn[k];
    if (group_sum(r, v)) {
      if (s >= 0) {
        float* q = slab + s * kTriWords;
#pragma unroll
        for (int k = 0; k < kTriWords; ++k) q[k] += v[k];
      } else {
        red_tri(tri + row * kTri, v);
      }
    }
    __syncwarp();
  }
};

// The block's warp slabs summed into the global rows of `hot` (kHot
// triangle rows; -1: an unused slot) as vector reductions; after a
// __syncthreads.
__device__ void flush_hot(float* tri, const float* slabs, const int* hot) {
  for (int s = threadIdx.x; s < kHot; s += blockDim.x) {
    const int row = __ldg(hot + s);
    if (row < 0) continue;
    float v[kTriWords];
#pragma unroll
    for (int k = 0; k < kTriWords; ++k) {
      v[k] = 0.0f;
      for (int w = 0; w < kWarps; ++w)
        v[k] += slabs[w * kSlabWords + s * kTriWords + k];
    }
    red_tri(tri + row * kTri, v);
  }
}

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
    const TriRow w = tri_row<true>(q);
    const V3 ng = w.ng;
    const V3 oxd = cross(o, d);
    const float div = dot(ng, d);
    const float idiv = 1.0f / (div == 0.0f ? 1.0f : div);
    const float beta = (dot(w.e2, oxd) - dot(w.c2, d)) * idiv;
    const float gamma = (dot(w.c1, d) - dot(w.e1, oxd)) * idiv;
    t = (w.k - dot(ng, o)) * idiv;
    const float alpha = 1.0f - beta - gamma;
    h.n = normalize(alpha * w.vn0 + beta * w.vn1 + gamma * w.vn2);
    h.m = __ldg(q + 16);
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
                                  const Grads& G, const HotAdds& A,
                                  const Tape& tape, float (&gp)[kNPar]) {
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
  reverse_sweep<kRR>(T, D, tape, nseg, col, row, samp, spp, rr_start, g, G, A,
                     gp);
}

// The champion adjoint of ray rid_g in direct mode: the recorded primary
// champion (champ_trace) and occlusion bits fill the one segment that
// direct_sweep (pathtrace_adj.cuh) differentiates, as kernel 2's direct
// mode does after its replay. Warp-uniform.
__device__ void direct_adjoint_champ(const Tables& T, const DirectSlots& S,
                                     const Rec& R, bool active, int rid_g,
                                     int spp, int width, V3 g,
                                     const Grads& G, const HotAdds& A,
                                     float (&gp)[kNPar]) {
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
    champ_trace(T, o, d, mint, maxt, R.id(0), h);
    live = h.m >= 0.0f;
    if (live) {
      q.o = o;
      q.d = d;
      q.t = h.t;
      q.beta = h.beta;
      q.gamma = h.gamma;
      q.obj = h.obj;
      q.m = static_cast<int>(h.m);
      for (int li = 0; li < T.n_lig; ++li)
        if (R.occ(li)) q.occ |= 1u << li;
    }
  }
  direct_sweep(T, S, q, live, col, row, samp, spp, g, G, A, gp);
}

// for_rays (pathtrace_adj.cuh) over the launch's ray order
// (rt_champ_order): the loop's i-th ray is order[i] for i < n_live =
// order[n_rays], in steps of whole warps over the same grid; a lane past
// n_live runs inactive. Every ray in the order has g != 0.
template <bool kRR, class F>
__device__ __forceinline__ void for_order(const AdjParams& p,
                                          const int* order, F&& f) {
  const int n_draws = n_draws_of(p.n_lig, p.bounces, kRR);
  const int n_live = __ldg(order + p.n_rays);
  const int lane = threadIdx.x & 31;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x - lane;
       base < n_live; base += gridDim.x * blockDim.x) {
    const int i = base + lane;
    const int rid = i < n_live ? __ldg(order + i) : p.n_rays;
    V3 g = mk(0.0f, 0.0f, 0.0f);
    if (i < n_live) {
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

// Path mode sweeps the rays in the launch's order (for_order), direct mode
// in ray order (for_rays; `order` null).
template <bool kRR, bool kDirect>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    pathtrace_bwd_champ_kernel(const __grid_constant__ AdjParams p,
                               const int* slot, const int* hot,
                               const int* order) {
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
  // a slab per warp where the launch has hot rows, then the tape slab
  float* slabs = smem + 2 * n_tab;
  const int n_slab = hot != nullptr ? kWarps * kSlabWords : 0;
  copy_table(s_par, p.par, kNPar);
  copy_table(s_mat, p.mat, n_mat);
  copy_table(s_lig, p.lig, n_lig);
  zero(g_par, n_tab + n_slab);
  Tape tape;
  tape.col = slabs + n_slab + threadIdx.x;
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
  Grads G;  // sph and tri unused: HotAdds adds those rows
  G.mat = g_mat;
  G.lig = g_lig;
  G.wrt = p.wrt;
  HotAdds A;
  A.sph = p.dsph;
  A.tri = p.dtri;
  A.slot = slot;
  A.slab = slabs + (threadIdx.x >> 5) * kSlabWords;

  float gp[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) gp[i] = 0.0f;
  auto ray = [&](const Draws& D, bool active, int rid_g, V3 g) {
    Rec R;
    R.ids = p.ids;
    R.occs = p.occs;
    R.n_rays = p.n_rays;
    R.rid = D.rid;
    if constexpr (kDirect)
      direct_adjoint_champ(T, direct_slots(D, p.dkeys, rid_g), R, active,
                           rid_g, p.spp, p.width, g, G, A, gp);
    else
      ray_adjoint_champ<kRR>(T, D, R, active, rid_g, p.spp, p.width,
                             p.bounces, p.rr_start, p.normalize_emitter != 0,
                             g, G, A, tape, gp);
  };
  if constexpr (kDirect)
    for_rays<kRR>(p, ray);
  else
    for_order<kRR>(p, order, ray);
  if (p.wrt & kWPar) add_par(g_par, gp);
  __syncthreads();
  if (p.wrt & kWPar) flush(p.dpar, g_par, kNPar);
  if (p.wrt & kWMat) flush(p.dmat, g_mat, n_mat);
  if (p.wrt & kWLig) flush(p.dlig, g_lig, n_lig);
  if (hot != nullptr) flush_hot(p.dtri, slabs, hot);
}

// ---------------------------------------------------------------------------
// The hot rows of a record (rt_champ_hot_rows): each triangle row's count,
// then the kHot rows with the most, ties to the lower index, none never
// named.
// ---------------------------------------------------------------------------

constexpr int kCountBlock = 1024;
constexpr int kCountShared = 12288;  // rows a block counts in shared memory
constexpr int kSelectBlock = 512;

// Adds one row of each lane to the count h[row] (0 <= row < n_rows): the
// lanes of the warp group by row (__match_any_sync) and the group's lowest
// lane adds its size. Warp-uniform.
__device__ __forceinline__ void count_row(int* h, int row, int n_rows,
                                          int lane) {
  if (row < 0 || row >= n_rows) row = -1;
  const unsigned peers = __match_any_sync(kFull, row);
  if (row >= 0 && (peers & ((1u << lane) - 1u)) == 0u)
    atomicAdd(h + row, __popc(peers));
}

// counts[j] += the record's ids equal to first + j, for 0 <= j < n_rows:
// into a shared count per block (flushed at the end) where the rows fit,
// else into counts; the ids read 4 at a time (16-byte loads, `ids`
// 16-byte aligned), lane l of a warp taking ids 4 l ... 4 l + 3 of the
// warp's 128, in a grid-stride loop in steps of whole warps (two loads in
// flight per lane), the last n_ids % 4 by the first warp. One block of
// kCountBlock threads per SM: the loads in flight keep the read near the
// card's rate.
__global__ void __launch_bounds__(kCountBlock)
    hot_count_kernel(const int* __restrict__ ids, int n_ids, int first,
                     int n_rows, int* __restrict__ counts) {
  extern __shared__ int hist[];
  const bool local = n_rows <= kCountShared;
  if (local) {
    for (int i = threadIdx.x; i < n_rows; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  int* h = local ? hist : counts;
  const int lane = threadIdx.x & 31;
  const int n4 = n_ids >> 2;
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x - lane; base < n4;
       base += 2 * stride) {
    // two loads in flight per lane
    const int i = base + lane, j = i + stride;
    const int4 none = make_int4(-1, -1, -1, -1);
    const int4 v = i < n4 ? __ldg(ids4 + i) : none;
    const int4 w = j < n4 ? __ldg(ids4 + j) : none;
    count_row(h, v.x - first, n_rows, lane);
    count_row(h, v.y - first, n_rows, lane);
    count_row(h, v.z - first, n_rows, lane);
    count_row(h, v.w - first, n_rows, lane);
    count_row(h, w.x - first, n_rows, lane);
    count_row(h, w.y - first, n_rows, lane);
    count_row(h, w.z - first, n_rows, lane);
    count_row(h, w.w - first, n_rows, lane);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int i = 4 * n4 + lane;
    count_row(h, i < n_ids ? __ldg(ids + i) - first : -1, n_rows, lane);
  }
  if (local) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_rows; i += blockDim.x)
      if (hist[i] != 0) atomicAdd(counts + i, hist[i]);
  }
}

// One block: the kHot rows with the largest nonzero counts of n, ties to
// the lower index. A radix select finds the kHot-th largest count c_K
// (8-bit passes over a shared histogram, from the highest byte n_ids has;
// every named row where fewer than kHot are), a block scan in index order
// takes the first of the rows at c_K, and the picked rows are ranked by
// (count, index): slot[j] = the rank, hot[rank] = the row (-1 for an
// unused rank), slot[j] = -1 for every other row.
__global__ void __launch_bounds__(kSelectBlock)
    hot_select_kernel(const int* __restrict__ counts, int n, int n_ids,
                      int* __restrict__ slot, int* __restrict__ hot) {
  __shared__ int bins[256];
  __shared__ int warp_n[kSelectBlock / 32];
  __shared__ int picked[kHot];
  __shared__ int n_picked, pick_bin, pick_need;
  const unsigned* c = reinterpret_cast<const unsigned*>(counts);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) n_picked = 0;
  __syncthreads();
  // the kHot-th largest nonzero count and how many rows at it to take
  unsigned thresh = 1u, prefix = 0u, mask = 0u;
  int need = kHot;
  bool all = false;  // take every named row
  // no count exceeds n_ids: the passes start at its highest byte
  int top = 0;
  while (top < 24 && (static_cast<unsigned>(n_ids) >> (top + 8)) != 0u)
    top += 8;
  for (int shift = top; shift >= 0 && !all; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) bins[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned v = c[i];
      if (v != 0u && (v & mask) == prefix) atomicAdd(&bins[(v >> shift) & 255], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l ... 248 - 8 l, largest first
      int local[8], sum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        local[k] = bins[255 - 8 * lane - k];
        sum += local[k];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += x;
      }
      const int excl = incl - sum;
      if (lane == 31 && incl < need) {  // fewer than `need` left: take all
        pick_bin = -1;
        pick_need = need;
      }
      if (excl < need && incl >= need) {
        int acc = excl, k = 0;
        for (; k < 7 && acc + local[k] < need; ++k) acc += local[k];
        pick_bin = 255 - 8 * lane - k;
        pick_need = need - acc;
      }
    }
    __syncthreads();
    const int b = pick_bin;
    need = pick_need;
    __syncthreads();
    if (b < 0) {
      all = true;  // only in the first pass: fewer than kHot rows are named
    } else {
      prefix |= static_cast<unsigned>(b) << shift;
      mask |= 255u << shift;
      thresh = prefix;
    }
  }
  // rows above the threshold, and the first `need` at it in index order
  int before = 0;  // rows at the threshold in earlier tiles
  for (int t0 = 0; t0 < n; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    const unsigned v = i < n ? c[i] : 0u;
    const bool tie = !all && v == thresh;
    const unsigned ties = __ballot_sync(kFull, tie);
    if (lane == 0) warp_n[warp] = __popc(ties);
    __syncthreads();
    int pos = before + __popc(ties & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      if (w < warp) pos += warp_n[w];
      total += warp_n[w];
    }
    before += total;
    const bool take = v != 0u && (all || v > thresh || (tie && pos < need));
    if (i < n) {
      if (take)
        picked[atomicAdd(&n_picked, 1)] = i;
      else
        slot[i] = -1;
    }
    __syncthreads();
  }
  // rank the picked rows by (count desc, index asc)
  const int m = n_picked;
  if (static_cast<int>(threadIdx.x) < m) {
    const int i = picked[threadIdx.x];
    const unsigned v = c[i];
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const int k = picked[j];
      const unsigned w = c[k];
      rank += (w > v || (w == v && k < i)) ? 1 : 0;
    }
    slot[i] = rank;
    hot[rank] = i;
  } else if (static_cast<int>(threadIdx.x) < kHot) {
    hot[threadIdx.x] = -1;
  }
}

// ---------------------------------------------------------------------------
// The ray order of a record (rt_champ_order): the rays with g != 0, the
// longest key first, rays of one key in ray order. A ray's key is the
// number of its leading recorded ids in [0, n_obj): at least the segments
// that ray_adjoint_champ tapes. A stable counting sort over tiles of
// kOrderTile rays on the digit n_seg - key: the counts per (digit, tile),
// one block's exclusive scan of them in (digit, tile) order, and a scatter
// that ranks each tile's rays by warp votes.
// ---------------------------------------------------------------------------

constexpr int kOrderBlock = 256;
constexpr int kOrderWarps = kOrderBlock / 32;
constexpr int kOrderPer = 4;  // rays per thread
constexpr int kOrderTile = kOrderBlock * kOrderPer;
constexpr int kDigits = kMaxSeg + 1;  // keys 0 ... n_seg
constexpr int kDropped = 255;         // the digit of a ray with g == 0
constexpr int kScanBlock = 1024;
constexpr int kScanPer = 8;  // entries per thread and chunk of the scan
constexpr int kScanChunk = kScanBlock * kScanPer;

// Ray j of tile t's chunk c, thread x: chunks of kOrderBlock consecutive
// rays, so that a chunk's warps hold its rays in ray order.
__device__ __forceinline__ int tile_ray(int tile, int c) {
  return tile * kOrderTile + c * kOrderBlock + static_cast<int>(threadIdx.x);
}

// Each tile's rays: the digit of each (keys, one byte per ray; kDropped
// for g == 0 or past n_rays) and the tile's count of each digit into
// counts[digit * n_tiles + tile]. A thread's kOrderPer rays read their ids
// segment by segment together, each up to its first id outside [0, n_obj).
__global__ void __launch_bounds__(kOrderBlock)
    order_count_kernel(const int* __restrict__ ids, int n_seg, int n_rays,
                       int n_obj, const float* __restrict__ g,
                       uint8_t* __restrict__ keys, int* __restrict__ counts,
                       int n_tiles) {
  __shared__ int hist[kDigits];
  const int tile = blockIdx.x, lane = threadIdx.x & 31;
  if (threadIdx.x < kDigits) hist[threadIdx.x] = 0;
  int key[kOrderPer];
  bool run[kOrderPer], live[kOrderPer];
#pragma unroll
  for (int c = 0; c < kOrderPer; ++c) {
    const int rid = tile_ray(tile, c);
    live[c] = false;
    if (rid < n_rays) {
      const float* gr = g + 3 * static_cast<size_t>(rid);
      live[c] = __ldg(gr) != 0.0f || __ldg(gr + 1) != 0.0f ||
                __ldg(gr + 2) != 0.0f;
    }
    run[c] = live[c];
    key[c] = 0;
  }
  for (int s = 0; s < n_seg; ++s) {
    int v[kOrderPer];
#pragma unroll
    for (int c = 0; c < kOrderPer; ++c)
      v[c] = run[c] ? __ldg(ids + static_cast<size_t>(s) * n_rays +
                            tile_ray(tile, c))
                    : -1;
    bool any = false;
#pragma unroll
    for (int c = 0; c < kOrderPer; ++c) {
      run[c] = run[c] && static_cast<unsigned>(v[c]) <
                             static_cast<unsigned>(n_obj);
      key[c] += run[c] ? 1 : 0;
      any = any || run[c];
    }
    if (!any) break;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kOrderPer; ++c) {
    const int rid = tile_ray(tile, c);
    const int digit = live[c] ? n_seg - key[c] : kDropped;
    if (rid < n_rays) keys[rid] = static_cast<uint8_t>(digit);
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit != kDropped && (peers & ((1u << lane) - 1u)) == 0u)
      atomicAdd(&hist[digit], __popc(peers));
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) <= n_seg)
    counts[threadIdx.x * n_tiles + tile] = hist[threadIdx.x];
}

// One block: counts (n entries in (digit, tile) order) replaced by their
// exclusive prefix sums, and *n_live = their total. A chunk of kScanChunk
// entries at a time: read into shared memory in coalesced loads, thread x
// scans a run of kScanPer consecutive entries after a block scan of the
// runs' sums, and the chunk goes back in coalesced stores.
__global__ void __launch_bounds__(kScanBlock)
    order_scan_kernel(int* __restrict__ counts, int n,
                      int* __restrict__ n_live) {
  __shared__ int buf[kScanChunk];
  __shared__ int warp_sum[kScanBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += kScanChunk) {
    const int m = min(kScanChunk, n - c0);
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = k * kScanBlock + static_cast<int>(threadIdx.x);
      if (i < m) buf[i] = counts[c0 + i];
    }
    __syncthreads();
    int v[kScanPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = static_cast<int>(threadIdx.x) * kScanPer + k;
      v[k] = i < m ? buf[i] : 0;
      sum += v[k];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += x;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kScanBlock / 32; ++w) {
      if (w < warp) before += warp_sum[w];
      total += warp_sum[w];
    }
    int run = carry + before + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = static_cast<int>(threadIdx.x) * kScanPer + k;
      if (i < m) buf[i] = run;
      run += v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = k * kScanBlock + static_cast<int>(threadIdx.x);
      if (i < m) counts[c0 + i] = buf[i];
    }
    carry += total;
    __syncthreads();  // buf and warp_sum are reused by the next chunk
  }
  if (threadIdx.x == 0) *n_live = carry;
}

// Each tile's rays to their places: order[offset of (digit, tile) + the
// rays of that digit before it in the tile] = rid. Chunk by chunk, warp by
// warp, lane by lane, so that a digit's rays keep ray order.
__global__ void __launch_bounds__(kOrderBlock)
    order_scatter_kernel(const uint8_t* __restrict__ keys, int n_seg,
                         int n_rays, const int* __restrict__ offsets,
                         int n_tiles, int* __restrict__ order) {
  __shared__ int base[kDigits];
  __shared__ int wc[kOrderWarps][kDigits];
  const int tile = blockIdx.x, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  if (static_cast<int>(threadIdx.x) <= n_seg)
    base[threadIdx.x] = offsets[threadIdx.x * n_tiles + tile];
  for (int c = 0; c < kOrderPer; ++c) {
    for (int i = threadIdx.x; i < kOrderWarps * kDigits; i += blockDim.x)
      (&wc[0][0])[i] = 0;
    __syncthreads();
    const int rid = tile_ray(tile, c);
    const int digit = rid < n_rays ? keys[rid] : kDropped;
    const unsigned peers = __match_any_sync(kFull, digit);
    const unsigned below = peers & ((1u << lane) - 1u);
    if (digit != kDropped && below == 0u) wc[warp][digit] = __popc(peers);
    __syncthreads();
    if (digit != kDropped) {
      int pos = base[digit] + __popc(below);
      for (int w = 0; w < warp; ++w) pos += wc[w][digit];
      order[pos] = rid;
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) <= n_seg)
      for (int w = 0; w < kOrderWarps; ++w)
        base[threadIdx.x] += wc[w][threadIdx.x];
    __syncthreads();
  }
}

// rt_champ_order's scratch in ints: the order (n_rays), the live count
// (padded to 4), the (digit, tile) counts, the digits (a byte per ray).
struct OrderScratch {
  int n_tiles, n_counts, n_words;
  size_t live, counts, keys;  // offsets in ints
};

__host__ __device__ inline OrderScratch order_scratch(int n_rays, int n_seg) {
  OrderScratch s;
  s.n_tiles = (n_rays + kOrderTile - 1) / kOrderTile;
  s.n_counts = (n_seg + 1) * s.n_tiles;
  s.live = static_cast<size_t>(n_rays);
  s.counts = s.live + 4;
  s.keys = s.counts + static_cast<size_t>(s.n_counts);
  s.n_words = static_cast<int>(s.keys + (static_cast<size_t>(n_rays) + 3) / 4);
  return s;
}

}  // namespace

// C interface (bound with ctypes).

// The hot rows of a record for kernel 3: the triangle ids of `ids` (n_ids
// int32, kernel 1's record: n_sph + triangle j; any other id is not
// counted) counted into `counts` (n_tri ints of scratch), then `slot`
// (n_tri ints) gets each triangle row's slot (its rank among the kHot rows
// named most, ties to the lower index; -1 for any other row) and `hot`
// (n_hot ints, n_hot == kHot) each slot's row (-1 unused). A memset and two
// launches on `stream`; allocates nothing, does not synchronise; returns
// the first error.
extern "C" int rt_champ_hot_rows(const int* ids, int n_ids, int n_sph,
                                 int n_tri, int* counts, int* slot, int* hot,
                                 int n_hot, void* stream) {
  if (n_ids < 0 || n_sph < 0 || n_tri < 0 || n_hot != kHot ||
      hot == nullptr || (n_ids > 0 && ids == nullptr) ||
      (n_tri > 0 && (counts == nullptr || slot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tri > 0) {
    const cudaError_t err =
        cudaMemsetAsync(counts, 0, sizeof(int) * n_tri, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_ids > 0 && n_tri > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long need = (static_cast<long long>(n_ids) + kCountBlock - 1) /
                           kCountBlock;
    const int grid = static_cast<int>(need < sms ? need : sms);
    // the 16-byte loads need an aligned record (torch's allocations are)
    if ((reinterpret_cast<uintptr_t>(ids) & 15u) != 0u)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        n_tri <= kCountShared ? sizeof(int) * static_cast<size_t>(n_tri) : 0;
    hot_count_kernel<<<grid, kCountBlock, smem, st>>>(ids, n_ids, n_sph,
                                                      n_tri, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hot_select_kernel<<<1, kSelectBlock, 0, st>>>(counts, n_tri, n_ids, slot,
                                                hot);
  return static_cast<int>(cudaGetLastError());
}

// The ints of rt_champ_order's scratch for a record of n_seg segments
// (1 ... kMaxSeg) of n_rays rays; -1 for another shape.
extern "C" int rt_champ_order_words(int n_rays, int n_seg) {
  if (n_rays < 0 || n_seg < 1 || n_seg > kMaxSeg) return -1;
  return order_scratch(n_rays, n_seg).n_words;
}

// Kernel 3's ray order of a record: `ids` (n_seg, n_rays) int32 (kernel 1's
// record; ids in [0, n_obj) are objects) and the cotangent `g` (n_rays, 3)
// give, in `scratch` (n_words ints, rt_champ_order_words), the rays with g
// != 0 in order (scratch[0 ... n_live)), the longest key first, rays of
// one key in ray order, and n_live = scratch[n_rays]. Three launches on
// `stream` (a memset of n_live for no rays); allocates nothing, does not
// synchronise; returns the first error.
extern "C" int rt_champ_order(const int* ids, int n_seg, int n_rays,
                              int n_obj, const float* g, int* scratch,
                              int n_words, void* stream) {
  if (n_rays < 0 || n_seg < 1 || n_seg > kMaxSeg || n_obj < 0 ||
      scratch == nullptr || n_words != order_scratch(n_rays, n_seg).n_words ||
      (n_rays > 0 && (ids == nullptr || g == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const OrderScratch s = order_scratch(n_rays, n_seg);
  int* live = scratch + s.live;
  if (n_rays == 0)
    return static_cast<int>(cudaMemsetAsync(live, 0, sizeof(int), st));
  int* counts = scratch + s.counts;
  uint8_t* keys = reinterpret_cast<uint8_t*>(scratch + s.keys);
  order_count_kernel<<<s.n_tiles, kOrderBlock, 0, st>>>(
      ids, n_seg, n_rays, n_obj, g, keys, counts, s.n_tiles);
  order_scan_kernel<<<1, kScanBlock, 0, st>>>(counts, s.n_counts, live);
  order_scatter_kernel<<<s.n_tiles, kOrderBlock, 0, st>>>(
      keys, n_seg, n_rays, counts, s.n_tiles, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Adds the cotangents of one pass into dpar (26,), dsph (S, 8), dtri (T,
// 32), dmat (M, 4), dlig (L, 20), which the caller zeroes (tri, dsph and
// dtri 16-byte aligned: read and added in 16-byte words); `wrt` is a bit
// set of the groups to compute (1 par, 2 sph, 4 tri, 8 mat, 16 lig). `ids`
// (1 + bounces, n_rays) int32 and `occs` ((1 + bounces) * n_lig, n_rays)
// bytes are kernel 1's record of the same pass (occs may be null when
// n_lig == 0); `slot` and `hot` (n_hot == kHot ints) its hot triangle
// rows (rt_champ_hot_rows; needed with tri in wrt and n_tri > 0, else
// ignored). `order`: the record's ray order (rt_champ_order's scratch for
// these ids and g), swept in that order; needed in path mode, null in
// direct mode (which sweeps in ray order).
// (k0, k1) is the pass key of the PRNG route (ignored with
// u_planes). rr != 0: the pass played Russian roulette from depth
// rr_start_depth on. direct != 0: the pass is direct mode's (bounces and
// rr 0, a record of one segment; draws as rt_pathtrace_bwd's). Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int rt_pathtrace_bwd_champ(
    const float* par, const float* sph, int n_sph, const float* tri,
    int n_tri, const float* mat, int n_mat, const float* lig, int n_lig,
    const float* g, const int* ids, const uint8_t* occs, const int* slot,
    const int* hot, int n_hot, const int* order, int n_rays, int ray_offset,
    const float* u_planes, unsigned int k0, unsigned int k1, int spp,
    int width, int bounces, int rr, int rr_start_depth, int direct,
    int two_sided, int normalize_emitter, int wrt, float* dpar, float* dsph,
    float* dtri, float* dmat, float* dlig, void* stream) {
  auto misaligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15u) != 0u;
  };
  // a slab only where the launch adds triangle rows
  const bool slab = (wrt & kWTri) && n_tri > 0;
  if (bounces < 0 || bounces >= kMaxSeg || n_lig > kMaxLights ||
      ids == nullptr || (n_lig > 0 && occs == nullptr) ||
      (direct && (bounces || rr)) ||
      (direct ? order != nullptr : order == nullptr) ||
      (slab && (slot == nullptr || hot == nullptr || n_hot != kHot)) ||
      ((wrt & kWSph) && misaligned(dsph)) ||
      ((wrt & kWTri) && misaligned(dtri)) ||
      (n_tri > 0 && misaligned(tri)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || wrt == 0) return static_cast<int>(cudaGetLastError());
  AdjParams p = adj_params(par, sph, n_sph, tri, n_tri, mat, n_mat, lig,
                           n_lig, g, n_rays, ray_offset, u_planes, k0, k1,
                           spp, width, bounces, rr_start_depth, two_sided,
                           normalize_emitter, wrt, dpar, dsph, dtri, dmat,
                           dlig);
  p.ids = ids;
  p.occs = occs;
  if (direct) set_direct_keys(p);
  // direct mode keeps no tape
  const size_t smem =
      sizeof(float) * (2 * (kParPad + kMat * n_mat + kLig * n_lig) +
                       (slab ? kWarps * kSlabWords : 0)) +
      (direct ? 0 : tape_bytes(bounces, kBlock));
  using Kernel = void (*)(AdjParams, const int*, const int*, const int*);
  const Kernel kernel = direct ? pathtrace_bwd_champ_kernel<false, true>
                        : rr   ? pathtrace_bwd_champ_kernel<true, false>
                               : pathtrace_bwd_champ_kernel<false, false>;
  // a grid-stride loop over a grid the card holds at once: each block
  // flushes its mat / lig / par buffers and its slabs once
  int grid = 0;
  const cudaError_t err = fit_grid(kernel, kBlock, smem, n_rays, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      p, slab ? slot : nullptr, slab ? hot : nullptr, order);
  return static_cast<int>(cudaGetLastError());
}
