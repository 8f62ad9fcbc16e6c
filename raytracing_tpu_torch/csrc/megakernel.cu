// The whole progressive path-tracing pass as one CUDA kernel for Hopper
// (sm_90a), K passes per launch.
//
// Replaces: raytracing_tpu/ops/pallas/megakernel.py::_render_pass_kernel
// (launcher pathtrace_pass_pallas), path mode over resident tables with
// u-planes or PRNG draws and spp >= 1, with or without Russian roulette,
// its champion recording (record=True) for the cell backward, and its
// direct mode (mode="direct", a kernel of its own below), its uniform-grid
// mode and its streamed Morton chunks (below) and its blocked layout (a
// thread's slot maps to a pixel block, below).
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
// What bounds it on this card: instruction issue and latency, not bytes.
// A launch moves 12 B/ray of accumulator each way (plus 8 B per draw slot
// in u-planes mode); a cornell pass needs ~1,900 FP32 operations per ray by
// the count of chip_smoke.py (its OPS_* constants: a lower bound that
// counts each object test at its discriminant or facing test), 0.030 ms
// per 1024^2 pass at 67 TFLOP/s, while the pass takes 0.58 ms: the
// threefry draws (integer work, not counted), the divergent shading and the
// dependent loads of the object loops set the pace. Measured before this
// design (one H100 80GB HBM3, 700 W): the sphere mask read and tested
// before the discriminant cost 19% of a sphere_field(1024) pass (8.14 ->
// 6.56 ms with the mask behind the candidate test); at cornell's traces
// in a 16-pass launch only 59% of a warp's lanes were active (paths end at
// different depths and each lane's pass loop waited for the warp's longest
// path).
// The design follows from that:
//   * one thread per ray over a flat 1-D grid, no tiles: the TPU's
//     vector-wide masking becomes per-ray branches, so a dead path stops
//     at once and a shadow ray stops at its first hit;
//   * path regeneration across the K passes of a launch: one loop
//     iteration traces one segment, and a lane whose path has ended starts
//     its next pass at once, so a warp's lanes trace together whatever
//     their pass and depth (cornell 16-pass launches 0.650 -> 0.606 ms per
//     pass). Regenerating across rays as well (a grid the card holds, each
//     lane walking its rays) measured slower on both cells and was dropped;
//   * the object loops test the discriminant (or the facing test) first
//     and read a row's mask only for a candidate that beats the champion,
//     which changes no result since a masked row never becomes champion
//     (sphere_field(1024) 8.14 -> 6.55 ms, cornell 0.59 -> 0.575 ms);
//   * the sphere loop computes the discriminants of kRows rows before it
//     looks at any candidate, so their loads and arithmetic overlap: 8 rows
//     for a table of kWideSpheres or more, 2 rows below. The 8-row loop
//     takes 71 registers against 56 and pays only on long tables; per
//     pass, 2 / 8 rows: cornell 0.578 / 0.64 ms, sphere_field(64) 0.150 /
//     0.213, (256) 0.78 / 0.94, (512) 1.92 / 1.92 in 16-pass launches and
//     2.57 / 2.47 ms in one-pass launches, sphere_field(1024) recording
//     6.18 / 5.47 ms. Two other designs measured slower and were dropped:
//     rows read as float4s with the champion's normal deferred past the
//     loop and the next row prefetched (71 registers: 8.2 ms on
//     sphere_field(1024)), and float4 reads alone (no faster than the
//     LDS.128 the compiler already makes of the aligned rows,
//     pathtrace.cuh);
//   * the scene tables are copied into shared memory once per block and
//     looped over; every thread of a warp reads the same word, a
//     broadcast. Up to 4608 spheres stay resident, as JAX's kernel keeps
//     36K floats in SMEM: sphere_field(1024) takes 32 KB, cornell ~1.4 KB.
//     Above 48 KB the launch opts into dynamic shared memory (at most
//     227 KB on the H100);
//   * acc lives in registers across the K passes of a launch;
//   * the draws are made in-kernel by threefry2x32 (threefry.cuh), so
//     PRNG mode reads no draw bytes and equals the JAX package's
//     u_planes_for_pass bit for bit; the lens and bounce draws share one
//     call site so lanes at different depths draw together;
//   * recording (non-null ids) writes each segment's champion right after
//     its trace and each NEE occlusion bit, 4 B + L B per segment and ray,
//     coalesced across a warp; a path that dies still writes a miss into
//     its remaining slots, so no slot keeps a stale value. The arithmetic
//     is that of the non-recording launch (one binary, a runtime pointer),
//     so the two accumulators are bit-equal.
// Times (one H100 80GB HBM3, 700 W, python -m
// raytracing_tpu_torch.profile_kernels, beside the earlier design built in
// the same run): cornell 1024^2 b5 0.579 ms per pass in 16-pass launches
// (0.645 before), 0.590 ms in one-pass launches (0.620);
// sphere_field(1024) recording 5.48 ms (8.09).
//
// Grid mode (the template parameter kGrid of both kernels; the instances
// without it keep their code and registers): the Pallas kernel's grid
// operands (megakernel.py:325-350, closest hit :932-1019, any-hit
// :1146-1321) visit every cell whose tight AABB a ray tile's window
// overlaps, in a baked front-to-back order, and stop a tile once no lane
// can gain (_loop_early): the TPU's vector-wide form of a per-ray march.
// Here each ray walks its own cells in order (pathtrace.cuh grid_walk, a
// 3-axis DDA) and stops at its own champion, so no cell order is baked.
// The brute prefix stays in shared memory: the triangles below the grids'
// start (cornell's walls) and the spheres unless the sphere grid is on.
// A triangle grid's rows are read from its cell-major copy
// (render/mega.py grid_cells, rebuilt on the card every call from the
// call's tables): a visited cell's rows are contiguous, in leaves of
// ops/megakernel.py GRID_LEAF rows under a box tree of the cell's own,
// which each lane walks nearest child first over its live window (the
// kCells instances, pathtrace.cuh cell_walk). The sphere grid's cells are
// walked through the CSR, every item from the whole table (a tree per
// cell, walked per lane or per warp, and the copy's rows alone measured
// slower there: a sphere's test is cheaper than a node's, the copy holds
// each sphere 2.85 times and L1 holds less of it). What bounded the walk
// before the copies (one H100 80GB HBM3, 700 W, profile_kernels --only
// grid): every item of a visited cell read through its index, one
// dependent load at a time, 74-146 triangles per cell of the torus scene;
// the cell walk tests ~8 node boxes and ~0.5 rows per walk there, and
// took the mesh grid's path pass from 7.03 to 5.87 ms. Its instances ask
// for 7 blocks per SM (72 registers, kCellMinBlocks; direct mode 8):
// left free, ptxas gave them 128 registers, and 16 warps per SM ran the
// walk slower than 28 with spills (PERF.md §6, row 1c). Champions are the
// least (t, id) pair, so a record names the row the brute loops would
// (the original row: sphere i or n_sph + fold index j, never a copied or
// duplicated row), and kernel 3 differentiates it unchanged.
//
// Streamed tables (JAX's Morton chunks, megakernel.py:874-935 and
// :1226-1270; pathtrace.cuh Stream): a triangle table past 64 rows outside
// grid mode, and a sphere table past 4608 rows without a sphere grid, stay
// in global memory in their Morton-sorted copy, with the walk's layout over
// it (render/mega.py chunk_tree): leaf boxes over runs of 2 sorted rows,
// an implicit binary tree of boxes over the leaves, and the loose rows
// (room-sized: cornell's walls), which no box holds. They run in instances
// of the grid-mode build of their own (template parameter kStream, 2-row
// resident sphere loop only: three more instances), whose grid walks are
// skipped when there is no grid; the grid-only instances keep their code,
// since stream loops in them cost grid direct mode 10-15% per pass (96
// registers against 72; one H100 80GB HBM3, 700 W, profile_kernels). The
// shared-memory prefix is empty for a streamed table. Each thread tests
// the loose rows, then walks the tree, culling a node whose box its live
// window [mint, min(maxt, champion t)] misses, with a stack of a level's
// depth, and tests a visited leaf's rows a few at a time (pathtrace.cuh
// lane_walk, warp_walk, leaf_rows). Triangles are walked by each lane
// nearest child first; spheres by the warp over the union of its lanes'
// trees (a node entered when any lane's window overlaps it), which saves
// the walk's steps where a row's test is cheap: each schedule measured
// the faster on its own table kind, and staging a leaf's rows in shared
// memory slower (PERF.md, PR 14). What bounded PR 9's loop,
// which slab-tested every chunk in Morton order and ran each overlapped
// chunk's 128 rows one dependent load at a time: Morton order is not front
// to back, so the champion culled few chunks, and the walls widened most
// chunk boxes to the room. A candidate wins on the least (t, original id)
// pair, so the record names original rows and the champion is the brute
// loops' in any visiting order (JAX keeps the first in Morton order at an
// exact tie). Times in PERF.md.
//
// A resident sphere table past ops/megakernel.py SPH_BRUTE_MAX[mode] rows
// (the kTree instances of pathtrace_kernel and direct_kernel, recording and
// not, picked when rt_pathtrace_pass or rt_direct_pass is given a tree; the
// brute build only, so the default and the --fmad=false builds carry
// them): the sphere loop of every trace and shadow ray becomes the walk of
// a box tree over the rows (pathtrace.cuh tree_walk: each lane's own walk
// in path mode, the warp's union of its lanes' walks in direct mode), the
// triangle loop after it unchanged. The tree (ops/megakernel.py
// SphereTree: the rows Morton-sorted, leaves of one row, node boxes
// widened by CHUNK_PAD of the rows' scale) is built from the call's own
// rows on the card by one launch of csrc/sphere_tree.cu, since a training
// step changes the table every step; the sorted rows and nodes are read
// from global memory, so the spheres are not staged in shared memory. What
// bounded the brute loop: it tested every row of the table per ray and
// shadow ray from shared memory, 20 FP32 operations and a broadcast read
// per sphere, near its instruction-rate ceiling; the walk tests ~80 node
// boxes and ~2.3 rows per ray in direct mode on sphere_field(1024)
// (MK.direct_walk_reference) and ~170 node boxes and ~6 rows per ray of a
// path pass at b5 (MK.pathtrace_walk_reference). Each visited row runs the
// brute loop's arithmetic and the least (t, original index) pair wins, so
// acc, ids and occs are the brute instances' bit for bit under the same
// build flags. Times in PERF.md §6, rows 1d and 1s.
//
// One build holds one half of the instances: the brute ones, or, with
// -DRT_GRID_MODE=1 (ops/megakernel.py GRID_FLAGS), grid mode's, which also
// stream. The wrappers load the half a launch needs, so nvcc compiles the
// halves at once as two libraries, and a program that walks no grid and
// streams no table never builds grid mode.
//
// Blocked layout (block > 0, JAX's mega_block; grid mode and streaming):
// consecutive thread slots cover block x block pixel squares, so a warp's
// rays are neighbours and walk the same cells. Only the slot -> ray map
// changes: every draw, accumulator slot and record column stays keyed by
// the row-major ray id, so the image is bit-identical with and without
// blocking. In the brute instances the map cost the 2-row path loop 20 B
// of spill (ptxas) for nothing to gain, so they keep the row-major map.
//
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

#ifndef RT_GRID_MODE
#define RT_GRID_MODE 0
#endif
constexpr bool kGridBuild = RT_GRID_MODE != 0;

namespace {

using namespace rt;

constexpr int kBlock = 128;
constexpr int kMaxPasses = 64;  // pass keys carried in the parameter block
// Blocks per SM that the grid-mode build's instances ask registers for
// (__launch_bounds__): path mode walking cell trees or streams 7 (72
// registers), path mode over the sphere grid alone and direct mode over
// grids 8 (64). Left free, ptxas gave the cell walk's instances 128
// registers (the mesh grid's path pass 6.48 against 5.87 ms at 7 blocks),
// the streamed ones 118 (+19-30% per pass) and the sphere grid's 76
// (1.55 against 1.39 ms at 8 blocks): 16-24 warps per SM ran these walks
// slower than 28-32 with spills (PERF.md §6, row 1c).
constexpr int kCellMinBlocks = 7;
constexpr int kGridMinBlocks = 8;
// The sphere tree's direct instances (kTree) likewise: left free, ptxas gave
// them 83 registers (5 blocks of 128 per SM) and sphere_field(1024)'s
// recording walk ran 505 us against 420 at 8 blocks (61 registers, no
// spill; PERF.md §6, row 1d)
constexpr int kTreeMinBlocks = 8;
// Path mode's (kTree of pathtrace_kernel, each lane's own walk): at 8
// blocks 64 registers, 176 B of stack, 16-20 B spilled, and
// sphere_field(1024)'s 1024^2 b5 pass ran 3.26 ms against 3.31 at 7 blocks
// (70 registers, no spill) and 3.32 at 6 (PERF.md §6, row 1s)
constexpr int kPathTreeMinBlocks = 8;
constexpr int kWideSpheres = 512;  // from here the 8-row sphere loop

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
  // the record of a ray that is not traced: n_seg misses, no occluder
  __device__ __forceinline__ void miss(int n_seg, int n_lig) const {
    for (int s = 0; s < n_seg; ++s) id(s, -1);
    for (int k = 0; k < n_seg * n_lig; ++k) occ(k, false);
  }
};

// Whether a recording launch skips ray rid: `live` is the cotangent (n_rays,
// 3) of the pass that the record is for (null: every ray is traced), and a
// ray whose row is 0 is one that kernel 3 never reads (pathtrace_adj.cuh
// for_rays, the same test), so the launch that records for kernel 2 past 64
// objects traces only the rays whose cotangent it needs.
__device__ __forceinline__ bool skip_ray(const float* live, int rid) {
  if (live == nullptr) return false;
  const float* g = live + 3 * static_cast<size_t>(rid);
  return !(g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f);
}

// Next-event estimation for light li with draw slot `slot`: shadow ray to
// a sampled disk point, shade with the pre-update throughput, then
// throughput *= albedo. A hit with no valid material adds nothing.
// Returns the occlusion bit (false without a valid hit, as JAX's dead
// window gives).
template <int kRows, bool kGrid, bool kStream, bool kCells, bool kTree>
__device__ __forceinline__ bool nee(const Tables& T, const Grids* G,
                                    const Stream* S, const Draws& D,
                                    int slot, int li, const Hit& h, float eps,
                                    Acc& A) {
  if (!(h.m >= 0.0f)) return false;
  const float* l = T.lig + li * kLig;
  const Shadow s = shadow_ray(T, D, slot, li, h, eps);
  const bool occ =
      anyhit<kRows, kGrid, kStream, kCells, kTree ? kLaneTree : kNoTree>(
          T, s.so, s.sd, 0.0f, s.dist, G, S);
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

// The passes of ray rid_g, added into A.r/g/b, one trace segment per loop
// iteration: a lane whose path has ended starts its next pass at once
// (path regeneration), so the lanes of a warp trace together whatever
// their pass and depth. Each ray's passes and segments run in the order
// of the schedule, so acc is what pass after pass would give. kRR: Russian
// roulette from depth rr_start on (a template parameter, so the build
// without it keeps its registers and code); kTree: the resident spheres
// walked as S, their box tree (trace and anyhit).
template <int kRows, bool kRR, bool kGrid, bool kStream, bool kCells,
          bool kTree>
__device__ void passes(const Tables& T, const Grids* G, const Stream* S,
                       Draws& D, const Rec& R,
                       const uint32_t* keys, int n_passes, int rid_g,
                       int spp, int width, int bounces, int rr_start,
                       bool normalize_emitter, Acc& A) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  int col, row, samp;
  pixel_of(rid_g, spp, width, col, row, samp);
  V3 o, d;
  float mint, maxt;
  Hit h;
  int k = 0;       // the lane's pass
  int depth = -1;  // its segment in that pass; -1: the pass starts
  while (k < n_passes) {
    const bool fresh = depth < 0;
    if (fresh && keys != nullptr) {
      D.k0 = keys[2 * k];
      D.k1 = keys[2 * k + 1];
    }
    // one draw site for the lens and the bounce, so lanes at different
    // depths make their draws together (spp > 1 takes no lens draw)
    float u0, u1;
    if (fresh && spp > 1)
      lens_uv(D, samp, spp, u0, u1);
    else
      D.pair(fresh ? 0 : bounce_slot(depth, L, kRR), u0, u1);
    if (fresh) {
      camera_ray_uv(T.par, u0, u1, col, row, o, d, mint, maxt);
    } else {
      float cx, cy, cz;
      bounce_ray_uv(u0, u1, h, eps, cx, cy, cz, o, d);
      mint = 0.0f;
      maxt = inf_f();
    }
    depth += 1;
    maxt = trace<kRows, kGrid, kStream, kCells,
                 kTree ? kLaneTree : kNoTree>(T, o, d, mint, maxt, h, G, S);
    R.id(depth, h.obj);  // before the emitter test, as JAX records it
    if (fresh) {
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
    }
    for (int li = 0; li < L; ++li)
      R.occ(depth * L + li,
            nee<kRows, kGrid, kStream, kCells, kTree>(
                T, G, S, D, nee_slot(depth, li, L, kRR), li, h, eps, A));
    // a path without a valid hit stays dead: nothing more accumulates
    bool more = depth < bounces && h.m >= 0.0f;
    if (kRR && more && depth >= rr_start) {
      V3 tp = mk(A.tr, A.tg, A.tb);
      more = rr_survive(D, depth, L, tp);
      A.tr = tp.x;
      A.tg = tp.y;
      A.tb = tp.z;
    }
    if (more) continue;
    // the dead path's remaining segments (ended by a miss or by the
    // roulette): a miss and no occlusion, as JAX's dead window (mint =
    // maxt = inf) records them
    if (R.ids != nullptr) {
      for (int s = depth + 1; s <= bounces; ++s) {
        R.id(s, -1);
        for (int li = 0; li < L; ++li) R.occ(s * L + li, false);
      }
    }
    k += 1;
    depth = -1;
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
  int rr_start;    // first depth of the roulette (kernel with kRR)
  int two_sided, normalize_emitter;
  int* ids;        // (1 + bounces, n_rays) or nullptr: not recording
  uint8_t* occs;   // ((1 + bounces) * n_lig, n_rays) or nullptr
  const float* live;  // recording: trace only these rays (skip_ray)
  int block;       // blocked layout's block edge, 0: row-major
  Grids grids;     // grid mode (kernel with kGrid)
  Stream tree;     // the spheres' tree (kernel with kTree)
};

// The row-major ray of thread slot `slot` in the blocked layout: slots
// fill block x block pixel squares, squares row by row (JAX's
// _effective_block decode; spp rays per pixel stay together).
__device__ __forceinline__ int blocked_ray(int slot, int spp, int width,
                                           int block) {
  const int pix = slot / spp;
  const int samp = slot - pix * spp;
  const int bb = block * block;
  const int bid = pix / bb;
  const int w_in = pix - bid * bb;
  const int per_row = width / block;
  const int brow = bid / per_row;
  const int bcol = bid - brow * per_row;
  const int wrow = w_in / block;
  const int row = brow * block + wrow;
  const int col = bcol * block + (w_in - wrow * block);
  return (row * width + col) * spp + samp;
}

// Tables of a launch in shared memory: in grid mode only the brute prefix
// (triangles below the grids' start, none when they stream; the spheres
// unless gridded or streamed); n_sph stays the whole table's, as the ids
// number triangles after it.
template <bool kGrid>
__device__ __forceinline__ Tables stage_launch_tables(
    float* smem, const float* par, const float* sph, int n_sph,
    const float* tri, int n_tri, const float* mat, int n_mat,
    const float* lig, int n_lig, bool two_sided, const Grids& G) {
  Tables T = stage_tables(smem, par, sph,
                          kGrid ? G.sph_resident(n_sph) : n_sph, tri,
                          kGrid ? G.tri_start : n_tri, mat, n_mat, lig,
                          n_lig, two_sided);
  T.n_sph = n_sph;
  return T;
}

// Params is __grid_constant__: the per-pass key reads index the parameter
// block in place instead of copying it to each thread's stack.
// kRows: sphere rows per iteration of the object loops (pathtrace.cuh);
// kRR: Russian roulette; kGrid: grid mode's global tables; kStream: the
// streamed chunks as well; kCells: triangle grids, walked through their
// cell-major copies; kTree: the resident spheres walked as a box tree
// (pathtrace.cuh warp_walk) from global memory, not staged in shared
// memory (the instances without them keep their code)
template <int kRows, bool kRR, bool kGrid, bool kStream, bool kCells,
          bool kTree = false>
__global__ void __launch_bounds__(
    kBlock, kTree ? kPathTreeMinBlocks
            : kGrid ? (kCells || kStream ? kCellMinBlocks : kGridMinBlocks)
                    : 1)
    pathtrace_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  Tables T = stage_launch_tables<kGrid>(
      reinterpret_cast<float*>(smem4), p.par, p.sph, kTree ? 0 : p.n_sph,
      p.tri, p.n_tri, p.mat, p.n_mat, p.lig, p.n_lig, p.two_sided != 0,
      p.grids);
  T.n_sph = p.n_sph;  // triangle ids count every sphere
  __syncthreads();

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= p.n_rays) return;
  // the blocked layout is grid mode's (the brute instances keep their
  // registers and spills; their rays hold no cell coherence to gain)
  const int rid = kGrid && p.block
                      ? blocked_ray(slot, p.spp, p.width, p.block)
                      : slot;

  const int rid_g = rid + p.ray_offset;
  const int n_draws = n_draws_of(p.n_lig, p.bounces, kRR);
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
  if (skip_ray(p.live, rid)) {
    R.miss(1 + p.bounces, p.n_lig);
    return;
  }

  float* a = p.acc + 3 * static_cast<size_t>(rid);
  Acc A;
  A.r = a[0];
  A.g = a[1];
  A.b = a[2];
  passes<kRows, kRR, kGrid, kStream, kCells, kTree>(
      T, &p.grids, &p.tree, D, R, p.u == nullptr ? p.keys : nullptr,
      p.n_passes, rid_g, p.spp, p.width, p.bounces, p.rr_start,
      p.normalize_emitter != 0, A);
  a[0] = A.r;
  a[1] = A.g;
  a[2] = A.b;
}

// ---------------------------------------------------------------------------
// Direct mode (JAX's mode="direct", megakernel.py:1362-1401): per pass and
// ray the primary hit, then per light a concentric disk sample, a shadow
// ray and albedo * clip(ambient + (occluded ? 0 : cos), 0, 1). No emitter
// term, no throughput, no bounce; K passes per launch, acc in registers.
// A kernel of its own, so path mode's loop pays nothing for it. Recording
// (the kRecord instances, launched for non-null ids, one pass; the
// differentiable direct pass's cell route) writes JAX's one recorded
// segment (megakernel.py:1642-1644): the primary champion and each light's
// occlusion bit (unoccluded without a valid hit), with the arithmetic of
// the launch that does not record.
//
// Draws, in u_planes_for_direct's layout: slot 0 the lens (unused at
// spp > 1), slot 1 + li light li. The PRNG route makes what the stage
// route's render_direct draws: pass p of a call keyed by k_p = key (a
// call of one pass) or fold_in(key, p), the lens from uniform(draw_key(k_p,
// LENS), (R, 2)) and light li from uniform(draw_key(k_p, LIGHT, 0, li),
// (R, 2)), i.e. threefry of slot key j at counter 2 rid + c. Each block
// derives the K (1 + L) slot keys of its launch into shared memory before
// its rays start (four threefry blocks a key), so the host makes no key.
//
// What bounds it: instruction issue, as in path mode. A launch moves 24 B
// of accumulator per ray; a cornell pass needs ~480 FP32 operations per
// ray (chip_smoke.py's OPS_* count), 0.0076 ms per 1024^2 pass at 67
// TFLOP/s, while it takes 0.073 ms per pass in 16-pass launches (one H100
// 80GB HBM3, 700 W): the threefry draws (integer, not counted) and the
// object loops' dependent loads set the pace. 56 registers, 20 B spilled.
// ---------------------------------------------------------------------------

// The direct draws of ray rid: u-planes (plane 2j + c, column rid) or
// threefry of slot key j of pass k at counter 2 rid_g + c.
struct DirectDraws {
  const float* u;
  int n_rays, rid;
  const uint32_t* keys;  // shared memory: 2 words per (pass, slot)
  int n_slots;           // 1 + n_lig
  uint32_t base;         // 2 * rid_g
  __device__ __forceinline__ void pair(int k, int j, float& u0,
                                       float& u1) const {
    if (u != nullptr) {
      u0 = __ldg(u + static_cast<size_t>(2 * j) * n_rays + rid);
      u1 = __ldg(u + static_cast<size_t>(2 * j + 1) * n_rays + rid);
    } else {
      const uint32_t* key = keys + 2 * (k * n_slots + j);
      u0 = threefry_uniform(key[0], key[1], base);
      u1 = threefry_uniform(key[0], key[1], base + 1u);
    }
  }
};

struct DirectParams {
  const float* par;
  const float* sph;
  const float* tri;
  const float* mat;
  const float* lig;
  int n_sph, n_tri, n_mat, n_lig;
  float* acc;  // (n_rays, 3), read once and written once
  int n_rays;
  int ray_offset;
  const float* u;  // (2 * (1 + n_lig), n_rays) or nullptr
  uint32_t k0, k1;  // the call's key (PRNG route)
  int first_pass;   // index of this launch's first pass in the call
  int per_pass;     // 0: a call of one pass, drawn from the key itself
  int n_passes;
  int spp, width;
  int two_sided;
  int* ids;        // (1, n_rays) or nullptr: not recording
  uint8_t* occs;   // (n_lig, n_rays) or nullptr
  const float* live;  // recording: trace only these rays (skip_ray)
  int block;       // blocked layout's block edge, 0: row-major
  Grids grids;     // grid mode (kernel with kGrid)
  Stream tree;     // the spheres' tree (kernel with kTree)
};

// kTree: the resident spheres walked as a box tree (pathtrace.cuh
// warp_walk) from global memory, not staged in shared memory.
template <int kRows, bool kGrid, bool kStream, bool kRecord, bool kCells,
          bool kTree = false>
__global__ void __launch_bounds__(
    kBlock, kTree ? kTreeMinBlocks : kGrid && !kStream ? kGridMinBlocks : 1)
    direct_kernel(const __grid_constant__ DirectParams p) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_sph_smem =
      kTree ? 0 : kGrid ? p.grids.sph_resident(p.n_sph) : p.n_sph;
  Tables T = stage_launch_tables<kGrid>(
      smem, p.par, p.sph, kTree ? 0 : p.n_sph, p.tri, p.n_tri, p.mat,
      p.n_mat, p.lig, p.n_lig, p.two_sided != 0, p.grids);
  T.n_sph = p.n_sph;  // triangle ids count every sphere
  uint32_t* keys = reinterpret_cast<uint32_t*>(
      smem + tables_floats(n_sph_smem, kGrid ? p.grids.tri_start : p.n_tri,
                           p.n_mat, p.n_lig));
  const int n_slots = 1 + p.n_lig;
  if (p.u == nullptr) {
    for (int i = threadIdx.x; i < p.n_passes * n_slots; i += blockDim.x) {
      const int k = i / n_slots;
      const int j = i - k * n_slots;
      uint32_t k0 = p.k0, k1 = p.k1;
      if (p.per_pass) fold_in(k0, k1, static_cast<uint32_t>(p.first_pass + k));
      direct_slot_key(k0, k1, j);
      keys[2 * i] = k0;
      keys[2 * i + 1] = k1;
    }
  }
  __syncthreads();

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= p.n_rays) return;
  // the blocked layout is grid mode's (the brute instances keep their
  // registers and spills; their rays hold no cell coherence to gain)
  const int rid = kGrid && p.block
                      ? blocked_ray(slot, p.spp, p.width, p.block)
                      : slot;
  const int rid_g = rid + p.ray_offset;
  DirectDraws D;
  D.u = p.u;
  D.n_rays = p.n_rays;
  D.rid = rid;
  D.keys = keys;
  D.n_slots = n_slots;
  D.base = 2u * static_cast<uint32_t>(rid_g);
  int col, row, samp;
  pixel_of(rid_g, p.spp, p.width, col, row, samp);
  const float eps = T.par[kEps];
  const float ambient = T.par[kAmbient];

  Rec R;
  R.ids = p.ids;
  R.occs = p.occs;
  R.n_rays = p.n_rays;
  R.rid = rid;
  if (kRecord && skip_ray(p.live, rid)) {
    R.miss(1, p.n_lig);
    return;
  }
  float* a = p.acc + 3 * static_cast<size_t>(rid);
  float ar = a[0], ag = a[1], ab = a[2];
  for (int k = 0; k < p.n_passes; ++k) {
    float u0, u1;
    if (p.spp > 1)
      stratified_uv(samp, p.spp, u0, u1);
    else
      D.pair(k, 0, u0, u1);
    V3 o, d;
    float mint, maxt;
    camera_ray_uv(T.par, u0, u1, col, row, o, d, mint, maxt);
    Hit h;
    trace<kRows, kGrid, kStream, kCells, kTree ? kWarpTree : kNoTree>(
        T, o, d, mint, maxt, h, &p.grids, &p.tree);
    if (kRecord) R.id(0, h.obj);
    if (!(h.m >= 0.0f)) {
      // no valid hit: no shadow ray, recorded unoccluded (JAX's dead
      // window)
      if (kRecord && R.occs != nullptr)
        for (int li = 0; li < p.n_lig; ++li) R.occ(li, false);
      continue;
    }
    const V3 al = albedo(T, static_cast<int>(h.m));
    for (int li = 0; li < p.n_lig; ++li) {
      D.pair(k, 1 + li, u0, u1);
      const Shadow s = shadow_ray_uv(T, u0, u1, li, h, eps);
      const bool occ =
          anyhit<kRows, kGrid, kStream, kCells, kTree ? kWarpTree : kNoTree>(
              T, s.so, s.sd, 0.0f, s.dist, &p.grids, &p.tree);
      if (kRecord) R.occ(li, occ);
      const float cosx = fminf(fmaxf(dot(s.sd, h.n), 0.0f), 1.0f);
      const float shade =
          fminf(fmaxf(ambient + (occ ? 0.0f : cosx), 0.0f), 1.0f);
      ar = ar + al.x * shade;
      ag = ag + al.y * shade;
      ab = ab + al.z * shade;
    }
  }
  a[0] = ar;
  a[1] = ag;
  a[2] = ab;
}

// direct_kernel's instance for a launch: the 8-row sphere loop from
// kWideSpheres resident spheres, the streamed instance when a stream is
// passed, the cell walk's when a triangle grid is (grid-mode build only),
// the sphere tree's when a tree is passed (brute build only).
using DirectKernel = void (*)(DirectParams);

template <bool kRecord, bool kCells>
DirectKernel direct_instance(bool wide, bool streamed, bool tree) {
#if RT_GRID_MODE
  (void)tree;
  if (streamed) return direct_kernel<2, true, true, kRecord, kCells>;
  return wide ? direct_kernel<8, true, false, kRecord, kCells>
              : direct_kernel<2, true, false, kRecord, kCells>;
#else
  (void)streamed;
  if (tree) return direct_kernel<2, false, false, kRecord, false, true>;
  return wide ? direct_kernel<8, false, false, kRecord, false>
              : direct_kernel<2, false, false, kRecord, false>;
#endif
}

// Whether `tree` is a SphereTree (ops/megakernel.py) over n_sph resident
// rows that the kTree instances can walk: the brute build only, n sorted
// rows in whole leaves of up to kCellLeafMax that hold the n_sph rows, a
// well-formed walk layout over them.
bool tree_ok(const Stream& tree, int n_sph) {
  return !kGridBuild && n_sph >= 1 && stream_ok(tree) &&
         tree.leaf <= kCellLeafMax && tree.n >= n_sph &&
         tree.n % tree.leaf == 0 && tree.n - n_sph < tree.leaf;
}

}  // namespace

// C interface (bound with ctypes). `keys` is a HOST array of n_passes pass
// keys (ignored with u_planes), copied into the launch's parameters.
// rr != 0: Russian roulette from depth rr_start_depth on (its draw slots in
// the layout). Non-null `ids` (and `occs` when n_lig > 0) record the
// champions and the occlusion bits of a one-pass launch; with a non-null
// `live` (the pass's cotangent, (n_rays, 3)) only the rays whose row is
// nonzero are traced, the others recorded as misses (skip_ray), and acc is
// scratch. grid_mode != 0 runs
// grid mode over `grids` and the streamed tables `streams` (set_grids; only
// in the build with RT_GRID_MODE=1, which takes nothing else); block > 0
// its blocked layout. A non-null `tree` (a HOST descriptor of the spheres'
// SphereTree, as rt_direct_pass takes it: tree_ok) runs the kTree
// instances, which walk it in place of the sphere loop (the brute build
// only; a malformed tree returns cudaErrorInvalidValue, launching nothing).
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int rt_pathtrace_pass(const float* par, const float* sph, int n_sph,
                                 const float* tri, int n_tri, const float* mat,
                                 int n_mat, const float* lig, int n_lig,
                                 float* acc, int n_rays, int ray_offset,
                                 const float* u_planes, const uint32_t* keys,
                                 int n_passes, int spp, int width, int bounces,
                                 int rr, int rr_start_depth, int two_sided,
                                 int normalize_emitter, int* ids,
                                 uint8_t* occs, const float* live,
                                 int grid_mode,
                                 const GridDesc* grids, int n_grids,
                                 int sph_grid, int tri_start,
                                 const Stream* streams, const Stream* tree,
                                 int block, void* stream) {
  Params p;
  if (n_passes < 1 || n_passes > kMaxPasses || (u_planes && n_passes != 1) ||
      (grid_mode != 0) != kGridBuild || (ids && n_passes != 1) ||
      (!ids && (occs || live)) ||
      (ids && n_lig > 0 && !occs) || block < 0 || (block && !grid_mode) ||
      (tree && !tree_ok(*tree, n_sph)) ||
      !set_grids(p.grids, grids, grid_mode ? n_grids : 0,
                 grid_mode ? sph_grid : 0, grid_mode ? tri_start : n_tri,
                 grid_mode ? streams : nullptr, sph, n_sph, n_tri))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
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
  p.rr_start = rr_start_depth;
  p.two_sided = two_sided;
  p.normalize_emitter = normalize_emitter;
  p.ids = ids;
  p.occs = occs;
  p.live = live;
  p.block = block;
  p.tree = tree ? *tree : Stream{};
  // the tables in shared memory: in grid mode the brute prefix alone, the
  // spheres unless walked as a tree
  const int n_sph_smem = tree ? 0 : p.grids.sph_resident(n_sph);
  const int n_tri_smem = p.grids.tri_start;
  const size_t smem =
      sizeof(float) * tables_floats(n_sph_smem, n_tri_smem, n_mat, n_lig);
  // eight sphere rows per loop iteration for a long table, two for a short
  // one, where the wide loop's registers cost more occupancy than it saves
  const bool wide = n_sph_smem >= kWideSpheres;
  void (*kernel)(Params) =
      rr ? (wide ? pathtrace_kernel<8, true, kGridBuild, false, false>
                 : pathtrace_kernel<2, true, kGridBuild, false, false>)
         : (wide ? pathtrace_kernel<8, false, kGridBuild, false, false>
                 : pathtrace_kernel<2, false, kGridBuild, false, false>);
#if !RT_GRID_MODE
  if (tree)  // the sphere tree's instances (the brute build only)
    kernel = rr ? pathtrace_kernel<2, true, false, false, false, true>
                : pathtrace_kernel<2, false, false, false, false, true>;
#endif
#if RT_GRID_MODE
  const bool streamed = p.grids.tri_st.n || p.grids.sph_st.n;
  if (p.grids.n_tri > 0)  // the cell walk's instances
    kernel = streamed ? (rr ? pathtrace_kernel<2, true, true, true, true>
                            : pathtrace_kernel<2, false, true, true, true>)
             : rr ? (wide ? pathtrace_kernel<8, true, true, false, true>
                          : pathtrace_kernel<2, true, true, false, true>)
                  : (wide ? pathtrace_kernel<8, false, true, false, true>
                          : pathtrace_kernel<2, false, true, false, true>);
  else if (streamed)  // the streamed instances
    kernel = rr ? pathtrace_kernel<2, true, true, true, false>
                : pathtrace_kernel<2, false, true, true, false>;
#endif
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// C interface of direct mode (bound with ctypes): n_passes passes into acc,
// rays ray_offset ... ray_offset + n_rays - 1 of the film. (k0, k1) is the
// call's key (ignored with u_planes); this launch runs passes first_pass
// ... first_pass + n_passes - 1 of the call, each keyed by fold_in(key,
// pass) when per_pass != 0, by the key itself otherwise (a call of one
// pass). Non-null `ids` (1, n_rays) (and `occs` (n_lig, n_rays) when n_lig
// > 0) record the primary champion and the occlusion bits of a one-pass
// launch; `live`, grid_mode, block and `tree` as rt_pathtrace_pass.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int rt_direct_pass(const float* par, const float* sph, int n_sph,
                              const float* tri, int n_tri, const float* mat,
                              int n_mat, const float* lig, int n_lig,
                              float* acc, int n_rays, int ray_offset,
                              const float* u_planes, unsigned int k0,
                              unsigned int k1, int first_pass, int per_pass,
                              int n_passes, int spp, int width, int two_sided,
                              int* ids, uint8_t* occs, const float* live,
                              int grid_mode,
                              const GridDesc* grids, int n_grids,
                              int sph_grid, int tri_start,
                              const Stream* streams, const Stream* tree,
                              int block, void* stream) {
  DirectParams p;
  if (n_passes < 1 || n_passes > kMaxPasses || first_pass < 0 || block < 0 ||
      (grid_mode != 0) != kGridBuild || (block && !grid_mode) ||
      (ids && n_passes != 1) || (!ids && (occs || live)) ||
      (ids && n_lig > 0 && !occs) ||
      (tree && !tree_ok(*tree, n_sph)) ||
      !set_grids(p.grids, grids, grid_mode ? n_grids : 0,
                 grid_mode ? sph_grid : 0, grid_mode ? tri_start : n_tri,
                 grid_mode ? streams : nullptr, sph, n_sph, n_tri))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
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
  p.k0 = k0;
  p.k1 = k1;
  p.first_pass = first_pass;
  p.per_pass = per_pass;
  p.n_passes = n_passes;
  p.spp = spp;
  p.width = width;
  p.two_sided = two_sided;
  p.ids = ids;
  p.occs = occs;
  p.live = live;
  p.block = block;
  p.tree = tree ? *tree : Stream{};
  // the tables (in grid mode the brute prefix; the spheres unless walked as
  // a tree), then the slot keys of the launch's passes
  const int n_sph_smem = tree ? 0 : p.grids.sph_resident(n_sph);
  const size_t smem =
      sizeof(float) *
          tables_floats(n_sph_smem, p.grids.tri_start, n_mat, n_lig) +
      (u_planes ? 0 : 2 * sizeof(uint32_t) * n_passes * (1 + n_lig));
  const bool wide = n_sph_smem >= kWideSpheres;
  const bool streamed = p.grids.tri_st.n || p.grids.sph_st.n;
  const bool cells = p.grids.n_tri > 0;
  const bool walk = tree != nullptr;
  const DirectKernel kernel =
      ids ? (cells ? direct_instance<true, true>(wide, streamed, walk)
                   : direct_instance<true, false>(wide, streamed, walk))
          : (cells ? direct_instance<false, true>(wide, streamed, walk)
                   : direct_instance<false, false>(wide, streamed, walk));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
