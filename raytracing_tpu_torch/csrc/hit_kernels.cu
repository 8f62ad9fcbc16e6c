// The stage pipeline's closest-hit searches as CUDA kernels for Hopper
// (sm_90a): kernel 4 over spheres and kernel 5 over triangles.
//
// Replaces: raytracing_tpu/ops/pallas/hit_kernels.py::_sphere_kernel
// (launcher sphere_search_pallas) and ::_triangle_kernel
// (triangle_search_pallas). Each finds, per ray, the closest object whose
// hit parameter lies inside [mint, maxt] and returns (t, idx), INF / -1 on
// a miss or for a dead ray (mint == maxt); exact ties go to the lowest
// index. Any-hit is the same search followed by isfinite(t), as in the
// JAX package.
//
// The brute loops (kernels 4 and 5 on tables of up to SPHERE_BRUTE_MAX
// and TRIANGLE_BRUTE_MAX rows, ops/hit_kernels.py): every live ray tests
// every object. What bounds them on this card is FP32 instruction throughput: a
// search reads 32 B and writes 8 B per ray, against ~20 operations per
// ray-sphere test and ~40 per ray-triangle test over every object of the
// scene. The design follows from that:
//   * one thread per ray; the Pallas kernels' vector-wide masks become
//     per-ray branches, and a dead ray skips the object loop;
//   * the object table is staged through shared memory in chunks: the
//     block loads a chunk cooperatively, synchronises, and every thread
//     tests its ray against the chunk (every thread of a warp reads the
//     same word, a broadcast). Any object count works, as in the Pallas
//     kernels, which hold the whole table in VMEM;
//   * objects are visited in increasing index with a strict `t < best`, so
//     exact ties go to the lowest index, as in the Pallas fori_loop;
//   * the arithmetic is that of ops/intersect.sphere_hit / triangle_hit
//     (the plain versions) in the same order, written with round-to-nearest
//     intrinsics so that nvcc contracts nothing into FMAs: the kernels
//     equal their plain versions bit for bit on the same packed rows.
//
// Kernel 4's tree instance (sphere_tree_kernel, past SPHERE_BRUTE_MAX
// rows): the brute loop's 2^30 tests of 2^20 rays against sphere_field(
// 1024) were near its own ceiling (the uncontracted tests run at about
// half the FMA rate the bound assumes), so the work itself shrinks: each
// ray walks a box tree over the rows (ops/hit_kernels.py sphere_tree,
// built on the card once per stage pass: the rows in the Morton order of
// their centres, leaves of SPHERE_LEAF rows (1, the fastest of 1, 2 and
// 4) whose boxes are centre -/+ |radius| of their masked-on rows
// widened by MK.CHUNK_PAD of the rows' scale, an
// implicit binary tree of node boxes over them, and the loose rows, which
// every ray tests first), nearest child first, culled at the champion's t
// (pathtrace.cuh node_enter and lane_walk, kernel 1's streamed walk,
// each lane its own). Each visited row runs the brute loop's uncontracted
// test, so every candidate's t is the brute loop's bit for bit, and the
// champion is the least (t, original index) pair, which is the brute
// loop's strict `<` in index order whatever the order of the visits.
// Why the walk culls no winner (render/mega.py chunk_tree's argument):
// the slab test rounds monotonically, so in float arithmetic a box that
// contains another overlaps every window the inner one overlaps; each
// node contains the widened box of every row under it, and the widening
// holds a row's rounded hit point inside its leaf's box. A node is
// dropped only when its entry is past the champion's t (`<=` keeps ties,
// whose lower index must still be tested). What bounds the walk: not the
// FP32 rate any more but the latency of its dependent steps (a node test
// is two 16-byte loads, 31 operations and a branch; the stack lives in
// local memory) and the divergence of the lanes' paths.
//
// Kernel 5's tree instance (triangle_tree_kernel, past TRIANGLE_BRUTE_MAX
// rows): kernel 4's design with a triangle's box. The brute loop ran a
// 4096-triangle soup at 3% of its FP32 bound (11 ms for 2^20 rays, PERF.md
// section 6, row 5): every live ray ran ~40 operations per row, so again
// the work itself shrinks. The tree is ops/hit_kernels.py triangle_tree,
// built on the card once per stage pass (csrc/sphere_tree.cu's triangle
// instance): the rows in the Morton order of their vertex centroids,
// leaves of TRIANGLE_LEAF rows whose boxes are the min / max of their
// masked-on rows' vertices widened by MK.CHUNK_PAD of the table's largest
// |coordinate|, and the loose rows (a box whose longest side is at least
// MK.LOOSE_SHARE of the table box's: cornell's walls), which every ray
// tests first. Each visited row runs the brute loop's uncontracted test
// (triangle_t), so the champion is again the least (t, original index).
// The culling argument is the spheres': a row's hit point lies in its
// leaf's widened box. It asks more of a triangle's t, whose rounding
// error 1 / div magnifies as a ray grazes the triangle's plane: a point
// can leave the widened box only for a ray within a few thousandths of a
// radian of the plane, near the box's edge, and the walk then misses it
// only where another row's hit culls the leaf first. The CPU tests, the
// plain walk over phase 8's 2^20 rays and over every search of a torus
// stage pass, and the card (chip_smoke.py phases 8 and 24) found none.
// Table rows (packed once per pass by ops/hit_kernels.py):
//   spheres   (S, 8):  [center xyz, radius, 0, mask, 0, 0]
//   triangles (T, 20): [n_geo, c1, c2, e1, e2, k, 0, mask, 0, 0]
// with n_geo = cross(e2, e1), c1 = cross(e1, p0), c2 = cross(e2, p0),
// k = dot(p0, n_geo): the constant-split Moller-Trumbore form.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace.cuh"

namespace {

using namespace rt;

constexpr int kBlock = 256;
constexpr int kTreeBlock = 128;  // 1-4% faster than 256 or 512 threads
constexpr int kSphRow = 8;
constexpr int kTriRow = 20;
constexpr int kSphChunk = 512;  // 16 KB of shared memory
constexpr int kTriChunk = 256;  // 20 KB

// float arithmetic that is never contracted into an FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot_rn(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 sub_rn(V3 a, V3 b) {
  return mk(sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z));
}
__device__ __forceinline__ V3 cross_rn(V3 a, V3 b) {
  return mk(sub(mul(a.y, b.z), mul(a.z, b.y)),
            sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x)));
}

// One ray of the search: its window and, for threads past the end, a dead
// ray (they still take part in staging the table).
struct Ray {
  V3 o, d;
  float lo, hi;
  bool alive;
};
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ mint,
                                        const float* __restrict__ maxt,
                                        int rid, int n_rays) {
  Ray r = {mk(0.0f, 0.0f, 0.0f), mk(0.0f, 0.0f, 0.0f), 0.0f, 0.0f, false};
  if (rid < n_rays) {
    const size_t i = 3 * static_cast<size_t>(rid);
    r.o = mk(__ldg(o + i), __ldg(o + i + 1), __ldg(o + i + 2));
    r.d = mk(__ldg(d + i), __ldg(d + i + 1), __ldg(d + i + 2));
    r.lo = __ldg(mint + rid);
    r.hi = __ldg(maxt + rid);
    r.alive = r.lo != r.hi;
  }
  return r;
}

// Copy n_floats of the table into shared memory, the whole block at once.
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g,
                                      int n_floats) {
  __syncthreads();  // every thread is done with the previous chunk
  for (int k = threadIdx.x; k < n_floats; k += blockDim.x) s[k] = __ldg(g + k);
  __syncthreads();
}

// The sphere test of the plain version (ops/intersect.sphere_hit),
// uncontracted: whether ray r (a = d.d, inv2a = 0.5 / a) hits the sphere
// (c, rad) at a root inside [lo, hi], the nearer such root in t. The
// tree instance's; the brute loop above keeps its own inline copy of the
// same operations (through this function it took 34 registers against
// 32 and ran 20% slower: 1.43 against 1.19 ms on phase 8's search, one
// H100 80GB HBM3 at 700 W, PERF.md section 6, row 4).
__device__ __forceinline__ bool sphere_t(const Ray& r, float a, float inv2a,
                                         V3 c, float rad, float& t) {
  const V3 m = sub_rn(r.o, c);
  const float b = mul(2.0f, dot_rn(m, r.d));
  const float cq = sub(dot_rn(m, m), mul(rad, rad));
  const float dis = sub(mul(b, b), mul(mul(4.0f, a), cq));
  if (!(dis >= 0.0f)) return false;
  const float sq = __fsqrt_rn(dis);
  const float t0 = mul(sub(-b, sq), inv2a);
  const float t1 = mul(add(-b, sq), inv2a);
  const float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
  if (tmn >= r.lo && tmn <= r.hi) {
    t = tmn;
  } else if (tmx >= r.lo && tmx <= r.hi) {
    t = tmx;
  } else {
    return false;
  }
  return true;
}

// The triangle test of the plain version (ops/intersect.triangle_hit),
// uncontracted: whether ray r (oxd = cross(o, d)) hits the packed row q
// (16-byte aligned) inside [lo, hi], two-sided (div != 0) or from the front
// (div > 0), and its t. The tree instance's; the brute loop keeps its own
// inline copy of the same operations, which it reads from shared memory.
template <bool kTwoSided>
__device__ __forceinline__ bool triangle_t(const Ray& r, V3 oxd,
                                           const float* q, float& t) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4 a = __ldg(q4);  // n_geo, c1.x
  const V3 ng = mk(a.x, a.y, a.z);
  const float div = dot_rn(r.d, ng);
  if (kTwoSided ? !(div != 0.0f) : !(div > 0.0f)) return false;
  const float4 b = __ldg(q4 + 1);  // c1.yz, c2.xy
  const float4 c = __ldg(q4 + 2);  // c2.z, e1
  const float4 e = __ldg(q4 + 3);  // e2, k
  const V3 c1 = mk(a.w, b.x, b.y), c2 = mk(b.z, b.w, c.x);
  const V3 e1 = mk(c.y, c.z, c.w), e2 = mk(e.x, e.y, e.z);
  const float idiv = __fdiv_rn(1.0f, div);
  const float beta = mul(sub(dot_rn(oxd, e2), dot_rn(r.d, c2)), idiv);
  const float gamma = mul(sub(dot_rn(r.d, c1), dot_rn(oxd, e1)), idiv);
  t = mul(sub(e.w, dot_rn(r.o, ng)), idiv);
  return beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
         add(beta, gamma) <= 1.0f && t >= r.lo && t <= r.hi;
}

__global__ void __launch_bounds__(kBlock)
    sphere_search_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ mint,
                         const float* __restrict__ maxt,
                         const float* __restrict__ rows, int n_obj,
                         float* __restrict__ t_out, int* __restrict__ i_out,
                         int n_rays) {
  __shared__ float s[kSphChunk * kSphRow];
  const int rid = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, mint, maxt, rid, n_rays);
  const float a = dot_rn(r.d, r.d);
  const float inv2a = __fdiv_rn(0.5f, a);
  float bt = inf_f();
  int bi = -1;
  for (int base = 0; base < n_obj; base += kSphChunk) {
    const int n = min(kSphChunk, n_obj - base);
    stage(s, rows + static_cast<size_t>(base) * kSphRow, n * kSphRow);
    if (!r.alive) continue;
    for (int j = 0; j < n; ++j) {
      const float* q = s + j * kSphRow;
      if (!(q[5] > 0.0f)) continue;
      const V3 m = sub_rn(r.o, ld3(q));
      const float b = mul(2.0f, dot_rn(m, r.d));
      const float cq = sub(dot_rn(m, m), mul(q[3], q[3]));
      const float dis = sub(mul(b, b), mul(mul(4.0f, a), cq));
      if (!(dis >= 0.0f)) continue;
      const float sq = __fsqrt_rn(dis);
      const float t0 = mul(sub(-b, sq), inv2a);
      const float t1 = mul(add(-b, sq), inv2a);
      const float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
      float t;
      if (tmn >= r.lo && tmn <= r.hi) {
        t = tmn;
      } else if (tmx >= r.lo && tmx <= r.hi) {
        t = tmx;
      } else {
        continue;
      }
      if (t < bt) {
        bt = t;
        bi = base + j;
      }
    }
  }
  if (rid < n_rays) {
    t_out[rid] = bt;
    i_out[rid] = bi;
  }
}

// Kernel 4's tree instance: ray rid walks S, the box tree over the sorted
// rows (Stream, pathtrace.cuh: rows, perm, node boxes, leaf masks and the
// loose rows), each lane its own tree (lane_walk). The warp's union of
// its lanes' trees (warp_walk, kernel 1's schedule for streamed spheres)
// ran 2.3-3.4x slower on random rays and 1.3-1.7x over a stage pass's
// searches (PERF.md section 6, row 4). The leaf masks name masked-on
// rows only (sphere_tree), so a visited row needs no mask test; its
// original index is read only where its t reaches the champion's.
__global__ void __launch_bounds__(kTreeBlock)
    sphere_tree_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ mint,
                       const float* __restrict__ maxt, const Stream S,
                       float* __restrict__ t_out, int* __restrict__ i_out,
                       int n_rays) {
  const int rid = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, mint, maxt, rid, n_rays);
  if (!r.alive) {
    if (rid < n_rays) {
      t_out[rid] = inf_f();
      i_out[rid] = -1;
    }
    return;
  }
  const float a = dot_rn(r.d, r.d);
  const float inv2a = __fdiv_rn(0.5f, a);
  float bt = inf_f();
  int bi = -1;
  auto test = [&](int s) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(S.rows) + 2 * s);
    float t;
    if (!sphere_t(r, a, inv2a, mk(q.x, q.y, q.z), q.w, t) || !(t <= bt))
      return false;
    const int id = __ldg(S.perm + s);
    if (t < bt || id < bi) {
      bt = t;
      bi = id;
    }
    return false;
  };
  lane_walk(S, r.o, safe_inv(r.d), r.lo, [&]() { return fminf(r.hi, bt); },
            test, [&](int r0, unsigned m) {
              for (; m; m &= m - 1) test(r0 + __ffs(m) - 1);
              return false;
            });
  t_out[rid] = bt;
  i_out[rid] = bi;
}

template <bool kTwoSided>
__global__ void __launch_bounds__(kBlock)
    triangle_search_kernel(const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ mint,
                           const float* __restrict__ maxt,
                           const float* __restrict__ rows, int n_obj,
                           float* __restrict__ t_out, int* __restrict__ i_out,
                           int n_rays) {
  __shared__ float s[kTriChunk * kTriRow];
  const int rid = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, mint, maxt, rid, n_rays);
  const V3 oxd = cross_rn(r.o, r.d);  // loop-invariant over triangles
  float bt = inf_f();
  int bi = -1;
  for (int base = 0; base < n_obj; base += kTriChunk) {
    const int n = min(kTriChunk, n_obj - base);
    stage(s, rows + static_cast<size_t>(base) * kTriRow, n * kTriRow);
    if (!r.alive) continue;
    for (int j = 0; j < n; ++j) {
      const float* q = s + j * kTriRow;
      if (!(q[17] > 0.0f)) continue;
      const V3 ng = ld3(q);
      const float div = dot_rn(r.d, ng);
      if (kTwoSided ? !(div != 0.0f) : !(div > 0.0f)) continue;
      const float idiv = __fdiv_rn(1.0f, div);
      const float beta =
          mul(sub(dot_rn(oxd, ld3(q + 12)), dot_rn(r.d, ld3(q + 6))), idiv);
      const float gamma =
          mul(sub(dot_rn(r.d, ld3(q + 3)), dot_rn(oxd, ld3(q + 9))), idiv);
      const float t = mul(sub(q[15], dot_rn(r.o, ng)), idiv);
      if (beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
          add(beta, gamma) <= 1.0f && t >= r.lo && t <= r.hi && t < bt) {
        bt = t;
        bi = base + j;
      }
    }
  }
  if (rid < n_rays) {
    t_out[rid] = bt;
    i_out[rid] = bi;
  }
}

// Kernel 5's tree instance: as sphere_tree_kernel over S, the box tree
// over the sorted triangle rows (ops/hit_kernels.py TriangleTree), each
// lane its own walk (lane_walk), every visited row through triangle_t.
template <bool kTwoSided>
__global__ void __launch_bounds__(kTreeBlock)
    triangle_tree_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ mint,
                         const float* __restrict__ maxt, const Stream S,
                         float* __restrict__ t_out, int* __restrict__ i_out,
                         int n_rays) {
  const int rid = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, mint, maxt, rid, n_rays);
  if (!r.alive) {
    if (rid < n_rays) {
      t_out[rid] = inf_f();
      i_out[rid] = -1;
    }
    return;
  }
  const V3 oxd = cross_rn(r.o, r.d);
  float bt = inf_f();
  int bi = -1;
  auto test = [&](int s) {
    const float* q = S.rows + kTriRow * static_cast<size_t>(s);
    float t;
    if (!triangle_t<kTwoSided>(r, oxd, q, t) || !(t <= bt)) return false;
    const int id = __ldg(S.perm + s);
    if (t < bt || id < bi) {
      bt = t;
      bi = id;
    }
    return false;
  };
  lane_walk(S, r.o, safe_inv(r.d), r.lo, [&]() { return fminf(r.hi, bt); },
            test, [&](int r0, unsigned m) {
              for (; m; m &= m - 1) test(r0 + __ffs(m) - 1);
              return false;
            });
  t_out[rid] = bt;
  i_out[rid] = bi;
}

// Whether S is a well-formed tree over n_obj rows (pathtrace.cuh
// stream_ok, leaves of at most 32 rows, whole leaves that hold the table).
bool tree_ok(const Stream& S, int n_obj) {
  return stream_ok(S) && S.leaf <= 32 && S.n >= n_obj && S.n % S.leaf == 0 &&
         S.n - n_obj < S.leaf;
}

}  // namespace

// o, d (n_rays, 3), mint, maxt (n_rays,), rows (n_obj, 8) float32;
// t_out (n_rays,) float32, i_out (n_rays,) int32. walk 0: the brute loop
// (the tree's arguments unused); 1: the tree instance over the tree of
// rows (ops/hit_kernels.py SphereTree: t_rows (n_tree, 8) sorted rows,
// perm (n_tree,), node (2 n_slots, 8) boxes, mask (n_tree / leaf words),
// loose (n_loose,)). Returns cudaErrorInvalidValue, launching nothing,
// for a tree that is malformed (stream_ok) or does not hold n_obj rows in
// whole leaves, else the launch's cudaGetLastError().
extern "C" int rt_sphere_search(const float* o, const float* d,
                                const float* mint, const float* maxt,
                                const float* rows, int n_obj,
                                const float* t_rows, const int* perm,
                                const float* node, const unsigned* mask,
                                const int* loose, int n_tree, int leaf,
                                int n_slots, int n_loose, int walk,
                                float* t_out, int* i_out, int n_rays,
                                void* stream) {
  const Stream S = {t_rows, perm, node, mask, loose, n_tree, leaf, n_slots,
                    n_loose};
  if (walk < 0 || walk > 1 || (walk && !tree_ok(S, n_obj)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (walk)
    sphere_tree_kernel<<<(n_rays + kTreeBlock - 1) / kTreeBlock, kTreeBlock,
                         0, s>>>(o, d, mint, maxt, S, t_out, i_out, n_rays);
  else
    sphere_search_kernel<<<(n_rays + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        o, d, mint, maxt, rows, n_obj, t_out, i_out, n_rays);
  return static_cast<int>(cudaGetLastError());
}

// As rt_sphere_search with rows (n_obj, 20) and a tree of TriangleTree
// (t_rows (n_tree, 20)); two_sided accepts div != 0, else div > 0.
extern "C" int rt_triangle_search(const float* o, const float* d,
                                  const float* mint, const float* maxt,
                                  const float* rows, int n_obj,
                                  const float* t_rows, const int* perm,
                                  const float* node, const unsigned* mask,
                                  const int* loose, int n_tree, int leaf,
                                  int n_slots, int n_loose, int walk,
                                  int two_sided, float* t_out, int* i_out,
                                  int n_rays, void* stream) {
  const Stream S = {t_rows, perm, node, mask, loose, n_tree, leaf, n_slots,
                    n_loose};
  if (walk < 0 || walk > 1 || (walk && !tree_ok(S, n_obj)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (walk) {
    const int grid = (n_rays + kTreeBlock - 1) / kTreeBlock;
    if (two_sided)
      triangle_tree_kernel<true><<<grid, kTreeBlock, 0, s>>>(
          o, d, mint, maxt, S, t_out, i_out, n_rays);
    else
      triangle_tree_kernel<false><<<grid, kTreeBlock, 0, s>>>(
          o, d, mint, maxt, S, t_out, i_out, n_rays);
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  if (two_sided)
    triangle_search_kernel<true><<<grid, kBlock, 0, s>>>(
        o, d, mint, maxt, rows, n_obj, t_out, i_out, n_rays);
  else
    triangle_search_kernel<false><<<grid, kBlock, 0, s>>>(
        o, d, mint, maxt, rows, n_obj, t_out, i_out, n_rays);
  return static_cast<int>(cudaGetLastError());
}
