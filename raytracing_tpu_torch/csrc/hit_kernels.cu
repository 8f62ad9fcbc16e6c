// The stage pipeline's closest-hit searches as two CUDA kernels for Hopper
// (sm_90a): kernel 4 over spheres and kernel 5 over triangles.
//
// Replaces: raytracing_tpu/ops/pallas/hit_kernels.py::_sphere_kernel
// (launcher sphere_search_pallas) and ::_triangle_kernel
// (triangle_search_pallas). Each finds, per ray, the closest object whose
// hit parameter lies inside [mint, maxt] and returns (t, idx), INF / -1 on
// a miss or for a dead ray (mint == maxt). Any-hit is the same search
// followed by isfinite(t), as in the JAX package.
//
// What bounds it on this card: FP32 instruction throughput. A search reads
// 32 B and writes 8 B per ray, against ~25 flops per ray-sphere test and
// ~40 per ray-triangle test, over every object of the scene (1024 spheres
// in sphere_field(1024): ~2.6e4 flops per ray, ~640 flops per byte).
// The design follows from that:
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

}  // namespace

// o, d (n_rays, 3), mint, maxt (n_rays,), rows (n_obj, 8) float32;
// t_out (n_rays,) float32, i_out (n_rays,) int32. Returns the launch's
// cudaGetLastError().
extern "C" int rt_sphere_search(const float* o, const float* d,
                                const float* mint, const float* maxt,
                                const float* rows, int n_obj, float* t_out,
                                int* i_out, int n_rays, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (n_rays + kBlock - 1) / kBlock;
  sphere_search_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, mint, maxt, rows, n_obj, t_out, i_out, n_rays);
  return static_cast<int>(cudaGetLastError());
}

// As rt_sphere_search with rows (n_obj, 20); two_sided accepts div != 0,
// else div > 0.
extern "C" int rt_triangle_search(const float* o, const float* d,
                                  const float* mint, const float* maxt,
                                  const float* rows, int n_obj, int two_sided,
                                  float* t_out, int* i_out, int n_rays,
                                  void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (n_rays + kBlock - 1) / kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_sided)
    triangle_search_kernel<true><<<grid, kBlock, 0, s>>>(
        o, d, mint, maxt, rows, n_obj, t_out, i_out, n_rays);
  else
    triangle_search_kernel<false><<<grid, kBlock, 0, s>>>(
        o, d, mint, maxt, rows, n_obj, t_out, i_out, n_rays);
  return static_cast<int>(cudaGetLastError());
}
