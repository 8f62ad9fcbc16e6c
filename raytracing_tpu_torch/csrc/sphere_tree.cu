// The box tree over an object table, built on the card in one launch: the
// layout that kernel 1 walks past MK.SPH_BRUTE_MAX[mode] resident spheres
// (csrc/megakernel.cu pathtrace_kernel's and direct_kernel's kTree
// instances) and kernels 4 and 5 walk past HK.SPHERE_BRUTE_MAX and
// HK.TRIANGLE_BRUTE_MAX rows (csrc/hit_kernels.cu sphere_tree_kernel and
// triangle_tree_kernel, the stage pass building each tree once). One
// build, templated on the row kind: sphere_tree_build_kernel over sphere
// rows, triangle_tree_build_kernel over triangle rows and their vertices.
//
// Its plain versions are ops/megakernel.py sphere_tree and
// ops/hit_kernels.py triangle_tree (the layout of MK.SphereTree and
// HK.TriangleTree, MK.box_tree's nodes, masks and loose rows); the output
// equals them element for element (torch.equal) on the same rows:
//   * each row's box where its mask is set (spheres column 5: centre -/+
//     |radius|; triangles column 17: its vertices' min / max), +inf / -inf
//     otherwise; the table's box over those boxes, the pad MK.CHUNK_PAD
//     times the largest |coordinate| of a masked-on row's box (spheres
//     |centre| + |radius|, triangles |vertex|) and the room (the box's
//     longest side);
//   * the rows in the stable order of the 30-bit Morton codes of their
//     points (a sphere's centre, a triangle's vertex centroid (v0 + v1 +
//     v2) / 3, as render/mega.tri_chunk_tables orders JAX's chunks)
//     against the table's box (MK.morton_codes: (c - pmin) / max(pmax -
//     pmin, 1e-20) * 1024 clamped to [0, 1023] and truncated, the bits
//     interleaved), padded with zero rows to whole leaves; perm the
//     original row of each sorted row, -1 for padding;
//   * the loose rows: the masked-on rows whose box's longest side is at
//     least loose_share of the room, the loose_max longest (a tie to the
//     lower sorted position, as MK.box_tree's stable sort), -1 after;
//   * each leaf's box over its other masked-on rows widened by the pad
//     (the empty box +inf / -inf where none), its mask word naming them,
//     the empty leaf slots past the last leaf, and the implicit binary
//     tree of node boxes over them, one level at a time; node 0 and the
//     two last columns of every node are zeros.
// Every float operation is the plain version's, written with
// round-to-nearest intrinsics so that nvcc contracts nothing; minima and
// maxima are exact in any order.
//
// Why one block: a training step changes the sphere table every step and a
// stage pass packs its tables every pass, so the tree is rebuilt every
// call, and the torch build of the same layout is ~140 small launches
// (2.3-3.0 ms of host time per call, PERF.md §7), more than the walk
// saves. One block of kThreads threads holds a table of
// up to kMaxRows rows in shared memory: the stable sort is a bitonic sort
// of (code, row) keys, each unique, so the order is the stable one; the
// node levels are refitted one after another behind __syncthreads (a
// block's own global writes are visible to it after the barrier). On one
// H100 it takes 37 us of device time at 1,024 rows and 247-250 us at 4,608
// (torch.profiler; PERF.md §6, row 1d), where the sort of 8,192 keys and
// thirteen level refits on one SM set the pace.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 1024;
constexpr int kRowBits = 13;
constexpr int kMaxRows = 1 << kRowBits;  // rows of a table: the key's row

struct Box {
  float lo[3], hi[3];
  bool take;  // masked on, with a box (lo <= hi on every axis)
};

// The row kinds. Each gives a row's box, the point of its Morton code and
// its reach (the largest |coordinate| of its box's ends, 0 where masked
// off: the pad's scale).
//
// Sphere rows (n, 8): [centre xyz, radius, ., mask, ., .].
struct SphereRows {
  static constexpr int kCols = kSph;
  const float* rows;
  __device__ __forceinline__ Box box(int r) const {
    const float* q = rows + static_cast<size_t>(r) * kCols;
    const bool on = q[5] > 0.0f;
    const float rad = fabsf(q[3]);
    Box b;
    b.take = on;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      b.lo[ax] = on ? __fsub_rn(q[ax], rad) : inf_f();
      b.hi[ax] = on ? __fadd_rn(q[ax], rad) : -inf_f();
      b.take = b.take && b.lo[ax] <= b.hi[ax];
    }
    return b;
  }
  __device__ __forceinline__ float point(int r, int ax) const {
    return rows[static_cast<size_t>(r) * kCols + ax];
  }
  __device__ __forceinline__ float reach(int r) const {
    const float* q = rows + static_cast<size_t>(r) * kCols;
    const float rad = fabsf(q[3]);
    float m = 0.0f;
    if (q[5] > 0.0f) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) m = fmaxf(m, __fadd_rn(fabsf(q[ax]), rad));
    }
    return m;
  }
};

// Triangle rows (n, 20): [n_geo, c1, c2, e1, e2, k, ., mask, ., .] (the
// mask in column 17), and their vertices v (n, 3, 3), which the rows do
// not hold.
struct TriangleRows {
  static constexpr int kCols = 20;
  const float* rows;
  const float* v;
  __device__ __forceinline__ bool on(int r) const {
    return rows[static_cast<size_t>(r) * kCols + 17] > 0.0f;
  }
  __device__ __forceinline__ Box box(int r) const {
    const float* p = v + 9 * static_cast<size_t>(r);
    const bool live = on(r);
    Box b;
    b.take = live;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      b.lo[ax] = live ? fminf(fminf(p[ax], p[3 + ax]), p[6 + ax]) : inf_f();
      b.hi[ax] = live ? fmaxf(fmaxf(p[ax], p[3 + ax]), p[6 + ax]) : -inf_f();
      b.take = b.take && b.lo[ax] <= b.hi[ax];
    }
    return b;
  }
  // the centroid as torch rounds (v0 + v1 + v2) / 3: two sums, then a true
  // division
  __device__ __forceinline__ float point(int r, int ax) const {
    const float* p = v + 9 * static_cast<size_t>(r);
    return __fdiv_rn(__fadd_rn(__fadd_rn(p[ax], p[3 + ax]), p[6 + ax]), 3.0f);
  }
  __device__ __forceinline__ float reach(int r) const {
    const float* p = v + 9 * static_cast<size_t>(r);
    float m = 0.0f;
    if (on(r)) {
#pragma unroll
      for (int k = 0; k < 9; ++k) m = fmaxf(m, fabsf(p[k]));
    }
    return m;
  }
};

__device__ __forceinline__ unsigned spread(unsigned x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

// The block's minimum (max = false) or maximum of v over `scratch`
// (kThreads floats, shared); every thread gets it.
__device__ float block_reduce(float v, bool max, float* scratch) {
  const int tid = threadIdx.x;
  __syncthreads();  // scratch is free
  scratch[tid] = v;
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    __syncthreads();
    if (tid < w)
      scratch[tid] = max ? fmaxf(scratch[tid], scratch[tid + w])
                         : fminf(scratch[tid], scratch[tid + w]);
  }
  __syncthreads();
  return scratch[0];
}

// The build of the table `tab` (s rows): one block of kThreads threads.
template <class Table>
__device__ __forceinline__ void build_tree(const Table& tab, int s, int leaf,
                                           int n_slots, float pad_share,
                                           float loose_share, int n_loose,
                                           float* out_rows, int* perm,
                                           float* node, int* mask,
                                           int* loose) {
  constexpr int kCols = Table::kCols;
  extern __shared__ unsigned long long keys[];  // np sort keys
  __shared__ float scratch[kThreads];
  __shared__ int n_cand;
  const int tid = threadIdx.x;
  const int n = (s + leaf - 1) / leaf * leaf;
  const int n_leaves = n / leaf;
  int np = 1;
  while (np < s) np <<= 1;
  // after the keys: each sorted position's loose score, the candidates'
  // positions, and a bit per position that takes part / is loose
  float* score = reinterpret_cast<float*>(keys + np);
  int* cand = reinterpret_cast<int*>(score + n);
  unsigned* take_bits = reinterpret_cast<unsigned*>(cand + n);
  unsigned* loose_bits = take_bits + (n + 31) / 32;

  // the table's box and the pad's scale, over the masked-on rows
  float lo[3] = {inf_f(), inf_f(), inf_f()};
  float hi[3] = {-inf_f(), -inf_f(), -inf_f()};
  float scale = 0.0f;
  for (int r = tid; r < s; r += kThreads) {
    const Box b = tab.box(r);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = fminf(lo[ax], b.lo[ax]);
      hi[ax] = fmaxf(hi[ax], b.hi[ax]);
    }
    scale = fmaxf(scale, tab.reach(r));
  }
  float pmin[3], pmax[3], ext[3];
  const float tiny = static_cast<float>(1e-20);  // as torch rounds it
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    pmin[ax] = block_reduce(lo[ax], false, scratch);
    pmax[ax] = block_reduce(hi[ax], true, scratch);
    ext[ax] = fmaxf(__fsub_rn(pmax[ax], pmin[ax]), tiny);
  }
  scale = block_reduce(scale, true, scratch);
  const float pad = __fmul_rn(pad_share, scale);
  const float room = fmaxf(fmaxf(__fsub_rn(pmax[0], pmin[0]),
                                 __fsub_rn(pmax[1], pmin[1])),
                           __fsub_rn(pmax[2], pmin[2]));
  const float loose_min = __fmul_rn(loose_share, room);

  // the stable Morton order: (code, row) keys, sorted
  for (int i = tid; i < np; i += kThreads) {
    unsigned long long key = ~0ull;
    if (i < s) {
      unsigned code = 0;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float x = __fmul_rn(
            __fdiv_rn(__fsub_rn(tab.point(i, ax), pmin[ax]), ext[ax]),
            1024.0f);
        code |= spread(static_cast<unsigned>(fminf(fmaxf(x, 0.0f), 1023.0f)))
                << ax;
      }
      key = (static_cast<unsigned long long>(code) << kRowBits) | i;
    }
    keys[i] = key;
  }
  for (int i = tid; i < (n + 31) / 32; i += kThreads)
    take_bits[i] = loose_bits[i] = 0u;
  if (tid == 0) n_cand = 0;
  __syncthreads();
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < np; i += kThreads) {
        const int x = i ^ j;
        if (x > i) {
          const unsigned long long a = keys[i], b = keys[x];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[x] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  auto orig = [&](int p) {
    return static_cast<int>(keys[p] & (kMaxRows - 1));
  };

  // the sorted rows, perm, and each position's loose score
  for (int i = tid; i < n * kCols; i += kThreads) {
    const int p = i / kCols;
    out_rows[i] = p < s ? __ldg(tab.rows + static_cast<size_t>(orig(p)) *
                                               kCols + (i - p * kCols))
                        : 0.0f;
  }
  for (int p = tid; p < n; p += kThreads) {
    perm[p] = p < s ? orig(p) : -1;
    float sc = -inf_f();
    if (p < s) {
      const Box b = tab.box(orig(p));
      const float side =
          fmaxf(fmaxf(__fsub_rn(b.hi[0], b.lo[0]), __fsub_rn(b.hi[1], b.lo[1])),
                __fsub_rn(b.hi[2], b.lo[2]));
      if (b.take) {
        atomicOr(take_bits + p / 32, 1u << (p % 32));
        if (side >= loose_min) {
          sc = side;
          cand[atomicAdd(&n_cand, 1)] = p;
        }
      }
    }
    score[p] = sc;
  }
  __syncthreads();

  // the loose rows: the n_loose best candidates by (score desc, position)
  const int nc = n_cand;
  for (int k = tid; k < n_loose; k += kThreads) loose[k] = -1;
  __syncthreads();
  for (int i = tid; i < nc; i += kThreads) {
    const int p = cand[i];
    const float sp = score[p];
    int rank = 0;
    for (int c = 0; c < nc && rank < n_loose; ++c) {
      const int q = cand[c];
      rank += score[q] > sp || (score[q] == sp && q < p);
    }
    if (rank < n_loose) {
      loose[rank] = p;
      atomicOr(loose_bits + p / 32, 1u << (p % 32));
    }
  }
  __syncthreads();

  // the leaves (their boxes widened by the pad, their masks) and the empty
  // slots past them
  for (int j = tid; j < n_slots; j += kThreads) {
    float bl[3] = {inf_f(), inf_f(), inf_f()};
    float bh[3] = {-inf_f(), -inf_f(), -inf_f()};
    if (j < n_leaves) {
      unsigned m = 0u;
      for (int b = 0; b < leaf; ++b) {
        const int p = j * leaf + b;
        const unsigned bit = 1u << (p % 32);
        if ((take_bits[p / 32] & bit) && !(loose_bits[p / 32] & bit)) {
          m |= 1u << b;
          const Box x = tab.box(orig(p));
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            bl[ax] = fminf(bl[ax], x.lo[ax]);
            bh[ax] = fmaxf(bh[ax], x.hi[ax]);
          }
        }
      }
      mask[j] = static_cast<int>(m);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        bl[ax] = __fsub_rn(bl[ax], pad);
        bh[ax] = __fadd_rn(bh[ax], pad);
      }
    }
    float* o = node + 8 * static_cast<size_t>(n_slots + j);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      o[ax] = bl[ax];
      o[3 + ax] = bh[ax];
    }
    o[6] = o[7] = 0.0f;
  }
  if (tid < 8) node[tid] = 0.0f;
  // the levels above, each over the one below
  for (int half = n_slots >> 1; half >= 1; half >>= 1) {
    __syncthreads();
    for (int k = half + tid; k < 2 * half; k += kThreads) {
      const float* a = node + 16 * static_cast<size_t>(k);
      float* o = node + 8 * static_cast<size_t>(k);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        o[ax] = fminf(a[ax], a[8 + ax]);
        o[3 + ax] = fmaxf(a[3 + ax], a[11 + ax]);
      }
      o[6] = o[7] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    sphere_tree_build_kernel(const SphereRows tab, int s, int leaf,
                             int n_slots, float pad_share, float loose_share,
                             int n_loose, float* out_rows, int* perm,
                             float* node, int* mask, int* loose) {
  build_tree(tab, s, leaf, n_slots, pad_share, loose_share, n_loose,
             out_rows, perm, node, mask, loose);
}

__global__ void __launch_bounds__(kThreads)
    triangle_tree_build_kernel(const TriangleRows tab, int s, int leaf,
                               int n_slots, float pad_share,
                               float loose_share, int n_loose,
                               float* out_rows, int* perm, float* node,
                               int* mask, int* loose) {
  build_tree(tab, s, leaf, n_slots, pad_share, loose_share, n_loose,
             out_rows, perm, node, mask, loose);
}

// Checks the arguments (the entries' contract below) and launches kernel
// over tab; cudaErrorInvalidValue, launching nothing, for bad ones.
template <class Table, class Kernel>
int launch_build(Kernel kernel, const Table& tab, int s, int leaf,
                 int n_slots, float pad_share, float loose_share, int n_loose,
                 float* out_rows, int* perm, float* node, int* mask,
                 int* loose, void* stream) {
  const int n = s > 0 && leaf > 0 ? (s + leaf - 1) / leaf * leaf : 0;
  int slots = 1;
  while (n > 0 && slots < n / leaf) slots <<= 1;
  if (s < 1 || s > kMaxRows || leaf < 1 || leaf > 32 || (leaf & (leaf - 1)) ||
      n_slots != slots || n_loose < 1 || n_loose > kLooseMax ||
      n_loose > n || !tab.rows || !out_rows || !perm || !node || !mask ||
      !loose)
    return static_cast<int>(cudaErrorInvalidValue);
  int np = 1;
  while (np < s) np <<= 1;
  const size_t smem = sizeof(unsigned long long) * np +
                      (sizeof(float) + sizeof(int)) * n +
                      2 * sizeof(unsigned) * ((n + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<1, kThreads, smem, st>>>(tab, s, leaf, n_slots, pad_share,
                                    loose_share, n_loose, out_rows, perm,
                                    node, mask, loose);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (s, 8) float32, 1 <= s <= kMaxRows; leaf a power of two up to 32;
// n_slots the least power of two >= ceil(s / leaf); pad_share
// (MK.CHUNK_PAD), loose_share (MK.LOOSE_SHARE) and n_loose = min(
// MK.LOOSE_MAX, n) as the plain version takes them. Writes, with n = ceil(s
// / leaf) leaf: out_rows (n, 8), perm (n,), node (2 n_slots, 8), mask
// (n / leaf,), loose (n_loose,) -- every element. Returns
// cudaErrorInvalidValue, launching nothing, for other arguments, else the
// launch's cudaGetLastError(). Launches on `stream`, allocates nothing,
// does not synchronise.
extern "C" int rt_sphere_tree(const float* rows, int s, int leaf,
                              int n_slots, float pad_share, float loose_share,
                              int n_loose, float* out_rows, int* perm,
                              float* node, int* mask, int* loose,
                              void* stream) {
  return launch_build(sphere_tree_build_kernel, SphereRows{rows}, s, leaf,
                      n_slots, pad_share, loose_share, n_loose, out_rows,
                      perm, node, mask, loose, stream);
}

// As rt_sphere_tree over triangle rows (s, 20) and their vertices v (s, 3,
// 3) float32; out_rows (n, 20).
extern "C" int rt_triangle_tree(const float* rows, const float* v, int s,
                                int leaf, int n_slots, float pad_share,
                                float loose_share, int n_loose,
                                float* out_rows, int* perm, float* node,
                                int* mask, int* loose, void* stream) {
  if (!v) return static_cast<int>(cudaErrorInvalidValue);
  return launch_build(triangle_tree_build_kernel, TriangleRows{rows, v}, s,
                      leaf, n_slots, pad_share, loose_share, n_loose,
                      out_rows, perm, node, mask, loose, stream);
}
