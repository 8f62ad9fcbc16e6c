// Device code shared by the forward pass (megakernel.cu) and its adjoints
// (megakernel_grad.cu, megakernel_champ.cu): vector helpers, the table
// layout, the draw source, closest hit and any-hit, and the pieces of one
// pass that the adjoints replay (camera ray, emitter test, NEE shadow ray,
// bounce ray). The kernels call the same functions, so kernel 2's forward
// replay picks the same champions, occlusion bits and draws as the forward
// pass, and kernel 3 replays the same draws and rays.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace rt {

constexpr int kNPar = 26;
constexpr int kSph = 8;
constexpr int kTri = 32;
constexpr int kMat = 4;
constexpr int kLig = 20;
// par layout (the JAX kernel's _PAR)
constexpr int kEye = 0, kU = 3, kV = 6, kW = 9, kFilmW = 12, kFilmH = 13,
              kCols = 14, kRows = 15, kFocal = 16, kLensR = 17, kPmin = 18,
              kPmax = 21, kEps = 24, kAmbient = 25;
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

// The scene tables, in shared memory (kernel 3 reads sph and tri from
// global memory, at its champions' rows only). In shared memory par is
// padded to kParPad floats, so each table starts on a 16-byte boundary
// (every row width is a multiple of 4 floats). The reader is the
// compiler: with the buffer declared float4 it knows the rows' alignment
// and reads a row's adjacent words as one LDS.128 (kernel 1's 2-row loop:
// 31 LDS.128 and 8 LDS.64, against 14 and 35 with the tables at kNPar).
// Without the padding kernel 1 took 0.593 against 0.578 ms per cornell
// pass and 5.72 against 5.47 ms recording sphere_field(1024) (one H100
// 80GB HBM3, 700 W, profile_kernels); explicit float4 reads in trace and
// anyhit measured no faster than the compiler's.
constexpr int kParPad = 28;
struct Tables {
  const float* par;
  const float* sph;
  const float* tri;
  const float* mat;
  const float* lig;
  int n_sph, n_tri, n_mat, n_lig;
  bool two_sided;
};

// A closest hit. Besides the surface (p, n, m) it names the champion, for
// the adjoint: obj = sphere i, or n_sph + triangle j, or -1; t its ray
// parameter; for a triangle beta and gamma, for a sphere beta = 1 when t
// is the far root.
struct Hit {
  V3 p, n;
  float m;  // material id as float, -1 = no hit
  int obj;
  float t, beta, gamma;
};

// Uniform grids (kernel 1's grid mode; accel/grid.py builds them on the
// host). One grid: the CSR offsets (C + 1) and payload of item ids (the
// absolute row of the triangle fold, or the sphere row), in global memory;
// its box [pmin, pmax], cell width (1e-30 on a degenerate axis) and
// resolution. The layout is the ctypes structure of ops/megakernel.py.
constexpr int kMaxGrids = 8;
struct GridDesc {
  const int* off;
  const int* items;
  float pmin[3], width[3], pmax[3];
  int n[3];
};
// A streamed table (JAX's Morton chunks; ops/megakernel.py Stream, built
// on the card by render/mega.py chunk_tables): its n rows in Morton order
// in global memory (the padding rows past n are zero rows, which no ray
// hits), perm, the original row of each sorted row, and the walk's layout
// over them (render/mega.py chunk_tree, ops/megakernel.py StreamTree): the
// node boxes of an implicit binary tree over n_slots leaves (a power of
// two; node k's box [pmin xyz, pmax xyz, 0, 0] at node + 8 k, the root 1,
// the children of k 2 k and 2 k + 1, leaf j the node n_slots + j over the
// sorted rows [j leaf, (j + 1) leaf); a box with pmin.x > pmax.x is empty),
// a mask word per 32 rows of a leaf (the rows that take part in it; a
// leaf of fewer than 32 rows has one word, its low bits), and
// the loose rows (n_loose sorted positions, -1 after the last), which every
// ray tests before the tree. Each node's box contains the box of every row
// under it, widened, so the slab test's monotone rounding never culls a
// leaf whose row the brute loop hits. A sorted copy: read through perm
// instead, the whole table cost the streamed kernel 1.1-1.6x (one H100
// 80GB HBM3, 700 W, profile_kernels). n = 0: the table is not streamed.
constexpr int kTreeDepth = 20;  // levels of a tree: the walk's stack
constexpr int kLooseMax = 64;
struct Stream {
  const float* rows;
  const int* perm;
  const float* node;
  const unsigned* mask;
  const int* loose;
  int n, leaf, n_slots, n_loose;
};

// Whether the walk's layout of a stream of n > 0 rows is well formed.
inline bool stream_ok(const Stream& S) {
  const bool pow2 = S.n_slots > 0 && (S.n_slots & (S.n_slots - 1)) == 0;
  return S.rows && S.perm && S.node && S.mask && S.loose &&
         S.leaf > 0 && S.leaf <= 128 && (S.leaf & (S.leaf - 1)) == 0 &&
         pow2 &&
         S.n_slots <= (1 << kTreeDepth) &&
         static_cast<long long>(S.n_slots) * S.leaf >= S.n &&
         S.n_loose >= 1 && S.n_loose <= kLooseMax;
}

// The tables of a launch that live in global memory: triangle grids g[0,
// n_tri), then the sphere grid when sph != 0, and the streamed tables
// (tri_st, sph_st). Triangles [0, tri_start) and (without the sphere grid
// or a sphere stream) the spheres stay brute force in shared memory; the
// gridded rows are read from the whole tables in global memory.
struct Grids {
  GridDesc g[kMaxGrids];
  int n_tri, sph, tri_start;
  const float* sph_tab;
  const float* tri_tab;
  Stream tri_st, sph_st;
  // spheres in shared memory (the brute loops') out of a table of n_sph
  __host__ __device__ int sph_resident(int n_sph) const {
    return (sph || sph_st.n) ? 0 : n_sph;
  }
};

// The global-memory arguments of a launch into a kernel's parameters (kernel
// 1's grid-mode build, kernel 2's large-table instance):
// the HOST array `grids` of n_grids descriptors (n_grids - sph_grid
// triangle grids, then the sphere grid when sph_grid != 0) and the HOST
// array `streams` (null, or the triangles' and the spheres' Stream, n = 0
// for a table that does not stream); sph and tri are the whole tables in
// global memory. Returns false on bad arguments.
inline bool set_grids(Grids& G, const GridDesc* grids, int n_grids,
                      int sph_grid, int tri_start, const Stream* streams,
                      const float* sph, int n_sph, const float* tri,
                      int n_tri) {
  if (n_grids < 0 || n_grids > kMaxGrids || sph_grid < 0 || sph_grid > 1 ||
      sph_grid > n_grids || tri_start < 0 || (n_grids > 0 && !grids))
    return false;
  for (int i = 0; i < kMaxGrids; ++i)
    G.g[i] = i < n_grids ? grids[i] : GridDesc{};
  G.n_tri = n_grids - sph_grid;
  G.sph = sph_grid;
  G.tri_start = tri_start;
  G.sph_tab = sph;
  G.tri_tab = tri;
  G.tri_st = streams ? streams[0] : Stream{};
  G.sph_st = streams ? streams[1] : Stream{};
  // a streamed table is the whole table, and neither gridded nor resident
  if ((G.tri_st.n && (G.tri_st.n != n_tri || G.n_tri || tri_start ||
                      !stream_ok(G.tri_st))) ||
      (G.sph_st.n && (G.sph_st.n != n_sph || G.sph || !stream_ok(G.sph_st))))
    return false;
  return true;
}

// 1 / d per axis, with 1e-30 in place of a zero component (JAX's safe_inv).
__device__ __forceinline__ V3 safe_inv(V3 d) {
  return mk(1.0f / (d.x == 0.0f ? 1e-30f : d.x),
            1.0f / (d.y == 0.0f ? 1e-30f : d.y),
            1.0f / (d.z == 0.0f ? 1e-30f : d.z));
}

// The slab test of node box nb (global memory, [pmin xyz, pmax xyz, 0, 0])
// against the ray's window [lo, hi], with inv = safe_inv(d): JAX's
// chunk_overlap for one ray (ops/megakernel.py chunk_overlap). False for
// an empty box; else `enter` = max(near, lo), which the window's end must
// reach.
__device__ __forceinline__ bool node_enter(const float* nb, V3 o, V3 inv,
                                           float lo, float hi, float& enter) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(nb));
  const float4 b = __ldg(reinterpret_cast<const float4*>(nb) + 1);
  if (a.x > a.w) return false;  // pmin.x > pmax.x: no row under it
  const float t0x = (a.x - o.x) * inv.x;
  const float t1x = (a.w - o.x) * inv.x;
  const float t0y = (a.y - o.y) * inv.y;
  const float t1y = (b.x - o.y) * inv.y;
  const float t0z = (a.z - o.z) * inv.z;
  const float t1z = (b.y - o.z) * inv.z;
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z));
  enter = fmaxf(near, lo);
  return enter <= fminf(far, hi);
}

// The rows of stream S that a ray with live window [lo, hi()] may hit
// (hi() read at every test, so that a closer champion culls what is
// left): loose(r) on each loose row, then the tree, and leaf(r0, m) on each
// word of a visited leaf (r0 its first sorted row, m the rows that take
// part). Stops and returns true where loose or leaf returns true. `<=`
// throughout, so a tie at the champion's t is still tested. Two
// schedules, each the faster on one kind of table (PERF.md, PR 14):
//
// lane_walk (triangles): each lane walks its own tree, nearest child
// first (the smaller entry; the other waits on a stack with its entry and
// is dropped when popped past the window's end). A triangle's test is
// costly, so a lane tests only the leaves its own window reaches.
template <class Hi, class Loose, class Leaf>
__device__ __forceinline__ bool lane_walk(const Stream& S, V3 o, V3 inv,
                                          float lo, Hi hi, Loose loose,
                                          Leaf leaf) {
  for (int k = 0; k < S.n_loose; ++k) {
    const int r = __ldg(S.loose + k);
    if (r < 0) break;
    if (loose(r)) return true;
  }
  int stack[kTreeDepth];
  float enter[kTreeDepth];
  int sp = 0;
  int node = 1;
  float e;
  if (!node_enter(S.node + 8, o, inv, lo, hi(), e)) return false;
  const int words = (S.leaf + 31) >> 5;
  while (true) {
    if (node >= S.n_slots) {
      const int j = node - S.n_slots;
      for (int w = 0; w < words; ++w)
        if (leaf(j * S.leaf + 32 * w, __ldg(S.mask + j * words + w)))
          return true;
    } else {
      float e0, e1;
      const float* c = S.node + 16 * node;
      const bool h0 = node_enter(c, o, inv, lo, hi(), e0);
      const bool h1 = node_enter(c + 8, o, inv, lo, hi(), e1);
      if (h0 && h1) {
        const int first = e1 < e0 ? 1 : 0;
        stack[sp] = 2 * node + 1 - first;
        enter[sp] = first ? e0 : e1;
        ++sp;
        node = 2 * node + first;
        continue;
      }
      if (h0 || h1) {
        node = 2 * node + (h0 ? 0 : 1);
        continue;
      }
    }
    do {
      if (sp == 0) return false;
      --sp;
    } while (!(enter[sp] <= hi()));
    node = stack[sp];
  }
}

// warp_walk (spheres): the warp walks the union of its lanes' trees as
// one: a node is entered when any active lane's window overlaps it, the
// child that more lanes enter nearer first first (the other waits on a
// stack with each lane's entry and is dropped when popped past every
// lane's window), a leaf's rows tested by the lanes whose own window
// overlaps it; a lane that is done (an occluder found) drops out of the
// votes, and the walk returns whether it is. A sphere's test is cheap and
// a molecule's tree deep, so the walk's own steps, taken once per warp
// without divergence, are what it saves. The warp is the active lanes at
// the walk's start (__activemask): every vote inside is over them and
// their control flow is uniform, so lanes of a warp that enter it apart
// (paths at other segments, kernel 2's replay) each walk their own union,
// and no lane waits on one outside it.
template <class Hi, class Loose, class Leaf>
__device__ __forceinline__ bool warp_walk(const Stream& S, V3 o, V3 inv,
                                          float lo, Hi hi, Loose loose,
                                          Leaf leaf) {
  bool done = false;
  for (int k = 0; k < S.n_loose && !done; ++k) {
    const int r = __ldg(S.loose + k);
    if (r < 0) break;
    done = loose(r);
  }
  const float none = __int_as_float(0x7fffffff);  // NaN: no entry
  auto lim = [&]() { return done ? -inf_f() : hi(); };
  const unsigned wm = __activemask();
  int stack[kTreeDepth];
  float enter[kTreeDepth];  // this lane's entry of each node on the stack
  int sp = 0;
  int node = 1;
  float e;
  float mine = node_enter(S.node + 8, o, inv, lo, lim(), e) ? e : none;
  if (!__any_sync(wm, mine <= lim())) return done;
  const int words = (S.leaf + 31) >> 5;
  while (true) {
    const bool in = mine <= lim();
    if (node >= S.n_slots) {
      if (in) {
        const int j = node - S.n_slots;
        for (int w = 0; w < words; ++w)
          if (leaf(j * S.leaf + 32 * w, __ldg(S.mask + j * words + w))) {
            done = true;
            break;
          }
      }
    } else {
      float e0 = none, e1 = none;
      bool h0 = false, h1 = false;
      const float* c = S.node + 16 * node;
      if (in) {
        h0 = node_enter(c, o, inv, lo, lim(), e0);
        h1 = node_enter(c + 8, o, inv, lo, lim(), e1);
      }
      const unsigned b0 = __ballot_sync(wm, h0);
      const unsigned b1 = __ballot_sync(wm, h1);
      if (b0 && b1) {
        const int v1 = __popc(__ballot_sync(wm, h1 && (!h0 || e1 < e0)));
        const int v0 = __popc(__ballot_sync(wm, h0 && (!h1 || e0 <= e1)));
        const int first = v1 > v0 ? 1 : 0;
        stack[sp] = 2 * node + 1 - first;
        enter[sp] = first ? (h0 ? e0 : none) : (h1 ? e1 : none);
        ++sp;
        node = 2 * node + first;
        mine = first ? (h1 ? e1 : none) : (h0 ? e0 : none);
        continue;
      }
      if (b0 || b1) {
        node = 2 * node + (b0 ? 0 : 1);
        mine = b0 ? (h0 ? e0 : none) : (h1 ? e1 : none);
        continue;
      }
    }
    do {
      if (sp == 0) return done;
      --sp;
    } while (!__any_sync(wm, enter[sp] <= lim()));
    node = stack[sp];
    mine = enter[sp];
  }
}

// The walk of one ray's live window [mint, maxt] through grid g, cell by
// cell in order (Amanatides-Woo, as the reference's Assign07 marches):
// visit(cell) tests the cell's items over the whole window and returns
// true to stop (an occluder found); bound() is the champion's t (the walk
// ends once the next cell's entry exceeds it). Conservative, so that no
// cell holding the hit is skipped by rounding: the walk starts `margin`
// before the ray enters the grid; where faces are crossed within `margin`
// of each other (through a cell edge or corner) it also visits the side
// cells of the other crossing orders and steps over all those faces at
// once; it stops only past bound() + margin. margin = kRelMargin (|exit
// t| + the ray's shortest cell crossing). accel/traverse.py's march is
// the same walk in PyTorch.
constexpr float kRelMargin = 1e-4f;
template <class Visit, class Bound>
__device__ __forceinline__ void grid_walk(const GridDesc& g, V3 o, V3 d,
                                          float mint, float maxt,
                                          Visit&& visit, Bound&& bound) {
  const float ox[3] = {o.x, o.y, o.z}, dx[3] = {d.x, d.y, d.z};
  float near = -inf_f(), far = inf_f(), tcell = inf_f();
  float td[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float sd = dx[ax] == 0.0f ? 1e-30f : dx[ax];
    const float t0 = (g.pmin[ax] - ox[ax]) / sd;
    const float t1 = (g.pmax[ax] - ox[ax]) / sd;
    near = fmaxf(near, fminf(t0, t1));
    far = fminf(far, fmaxf(t0, t1));
    const float ad = fabsf(dx[ax]);
    td[ax] = ad > 0.0f ? g.width[ax] / ad : inf_f();
    tcell = fminf(tcell, td[ax]);
  }
  const float margin = kRelMargin * (fabsf(far) + tcell);
  const float lo = fmaxf(near, mint);
  const float hi = fminf(far, maxt);
  if (!(lo <= hi + margin)) return;
  const float t = lo - margin;
  int c[3], st[3];
  float tn[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float q = floorf((ox[ax] + t * dx[ax] - g.pmin[ax]) / g.width[ax]);
    c[ax] = static_cast<int>(
        fminf(fmaxf(q, 0.0f), static_cast<float>(g.n[ax] - 1)));
    const bool pos = dx[ax] > 0.0f;
    st[ax] = pos ? 1 : -1;
    const float bnd =
        g.pmin[ax] + static_cast<float>(c[ax] + (pos ? 1 : 0)) * g.width[ax];
    tn[ax] = dx[ax] != 0.0f ? (bnd - ox[ax]) / dx[ax] : inf_f();
  }
  const int nx = g.n[0], ny = g.n[1], nz = g.n[2];
  for (int s = 0; s <= nx + ny + nz; ++s) {  // each step advances an axis
    if (visit((c[2] * ny + c[1]) * nx + c[0])) return;
    const float tmin = fminf(tn[0], fminf(tn[1], tn[2]));
    if (!(tmin <= fminf(hi, bound()) + margin)) return;
    const float lim = tmin + margin;
    const int tie = (tn[0] <= lim ? 1 : 0) | (tn[1] <= lim ? 2 : 0) |
                    (tn[2] <= lim ? 4 : 0);
    const int n_tie = __popc(tie);
    if (n_tie > 1) {
      for (int sub = 1; sub < 7; ++sub) {
        if ((sub & ~tie) != 0 || __popc(sub) >= n_tie) continue;
        const int x = c[0] + ((sub & 1) ? st[0] : 0);
        const int y = c[1] + ((sub & 2) ? st[1] : 0);
        const int z = c[2] + ((sub & 4) ? st[2] : 0);
        if (x >= 0 && x < nx && y >= 0 && y < ny && z >= 0 && z < nz &&
            visit((z * ny + y) * nx + x))
          return;
      }
    }
    bool out = false;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      if (tie & (1 << ax)) {
        c[ax] += st[ax];
        tn[ax] += td[ax];
        out = out || c[ax] < 0 || c[ax] >= g.n[ax];
      }
    }
    if (out) return;
  }
}

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
      u0 = threefry_uniform(k0, k1, c);
      u1 = threefry_uniform(k0, k1, c + 1u);
    }
  }
  // u0 of slot j alone (Russian roulette reads no u1)
  __device__ __forceinline__ float first(int j) const {
    if (u != nullptr)
      return __ldg(u + static_cast<size_t>(2 * j) * n_rays + rid);
    return threefry_uniform(k0, k1, base + 2u * static_cast<uint32_t>(j));
  }
};

// Draw slots of one pass, in JAX's order (megakernel_grad.n_draw_pairs):
// lens, NEE per light, then per depth: [rr], bounce, NEE per light, where
// rr (0 or 1) is the Russian-roulette slot of a pass with Russian roulette.
// Segment s (the primary hit is segment 0) draws its NEE sample of light li
// at nee_slot(s, li), its roulette (u0 only) at rr_slot(s) and its bounce
// at bounce_slot(s). With rr = 0 these are the slots of a pass without
// Russian roulette.
__device__ __forceinline__ int n_draws_of(int n_lig, int bounces, int rr) {
  return 1 + n_lig + bounces * (1 + n_lig + rr);
}
__device__ __forceinline__ int nee_slot(int s, int li, int n_lig, int rr) {
  return s * (1 + n_lig + rr) + 1 + li;
}
__device__ __forceinline__ int rr_slot(int s, int n_lig) {
  return 1 + n_lig + s * (2 + n_lig);
}
__device__ __forceinline__ int bounce_slot(int s, int n_lig, int rr) {
  return 1 + n_lig + s * (1 + n_lig + rr) + rr;
}

// Russian roulette after segment s's NEE, as JAX's _render_pass_kernel
// plays it: the path survives with p = clip(max(tp), 0.05, 1) when u0 of
// slot rr_slot(s) is below p, and its throughput is then scaled by 1 / p;
// returns false when the path ends. The adjoints replay it bit for bit (a
// product and a division, no multiply-add to contract).
__device__ __forceinline__ bool rr_survive(const Draws& D, int s, int n_lig,
                                           V3& tp) {
  const float p = fminf(fmaxf(fmaxf(tp.x, fmaxf(tp.y, tp.z)), 0.05f), 1.0f);
  if (!(D.first(rr_slot(s, n_lig)) < p)) return false;
  const float inv_p = 1.0f / p;
  tp = mk(tp.x * inv_p, tp.y * inv_p, tp.z * inv_p);
  return true;
}

// The discriminant of sphere row s for ray (o, d) with a = d.d: b = 2 m.d,
// cq = m.m - r^2 (m = o - c), dis = b^2 - 4 a cq.
__device__ __forceinline__ float sphere_dis(const float* s, V3 o, V3 d,
                                            float a, float& b) {
  const V3 m = o - ld3(s);
  const float r = s[3];
  b = 2.0f * dot(m, d);
  const float cq = dot(m, m) - r * r;
  return b * b - 4.0f * a * cq;
}

// The root of a sphere whose discriminant dis >= 0 that lies in [mint,
// maxt]: the nearer one (far false), else the farther (far true); false
// when neither does.
__device__ __forceinline__ bool sphere_root(float b, float dis, float inv2a,
                                            float mint, float maxt, float& t,
                                            bool& far) {
  const float sq = sqrtf(dis);
  const float t0 = (-b - sq) * inv2a;
  const float t1 = (-b + sq) * inv2a;
  const float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
  far = false;
  if (tmn >= mint && tmn <= maxt) {
    t = tmn;
  } else if (tmx >= mint && tmx <= maxt) {
    t = tmx;
    far = true;
  } else {
    return false;
  }
  return true;
}

// The closest-hit champion of one ray: t, shading normal, material,
// object id, and beta, gamma (for a sphere beta = 1 at the far root).
struct Champ {
  float t;
  V3 n;
  float m;
  int obj;
  float beta, gamma;
};

// The test of triangle row q of a global table against the ray (o, d) in
// [mint, maxt], from its floats 0-15 (the brute loop's arithmetic): facing
// (two_sided: any side), inside and in the window; t, beta, gamma.
struct TriTest {
  float t, beta, gamma;
  bool ok;
};
__device__ __forceinline__ TriTest tri_test(const float* q, V3 o, V3 d,
                                            V3 oxd, bool two_sided,
                                            float mint, float maxt) {
  TriTest h = {0.0f, 0.0f, 0.0f, false};
  const V3 ng = ld3(q);
  const float div = dot(ng, d);
  if (two_sided ? !(div != 0.0f) : !(div > 0.0f)) return h;
  const float idiv = 1.0f / div;
  // constant-split Moller-Trumbore over [n_geo, c1, c2, e1, e2, k]
  h.beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
  h.gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
  h.t = (q[15] - dot(ng, o)) * idiv;
  h.ok = h.beta >= 0.0f && h.beta <= 1.0f && h.gamma >= 0.0f &&
         h.beta + h.gamma <= 1.0f && h.t >= mint && h.t <= maxt;
  return h;
}

// Test h of triangle row q, object id obj, taken over the champion c where
// it wins on the least (t, id) pair and the row's mask is set; the mask
// and the shading floats 18-26 are read only then.
__device__ __forceinline__ void tri_take(const float* q, int obj,
                                         const TriTest& h, Champ& c) {
  if (h.ok && (h.t < c.t || (h.t == c.t && obj < c.obj)) && q[17] > 0.0f) {
    const float alpha = 1.0f - h.beta - h.gamma;
    c.n = normalize(alpha * ld3(q + 18) + h.beta * ld3(q + 21) +
                    h.gamma * ld3(q + 24));
    c.t = h.t;
    c.m = q[16];
    c.obj = obj;
    c.beta = h.beta;
    c.gamma = h.gamma;
  }
}

// Triangle row q of a global table (a grid cell's item), object id obj,
// as a closest-hit candidate of the ray (o, d) in [mint, maxt]: the brute
// loop's arithmetic, the least (t, id) pair winning over the champion c
// (tri_test and tri_take, above, split it for a streamed leaf; the grid
// walk keeps this form, whose code its instances were timed with).
__device__ __forceinline__ void tri_candidate(const float* q, int obj, V3 o,
                                              V3 d, V3 oxd, bool two_sided,
                                              float mint, float maxt,
                                              Champ& c) {
  const V3 ng = ld3(q);
  const float div = dot(ng, d);
  if (two_sided ? !(div != 0.0f) : !(div > 0.0f)) return;
  const float idiv = 1.0f / div;
  // constant-split Moller-Trumbore over [n_geo, c1, c2, e1, e2, k]
  const float beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
  const float gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
  const float t = (q[15] - dot(ng, o)) * idiv;
  if (beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
      beta + gamma <= 1.0f && t >= mint && t <= maxt &&
      (t < c.t || (t == c.t && obj < c.obj)) && q[17] > 0.0f) {
    const float alpha = 1.0f - beta - gamma;
    c.n = normalize(alpha * ld3(q + 18) + beta * ld3(q + 21) +
                    gamma * ld3(q + 24));
    c.t = t;
    c.m = q[16];
    c.obj = obj;
    c.beta = beta;
    c.gamma = gamma;
  }
}

// Sphere row s, object id j, with its discriminant dis and b
// (sphere_dis), taken over the champion c as tri_take takes a triangle; a
// = d.d, inv2a = 0.5 / a.
__device__ __forceinline__ void sph_take(const float* s, int j, V3 o, V3 d,
                                         float inv2a, float mint, float maxt,
                                         float b, float dis, Champ& c) {
  float t;
  bool far;
  if (dis >= 0.0f && sphere_root(b, dis, inv2a, mint, maxt, t, far) &&
      (t < c.t || (t == c.t && j < c.obj)) && s[5] > 0.0f) {
    c.t = t;
    c.n = normalize(o + t * d - ld3(s));
    c.m = s[4];
    c.obj = j;
    c.beta = far ? 1.0f : 0.0f;
  }
}

// Sphere row s of a global table, object id j, as tri_candidate.
__device__ __forceinline__ void sph_candidate(const float* s, int j, V3 o,
                                              V3 d, float a, float inv2a,
                                              float mint, float maxt,
                                              Champ& c) {
  float b;
  const float dis = sphere_dis(s, o, d, a, b);
  float t;
  bool far;
  if (dis >= 0.0f && sphere_root(b, dis, inv2a, mint, maxt, t, far) &&
      (t < c.t || (t == c.t && j < c.obj)) && s[5] > 0.0f) {
    c.t = t;
    c.n = normalize(o + t * d - ld3(s));
    c.m = s[4];
    c.obj = j;
    c.beta = far ? 1.0f : 0.0f;
  }
}

// The rows of one 32-row word of a streamed leaf (r0 its first sorted row,
// m the rows that take part), kU at a time: test(r) of each of the kU rows
// first (independent, so their loads are in flight together), then take(r,
// test) in row order; stops and returns true where take does.
template <int kU, class Test, class Take>
__device__ __forceinline__ bool leaf_rows(int r0, unsigned m, Test test,
                                          Take take) {
  while (m) {
    int r[kU];
    decltype(test(0)) h[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      r[k] = m ? r0 + __ffs(m) - 1 : -1;
      m &= m - 1u;
    }
#pragma unroll
    for (int k = 0; k < kU; ++k)
      if (r[k] >= 0) h[k] = test(r[k]);
#pragma unroll
    for (int k = 0; k < kU; ++k)
      if (r[k] >= 0 && take(r[k], h[k])) return true;
  }
  return false;
}
constexpr int kTriRows = 2;  // a streamed leaf's rows per step (leaf_rows)
constexpr int kSphRows = 4;
struct SphTest {
  float b, dis;
};

// Whether triangle row q / sphere row s of a global table occludes the
// ray (o, d) in [mint, maxt] (the brute any-hit loop's tests).
__device__ __forceinline__ bool tri_occludes(const float* q, V3 o, V3 d,
                                             V3 oxd, bool two_sided,
                                             float mint, float maxt) {
  const V3 ng = ld3(q);
  const float div = dot(ng, d);
  if (two_sided ? !(div != 0.0f) : !(div > 0.0f)) return false;
  const float idiv = 1.0f / div;
  const float beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
  const float gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
  const float t = (q[15] - dot(ng, o)) * idiv;
  return beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
         beta + gamma <= 1.0f && t >= mint && t <= maxt && q[17] > 0.0f;
}
__device__ __forceinline__ bool sph_occludes(const float* s, V3 o, V3 d,
                                             float a, float inv2a,
                                             float mint, float maxt) {
  float b;
  const float dis = sphere_dis(s, o, d, a, b);
  float t;
  bool far;
  return dis >= 0.0f && sphere_root(b, dis, inv2a, mint, maxt, t, far) &&
         s[5] > 0.0f;
}

// Closest hit in [mint, maxt] (strict `t < best` champion over increasing
// index, spheres then triangles); returns the new maxt (champion t, or
// maxt on a miss). The sphere loop takes kRows rows per iteration: their
// discriminants first (independent, so their loads and arithmetic
// overlap), then the candidates in index order. More rows hide more of a
// long table's latency but take registers (on the H100, sphere_field(1024)
// recording 7.77 / 6.18 / 5.67 / 5.48 ms at 1 / 2 / 4 / 8 rows, cornell
// 0.58 / 0.58 / 0.61 / 0.63 ms per pass). A row's mask is read only for a
// candidate that beats the champion: a masked object never becomes the
// champion, so this changes no result.
//
// Grid mode (kGrid, G non-null): the brute loops cover the shared-memory
// prefix (T.n_tri triangles; the spheres unless gridded or streamed), then
// the streamed tables are read chunk by chunk (kStream, instances of their
// own, so that grid mode alone keeps its code) and each grid is walked
// (grid_walk), their rows tested from global memory with the same
// arithmetic (tri_candidate / sph_candidate serve both); there a
// candidate wins on the least (t, original id) pair, so the champion is
// the brute loops' whatever order the chunks and cells come in (mesh
// triangles that share an edge are hit at the same t).
//
// A streamed table (the Pallas kernel's chunk loops, megakernel.py:874-935,
// which test every Morton chunk a ray tile overlaps, in Morton order): the
// table's tree is walked, triangles by each lane on its own (lane_walk),
// spheres by the warp over its lanes' union (warp_walk): the loose rows
// first, so that a wall's t culls the tree from the start, then nearer
// children first, culled by the live window [mint, min(maxt, champion
// t)]; a visited leaf's rows are tested kTriRows / kSphRows at a time
// (leaf_rows) from the Morton-sorted copy, which L2 holds (1,002 triangles
// take 125 KB). A row's mask and shading floats are read only where it
// wins. The
// walk visits leaves in another order than the brute loop's rows and the
// Morton chunks, which changes no champion: the least (t, original id)
// pair wins.
template <int kRows = 2, bool kGrid = false, bool kStream = false>
__device__ float trace(const Tables& T, V3 o, V3 d, float mint, float maxt,
                       Hit& h, const Grids* G = nullptr) {
  float bt = inf_f();
  V3 bn = mk(0.0f, 0.0f, 0.0f);
  float bm = -1.0f;
  int bobj = -1;
  float bbeta = 0.0f, bgamma = 0.0f;
  if (mint != maxt) {
    const float a = dot(d, d);
    const float inv2a = 0.5f / a;
    auto candidate = [&](int i, float b, float dis) {
      const float* s = T.sph + i * kSph;
      float t;
      bool far;
      if (sphere_root(b, dis, inv2a, mint, maxt, t, far) && t < bt &&
          s[5] > 0.0f) {
        bt = t;
        bn = normalize(o + t * d - ld3(s));
        bm = s[4];
        bobj = i;
        bbeta = far ? 1.0f : 0.0f;
      }
    };
    const int ns = kGrid ? G->sph_resident(T.n_sph) : T.n_sph;
    int i = 0;
    for (; i + kRows <= ns; i += kRows) {
      float b[kRows], dis[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        dis[k] = sphere_dis(T.sph + (i + k) * kSph, o, d, a, b[k]);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (dis[k] >= 0.0f) candidate(i + k, b[k], dis[k]);
    }
    for (; i < ns; ++i) {
      float b;
      const float dis = sphere_dis(T.sph + i * kSph, o, d, a, b);
      if (dis >= 0.0f) candidate(i, b, dis);
    }
    const V3 oxd = cross(o, d);  // loop-invariant over triangles
    for (i = 0; i < T.n_tri; ++i) {
      const float* q = T.tri + i * kTri;
      const V3 ng = ld3(q);
      const float div = dot(ng, d);
      if (T.two_sided ? !(div != 0.0f) : !(div > 0.0f)) continue;
      const float idiv = 1.0f / div;
      // constant-split Moller-Trumbore over [n_geo, c1, c2, e1, e2, k]
      const float beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
      const float gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
      const float t = (q[15] - dot(ng, o)) * idiv;
      if (beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
          beta + gamma <= 1.0f && t >= mint && t <= maxt && t < bt &&
          q[17] > 0.0f) {
        const float alpha = 1.0f - beta - gamma;
        bn = normalize(alpha * ld3(q + 18) + beta * ld3(q + 21) +
                       gamma * ld3(q + 24));
        bt = t;
        bm = q[16];
        bobj = T.n_sph + i;
        bbeta = beta;
        bgamma = gamma;
      }
    }
    if constexpr (kGrid) {
      Champ c = {bt, bn, bm, bobj, bbeta, bgamma};
      if constexpr (kStream) {
        const V3 inv = safe_inv(d);
        auto live = [&]() { return fminf(maxt, c.t); };
        const Stream& SS = G->sph_st;
        if (SS.n) {
          auto row = [&](int r) {
            return SS.rows + static_cast<size_t>(r) * kSph;
          };
          auto test = [&](int r) {
            SphTest h;
            h.dis = sphere_dis(row(r), o, d, a, h.b);
            return h;
          };
          auto take = [&](int r, const SphTest& h) {
            if (h.dis >= 0.0f)
              sph_take(row(r), __ldg(SS.perm + r), o, d, inv2a, mint, maxt,
                       h.b, h.dis, c);
            return false;
          };
          warp_walk(SS, o, inv, mint, live,
                    [&](int r) { return take(r, test(r)); },
                    [&](int r0, unsigned m) {
                      return leaf_rows<kSphRows>(r0, m, test, take);
                    });
        }
        const Stream& TS = G->tri_st;
        if (TS.n) {
          auto row = [&](int r) {
            return TS.rows + static_cast<size_t>(r) * kTri;
          };
          auto test = [&](int r) {
            return tri_test(row(r), o, d, oxd, T.two_sided, mint, maxt);
          };
          auto take = [&](int r, const TriTest& h) {
            if (h.ok) tri_take(row(r), T.n_sph + __ldg(TS.perm + r), h, c);
            return false;
          };
          lane_walk(TS, o, inv, mint, live,
                    [&](int r) { return take(r, test(r)); },
                    [&](int r0, unsigned m) {
                      return leaf_rows<kTriRows>(r0, m, test, take);
                    });
        }
      }
      auto bound = [&]() { return c.t; };
      for (int gi = 0; gi < G->n_tri; ++gi) {
        const GridDesc& g = G->g[gi];
        grid_walk(g, o, d, mint, maxt, [&](int cell) {
          const int e = __ldg(g.off + cell + 1);
          for (int k = __ldg(g.off + cell); k < e; ++k) {
            const int j = __ldg(g.items + k);
            tri_candidate(G->tri_tab + static_cast<size_t>(j) * kTri,
                          T.n_sph + j, o, d, oxd, T.two_sided, mint, maxt, c);
          }
          return false;
        }, bound);
      }
      if (G->sph) {
        const GridDesc& g = G->g[G->n_tri];
        grid_walk(g, o, d, mint, maxt, [&](int cell) {
          const int e = __ldg(g.off + cell + 1);
          for (int k = __ldg(g.off + cell); k < e; ++k) {
            const int j = __ldg(g.items + k);
            sph_candidate(G->sph_tab + static_cast<size_t>(j) * kSph, j, o,
                          d, a, inv2a, mint, maxt, c);
          }
          return false;
        }, bound);
      }
      bt = c.t;
      bn = c.n;
      bm = c.m;
      bobj = c.obj;
      bbeta = c.beta;
      bgamma = c.gamma;
    }
  }
  const bool found = bm >= 0.0f;
  const float ts = found ? bt : 0.0f;
  h.p = o + ts * d;
  h.n = bn;
  h.m = bm;
  h.obj = found ? bobj : -1;
  h.t = ts;
  h.beta = bbeta;
  h.gamma = bgamma;
  return found ? bt : maxt;
}

// Occlusion of the segment [mint, maxt]; stops at the first hit. Spheres
// kRows at a time and masks as in trace.
// Grid mode (kGrid): the prefix as in trace, then the streamed tables
// (kStream; trace's walk over [mint, maxt]) and the grids' walks, each
// stopping at its first occluder.
template <int kRows = 2, bool kGrid = false, bool kStream = false>
__device__ bool anyhit(const Tables& T, V3 o, V3 d, float mint, float maxt,
                       const Grids* G = nullptr) {
  if (mint == maxt) return false;
  const float a = dot(d, d);
  const float inv2a = 0.5f / a;
  auto hits = [&](int i, float b, float dis) {
    float t;
    bool far;
    return sphere_root(b, dis, inv2a, mint, maxt, t, far) &&
           T.sph[i * kSph + 5] > 0.0f;
  };
  const int ns = kGrid ? G->sph_resident(T.n_sph) : T.n_sph;
  int i = 0;
  for (; i + kRows <= ns; i += kRows) {
    float b[kRows], dis[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      dis[k] = sphere_dis(T.sph + (i + k) * kSph, o, d, a, b[k]);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (dis[k] >= 0.0f && hits(i + k, b[k], dis[k])) return true;
  }
  for (; i < ns; ++i) {
    float b;
    const float dis = sphere_dis(T.sph + i * kSph, o, d, a, b);
    if (dis >= 0.0f && hits(i, b, dis)) return true;
  }
  const V3 oxd = cross(o, d);
  for (i = 0; i < T.n_tri; ++i) {
    const float* q = T.tri + i * kTri;
    const V3 ng = ld3(q);
    const float div = dot(ng, d);
    if (T.two_sided ? !(div != 0.0f) : !(div > 0.0f)) continue;
    const float idiv = 1.0f / div;
    const float beta = (dot(ld3(q + 12), oxd) - dot(ld3(q + 6), d)) * idiv;
    const float gamma = (dot(ld3(q + 3), d) - dot(ld3(q + 9), oxd)) * idiv;
    const float t = (q[15] - dot(ng, o)) * idiv;
    if (beta >= 0.0f && beta <= 1.0f && gamma >= 0.0f &&
        beta + gamma <= 1.0f && t >= mint && t <= maxt && q[17] > 0.0f)
      return true;
  }
  if constexpr (kGrid) {
    if constexpr (kStream) {
      const V3 inv = safe_inv(d);
      auto window = [&]() { return maxt; };
      const Stream& SS = G->sph_st;
      if (SS.n) {
        auto row = [&](int r) {
          return SS.rows + static_cast<size_t>(r) * kSph;
        };
        auto test = [&](int r) {
          SphTest h;
          h.dis = sphere_dis(row(r), o, d, a, h.b);
          return h;
        };
        auto take = [&](int r, const SphTest& h) {
          float t;
          bool far;
          return h.dis >= 0.0f &&
                 sphere_root(h.b, h.dis, inv2a, mint, maxt, t, far) &&
                 row(r)[5] > 0.0f;
        };
        if (warp_walk(SS, o, inv, mint, window,
                      [&](int r) { return take(r, test(r)); },
                      [&](int r0, unsigned m) {
                        return leaf_rows<kSphRows>(r0, m, test, take);
                      }))
          return true;
      }
      const Stream& TS = G->tri_st;
      if (TS.n) {
        auto row = [&](int r) {
          return TS.rows + static_cast<size_t>(r) * kTri;
        };
        auto test = [&](int r) {
          return tri_test(row(r), o, d, oxd, T.two_sided, mint, maxt);
        };
        auto take = [&](int r, const TriTest& h) {
          return h.ok && row(r)[17] > 0.0f;
        };
        if (lane_walk(TS, o, inv, mint, window,
                      [&](int r) { return take(r, test(r)); },
                      [&](int r0, unsigned m) {
                        return leaf_rows<kTriRows>(r0, m, test, take);
                      }))
          return true;
      }
    }
    bool occ = false;
    auto bound = []() { return inf_f(); };
    for (int gi = 0; gi < G->n_tri && !occ; ++gi) {
      const GridDesc& g = G->g[gi];
      grid_walk(g, o, d, mint, maxt, [&](int cell) {
        const int e = __ldg(g.off + cell + 1);
        for (int k = __ldg(g.off + cell); k < e && !occ; ++k)
          occ = tri_occludes(
              G->tri_tab + static_cast<size_t>(__ldg(g.items + k)) * kTri, o,
              d, oxd, T.two_sided, mint, maxt);
        return occ;
      }, bound);
    }
    if (G->sph && !occ) {
      const GridDesc& g = G->g[G->n_tri];
      grid_walk(g, o, d, mint, maxt, [&](int cell) {
        const int e = __ldg(g.off + cell + 1);
        for (int k = __ldg(g.off + cell); k < e && !occ; ++k)
          occ = sph_occludes(
              G->sph_tab + static_cast<size_t>(__ldg(g.items + k)) * kSph, o,
              d, a, inv2a, mint, maxt);
        return occ;
      }, bound);
    }
    return occ;
  }
  return false;
}

// Pixel (col, row) and sub-sample of global ray id rid_g.
__device__ __forceinline__ void pixel_of(int rid_g, int spp, int width,
                                         int& col, int& row, int& samp) {
  const int pix = rid_g / spp;
  samp = rid_g - pix * spp;
  row = pix / width;
  col = pix - row * width;
}

// The stratified lens-cell centre of sub-sample samp at spp = k^2 > 1.
__device__ __forceinline__ void stratified_uv(int samp, int spp, float& u0,
                                              float& u1) {
  const int k = static_cast<int>(sqrtf(static_cast<float>(spp)) + 0.5f);
  const int si = samp / k;
  const int sj = samp - si * k;
  u0 = (static_cast<float>(sj) + 0.5f) / static_cast<float>(k);
  u1 = (static_cast<float>(si) + 0.5f) / static_cast<float>(k);
}

// Lens sample: spp > 1 uses the stratified lens-cell centre and leaves
// draw slot 0 unused.
__device__ __forceinline__ void lens_uv(const Draws& D, int samp, int spp,
                                        float& u0, float& u1) {
  if (spp > 1)
    stratified_uv(samp, spp, u0, u1);
  else
    D.pair(0, u0, u1);
}

// Primary ray of pixel (col, row) for lens sample (u0, u1): film point ->
// pinhole direction -> focal point -> thin-lens origin and direction,
// clipped to the scene AABB (a miss is the dead window mint = maxt = INF).
__device__ __forceinline__ void camera_ray_uv(const float* P, float u0,
                                              float u1, int col, int row,
                                              V3& o, V3& d, float& mint,
                                              float& maxt) {
  const V3 e = ld3(P + kEye), U = ld3(P + kU), V = ld3(P + kV),
           W = ld3(P + kW);
  const float su = (-0.5f + (static_cast<float>(col) + 0.5f) / P[kCols]) *
                   P[kFilmW];
  const float sv = (0.5f - (static_cast<float>(row) + 0.5f) / P[kRows]) *
                   P[kFilmH];
  const V3 pd = normalize(su * U + sv * V - W);
  const float fl = P[kFocal];
  const float pipd = -dot(e - fl * W, W);
  const float tf = -(dot(e, W) + pipd) / dot(pd, W);
  const V3 fp = e + tf * pd;

  float lx, ly;
  concentric(u0, u1, lx, ly);
  const float lr = P[kLensR];
  o = e + lr * (lx * U + ly * V);
  d = normalize(fp - o);

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
  mint = inf_f();
  maxt = inf_f();
  if (tmin <= tmax) {
    mint = tmin;
    maxt = tmax;
  }
}

// The primary ray with its lens sample from lens_uv.
__device__ __forceinline__ void camera_ray(const float* P, const Draws& D,
                                           int col, int row, int samp,
                                           int spp, V3& o, V3& d,
                                           float& mint, float& maxt) {
  float u0, u1;
  lens_uv(D, samp, spp, u0, u1);
  camera_ray_uv(P, u0, u1, col, row, o, d, mint, maxt);
}

// The light whose disk the primary segment [mint, maxt) hits first in
// light order, or -1. A hit ends the path.
__device__ __forceinline__ int emitter_hit(const Tables& T, V3 o, V3 d,
                                           float mint, float maxt) {
  for (int li = 0; li < T.n_lig && mint != maxt; ++li) {
    const float* l = T.lig + li * kLig;
    const V3 lp = ld3(l), ln = ld3(l + 3);
    const float den = dot(d, ln);
    const float num = dot(lp - o, ln);
    const float t = num / (den == 0.0f ? 1.0f : den);
    const V3 q = o + t * d - lp;
    const bool on_disk = dot(q, q) <= l[12] * l[12];
    if (den != 0.0f && num != 0.0f && on_disk && t < inf_f() && t >= mint &&
        t < maxt)
      return li;
  }
  return -1;
}

// The NEE shadow ray of light li from hit h with draw slot `slot`: disk
// sample (sx, sy) = concentric(u) (before the radius), origin so =
// h.p + eps h.n, unnormalised direction dl to the sampled point, unit
// direction sd and length dist.
struct Shadow {
  float sx, sy;
  V3 so, dl, sd;
  float dist;
};
__device__ __forceinline__ Shadow shadow_ray_uv(const Tables& T, float u0,
                                                float u1, int li,
                                                const Hit& h, float eps) {
  const float* l = T.lig + li * kLig;
  Shadow s;
  concentric(u0, u1, s.sx, s.sy);
  const float rad = l[12];
  const float sx = s.sx * rad;
  const float sy = s.sy * rad;
  const V3 tgt = ld3(l) + sx * ld3(l + 14) + sy * ld3(l + 17);
  s.so = h.p + eps * h.n;
  s.dl = tgt - s.so;
  const float d2 = dot(s.dl, s.dl);
  s.dist = d2 > 0.0f ? sqrtf(d2) : 0.0f;
  s.sd = normalize(s.dl);
  return s;
}
__device__ __forceinline__ Shadow shadow_ray(const Tables& T, const Draws& D,
                                             int slot, int li, const Hit& h,
                                             float eps) {
  float u0, u1;
  D.pair(slot, u0, u1);
  return shadow_ray_uv(T, u0, u1, li, h, eps);
}

// The cosine bounce from hit h for the draw (u0, u1): disk sample (cx, cy)
// lifted by cz, unit direction d and origin o = h.p + eps h.n.
__device__ __forceinline__ void bounce_ray_uv(float u0, float u1,
                                              const Hit& h, float eps,
                                              float& cx, float& cy,
                                              float& cz, V3& o, V3& d) {
  V3 tx, bx;
  tangent_frame(h.n, tx, bx);
  concentric(u0, u1, cx, cy);
  cz = sqrtf(fmaxf(0.0f, 1.0f - cx * cx - cy * cy));
  d = normalize(cx * tx + cy * bx + cz * h.n);
  o = h.p + eps * h.n;
}

// The cosine bounce with the draw of slot `slot`.
__device__ __forceinline__ void bounce_ray(const Draws& D, int slot,
                                           const Hit& h, float eps, float& cx,
                                           float& cy, float& cz, V3& o,
                                           V3& d) {
  float u0, u1;
  D.pair(slot, u0, u1);
  bounce_ray_uv(u0, u1, h, eps, cx, cy, cz, o, d);
}

// Albedo rgb of material id m (zeros outside the table).
__device__ __forceinline__ V3 albedo(const Tables& T, int m) {
  if (m < T.n_mat) return ld3(T.mat + m * kMat);
  return mk(0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void copy_table(float* dst, const float* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Floats of the five tables in shared memory, par padded.
__host__ __device__ inline int tables_floats(int n_sph, int n_tri, int n_mat,
                                             int n_lig) {
  return kParPad + kSph * n_sph + kTri * n_tri + kMat * n_mat + kLig * n_lig;
}

// Copies the five tables into shared memory at `smem` (16-byte aligned), in
// the order par (padded), sph, tri, mat, lig; the caller synchronises.
__device__ __forceinline__ Tables stage_tables(float* smem, const float* par,
                                               const float* sph, int n_sph,
                                               const float* tri, int n_tri,
                                               const float* mat, int n_mat,
                                               const float* lig, int n_lig,
                                               bool two_sided) {
  Tables T;
  float* s_par = smem;
  float* s_sph = s_par + kParPad;
  float* s_tri = s_sph + kSph * n_sph;
  float* s_mat = s_tri + kTri * n_tri;
  float* s_lig = s_mat + kMat * n_mat;
  copy_table(s_par, par, kNPar);
  copy_table(s_sph, sph, kSph * n_sph);
  copy_table(s_tri, tri, kTri * n_tri);
  copy_table(s_mat, mat, kMat * n_mat);
  copy_table(s_lig, lig, kLig * n_lig);
  T.par = s_par;
  T.sph = s_sph;
  T.tri = s_tri;
  T.mat = s_mat;
  T.lig = s_lig;
  T.n_sph = n_sph;
  T.n_tri = n_tri;
  T.n_mat = n_mat;
  T.n_lig = n_lig;
  T.two_sided = two_sided;
  return T;
}

}  // namespace rt
