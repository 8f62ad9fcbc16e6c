// The adjoint of one path, shared by kernel 2 (megakernel_grad.cu, which
// fills the tape by tracing the tables) and kernel 3 (megakernel_champ.cu,
// which fills it from kernel 1's champion record): the tape segment, the
// adjoints of the forward's pieces (safe normalize, tangent frame, the
// champion surface, the closest hit's champion row, the camera chain) and
// the reverse sweep over a filled tape. Hard-gradient convention and
// guards as described in megakernel_grad.cu.
//
// Both kernels are built with --fmad=false (ops/megakernel_grad.ADJ_FLAGS):
// no contracted multiply-adds, so each computes its plain version's
// float32 arithmetic. The sphere root's discriminant b^2 - 4ac cancels
// near a silhouette, where the hard gradient (~1/sqrt(dis)) is largest,
// so a few grazing rays carry most of the sphere and camera cotangents and
// their rounding decides them. Measured on one H100 80GB HBM3 (700 W),
// contracted builds against their plain versions: kernel 3 on
// sphere_field(1024) at 1024^2 b5, sph cosine 0.068; kernel 2 on
// sphere_field(64) at 256x192 b5, sph cosine 0.22 and par -0.80, and on
// cornell at 1024^2 b5, par and tri norm ratios 1.042-1.043. Uncontracted,
// every group agrees to ~1e-5 of scale or better. The cost: kernel 2 6.2
// ms against 5.5 ms on cornell 1024^2, kernel 3 1.60 ms against 1.40 ms
// on sphere_field(1024).
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "pathtrace.cuh"

namespace rt {

constexpr int kMaxSeg = 16;     // bounces <= 15
constexpr int kMaxLights = 32;  // occlusion bits per segment
// diff_wrt groups
constexpr int kWPar = 1, kWSph = 2, kWTri = 4, kWMat = 8, kWLig = 16;

// Adjoint of safe normalize y = v / |v| for cotangent gy.
__device__ __forceinline__ V3 normalize_adj(V3 v, V3 gy) {
  const float n2 = dot(v, v);
  if (!(n2 > 0.0f)) return gy;
  const float inv = rsqrtf(n2);
  const V3 y = inv * v;
  return inv * (gy - dot(gy, y) * y);
}

// Adjoint of tangent_frame(n) -> (t, b) for cotangents gt, gb; returns gn.
__device__ __forceinline__ V3 tangent_frame_adj(V3 n, V3 gt, V3 gb) {
  const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  const float mn = fminf(ax, fminf(ay, az));
  const bool fx = ax == mn;
  const bool fy = (ay == mn) && !fx;
  const bool fz = (az == mn) && !fx && !fy;
  const V3 vr = mk(fx ? 1.0f : n.x, fy ? 1.0f : n.y, fz ? 1.0f : n.z);
  const V3 v = normalize(vr);
  const V3 tr = cross(v, n);
  const V3 t = normalize(tr);
  const V3 br = cross(n, t);
  // b = normalize(cross(n, t))
  const V3 gbr = normalize_adj(br, gb);
  V3 gn = cross(t, gbr);
  gt = gt + cross(gbr, n);
  // t = normalize(cross(v, n))
  const V3 gtr = normalize_adj(tr, gt);
  gn = gn + cross(gtr, v);
  const V3 gv = cross(n, gtr);
  // v = normalize(n with its smallest component replaced by 1)
  const V3 gvr = normalize_adj(vr, gv);
  return gn + mk(fx ? 0.0f : gvr.x, fy ? 0.0f : gvr.y, fz ? 0.0f : gvr.z);
}

__device__ __forceinline__ void add3(float* p, V3 g) {
  atomicAdd(p + 0, g.x);
  atomicAdd(p + 1, g.y);
  atomicAdd(p + 2, g.z);
}

// Gradient buffers laid out like the tables: all in shared memory in
// kernel 2; kernel 3 points sph and tri at the global outputs.
struct Grads {
  float* sph;
  float* tri;
  float* mat;
  float* lig;
  int wrt;
};

// One trace segment of the tape.
struct Seg {
  V3 o, d;
  V3 tp;  // throughput at the segment's start
  float t, beta, gamma;
  int obj;  // champion (sphere i, n_sph + triangle j); -1: no valid hit
  int m;    // material id
  uint32_t occ;  // bit li: light li's shadow ray was occluded
};

// Surface of a tape segment: hit point, unnormalised and unit normal.
__device__ __forceinline__ void surface(const Tables& T, const Seg& q, V3& hp,
                                        V3& nraw, V3& hn) {
  hp = q.o + q.t * q.d;
  if (q.obj < T.n_sph) {
    nraw = hp - ld3(T.sph + q.obj * kSph);
  } else {
    const float* r = T.tri + (q.obj - T.n_sph) * kTri;
    const float alpha = 1.0f - q.beta - q.gamma;
    nraw = alpha * ld3(r + 18) + q.beta * ld3(r + 21) + q.gamma * ld3(r + 24);
  }
  hn = normalize(nraw);
}

// Adjoint of the closest hit of segment q: from the cotangents of the hit
// point and unit normal to those of the segment's origin and direction,
// with the champion row's cotangent added into G.
__device__ void trace_adj(const Tables& T, const Seg& q, V3 nraw, V3 ghp,
                          V3 ghn, const Grads& G, V3& go, V3& gd) {
  const V3 o = q.o, d = q.d;
  const float t = q.t;
  // hp = o + t d
  go = ghp;
  gd = t * ghp;
  float gt = dot(ghp, d);
  const V3 gnr = normalize_adj(nraw, ghn);
  if (q.obj < T.n_sph) {
    const float* s = T.sph + q.obj * kSph;
    const V3 c = ld3(s);
    const float r = s[3];
    // nraw = o + t d - c
    go = go + gnr;
    gd = gd + t * gnr;
    gt += dot(gnr, d);
    V3 gc = mk(-gnr.x, -gnr.y, -gnr.z);
    // t = (-b -+ sq) / (2a): sq = sqrt(dis), dis = b^2 - 4 a cq,
    // b = 2 m.d, cq = m.m - r^2, m = o - c, a = d.d
    const float a = dot(d, d);
    const float inv2a = 0.5f / a;
    const V3 m = o - c;
    const float b = 2.0f * dot(m, d);
    const float cq = dot(m, m) - r * r;
    const float dis = b * b - 4.0f * a * cq;
    const float sq = dis > 0.0f ? sqrtf(dis) : 0.0f;
    const float sgn = q.beta > 0.5f ? 1.0f : -1.0f;  // far root: +sq
    const float ginv2a = gt * (-b + sgn * sq);
    const float gsq = gt * sgn * inv2a;
    float gb = -gt * inv2a;
    const float gdis = dis > 0.0f ? gsq * 0.5f / sq : 0.0f;
    gb += gdis * 2.0f * b;
    const float ga = -4.0f * cq * gdis - ginv2a * 0.5f / (a * a);
    const float gcq = -4.0f * a * gdis;
    const V3 gm = (2.0f * gcq) * m + (2.0f * gb) * d;
    gd = gd + (2.0f * gb) * m + (2.0f * ga) * d;
    go = go + gm;
    gc = gc - gm;
    if (G.wrt & kWSph) {
      float* gs = G.sph + q.obj * kSph;
      add3(gs, gc);
      atomicAdd(gs + 3, -2.0f * r * gcq);
    }
    return;
  }
  const int j = q.obj - T.n_sph;
  const float* row = T.tri + j * kTri;
  const V3 ng = ld3(row), c1 = ld3(row + 3), c2 = ld3(row + 6),
           e1 = ld3(row + 9), e2 = ld3(row + 12);
  const V3 vn0 = ld3(row + 18), vn1 = ld3(row + 21), vn2 = ld3(row + 24);
  const float beta = q.beta, gamma = q.gamma, alpha = 1.0f - beta - gamma;
  // nraw = alpha vn0 + beta vn1 + gamma vn2, alpha = 1 - beta - gamma
  const float g0 = dot(gnr, vn0);
  const float gbeta = dot(gnr, vn1) - g0;
  const float ggamma = dot(gnr, vn2) - g0;
  // beta = Nb / div, gamma = Ng / div, t = Nt / div
  const V3 oxd = cross(o, d);
  const float div = dot(ng, d);
  const float idiv = 1.0f / div;
  const float nb = dot(e2, oxd) - dot(c2, d);
  const float ngm = dot(c1, d) - dot(e1, oxd);
  const float nt = row[15] - dot(ng, o);
  const float gidiv = gbeta * nb + ggamma * ngm + gt * nt;
  const float gnb = gbeta * idiv, gng = ggamma * idiv, gnt = gt * idiv;
  const float gdiv = -gidiv * idiv * idiv;
  const V3 goxd = gnb * e2 - gng * e1;
  gd = gd + gdiv * ng - gnb * c2 + gng * c1 + cross(goxd, o);
  go = go - gnt * ng + cross(d, goxd);
  if (G.wrt & kWTri) {
    float* gr = G.tri + j * kTri;
    add3(gr + 0, gdiv * d - gnt * o);  // n_geo
    add3(gr + 3, gng * d);             // c1
    add3(gr + 6, -gnb * d);            // c2
    add3(gr + 9, -gng * oxd);          // e1
    add3(gr + 12, gnb * oxd);          // e2
    atomicAdd(gr + 15, gnt);           // k
    add3(gr + 18, alpha * gnr);
    add3(gr + 21, beta * gnr);
    add3(gr + 24, gamma * gnr);
  }
}

// Adjoint of the camera chain (film point -> focal point -> thin lens ->
// normalize) from the primary ray's origin and direction cotangents into
// the par cotangents gp.
__device__ void camera_adj(const float* P, const Draws& D, int col, int row,
                           int samp, int spp, V3 go, V3 gd,
                           float (&gp)[kNPar]) {
  const V3 e = ld3(P + kEye), U = ld3(P + kU), V = ld3(P + kV),
           W = ld3(P + kW);
  const float colf = static_cast<float>(col) + 0.5f;
  const float rowf = static_cast<float>(row) + 0.5f;
  const float au = -0.5f + colf / P[kCols];
  const float av = 0.5f - rowf / P[kRows];
  const float su = au * P[kFilmW], sv = av * P[kFilmH];
  const V3 cr = su * U + sv * V - W;
  const V3 pd = normalize(cr);
  const float fl = P[kFocal];
  const V3 pip = e - fl * W;
  const float pipd = -dot(pip, W);
  const float den = dot(pd, W);
  const float tf = -(dot(e, W) + pipd) / den;
  const V3 fp = e + tf * pd;
  float u0, u1, lx, ly;
  lens_uv(D, samp, spp, u0, u1);
  concentric(u0, u1, lx, ly);
  const float lr = P[kLensR];
  const V3 lo = lx * U + ly * V;
  const V3 o = e + lr * lo;

  // d = normalize(fp - o)
  const V3 gdr = normalize_adj(fp - o, gd);
  go = go - gdr;
  // o = e + lr (lx U + ly V)
  V3 ge = go;
  const float glr = dot(go, lo);
  V3 gU = (lr * lx) * go, gV = (lr * ly) * go;
  // fp = e + tf pd
  ge = ge + gdr;
  const float gtf = dot(gdr, pd);
  V3 gpd = tf * gdr;
  // tf = num / den, num = -(e.W + pipd)
  const float gnum = gtf / den;
  const float gden = -gtf * tf / den;
  ge = ge - gnum * W;
  V3 gW = mk(-gnum * e.x, -gnum * e.y, -gnum * e.z);
  const float gpipd = -gnum;
  // pipd = -pip.W, pip = e - fl W
  const V3 gpip = mk(-gpipd * W.x, -gpipd * W.y, -gpipd * W.z);
  gW = gW - gpipd * pip - fl * gpip;
  ge = ge + gpip;
  const float gfl = -dot(gpip, W);
  // den = pd.W
  gpd = gpd + gden * W;
  gW = gW + gden * pd;
  // pd = normalize(su U + sv V - W)
  const V3 gcr = normalize_adj(cr, gpd);
  const float gsu = dot(gcr, U), gsv = dot(gcr, V);
  gU = gU + su * gcr;
  gV = gV + sv * gcr;
  gW = gW - gcr;
  gp[kEye + 0] += ge.x;
  gp[kEye + 1] += ge.y;
  gp[kEye + 2] += ge.z;
  gp[kU + 0] += gU.x;
  gp[kU + 1] += gU.y;
  gp[kU + 2] += gU.z;
  gp[kV + 0] += gV.x;
  gp[kV + 1] += gV.y;
  gp[kV + 2] += gV.z;
  gp[kW + 0] += gW.x;
  gp[kW + 1] += gW.y;
  gp[kW + 2] += gW.z;
  gp[kFilmW] += gsu * au;
  gp[kFilmH] += gsv * av;
  gp[kCols] += -gsu * P[kFilmW] * colf / (P[kCols] * P[kCols]);
  gp[kRows] += gsv * P[kFilmH] * rowf / (P[kRows] * P[kRows]);
  gp[kFocal] += gfl;
  gp[kLensR] += glr;
}

// The reverse sweep over a tape of nseg segments (segment 0 is the
// primary hit) for the accumulator cotangent g: per segment in reverse,
// the next segment's origin and direction through the bounce, the NEE
// terms and the albedo, then the closest hit into its champion row; last
// the camera chain into gp. Nothing here depends on how the tape was
// filled.
__device__ void reverse_sweep(const Tables& T, const Draws& D, const Seg* tape,
                              int nseg, int col, int row, int samp, int spp,
                              V3 g, const Grads& G, float (&gp)[kNPar]) {
  const int L = T.n_lig;
  const float eps = T.par[kEps];
  const bool geo = (G.wrt & (kWPar | kWSph | kWTri)) != 0;
  V3 gtp = mk(0.0f, 0.0f, 0.0f);   // cotangent of the throughput
  V3 go_n = gtp, gd_n = gtp;       // of the next segment's origin, direction
  for (int s = nseg - 1; s >= 0; --s) {
    const Seg& q = tape[s];
    V3 hp, nraw, hn;
    surface(T, q, hp, nraw, hn);
    V3 ghp = mk(0.0f, 0.0f, 0.0f), ghn = ghp;
    Hit hq;
    hq.p = hp;
    hq.n = hn;
    if (geo && s + 1 < nseg) {
      // o' = hp + eps hn, d' = normalize(cx t + cy b + cz hn)
      float cx, cy, cz;
      V3 o2, d2, tx, bx;
      bounce_ray(D, bounce_slot(s, L), hq, eps, cx, cy, cz, o2, d2);
      tangent_frame(hn, tx, bx);
      const V3 gdr = normalize_adj(cx * tx + cy * bx + cz * hn, gd_n);
      ghn = ghn + cz * gdr + tangent_frame_adj(hn, cx * gdr, cy * gdr);
      ghp = ghp + go_n;
      ghn = ghn + eps * go_n;
      gp[kEps] += dot(go_n, hn);
    }
    // NEE terms in reverse light order
    const V3 al = albedo(T, q.m);
    V3 galb = mk(0.0f, 0.0f, 0.0f);
    for (int li = L - 1; li >= 0; --li) {
      V3 tpb = q.tp;  // throughput before this light's NEE
      for (int k = 0; k < li; ++k)
        tpb = mk(tpb.x * al.x, tpb.y * al.y, tpb.z * al.z);
      const float* l = T.lig + li * kLig;
      const bool free = ((q.occ >> li) & 1u) == 0u;
      float geom = 0.0f;
      const Shadow sh = shadow_ray(T, D, nee_slot(s, li, L), li, hq, eps);
      const V3 lp = ld3(l), ln = ld3(l + 3), irr = ld3(l + 6);
      const V3 qv = hp - lp;
      const float r2 = dot(qv, qv);
      const float rr = fmaxf(r2, 1e-20f);
      const float cxv = dot(sh.sd, hn), cyv = -dot(sh.sd, ln);
      const float cosx = fminf(fmaxf(cxv, 0.0f), 1.0f);
      const float cosy = fminf(fmaxf(cyv, 0.0f), 1.0f);
      if (free) geom = l[13] * cosx * cosy / rr;
      const V3 shd = geom * irr;
      // acc += tpb * al * shd; tp = tpb * al
      galb = galb + mk(gtp.x * tpb.x + g.x * tpb.x * shd.x,
                       gtp.y * tpb.y + g.y * tpb.y * shd.y,
                       gtp.z * tpb.z + g.z * tpb.z * shd.z);
      gtp = mk(gtp.x * al.x + g.x * al.x * shd.x,
               gtp.y * al.y + g.y * al.y * shd.y,
               gtp.z * al.z + g.z * al.z * shd.z);
      if (!free || !(geo || (G.wrt & kWLig))) continue;
      const V3 gsh = mk(g.x * tpb.x * al.x, g.y * tpb.y * al.y,
                        g.z * tpb.z * al.z);
      const float ggeom = dot(gsh, irr);
      const float garea = ggeom * cosx * cosy / rr;
      const float gcosx = ggeom * l[13] * cosy / rr;
      const float gcosy = ggeom * l[13] * cosx / rr;
      const float gr2 = r2 > 1e-20f ? -ggeom * geom / rr : 0.0f;
      const float gcx = (cxv > 0.0f && cxv < 1.0f) ? gcosx : 0.0f;
      const float gcy = (cyv > 0.0f && cyv < 1.0f) ? gcosy : 0.0f;
      const V3 gq = (2.0f * gr2) * qv;
      // sd = normalize(dl), dl = tgt - so, so = hp + eps hn
      const V3 gdl = normalize_adj(sh.dl, gcx * hn - gcy * ln);
      ghp = ghp + gq - gdl;
      ghn = ghn + gcx * sh.sd - eps * gdl;
      gp[kEps] -= dot(gdl, hn);
      if (G.wrt & kWLig) {
        // tgt = lp + rad (sx ta + sy ba)
        const float rad = l[12];
        const V3 ta = ld3(l + 14), ba = ld3(l + 17);
        float* gl = G.lig + li * kLig;
        add3(gl + 0, gdl - gq);
        add3(gl + 3, mk(-gcy * sh.sd.x, -gcy * sh.sd.y, -gcy * sh.sd.z));
        add3(gl + 6, geom * gsh);
        atomicAdd(gl + 12, dot(gdl, sh.sx * ta + sh.sy * ba));
        atomicAdd(gl + 13, garea);
        add3(gl + 14, (sh.sx * rad) * gdl);
        add3(gl + 17, (sh.sy * rad) * gdl);
      }
    }
    if ((G.wrt & kWMat) && q.m < T.n_mat) add3(G.mat + q.m * kMat, galb);
    if (!geo) continue;
    trace_adj(T, q, nraw, ghp, ghn, G, go_n, gd_n);
  }
  if (nseg > 0 && (G.wrt & kWPar))
    camera_adj(T.par, D, col, row, samp, spp, go_n, gd_n, gp);
}

}  // namespace rt
