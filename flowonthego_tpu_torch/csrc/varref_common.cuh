// The variational-refinement inner loop: one pixel's arithmetic, which
// every form of the loop shares, and refine_loop, the loop over a field's
// pixels that both routes of K4 run (varref_tiled.cu: one thread-block
// cluster per field, or the whole card).  K3 (varref_fused.cu, one CTA per
// field, a thread a pixel with the pixel's state in registers) has a loop
// of its own built from the same per-pixel functions.  The forms differ in
// where the planes live, in how the threads cover the field and in the
// barrier between phases; every pixel is computed with the same
// arithmetic, in the same order, in all of them.
//
// Per round (inner_iter = level + 1 rounds), as refine_loop runs it:
//   AB smoothness s = qa * rsqrt(|grad uu|^2 + |grad vv|^2 + eps)
//      (3-tap flow derivative, replicate border) at the pixel, at its
//      right neighbour and at the one below, for the pair sums
//      s_h = s + s[i+1] (last column 0), s_v = s + s[j+1] (last row 0).
//      A pixel recomputes its neighbours' s (the same expression, so the
//      same bits) instead of reading a plane of s across a barrier.
//   C  robust colour + gradient data term -> per-pixel 2x2 system; the
//      sub-Laplacian of the base flow (wx, wy) into b1, b2; A11/A22 with
//      the diffusivity sum, kept as omega / A11 and omega / A22
//   D  solve_iter red-black SOR sweeps (odd cells first; dv uses the new du)
// then uu = wx + du, vv = wy + dv.
//
// Barriers of refine_loop: one after AB (C reads the neighbours' pair
// sums) and one after every half-sweep (the next reads the neighbours' du,
// dv): 1 + inner_iter * (1 + 2 * solve_iter).  None stands between C and
// the first half-sweep: C reads and writes only its own pixel's planes
// (and s_h, s_v, which AB wrote before the last barrier), a pixel belongs
// to the same thread in every phase, and the first half-sweep writes only
// odd cells and reads only their even neighbours' du, dv, which nothing
// has touched since the barrier.
//
// A batch of B frames: every input plane is [B][h][w] and dIs is
// [B][8][C][h][w].  The loop walks idx over [first, last) with a stride;
// frame f = idx / (h*w), and the pixel's row and column within its frame
// set every border rule, so row h-1 of frame f never reads frame f+1 and
// the red-black parity is (i + j) of the frame.  The cluster route runs it
// with one frame per cluster, the grid route once over the batch.
//
// The 9 work planes are reached through a Planes policy: at(k, idx) is
// plane k at this thread's pixel or at a neighbour one row up or up to
// two rows down, which another CTA may hold, and put(k, idx, v) writes a
// plane that other CTAs read across a row border (du, dv, s_v).
// GlobalPlanes keeps them in device memory (the grid route): written and
// read by other threads within the launch, so plain pointers, never const
// __restrict__ (which could be read through the non-coherent cache); the
// barrier orders the writes before the reads that follow.  The cluster
// route keeps them in its CTAs' shared memory, split by rows
// (varref_tiled.cu).
// Red-black cells of one colour read only neighbours of the other colour,
// so each half-sweep updates in place.

#pragma once

#include <cuda_runtime.h>

namespace fot_varref {

// The JAX package's constants, computed in double and rounded once.
constexpr float kDataNorm = (float)(0.1 * 0.1);
constexpr float kEpsColor = (float)(0.001 * 0.001);
constexpr float kEpsGrad = (float)(0.001 * 0.001);
constexpr float kEpsSmooth = (float)(0.001 * 0.001);
// The work planes.
// kW11, kW22: the SOR weight over the diagonal, omega / A11 and omega / A22.
enum Plane { kSh, kSv, kW11, kW22, kA12, kB1, kB2, kDu, kDv, kScratchPlanes };

// The work planes in device memory: plane k of N pixels at base + k * N.
struct GlobalPlanes {
  float* base;
  int N;
  __device__ __forceinline__ float& at(int k, int idx) const {
    return base[k * N + idx];
  }
  __device__ __forceinline__ void put(int k, int idx, float v) const {
    base[k * N + idx] = v;
  }
};

// ---- one pixel's arithmetic, shared by every form of the loop ----
//
// Each expression is written once here, so that K3's loop over pixels held
// in registers (varref_fused.cu) and refine_loop below evaluate the same
// operations in the same order: with --fmad=false that makes them agree
// bit for bit.

// Smoothness weight from the flow (base + increment) at the four
// neighbours of a pixel, each replaced by the pixel itself at a border.
__device__ __forceinline__ float smoothness(float uR, float uL, float uD,
                                            float uU, float vR, float vL,
                                            float vD, float vU, float qa) {
  const float ux = 0.5f * (uR - uL);
  const float uy = 0.5f * (uD - uU);
  const float vx = 0.5f * (vR - vL);
  const float vy = 0.5f * (vD - vU);
  return qa * rsqrtf(ux * ux + uy * uy + vx * vx + vy * vy + kEpsSmooth);
}

// The robust colour + gradient data term at one pixel: the 2x2 system's
// a11, a22, a12 and the data part of its right-hand side.
struct DataTerm {
  float a11, a22, a12, b1, b2;
};

// dI(k, c): derivative plane k (Ix, Iy, Iz, Ixx, Ixy, Iyy, Ixz, Iyz) of
// channel c at this pixel; (u0, v0) the flow increment, m the mask.  CH > 0
// fixes the channel count at compile time (the loops unroll, so a pixel's
// 8 * C loads are in flight together and its divisions overlap); the sums
// run over the channels in the same order either way.
template <int CH, class DI>
__device__ __forceinline__ DataTerm data_term(DI dI, int n_channels, float u0,
                                              float v0, float m, float hd3,
                                              float hg3) {
  const int C = CH > 0 ? CH : n_channels;
  // colour constancy
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float Ix = dI(0, c), Iy = dI(1, c), Iz = dI(2, c);
    const float r = Iz + Ix * u0 + Iy * v0;
    acc += r * r / (Ix * Ix + Iy * Iy + kDataNorm);
  }
  float t = m * hd3 * rsqrtf(acc + kEpsColor);
  float x11 = 0.0f, x12 = 0.0f, x22 = 0.0f, y1 = 0.0f, y2 = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float Ix = dI(0, c), Iy = dI(1, c), Iz = dI(2, c);
    const float tc = t / (Ix * Ix + Iy * Iy + kDataNorm);
    x11 += tc * Ix * Ix;
    x12 += tc * Ix * Iy;
    x22 += tc * Iy * Iy;
    y1 += tc * Iz * Ix;
    y2 += tc * Iz * Iy;
  }
  // gradient constancy
  acc = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float Ixx = dI(3, c), Ixy = dI(4, c), Iyy = dI(5, c);
    const float Ixz = dI(6, c), Iyz = dI(7, c);
    const float n1 = Ixx * Ixx + Ixy * Ixy + kDataNorm;
    const float n2 = Iyy * Iyy + Ixy * Ixy + kDataNorm;
    const float r1 = Ixz + Ixx * u0 + Ixy * v0;
    const float r2 = Iyz + Ixy * u0 + Iyy * v0;
    acc += r1 * r1 / n1 + r2 * r2 / n2;
  }
  t = m * hg3 * rsqrtf(acc + kEpsGrad);
  float g11 = 0.0f, g12 = 0.0f, g22 = 0.0f, z1 = 0.0f, z2 = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float Ixx = dI(3, c), Ixy = dI(4, c), Iyy = dI(5, c);
    const float Ixz = dI(6, c), Iyz = dI(7, c);
    const float t1 = t / (Ixx * Ixx + Ixy * Ixy + kDataNorm);
    const float t2 = t / (Iyy * Iyy + Ixy * Ixy + kDataNorm);
    g11 += t1 * Ixx * Ixx + t2 * Ixy * Ixy;
    g12 += t1 * Ixx * Ixy + t2 * Ixy * Iyy;
    g22 += t2 * Iyy * Iyy + t1 * Ixy * Ixy;
    z1 += t1 * Ixx * Ixz + t2 * Ixy * Iyz;
    z2 += t2 * Iyy * Iyz + t1 * Ixy * Ixz;
  }
  return {x11 + g11, x22 + g22, x12 + g12, -y1 - z1, -y2 - z2};
}

// A pixel's place in its frame: which of its four neighbours exist.
struct Borders {
  bool left, right, up, down;
};

// The diffusivity pair sums around a pixel: s_h, s_v at the pixel and at
// its left and upper neighbours (zero where there is none).
struct PairSums {
  float sh0, sv0, shl, svu;
};

// Sub-Laplacian of one component f of the base flow at a pixel (f0) and
// its neighbours; a coefficient vanishes where there is no neighbour.
__device__ __forceinline__ float sub_laplacian(float f0, float fR, float fL,
                                               float fD, float fU,
                                               const PairSums& s,
                                               const Borders& b) {
  const float ch = b.right ? s.sh0 * (fR - f0) : 0.0f;
  const float chl = b.left ? s.shl * (f0 - fL) : 0.0f;
  const float cv = b.down ? s.sv0 * (fD - f0) : 0.0f;
  const float cvu = b.up ? s.svu * (f0 - fU) : 0.0f;
  return ((ch - chl) + cv) - cvu;
}

// One SOR update of a cell: (u, v) from its neighbours' increments (zero
// where there is none); dv uses the new du.  w11, w22 are omega / A11 and
// omega / A22.
__device__ __forceinline__ void sor_update(
    float& u, float& v, float uU, float uL, float uD, float uR, float vU,
    float vL, float vD, float vR, const PairSums& s, float b1, float b2,
    float a12, float w11, float w22, float omega) {
  const float sig_u = -(s.svu * uU + s.shl * uL + s.sv0 * uD + s.sh0 * uR);
  const float sig_v = -(s.svu * vU + s.shl * vL + s.sv0 * vD + s.sh0 * vR);
  const float B1 = b1 - sig_u;
  const float B2 = b2 - sig_v;
  const float un = (1.0f - omega) * u + w11 * (B1 - a12 * v);
  const float vn = (1.0f - omega) * v + w22 * (B2 - a12 * un);
  u = un;
  v = vn;
}

// A pixel on a thread's walk over the field: idx into the planes, its
// frame f, and its row j and column i within the frame.
struct Pixel {
  int idx, f, j, i;
};

// Each pixel idx = first, first + stride, ... < last is visited by exactly
// one thread, the same in every phase; sync() separates the phases that
// read what other threads wrote.  A thread finds its first pixel's frame,
// row and column by division once and walks on by additions: a phase is
// short enough for integer divisions per pixel to show in its time.
//
// CH > 0 fixes the channel count at compile time (the data term's loops
// over the channels unroll, so a pixel's 8 * C derivative loads are in
// flight together and its divisions overlap); CH == 0 takes it from
// n_channels.  The sums run over the channels in the same order either way.
template <int CH, class Planes, class Sync>
__device__ __forceinline__ void refine_loop(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ dIs,
    int h, int w, int n_channels, int inner_iter, int solve_iter, float omega,
    float qa, float hd3, float hg3, Planes pl, float* __restrict__ uu_out,
    float* __restrict__ vv_out, int first, int last, int stride, Sync sync) {
  const int n = h * w;       // pixels of one frame
  const int C = CH > 0 ? CH : n_channels;
  Pixel p0;
  {
    const int r = first / w;  // row of the batch
    p0.idx = first;
    p0.i = first - r * w;
    p0.f = r / h;
    p0.j = r - p0.f * h;
  }
  const int step_i = stride % w, step_r = stride / w;
  const int step_j = step_r % h, step_f = step_r / h;
  auto next = [&](Pixel& p) {
    p.idx += stride;
    p.i += step_i;
    p.j += step_j;
    p.f += step_f;
    if (p.i >= w) {
      p.i -= w;
      p.j += 1;
    }
    if (p.j >= h) {
      p.j -= h;
      p.f += 1;
    }
  };
  // smoothness at pixel idx (row j, column i of its frame), which may be
  // this thread's pixel, its right neighbour or the one below
  auto smooth = [&](int idx, int j, int i) {
    const int iL = idx - (i > 0), iR = idx + (i < w - 1);
    const int jU = idx - (j > 0 ? w : 0), jD = idx + (j < h - 1 ? w : 0);
    return smoothness(wx[iR] + pl.at(kDu, iR), wx[iL] + pl.at(kDu, iL),
                      wx[jD] + pl.at(kDu, jD), wx[jU] + pl.at(kDu, jU),
                      wy[iR] + pl.at(kDv, iR), wy[iL] + pl.at(kDv, iL),
                      wy[jD] + pl.at(kDv, jD), wy[jU] + pl.at(kDv, jU), qa);
  };

  for (Pixel p = p0; p.idx < last; next(p)) {
    pl.put(kDu, p.idx, 0.0f);
    pl.put(kDv, p.idx, 0.0f);
  }
  sync();

  for (int it = 0; it < inner_iter; ++it) {
    // ---- AB: smoothness and its pair sums ----
    for (Pixel p = p0; p.idx < last; next(p)) {
      const int idx = p.idx, j = p.j, i = p.i;
      const float s0 = smooth(idx, j, i);
      pl.at(kSh, idx) =
          (i == w - 1) ? 0.0f : s0 + smooth(idx + 1, j, i + 1);
      pl.put(kSv, idx,
             (j == h - 1) ? 0.0f : s0 + smooth(idx + w, j + 1, i));
    }
    sync();
    // ---- C: data term, sub-Laplacian, diagonal ----
    for (Pixel p = p0; p.idx < last; next(p)) {
      const int idx = p.idx, j = p.j, i = p.i;
      // this pixel's derivative planes: [B][8][C][n] = Ix, Iy, Iz, Ixx,
      // Ixy, Iyy, Ixz, Iyz
      const float* __restrict__ d0 =
          dIs + (p.f * 8 * C) * n + (idx - p.f * n);
      auto dI = [&](int k, int c) { return d0[(k * C + c) * n]; };
      const float u0 = pl.at(kDu, idx), v0 = pl.at(kDv, idx), m = mask[idx];
      const DataTerm d = data_term<CH>(dI, C, u0, v0, m, hd3, hg3);
      const float sh0 = pl.at(kSh, idx), sv0 = pl.at(kSv, idx);
      const float shl = i > 0 ? pl.at(kSh, idx - 1) : 0.0f;
      const float svu = j > 0 ? pl.at(kSv, idx - w) : 0.0f;
      // sub-Laplacian of the base flow; coefficients vanish past the
      // last column / row (s_h, s_v are zero there).  sub_laplacian()'s
      // expression, written on the planes: through the helper the grid
      // route's kernel takes 96 registers a thread at C = 3 where this
      // takes 80, and loses a CTA an SM.
      float lap[2];
      const float* src[2] = {wx, wy};
      for (int k = 0; k < 2; ++k) {
        const float* f = src[k];
        const float ch = (i == w - 1) ? 0.0f : sh0 * (f[idx + 1] - f[idx]);
        const float chl = i > 0 ? shl * (f[idx] - f[idx - 1]) : 0.0f;
        const float cv = (j == h - 1) ? 0.0f : sv0 * (f[idx + w] - f[idx]);
        const float cvu = j > 0 ? svu * (f[idx] - f[idx - w]) : 0.0f;
        lap[k] = ((ch - chl) + cv) - cvu;
      }
      const float sdp = svu + shl + sv0 + sh0;
      // the sweeps need only omega / A11 and omega / A22: divide once here
      pl.at(kW11, idx) = omega / (d.a11 + sdp);
      pl.at(kW22, idx) = omega / (d.a22 + sdp);
      pl.at(kA12, idx) = d.a12;
      pl.at(kB1, idx) = d.b1 + lap[0];
      pl.at(kB2, idx) = d.b2 + lap[1];
    }
    // with no sweep to end in a barrier, the next round's AB would
    // overwrite pair sums that a neighbour's C still reads
    if (solve_iter <= 0) sync();
    // ---- D: red-black SOR (no barrier after C, see the top) ----
    for (int sweep = 0; sweep < 2 * solve_iter; ++sweep) {
      const int want = (sweep & 1) ? 0 : 1;  // odd cells first
      for (Pixel p = p0; p.idx < last; next(p)) {
        const int idx = p.idx, j = p.j, i = p.i;
        if (((i + j) & 1) != want) continue;
        const PairSums s{pl.at(kSh, idx), pl.at(kSv, idx),
                         i > 0 ? pl.at(kSh, idx - 1) : 0.0f,
                         j > 0 ? pl.at(kSv, idx - w) : 0.0f};
        const float uU = j > 0 ? pl.at(kDu, idx - w) : 0.0f;
        const float uL = i > 0 ? pl.at(kDu, idx - 1) : 0.0f;
        const float uD = j < h - 1 ? pl.at(kDu, idx + w) : 0.0f;
        const float uR = i < w - 1 ? pl.at(kDu, idx + 1) : 0.0f;
        const float vU = j > 0 ? pl.at(kDv, idx - w) : 0.0f;
        const float vL = i > 0 ? pl.at(kDv, idx - 1) : 0.0f;
        const float vD = j < h - 1 ? pl.at(kDv, idx + w) : 0.0f;
        const float vR = i < w - 1 ? pl.at(kDv, idx + 1) : 0.0f;
        float u = pl.at(kDu, idx), v = pl.at(kDv, idx);
        sor_update(u, v, uU, uL, uD, uR, vU, vL, vD, vR, s, pl.at(kB1, idx),
                   pl.at(kB2, idx), pl.at(kA12, idx), pl.at(kW11, idx),
                   pl.at(kW22, idx), omega);
        pl.put(kDu, idx, u);
        pl.put(kDv, idx, v);
      }
      sync();
    }
  }
  for (Pixel p = p0; p.idx < last; next(p)) {
    uu_out[p.idx] = wx[p.idx] + pl.at(kDu, p.idx);
    vv_out[p.idx] = wy[p.idx] + pl.at(kDv, p.idx);
  }
}

}  // namespace fot_varref
