// The variational-refinement inner loop, shared by K3 (varref_fused.cu,
// one CTA) and K4 (varref_tiled.cu, the whole card).  Both kernels run
// refine_loop below; they differ only in how the threads stride over the
// field and in the barrier between phases, so every pixel is computed
// with the same arithmetic in both.
//
// Per round (inner_iter = level + 1 rounds):
//   A  smoothness s = qa * rsqrt(|grad uu|^2 + |grad vv|^2 + eps)
//      (3-tap flow derivative, replicate border)
//   B  pair sums s_h = s + s[i+1] (last column 0), s_v = s + s[j+1] (last row 0)
//   C  robust colour + gradient data term -> per-pixel 2x2 system; the
//      sub-Laplacian of the base flow (wx, wy) into b1, b2; A11/A22 with
//      the diffusivity sum
//   D  solve_iter red-black SOR sweeps (odd cells first; dv uses the new du)
// then uu = wx + du, vv = wy + dv.
//
// A batch of B frames: every plane is [B][h][w] and dIs is [B][8][C][h][w].
// The loop walks idx over B*h*w; frame f = idx / (h*w), and the pixel's
// row and column within its frame set every border rule, so row h-1 of
// frame f never reads frame f+1 and the red-black parity is (i + j) of
// the frame.  K3 runs it with B = 1 per CTA, K4 once over the batch.
//
// The 10 work planes live in device memory.  They are written and read
// by other threads (other CTAs, for K4) within the launch, so they are
// plain pointers: a const __restrict__ one could be read through the
// non-coherent cache.  The barrier orders those writes before the reads
// that follow.  Red-black cells of one colour read only neighbours of the
// other colour, so each half-sweep updates in place.

#pragma once

#include <cuda_runtime.h>

namespace fot_varref {

// The JAX package's constants, computed in double and rounded once.
constexpr float kDataNorm = (float)(0.1 * 0.1);
constexpr float kEpsColor = (float)(0.001 * 0.001);
constexpr float kEpsGrad = (float)(0.001 * 0.001);
constexpr float kEpsSmooth = (float)(0.001 * 0.001);
constexpr int kScratchPlanes = 10;  // s, s_h, s_v, A11, A22, a12, b1, b2, du, dv

// Each pixel idx in [0, B*h*w) is visited by exactly one thread: idx =
// first, first + stride, ...; sync() separates phases and half-sweeps.
template <class Sync>
__device__ __forceinline__ void refine_loop(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ dIs,
    int n_frames, int h, int w, int C, int inner_iter, int solve_iter,
    float omega, float qa, float hd3, float hg3, float* scratch,
    float* __restrict__ uu_out, float* __restrict__ vv_out, int first,
    int stride, Sync sync) {
  const int n = h * w;       // pixels of one frame
  const int N = n_frames * n;
  float* s = scratch;
  float* sh = s + N;
  float* sv = sh + N;
  float* A11 = sv + N;
  float* A22 = A11 + N;
  float* a12 = A22 + N;
  float* b1 = a12 + N;
  float* b2 = b1 + N;
  float* du = b2 + N;
  float* dv = du + N;
  // dIs planes: [B][8][C][n] = Ix, Iy, Iz, Ixx, Ixy, Iyy, Ixz, Iyz
  auto dI = [&](int k, int c, int idx) {
    const int f = idx / n;
    return dIs[((f * 8 + k) * C + c) * n + (idx - f * n)];
  };
  // (row, column) of idx within its frame
  auto rc = [&](int idx, int& j, int& i) {
    const int q = idx % n;
    j = q / w;
    i = q - j * w;
  };

  for (int idx = first; idx < N; idx += stride) {
    du[idx] = 0.0f;
    dv[idx] = 0.0f;
  }
  sync();

  for (int it = 0; it < inner_iter; ++it) {
    // ---- A: smoothness ----
    for (int idx = first; idx < N; idx += stride) {
      int j, i;
      rc(idx, j, i);
      const int iL = idx - (i > 0), iR = idx + (i < w - 1);
      const int jU = idx - (j > 0 ? w : 0), jD = idx + (j < h - 1 ? w : 0);
      const float ux = 0.5f * ((wx[iR] + du[iR]) - (wx[iL] + du[iL]));
      const float uy = 0.5f * ((wx[jD] + du[jD]) - (wx[jU] + du[jU]));
      const float vx = 0.5f * ((wy[iR] + dv[iR]) - (wy[iL] + dv[iL]));
      const float vy = 0.5f * ((wy[jD] + dv[jD]) - (wy[jU] + dv[jU]));
      s[idx] = qa * rsqrtf(ux * ux + uy * uy + vx * vx + vy * vy + kEpsSmooth);
    }
    sync();
    // ---- B: pair sums ----
    for (int idx = first; idx < N; idx += stride) {
      int j, i;
      rc(idx, j, i);
      sh[idx] = (i == w - 1) ? 0.0f : s[idx] + s[idx + 1];
      sv[idx] = (j == h - 1) ? 0.0f : s[idx] + s[idx + w];
    }
    sync();
    // ---- C: data term, sub-Laplacian, diagonal ----
    for (int idx = first; idx < N; idx += stride) {
      int j, i;
      rc(idx, j, i);
      const float u0 = du[idx], v0 = dv[idx], m = mask[idx];
      // colour constancy
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float Ix = dI(0, c, idx), Iy = dI(1, c, idx), Iz = dI(2, c, idx);
        const float r = Iz + Ix * u0 + Iy * v0;
        acc += r * r / (Ix * Ix + Iy * Iy + kDataNorm);
      }
      float t = m * hd3 * rsqrtf(acc + kEpsColor);
      float x11 = 0.0f, x12 = 0.0f, x22 = 0.0f, y1 = 0.0f, y2 = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float Ix = dI(0, c, idx), Iy = dI(1, c, idx), Iz = dI(2, c, idx);
        const float tc = t / (Ix * Ix + Iy * Iy + kDataNorm);
        x11 += tc * Ix * Ix;
        x12 += tc * Ix * Iy;
        x22 += tc * Iy * Iy;
        y1 += tc * Iz * Ix;
        y2 += tc * Iz * Iy;
      }
      // gradient constancy
      acc = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float Ixx = dI(3, c, idx), Ixy = dI(4, c, idx), Iyy = dI(5, c, idx);
        const float Ixz = dI(6, c, idx), Iyz = dI(7, c, idx);
        const float n1 = Ixx * Ixx + Ixy * Ixy + kDataNorm;
        const float n2 = Iyy * Iyy + Ixy * Ixy + kDataNorm;
        const float r1 = Ixz + Ixx * u0 + Ixy * v0;
        const float r2 = Iyz + Ixy * u0 + Iyy * v0;
        acc += r1 * r1 / n1 + r2 * r2 / n2;
      }
      t = m * hg3 * rsqrtf(acc + kEpsGrad);
      float g11 = 0.0f, g12 = 0.0f, g22 = 0.0f, z1 = 0.0f, z2 = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float Ixx = dI(3, c, idx), Ixy = dI(4, c, idx), Iyy = dI(5, c, idx);
        const float Ixz = dI(6, c, idx), Iyz = dI(7, c, idx);
        const float t1 = t / (Ixx * Ixx + Ixy * Ixy + kDataNorm);
        const float t2 = t / (Iyy * Iyy + Ixy * Ixy + kDataNorm);
        g11 += t1 * Ixx * Ixx + t2 * Ixy * Ixy;
        g12 += t1 * Ixx * Ixy + t2 * Ixy * Iyy;
        g22 += t2 * Iyy * Iyy + t1 * Ixy * Ixy;
        z1 += t1 * Ixx * Ixz + t2 * Ixy * Iyz;
        z2 += t2 * Iyy * Iyz + t1 * Ixy * Ixz;
      }
      const float a11 = x11 + g11, a22 = x22 + g22;
      const float sh0 = sh[idx], sv0 = sv[idx];
      const float shl = i > 0 ? sh[idx - 1] : 0.0f;
      const float svu = j > 0 ? sv[idx - w] : 0.0f;
      // sub-Laplacian of the base flow; coefficients vanish past the
      // last column / row (s_h, s_v are zero there)
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
      A11[idx] = a11 + sdp;
      A22[idx] = a22 + sdp;
      a12[idx] = x12 + g12;
      b1[idx] = (-y1 - z1) + lap[0];
      b2[idx] = (-y2 - z2) + lap[1];
    }
    sync();
    // ---- D: red-black SOR ----
    for (int sweep = 0; sweep < 2 * solve_iter; ++sweep) {
      const int want = (sweep & 1) ? 0 : 1;  // odd cells first
      for (int idx = first; idx < N; idx += stride) {
        int j, i;
        rc(idx, j, i);
        if (((i + j) & 1) != want) continue;
        const float sh0 = sh[idx], sv0 = sv[idx];
        const float shl = i > 0 ? sh[idx - 1] : 0.0f;
        const float svu = j > 0 ? sv[idx - w] : 0.0f;
        const float uU = j > 0 ? du[idx - w] : 0.0f;
        const float uL = i > 0 ? du[idx - 1] : 0.0f;
        const float uD = j < h - 1 ? du[idx + w] : 0.0f;
        const float uR = i < w - 1 ? du[idx + 1] : 0.0f;
        const float vU = j > 0 ? dv[idx - w] : 0.0f;
        const float vL = i > 0 ? dv[idx - 1] : 0.0f;
        const float vD = j < h - 1 ? dv[idx + w] : 0.0f;
        const float vR = i < w - 1 ? dv[idx + 1] : 0.0f;
        const float sig_u = -(svu * uU + shl * uL + sv0 * uD + sh0 * uR);
        const float sig_v = -(svu * vU + shl * vL + sv0 * vD + sh0 * vR);
        const float B1 = b1[idx] - sig_u;
        const float B2 = b2[idx] - sig_v;
        const float u = du[idx], v = dv[idx], c12 = a12[idx];
        const float un = (1.0f - omega) * u + omega / A11[idx] * (B1 - c12 * v);
        const float vn = (1.0f - omega) * v + omega / A22[idx] * (B2 - c12 * un);
        du[idx] = un;
        dv[idx] = vn;
      }
      sync();
    }
  }
  for (int idx = first; idx < N; idx += stride) {
    uu_out[idx] = wx[idx] + du[idx];
    vv_out[idx] = wy[idx] + dv[idx];
  }
}

}  // namespace fot_varref
