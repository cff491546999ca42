// K3: the variational-refinement inner loop, fused into one kernel.
// Replaces the Pallas kernel flowonthego_tpu/ops/pallas/varref_fused.py
// (variational_refine_fused -> _kernel -> _refine_block).  It computes
// what fot_varref::refine_loop (varref_common.cuh, K4's loop) computes,
// from the same per-pixel expressions, so the two agree bit for bit.
//
// Bound: latency.  A field at or below the resolver's threshold
// (ops/variational.py) is a few hundred pixels, and the loop is a chain of
// 1 + rounds * (1 + 2 * solve_iter) short phases (43 at level 5 with three
// SOR iterations), each reading what its neighbours wrote in the one
// before.  What a launch costs is what a phase costs, times 43: a barrier,
// a trip to wherever the planes live, and the instructions one SM must
// issue for the phase.  So the design is the TPU kernel's, one block with
// everything resident, taken one step further:
//   * one CTA a field, one thread a pixel (whole warps, at most 1,024
//     pixels), __syncthreads() between phases;
//   * what only its own pixel reads lives in the thread's registers for the
//     whole loop: its place in the frame and which neighbours exist, the
//     base flow at the pixel and at its four neighbours, the mask, the
//     2x2 system (w11, w22, a12, b1, b2), the four pair sums and the
//     increment (du, dv);
//   * what a neighbour reads lives in the CTA's shared memory: du, dv, the
//     smoothness s (written once a round, where refine_loop recomputes it
//     for the right and lower neighbour to save a barrier that costs a
//     cluster or the grid far more than it costs one CTA) and the base
//     flow; and so do the 8 C derivative planes, staged once at the start
//     with all of a thread's loads in flight, which the data term reads in
//     every round.  That is 5 + 8 C planes: 29 * 4 B * 448 px = 51 KB at C
//     = 3, well inside a CTA's 227 KB at 1,024 px;
//   * a half-sweep is then eight shared-memory loads, the update and two
//     stores; nothing leaves the SM between the stage-in and the last
//     store, and the wrapper allocates no scratch;
//   * the kernel is compiled twice, for CTAs of up to 512 and up to 1,024
//     threads: a thread holds ~100 values at C = 3, and a kernel that must
//     be able to run 1,024 threads gets 64 registers a thread and spills
//     (0.033 against 0.025 ms at 14x32 on an H100).  The paths' coarsest
//     fields (448 and 510 px) take the first.
// With the work planes in device memory (the form before) every phase
// paid a round trip to the L2, and the data term read its 3 + 8 C inputs
// from there in every round.
//
// The wrapper plans threads and shared bytes
// (ops/cuda/varref_fused.fused_plan); a field of more than 1,024 pixels, or
// one whose planes do not fit, is refused here with an error, never sent
// to K4.
//
// Batch: one CTA per frame (gridDim.x = B); CTA b stages frame b's planes
// and runs the loop on them, so each frame is computed as a single-frame
// launch would compute it.

#include <cstdint>
#include <cuda_runtime.h>

#include "varref_common.cuh"

namespace {

using namespace fot_varref;

constexpr int kSharedPlanes = 5;   // du, dv, s, wx, wy (+ 8 * C of dIs)
constexpr int kMaxPixels = 1024;   // one thread a pixel

// Shared memory: [du][dv][s][wx][wy][8 * C derivative planes], n floats
// each.  Threads past the last pixel only keep the barriers.  MAX_THREADS:
// the most threads a launch of this instantiation has.
template <int CH, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS) varref_kernel(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ dIs, int h,
    int w, int n_channels, int inner_iter, int solve_iter, float omega,
    float qa, float hd3, float hg3, float* __restrict__ uu_out,
    float* __restrict__ vv_out) {
  extern __shared__ float planes[];
  const int C = CH > 0 ? CH : n_channels;
  const int n = h * w;
  const int64_t f = blockIdx.x;
  float* s_du = planes;
  float* s_dv = s_du + n;
  float* s_s = s_dv + n;
  float* s_wx = s_s + n;
  float* s_wy = s_wx + n;
  float* s_dIs = s_wy + n;

  const int idx = threadIdx.x;
  const bool active = idx < n;
  const int j = idx / w, i = idx - j * w;
  const Borders b{i > 0, i < w - 1, j > 0, j < h - 1};
  const bool odd = (i + j) & 1;
  // the four neighbours, each the pixel itself at a border
  const int iL = idx - b.left, iR = idx + b.right;
  const int jU = idx - (b.up ? w : 0), jD = idx + (b.down ? w : 0);

  // ---- stage this frame's planes; a thread's loads are all in flight
  // before its first store ----
  float wx0 = 0.0f, wy0 = 0.0f, m = 0.0f;
  if (active) {
    const float* g_dIs = dIs + f * 8 * C * n + idx;
    wx0 = wx[f * n + idx];
    wy0 = wy[f * n + idx];
    m = mask[f * n + idx];
    if (CH > 0) {
      constexpr int K = 8 * (CH > 0 ? CH : 1);
      float d[K];
#pragma unroll
      for (int k = 0; k < K; ++k) d[k] = g_dIs[k * n];
#pragma unroll
      for (int k = 0; k < K; ++k) s_dIs[k * n + idx] = d[k];
    } else {
      for (int k = 0; k < 8 * C; ++k) s_dIs[k * n + idx] = g_dIs[k * n];
    }
    s_wx[idx] = wx0;
    s_wy[idx] = wy0;
    s_du[idx] = 0.0f;
    s_dv[idx] = 0.0f;
  }
  __syncthreads();

  float wxR = 0.0f, wxL = 0.0f, wxD = 0.0f, wxU = 0.0f;
  float wyR = 0.0f, wyL = 0.0f, wyD = 0.0f, wyU = 0.0f;
  if (active) {
    wxR = s_wx[iR], wxL = s_wx[iL], wxD = s_wx[jD], wxU = s_wx[jU];
    wyR = s_wy[iR], wyL = s_wy[iL], wyD = s_wy[jD], wyU = s_wy[jU];
  }
  auto dI = [&](int k, int c) { return s_dIs[(k * C + c) * n + idx]; };
  float u = 0.0f, v = 0.0f;   // this pixel's du, dv
  float w11 = 0.0f, w22 = 0.0f, a12 = 0.0f, b1 = 0.0f, b2 = 0.0f;
  PairSums ps{0.0f, 0.0f, 0.0f, 0.0f};

  for (int it = 0; it < inner_iter; ++it) {
    // ---- A: smoothness ----
    float s0 = 0.0f;
    if (active) {
      s0 = smoothness(wxR + s_du[iR], wxL + s_du[iL], wxD + s_du[jD],
                      wxU + s_du[jU], wyR + s_dv[iR], wyL + s_dv[iL],
                      wyD + s_dv[jD], wyU + s_dv[jU], qa);
      s_s[idx] = s0;
    }
    __syncthreads();
    // ---- B, C: pair sums, data term, sub-Laplacian, diagonal ----
    if (active) {
      ps.sh0 = b.right ? s0 + s_s[idx + 1] : 0.0f;
      ps.sv0 = b.down ? s0 + s_s[idx + w] : 0.0f;
      ps.shl = b.left ? s_s[idx - 1] + s0 : 0.0f;
      ps.svu = b.up ? s_s[idx - w] + s0 : 0.0f;
      const DataTerm d = data_term<CH>(dI, C, u, v, m, hd3, hg3);
      const float lap_u = sub_laplacian(wx0, wxR, wxL, wxD, wxU, ps, b);
      const float lap_v = sub_laplacian(wy0, wyR, wyL, wyD, wyU, ps, b);
      const float sdp = ps.svu + ps.shl + ps.sv0 + ps.sh0;
      w11 = omega / (d.a11 + sdp);
      w22 = omega / (d.a22 + sdp);
      a12 = d.a12;
      b1 = d.b1 + lap_u;
      b2 = d.b2 + lap_v;
    }
    // with no sweep to end in a barrier, the next round's A would
    // overwrite s while a neighbour still reads it
    if (solve_iter <= 0) __syncthreads();
    // ---- D: red-black SOR, odd cells first.  No barrier stands between C
    // and the first half-sweep: C writes nothing a neighbour reads, and the
    // half-sweep reads only the other colour's du, dv, which nothing has
    // touched since the last barrier. ----
    for (int sweep = 0; sweep < 2 * solve_iter; ++sweep) {
      const bool want_odd = !(sweep & 1);
      if (active && odd == want_odd) {
        const float uU = b.up ? s_du[idx - w] : 0.0f;
        const float uL = b.left ? s_du[idx - 1] : 0.0f;
        const float uD = b.down ? s_du[idx + w] : 0.0f;
        const float uR = b.right ? s_du[idx + 1] : 0.0f;
        const float vU = b.up ? s_dv[idx - w] : 0.0f;
        const float vL = b.left ? s_dv[idx - 1] : 0.0f;
        const float vD = b.down ? s_dv[idx + w] : 0.0f;
        const float vR = b.right ? s_dv[idx + 1] : 0.0f;
        sor_update(u, v, uU, uL, uD, uR, vU, vL, vD, vR, ps, b1, b2, a12, w11,
                   w22, omega);
        s_du[idx] = u;
        s_dv[idx] = v;
      }
      __syncthreads();
    }
  }
  if (active) {
    uu_out[f * n + idx] = wx0 + u;
    vv_out[f * n + idx] = wy0 + v;
  }
}

}  // namespace

// B CTAs of `threads` threads (whole warps, at least a thread a pixel, at
// most 1,024), each with (5 + 8 * C) * h * w floats of dynamic shared
// memory.
extern "C" int fot_varref_fused(const void* wx, const void* wy,
                                const void* mask, const void* dIs, int B,
                                int h, int w, int C, int inner_iter,
                                int solve_iter, float omega, float qa,
                                float hd3, float hg3, int threads, void* uu,
                                void* vv, void* stream) {
  if (B * h * w == 0) return 0;
  if (threads < h * w || threads > kMaxPixels || threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  const size_t shared =
      (size_t)(kSharedPlanes + 8 * C) * h * w * sizeof(float);
  // up to 512 threads: the instantiation that may use 128 registers a
  // thread
  const bool small = threads <= kMaxPixels / 2;
  auto kernel = C == 3   ? (small ? varref_kernel<3, kMaxPixels / 2>
                                  : varref_kernel<3, kMaxPixels>)
                : C == 1 ? (small ? varref_kernel<1, kMaxPixels / 2>
                                  : varref_kernel<1, kMaxPixels>)
                         : varref_kernel<0, kMaxPixels>;
  // Above 48 KB a CTA's dynamic shared memory is opt-in; more than the
  // card has is refused here.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises with this code
    return (int)err;
  }
  kernel<<<B, threads, shared, (cudaStream_t)stream>>>(
      (const float*)wx, (const float*)wy, (const float*)mask,
      (const float*)dIs, h, w, C, inner_iter, solve_iter, omega, qa, hd3, hg3,
      (float*)uu, (float*)vv);
  return (int)cudaGetLastError();
}
