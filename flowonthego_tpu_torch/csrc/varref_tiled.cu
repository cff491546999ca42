// K4: the variational-refinement inner loop on fields too large for one
// CTA, spread over the whole card.  Replaces the Pallas kernel
// flowonthego_tpu/ops/pallas/varref_fused.py (variational_refine_tiled ->
// _tiled_kernel).  It runs the same loop as K3, fot_varref::refine_loop
// (varref_common.cuh), so it computes the same function pixel for pixel.
//
// Bound: bytes, then barriers.  At 448x1024 (458,752 px, C = 3) the
// data-term phase reads ~27 planes (~50 MB) and every phase is one pass
// over the field; each round has 3 + 2 * solve_iter dependent phases.
//
// Design: one cooperative launch with as many CTAs as can be resident at
// once (occupancy x SM count, capped at one pixel per thread).  The CTAs
// walk the field grid-stride, and a grid-wide barrier (grid.sync(), which
// also orders global memory) stands wherever K3 has __syncthreads().
// The TPU kernel's alternative, one tile per program with a recompute
// halo of R = inner_iter * (3 + 2 * solve_iter) pixels, would cost
// (S + 2R)(T + 2R) / (S T) in extra work: tiles that fit 227 KB of shared
// memory are ~40 px wide, and R = 27 at op-3 scale 2, so ~5x.  The grid
// barrier costs a few microseconds instead, ~10 per round.  A launch that
// the card refuses (a grid that cannot be resident) returns its error; it
// is never split or sent to K3.
//
// Batch: one launch walks all B*h*w pixels of the batch; refine_loop
// derives each pixel's frame, row and column from its index, so border
// rules and red-black parity stay per frame.  A launch the card refuses is
// never split per frame either.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "varref_common.cuh"

namespace {

constexpr int kThreads = 256;

struct GridSync {
  __device__ void operator()() const { cooperative_groups::this_grid().sync(); }
};

__global__ void __launch_bounds__(kThreads) varref_tiled_kernel(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ dIs,
    int n_frames, int h, int w, int C, int inner_iter, int solve_iter,
    float omega, float qa, float hd3, float hg3, float* scratch,
    float* __restrict__ uu_out, float* __restrict__ vv_out) {
  fot_varref::refine_loop(wx, wy, mask, dIs, n_frames, h, w, C, inner_iter,
                          solve_iter,
                          omega, qa, hd3, hg3, scratch, uu_out, vv_out,
                          blockIdx.x * blockDim.x + threadIdx.x,
                          gridDim.x * blockDim.x, GridSync());
}

}  // namespace

extern "C" int fot_varref_tiled(const void* wx, const void* wy,
                                const void* mask, const void* dIs, int B,
                                int h, int w, int C, int inner_iter,
                                int solve_iter, float omega, float qa,
                                float hd3, float hg3, void* scratch, void* uu,
                                void* vv, void* stream) {
  const int n = B * h * w;
  if (n == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, varref_tiled_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  int blocks = per_sm * sms;
  const int needed = (n + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;

  const float* wx_f = (const float*)wx;
  const float* wy_f = (const float*)wy;
  const float* mask_f = (const float*)mask;
  const float* dIs_f = (const float*)dIs;
  float* scratch_f = (float*)scratch;
  float* uu_f = (float*)uu;
  float* vv_f = (float*)vv;
  void* args[] = {&wx_f,  &wy_f,       &mask_f,     &dIs_f, &B,
                  &h,     &w,          &C,          &inner_iter,
                  &solve_iter, &omega, &qa,         &hd3,   &hg3,
                  &scratch_f,  &uu_f,  &vv_f};
  // blocks == 0 (no CTA fits on an SM) is refused here as an invalid
  // configuration.
  err = cudaLaunchCooperativeKernel((const void*)varref_tiled_kernel,
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises with this code
    return (int)err;
  }
  return (int)cudaGetLastError();
}
