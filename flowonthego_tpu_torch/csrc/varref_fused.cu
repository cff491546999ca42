// K3: the variational-refinement inner loop, fused into one kernel.
// Replaces the Pallas kernel flowonthego_tpu/ops/pallas/varref_fused.py
// (variational_refine_fused -> _kernel -> _refine_block).  The loop
// itself is fot_varref::refine_loop (varref_common.cuh), shared with K4.
//
// Bound: latency.  A field at or below the resolver's threshold
// (ops/variational.py) is small, and a round is ~9 dependent phases, so
// the work is a chain of small stencils.  One CTA of 1024 threads walks
// the field grid-stride; the 9 work planes live in device memory
// (L2-resident) because the TPU's one-block design — ~34 planes resident
// at once — does not fit 227 KB of shared memory.  __syncthreads()
// separates phases and half-sweeps; it also orders this block's
// global-memory writes before the reads that follow.  Larger fields go to
// K4, which spreads the same loop over a thread-block cluster or the
// whole card.
//
// Batch: one CTA per frame (gridDim.x = B); CTA b runs the loop on frame
// b's planes and its own 9 scratch planes, so each frame is computed as
// a single-frame launch would compute it.

#include <cstdint>
#include <cuda_runtime.h>

#include "varref_common.cuh"

namespace {

struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

template <int CH>
__global__ void __launch_bounds__(1024) varref_kernel(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ dIs, int h,
    int w, int C, int inner_iter, int solve_iter, float omega, float qa,
    float hd3, float hg3, float* scratch, float* __restrict__ uu_out,
    float* __restrict__ vv_out) {
  const int64_t n = (int64_t)h * w, f = blockIdx.x;
  fot_varref::refine_loop<CH>(
      wx + f * n, wy + f * n, mask + f * n, dIs + f * 8 * C * n, h, w, C,
      inner_iter, solve_iter, omega, qa, hd3, hg3,
      fot_varref::GlobalPlanes{scratch + f * fot_varref::kScratchPlanes * n,
                               (int)n},
      uu_out + f * n, vv_out + f * n, (int)threadIdx.x, (int)n,
      (int)blockDim.x, BlockSync());
}

}  // namespace

extern "C" int fot_varref_fused(const void* wx, const void* wy,
                                const void* mask, const void* dIs, int B,
                                int h, int w, int C, int inner_iter,
                                int solve_iter, float omega, float qa,
                                float hd3, float hg3, void* scratch, void* uu,
                                void* vv, void* stream) {
  if (B * h * w == 0) return 0;
  auto kernel = C == 3 ? varref_kernel<3>
                : C == 1 ? varref_kernel<1> : varref_kernel<0>;
  kernel<<<B, 1024, 0, (cudaStream_t)stream>>>(
      (const float*)wx, (const float*)wy, (const float*)mask,
      (const float*)dIs, h, w, C, inner_iter, solve_iter, omega, qa, hd3, hg3,
      (float*)scratch, (float*)uu, (float*)vv);
  return (int)cudaGetLastError();
}
