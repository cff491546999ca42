// G3: patch-to-dense flow aggregation of one scale.  Replaces the XLA
// fusions of flowonthego_tpu/ops/densify.py densify (_pixel_weights, the
// overlap-add canvas, the clip and the normalisation); the JAX package
// has no Pallas kernel for it.
//
// Each patch pixel carries the weight w = 1 / sum_c max(min_errval, e_c)
// (e_c its squared residual, or the square root of it) and adds (w, w*u,
// w*v) to the one image pixel it covers; each pixel's flow is the
// weighted mean, 0 where no weight landed.  Patch origins are static
// grid midpoints, so with steps-periodic coordinates Y = Yq*steps + pr
// on the canvas, pixel Y gets the patch rows j = Yq - m at patch row
// py = m*steps + pr, m < r = ceil(ps / steps), and likewise along x.
//
// A gather, one thread an output pixel, no atomics: the plain version's
// canvas sums the shifted planes over m, then over q, with zero planes
// where a shift has no patch, so the kernel adds in that order, the
// zeros included (x + 0.0 is not x for x = -0.0; without fast math the
// compiler keeps those adds).  The channel sum of the weight takes
// PyTorch's CUDA reduction order over a last dim of three floats, two
// lanes: (e0 + e2) + e1.  So on the card the kernel equals the plain
// version bit for bit.  The forward-backward merge's accumulator (G5,
// fb_merge.cu) comes in as `add` and is added to the canvas before the
// normalisation, as in the plain version.
//
// Bound: bytes (the per-pixel costs read once, the flow written once;
// each cost value lands on exactly one pixel).  Neighbouring threads take
// neighbouring pixels, which read neighbouring patch pixels.

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_weight.cuh"

namespace {

__global__ void glue_densify_kernel(
    const float* __restrict__ p, const float* __restrict__ cost,
    const float* __restrict__ add, int h, int w, int C, int ps, int steps,
    int n_h, int n_w, int off_y, int off_x, float min_errval, int use_sqrt,
    int64_t n, float* __restrict__ out) {
  const int r = (ps + steps - 1) / steps;
  const int Yp = (n_h + r - 1) * steps;     // the canvas
  const int Xp = (n_w + r - 1) * steps;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = idx / w;
    const int x = (int)(idx - row * w);
    const int b = (int)(row / h);
    const int y = (int)(row - (int64_t)b * h);
    // canvas (0, 0) sits at image (off - ps/2) on each axis
    const int Y = y - (off_y - ps / 2);
    const int X = x - (off_x - ps / 2);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    if (Y >= 0 && Y < Yp && X >= 0 && X < Xp) {
      const int Yq = Y / steps, pr = Y - Yq * steps;
      const int Xq = X / steps, qc = X - Xq * steps;
      for (int q = 0; q < r; ++q) {
        const int i = Xq - q;
        const int px = q * steps + qc;
        float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;   // the sum over m
        if (i >= 0 && i < n_w) {
          for (int m = 0; m < r; ++m) {
            const int j = Yq - m;
            const int py = m * steps + pr;
            float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
            if (j >= 0 && j < n_h && py < ps && px < ps) {
              const int64_t patch = ((int64_t)b * n_h + j) * n_w + i;
              const float wt = pixel_weight(
                  cost + ((patch * ps + py) * ps + px) * C, C, min_errval,
                  use_sqrt);
              c0 = wt;
              c1 = wt * p[patch * 2];
              c2 = wt * p[patch * 2 + 1];
            }
            if (m == 0) {
              t0 = c0; t1 = c1; t2 = c2;
            } else {
              t0 = t0 + c0; t1 = t1 + c1; t2 = t2 + c2;
            }
          }
        }
        if (q == 0) {
          a0 = t0; a1 = t1; a2 = t2;
        } else {
          a0 = a0 + t0; a1 = a1 + t1; a2 = a2 + t2;
        }
      }
    }
    if (add != nullptr) {
      a0 = a0 + add[idx * 3];
      a1 = a1 + add[idx * 3 + 1];
      a2 = a2 + add[idx * 3 + 2];
    }
    out[idx * 2] = a0 > 0.0f ? a1 / a0 : 0.0f;
    out[idx * 2 + 1] = a0 > 0.0f ? a2 / a0 : 0.0f;
  }
}

}  // namespace

// p [B, n_h, n_w, 2], cost [B, n_h, n_w, ps, ps, C] float32, contiguous;
// add: null or [B, h, w, 3] (weight, w*u, w*v) added before the
// normalisation; out [B, h, w, 2].  (off_y, off_x): the grid's offsets.
extern "C" int fot_densify(const void* p, const void* cost, const void* add,
                           int B, int h, int w, int C, int ps, int steps,
                           int n_h, int n_w, int off_y, int off_x,
                           float min_errval, int use_sqrt, void* out,
                           void* stream) {
  const int64_t n = (int64_t)B * h * w;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  glue_densify_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)p, (const float*)cost, (const float*)add, h, w, C, ps,
      steps, n_h, n_w, off_y, off_x, min_errval, use_sqrt, n, (float*)out);
  return (int)cudaGetLastError();
}
