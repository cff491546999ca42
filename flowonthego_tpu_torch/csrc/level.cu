// G1: one pyramid level's borders and gradients.  Replaces the XLA fusion
// of flowonthego_tpu/ops/pyramid.py build_pyramid (its pad_replicate,
// central_diff and pad_constant on a level); the JAX package has no
// Pallas kernel for it.
//
// From a level [B, h, w, C] (K1's output) it writes the padded level's
// three tensors [B, h + 2p, w + 2p, C]: the image replicate-padded by p,
// and the central differences
//   gx[y, x] = I[y, min(x + 1, w - 1)] - I[y, max(x - 1, 0)]  (gy likewise)
// inside, zero in the p-wide border.  That is one subtraction an output,
// so the kernel equals the plain version bit for bit.
//
// Bound: bytes (one read of the level, three padded writes).  One thread
// per output float, consecutive threads on consecutive floats of a padded
// row, so every warp's stores are coalesced and its reads of the level
// (each float read by at most five outputs) hit L1 and L2.  The plain
// version takes ~22 PyTorch kernels a level and frame (two index_select
// pads, two more for the differences' borders, two subtractions, two
// constant pads); this is one launch for the batch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void glue_level_kernel(const float* __restrict__ cur, int h, int w,
                                  int C, int pad, int64_t n,
                                  float* __restrict__ image,
                                  float* __restrict__ gx,
                                  float* __restrict__ gy) {
  const int Hp = h + 2 * pad;
  const int64_t row = (int64_t)(w + 2 * pad) * C;   // floats of a padded row
  const int64_t frame = (int64_t)h * w * C;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = idx / row;              // padded row over the batch
    const int k = (int)(idx - r * row);       // float within that row
    const int b = (int)(r / Hp);
    const int y = (int)(r - (int64_t)b * Hp) - pad;
    const int px = k / C;
    const int c = k - px * C;
    const int x = px - pad;
    const float* f = cur + b * frame + c;
    const int yc = min(max(y, 0), h - 1);
    const int xc = min(max(x, 0), w - 1);
    image[idx] = f[((int64_t)yc * w + xc) * C];
    float dx = 0.0f;
    float dy = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float* line = f + (int64_t)y * w * C;
      dx = line[min(x + 1, w - 1) * C] - line[max(x - 1, 0) * C];
      dy = f[((int64_t)min(y + 1, h - 1) * w + x) * C] -
           f[((int64_t)max(y - 1, 0) * w + x) * C];
    }
    gx[idx] = dx;
    gy[idx] = dy;
  }
}

}  // namespace

// cur [B, h, w, C] float32, contiguous; image, gx, gy [B, h + 2 pad,
// w + 2 pad, C] float32, contiguous, written whole.
extern "C" int fot_level(const void* cur, int B, int h, int w, int C, int pad,
                         void* image, void* gx, void* gy, void* stream) {
  const int64_t n = (int64_t)B * (h + 2 * pad) * (w + 2 * pad) * C;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  glue_level_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)cur, h, w, C, pad, n, (float*)image, (float*)gx,
      (float*)gy);
  return (int)cudaGetLastError();
}
