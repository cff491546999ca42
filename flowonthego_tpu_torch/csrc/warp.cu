// K5: bilinear backward warp with a clamp on each tap, plus the
// in-bounds mask.  Replaces the Pallas kernel
// flowonthego_tpu/ops/pallas/warp.py (warp_image_banded -> _kernel).
//
// Bound: bytes.  Per pixel it reads 8 B of flow and four taps of C floats
// (neighbouring pixels read neighbouring taps, so the taps mostly hit L1
// and L2) and writes (C + 1) * 4 B.  One thread per pixel, consecutive
// threads on consecutive pixels, does the four taps for all C channels
// and writes the mask.  The TPU kernel's (2B+2)^2 masked stencil existed
// only because the TPU has no gather; a direct load needs no |flow| bound.
//
// The arithmetic is the plain version's (ops/variational.warp_image),
// operation for operation: xx = i + wx, x0 = floor(xx), dx = xx - x0,
// taps clamped to the image, and
//   a*(1-dx)*(1-dy) + b*dx*(1-dy) + c*(1-dx)*dy + d*dx*dy
// evaluated left to right.  With --fmad=false nothing is contracted, so
// the kernel is bit-exact with the plain version.
//
// Batch: one thread per pixel over B*h*w; frame f = idx / (h*w), and the
// taps clamp to frame f's image.  The source may be a strided view (a crop
// of padded pyramid levels): row r of frame f starts at src + f *
// frame_stride + r * row_stride, pixels are C floats apart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void warp_kernel(const float* __restrict__ src,
                            int64_t frame_stride, int64_t row_stride,
                            const float* __restrict__ wx,
                            const float* __restrict__ wy, int n_frames, int h,
                            int w, int C, float* __restrict__ out,
                            float* __restrict__ mask) {
  const int n = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_frames * n) {
    const int f = idx / n, q = idx - f * n;
    const int j = q / w, i = q - j * w;
    src += f * frame_stride;
    const float xx = (float)i + wx[idx];
    const float yy = (float)j + wy[idx];
    const float x0 = floorf(xx);
    const float y0 = floorf(yy);
    const float dx = xx - x0;
    const float dy = yy - y0;
    mask[idx] = (xx >= 0.0f && xx < (float)w && yy >= 0.0f && yy < (float)h)
                    ? 1.0f : 0.0f;
    const int x1 = (int)fminf(fmaxf(x0, 0.0f), (float)(w - 1));
    const int x2 = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)(w - 1));
    const int y1 = (int)fminf(fmaxf(y0, 0.0f), (float)(h - 1));
    const int y2 = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)(h - 1));
    const float omdx = 1.0f - dx;
    const float omdy = 1.0f - dy;
    const float* r1 = src + y1 * row_stride;
    const float* r2 = src + y2 * row_stride;
    float* o = out + (int64_t)idx * C;
    for (int c = 0; c < C; ++c) {
      const float a = r1[x1 * C + c], b = r1[x2 * C + c];
      const float cc = r2[x1 * C + c], d = r2[x2 * C + c];
      o[c] = a * omdx * omdy + b * dx * omdy + cc * omdx * dy + d * dx * dy;
    }
  }
}

}  // namespace

extern "C" int fot_warp(const void* src, int64_t frame_stride,
                        int64_t row_stride, const void* wx, const void* wy,
                        int B, int h, int w, int C, void* out, void* mask,
                        void* stream) {
  const int n = B * h * w;
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, frame_stride, row_stride, (const float*)wx,
      (const float*)wy, B, h, w, C, (float*)out, (float*)mask);
  return (int)cudaGetLastError();
}
