// K5: bilinear backward warp with a clamp on each tap, plus the
// in-bounds mask.  Replaces the Pallas kernel
// flowonthego_tpu/ops/pallas/warp.py (warp_image_banded -> _kernel).
//
// Bound: bytes.  Per pixel it reads 8 B of flow and four taps of C floats
// (neighbouring pixels read neighbouring taps, so the taps mostly hit L1
// and L2) and writes (C + 1) * 4 B.  The TPU kernel's (2B+2)^2 masked
// stencil existed only because the TPU has no gather; a direct load needs
// no |flow| bound.
//
// What was measured (probes/warp_probe.cu, 448x1024 on an H100): the
// kernel is bound by how many sectors a warp's tap loads touch and by how
// many loads a thread has in flight, not by its stores.  So:
//   * a warp's lanes stay on neighbouring pixels of one row (on a smooth
//     flow, which is what the pipeline gives, their taps then share
//     sectors; four consecutive pixels a thread with 128-bit flow loads
//     and stores spread a warp's taps over four times the span and lost,
//     with or without its stores passed through shared memory);
//   * a thread owns the same column of kRows consecutive rows, whose 16 C
//     tap loads are all issued before the first blend;
//   * the channel count is a compile-time constant (C = 1 and 3; any
//     other count takes a generic form), so the tap loops unroll;
//   * row and frame come from blockIdx, so no thread divides.
// One thread an output float (taps and stores coalesce exactly, the
// coordinates recomputed per channel) is ~10% faster on a random flow and
// 60% slower on a smooth one, so it was not taken.
//
// The arithmetic is the plain version's (ops/variational.warp_image),
// operation for operation: xx = i + wx, x0 = floor(xx), dx = xx - x0,
// taps clamped to the image, and
//   a*(1-dx)*(1-dy) + b*dx*(1-dy) + c*(1-dx)*dy + d*dx*dy
// evaluated left to right.  With --fmad=false nothing is contracted, so
// the kernel is bit-exact with the plain version.
//
// Batch: blockIdx.z is the frame, and the taps clamp to that frame's
// image.  The source may be a strided view (a crop of padded pyramid
// levels): row r of frame f starts at src + f * frame_stride + r *
// row_stride, pixels are C floats apart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads of a CTA, at most
constexpr int kRows = 4;        // rows a thread owns

// One pixel's four taps: offsets of its two columns within a row (in
// floats), its two rows and the blend weights.
struct Taps {
  const float* r1;
  const float* r2;
  int c1, c2;
  float dx, dy, omdx, omdy;
};

// Sets up pixel (j, i)'s taps for the flow (fx, fy) and returns its
// in-bounds mask.  `frame` is the frame's first pixel.
__device__ __forceinline__ float setup(const float* __restrict__ frame,
                                       int64_t row_stride, int h, int w,
                                       int C, int j, int i, float fx,
                                       float fy, Taps& t) {
  const float xx = (float)i + fx;
  const float yy = (float)j + fy;
  const float x0 = floorf(xx);
  const float y0 = floorf(yy);
  t.dx = xx - x0;
  t.dy = yy - y0;
  const int x1 = (int)fminf(fmaxf(x0, 0.0f), (float)(w - 1));
  const int x2 = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)(w - 1));
  const int y1 = (int)fminf(fmaxf(y0, 0.0f), (float)(h - 1));
  const int y2 = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)(h - 1));
  t.omdx = 1.0f - t.dx;
  t.omdy = 1.0f - t.dy;
  t.r1 = frame + y1 * row_stride;
  t.r2 = frame + y2 * row_stride;
  t.c1 = x1 * C;
  t.c2 = x2 * C;
  return (xx >= 0.0f && xx < (float)w && yy >= 0.0f && yy < (float)h)
             ? 1.0f : 0.0f;
}

__device__ __forceinline__ float blend(const Taps& t, float a, float b,
                                       float cc, float d) {
  return a * t.omdx * t.omdy + b * t.dx * t.omdy + cc * t.omdx * t.dy +
         d * t.dx * t.dy;
}

// One pixel a lane, R consecutive rows a thread; CH > 0 channels at
// compile time, or n_channels at run time (CH == 0, one row a thread).
// blockDim.x is whole warps; blockIdx = (columns, rows / R, frame).
template <int CH, int R>
__global__ void __launch_bounds__(kThreads) warp_kernel(
    const float* __restrict__ src, int64_t frame_stride, int64_t row_stride,
    const float* __restrict__ wx, const float* __restrict__ wy, int h, int w,
    int n_channels, float* __restrict__ out, float* __restrict__ mask) {
  constexpr int N = CH > 0 ? CH : 1;
  const int C = CH > 0 ? CH : n_channels;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j0 = blockIdx.y * R;
  if (i >= w) return;
  const float* frame = src + blockIdx.z * frame_stride;
  const int64_t first = ((int64_t)blockIdx.z * h + j0) * w + i;
  // rows past the last one are computed as the last one and not stored
  const int n_rows = min(R, h - j0);
  float fx[R], fy[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t idx = first + (int64_t)min(r, n_rows - 1) * w;
    fx[r] = wx[idx];
    fy[r] = wy[idx];
  }
  Taps t[R];
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    m[r] = setup(frame, row_stride, h, w, C, j0 + min(r, n_rows - 1), i,
                 fx[r], fy[r], t[r]);
  if (CH > 0) {
    float a[R][N], b[R][N], cc[R][N], d[R][N];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        a[r][c] = t[r].r1[t[r].c1 + c];
        b[r][c] = t[r].r1[t[r].c2 + c];
        cc[r][c] = t[r].r2[t[r].c1 + c];
        d[r][c] = t[r].r2[t[r].c2 + c];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n_rows) {
        const int64_t idx = first + (int64_t)r * w;
        mask[idx] = m[r];
#pragma unroll
        for (int c = 0; c < N; ++c)
          out[idx * N + c] = blend(t[r], a[r][c], b[r][c], cc[r][c], d[r][c]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n_rows) {
        const int64_t idx = first + (int64_t)r * w;
        mask[idx] = m[r];
        for (int c = 0; c < C; ++c)
          out[idx * C + c] =
              blend(t[r], t[r].r1[t[r].c1 + c], t[r].r1[t[r].c2 + c],
                    t[r].r2[t[r].c1 + c], t[r].r2[t[r].c2 + c]);
      }
    }
  }
}

// Launches warp_kernel<CH, R> over B frames of h x w pixels.
template <int CH, int R>
void launch(const float* src, int64_t frame_stride, int64_t row_stride,
            const float* wx, const float* wy, int B, int h, int w, int C,
            float* out, float* mask, cudaStream_t stream) {
  // the fewest whole warps that cover a row, up to a CTA
  int tx = 32;
  while (tx < kThreads && tx < w) tx *= 2;
  const dim3 grid((w + tx - 1) / tx, (h + R - 1) / R, B);
  warp_kernel<CH, R><<<grid, tx, 0, stream>>>(
      src, frame_stride, row_stride, wx, wy, h, w, C, out, mask);
}

}  // namespace

extern "C" int fot_warp(const void* src, int64_t frame_stride,
                        int64_t row_stride, const void* wx, const void* wy,
                        int B, int h, int w, int C, void* out, void* mask,
                        void* stream) {
  if (B * h * w == 0) return 0;
  auto fn = C == 3 ? launch<3, kRows> : C == 1 ? launch<1, kRows>
                                               : launch<0, 1>;
  fn((const float*)src, frame_stride, row_stride, (const float*)wx,
     (const float*)wy, B, h, w, C, (float*)out, (float*)mask,
     (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
