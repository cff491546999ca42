// G4: the image derivatives of variational refinement.  Replaces the XLA
// fusions of flowonthego_tpu/ops/variational.py get_derivatives (its
// deriv5 stencils); the JAX package has no Pallas kernel for it.  K3 and
// both routes of K4 read its output.
//
// On mean = 0.5 * (im1 + w_im2) and Iz = w_im2 - im1 (w_im2: K5's warp),
//   Ix = d5x(mean), Iy = d5y(mean),
//   Ixx = d5x(Ix), Ixy = d5y(Ix), Iyy = d5y(Iy), Ixz = d5x(Iz), Iyz = d5y(Iz),
// with d5(x)[i] = (8 (x[i+1] - x[i-1]) - (x[i+2] - x[i-2])) / 12 and a
// replicate border on each stencil's own input: a second derivative
// replicates the first derivative's edge, not the image's.  Output: the
// planes [B, 8, C, h, w] in Derivatives order (Ix, Iy, Iz, Ixx, Ixy, Iyy,
// Ixz, Iyz), the layout K3 and K4 take.
//
// One CTA a 32 x 8 tile of one channel of one frame.  It first computes
// Ix, Iy, Iz on the tile and a 2-pixel halo into shared memory, each halo
// cell holding the first derivative at its coordinate clamped to the
// image (computed from the image with its own clamped taps); that is the
// first derivative's replicate border, so the second derivatives read
// their four taps straight from the tile.  Bound: bytes (two images read,
// eight planes written); the halo recomputes 2 x 20% of a tile's first
// derivatives from L1.
//
// The arithmetic is the plain version's on the card operation for
// operation: PyTorch's CUDA division by a Python scalar multiplies by the
// float reciprocal, so "/ 12" is "* (1.0f / 12.0f)" here; with
// --fmad=false nothing is contracted.  The kernel equals the plain
// version on the card bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;                 // tile columns (a warp)
constexpr int kTy = 8;                  // tile rows
constexpr int kHalo = 2;                // deriv5 reaches two pixels
constexpr int kSx = kTx + 2 * kHalo;
constexpr int kSy = kTy + 2 * kHalo;
constexpr float kInv12 = 1.0f / 12.0f;

__device__ __forceinline__ float d5(float m2, float m1, float p1, float p2) {
  return (8.0f * (p1 - m1) - (p2 - m2)) * kInv12;
}

// One channel of one frame: pixel (y, x) at f[y * row + x * C].
struct Plane {
  const float* f;
  int64_t row;
  int C;
  __device__ __forceinline__ float at(int y, int x) const {
    return f[y * row + (int64_t)x * C];
  }
};

__global__ void glue_derivs_kernel(const float* __restrict__ im1,
                                   int64_t f1, int64_t r1,
                                   const float* __restrict__ im2,
                                   int64_t f2, int64_t r2, int h, int w,
                                   int C, float* __restrict__ dIs) {
  __shared__ float sx[kSy][kSx];
  __shared__ float sy[kSy][kSx];
  __shared__ float sz[kSy][kSx];
  const int b = blockIdx.z / C;
  const int c = blockIdx.z - b * C;
  const Plane a{im1 + b * f1 + c, r1, C};
  const Plane v{im2 + b * f2 + c, r2, C};
  const int x0 = blockIdx.x * kTx - kHalo;
  const int y0 = blockIdx.y * kTy - kHalo;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int k = tid; k < kSx * kSy; k += kTx * kTy) {
    const int ty = k / kSx;
    const int tx = k - ty * kSx;
    const int y = min(max(y0 + ty, 0), h - 1);
    const int x = min(max(x0 + tx, 0), w - 1);
    const int xm2 = max(x - 2, 0), xm1 = max(x - 1, 0);
    const int xp1 = min(x + 1, w - 1), xp2 = min(x + 2, w - 1);
    const int ym2 = max(y - 2, 0), ym1 = max(y - 1, 0);
    const int yp1 = min(y + 1, h - 1), yp2 = min(y + 2, h - 1);
    auto mean = [&](int yy, int xx) {
      return 0.5f * (a.at(yy, xx) + v.at(yy, xx));
    };
    sx[ty][tx] = d5(mean(y, xm2), mean(y, xm1), mean(y, xp1), mean(y, xp2));
    sy[ty][tx] = d5(mean(ym2, x), mean(ym1, x), mean(yp1, x), mean(yp2, x));
    sz[ty][tx] = v.at(y, x) - a.at(y, x);
  }
  __syncthreads();
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= w || y >= h) return;
  const int tx = threadIdx.x + kHalo;
  const int ty = threadIdx.y + kHalo;
  const int64_t plane = (int64_t)h * w;
  float* o = dIs + ((int64_t)b * 8 * C + c) * plane + (int64_t)y * w + x;
  const int64_t step = C * plane;       // from one derivative to the next
  o[0] = sx[ty][tx];
  o[step] = sy[ty][tx];
  o[2 * step] = sz[ty][tx];
  o[3 * step] = d5(sx[ty][tx - 2], sx[ty][tx - 1], sx[ty][tx + 1],
                   sx[ty][tx + 2]);
  o[4 * step] = d5(sx[ty - 2][tx], sx[ty - 1][tx], sx[ty + 1][tx],
                   sx[ty + 2][tx]);
  o[5 * step] = d5(sy[ty - 2][tx], sy[ty - 1][tx], sy[ty + 1][tx],
                   sy[ty + 2][tx]);
  o[6 * step] = d5(sz[ty][tx - 2], sz[ty][tx - 1], sz[ty][tx + 1],
                   sz[ty][tx + 2]);
  o[7 * step] = d5(sz[ty - 2][tx], sz[ty - 1][tx], sz[ty + 1][tx],
                   sz[ty + 2][tx]);
}

}  // namespace

// im1, im2 [B, h, w, C] float32 with dense pixels: pixel (b, y, x) at
// b * f + y * r + x * C (strided crops of padded levels allowed);
// dIs [B, 8, C, h, w] float32, contiguous.
extern "C" int fot_derivs(const void* im1, int64_t f1, int64_t r1,
                          const void* im2, int64_t f2, int64_t r2, int B,
                          int h, int w, int C, void* dIs, void* stream) {
  if ((int64_t)B * h * w * C == 0) return 0;
  const dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy, B * C);
  glue_derivs_kernel<<<grid, dim3(kTx, kTy), 0, (cudaStream_t)stream>>>(
      (const float*)im1, f1, r1, (const float*)im2, f2, r2, h, w, C,
      (float*)dIs);
  return (int)cudaGetLastError();
}
