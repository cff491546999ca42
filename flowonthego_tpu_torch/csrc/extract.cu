// G2: template extraction and Gauss-Newton Hessians of one scale.
// Replaces the XLA fusions of flowonthego_tpu/ops/patches.py
// extract_templates_and_hessians (its extract_windows gathers, the mean
// normalisation and the three Hessian sums); the JAX package has no
// Pallas kernel for it.
//
// Per patch (j, i) of frame b, the ps x ps x C window whose top left lies
// at row top + j * steps, column left + i * steps of the padded levels
// [B, Hp, Wp, C] is copied out of the image, d/dx and d/dy; the image's
// window less its mean over all ps*ps*C values (when mean normalisation
// is on) is the template; H = (sum gx^2 + e, sum gx*gy, sum gy^2 + e),
// e = 1e-10 where the determinant is exactly zero, else 0.
//
// Bound: bytes (the three levels read, three windows of every patch
// written; windows overlap, so the writes dominate).  One warp a patch:
// a window row is ps*C contiguous floats, so a warp's lanes read and
// write neighbouring floats; the four sums are reduced across the warp
// with shuffles, and the template is written in a second pass over the
// window (from L1).  The copies are exact; the mean and the Hessians sum
// in another order than the plain version (lane-strided, then a
// butterfly), so they differ from it by a few ulp of the sums.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 patches a CTA

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void glue_extract_kernel(
    const float* __restrict__ I, const float* __restrict__ Ix,
    const float* __restrict__ Iy, int Hp, int Wp, int C, int ps, int steps,
    int n_h, int n_w, int top, int left, int mean_on, int64_t n_patches,
    float* __restrict__ tmpl, float* __restrict__ tgx,
    float* __restrict__ tgy, float* __restrict__ H) {
  const int64_t patch = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  if (patch >= n_patches) return;            // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int per_frame = n_h * n_w;
  const int b = (int)(patch / per_frame);
  const int rest = (int)(patch - (int64_t)b * per_frame);
  const int j = rest / n_w;
  const int i = rest - j * n_w;
  const int row_len = ps * C;                 // floats of a window row
  const int N = ps * row_len;
  const int64_t row_stride = (int64_t)Wp * C;
  const int64_t base = ((int64_t)b * Hp + top + j * steps) * row_stride +
                       (int64_t)(left + i * steps) * C;
  const int64_t out = patch * N;
  float s = 0.0f, h00 = 0.0f, h01 = 0.0f, h11 = 0.0f;
  for (int k = lane; k < N; k += 32) {
    const int r = k / row_len;
    const int64_t src = base + r * row_stride + (k - r * row_len);
    const float gx = Ix[src];
    const float gy = Iy[src];
    s += I[src];
    h00 += gx * gx;
    h01 += gx * gy;
    h11 += gy * gy;
    tgx[out + k] = gx;
    tgy[out + k] = gy;
  }
  s = warp_sum(s);
  h00 = warp_sum(h00);
  h01 = warp_sum(h01);
  h11 = warp_sum(h11);
  const float mean = s / (float)N;
  for (int k = lane; k < N; k += 32) {
    const int r = k / row_len;
    const float v = I[base + r * row_stride + (k - r * row_len)];
    tmpl[out + k] = mean_on ? v - mean : v;
  }
  if (lane == 0) {
    const float det = h00 * h11 - h01 * h01;
    const float bump = det == 0.0f ? 1e-10f : 0.0f;
    H[patch * 3] = h00 + bump;
    H[patch * 3 + 1] = h01;
    H[patch * 3 + 2] = h11 + bump;
  }
}

}  // namespace

// I, Ix, Iy [B, Hp, Wp, C] float32, contiguous; the window of patch
// (j, i) starts at row top + j * steps, column left + i * steps.  tmpl,
// tgx, tgy [B, n_h, n_w, ps, ps, C], H [B, n_h, n_w, 3].
extern "C" int fot_extract(const void* I, const void* Ix, const void* Iy,
                           int B, int Hp, int Wp, int C, int ps, int steps,
                           int n_h, int n_w, int top, int left, int mean_on,
                           void* tmpl, void* tgx, void* tgy, void* H,
                           void* stream) {
  const int64_t n_patches = (int64_t)B * n_h * n_w;
  if (n_patches == 0) return 0;
  const int64_t blocks = (n_patches * 32 + kThreads - 1) / kThreads;
  glue_extract_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)I, (const float*)Ix, (const float*)Iy, Hp, Wp, C, ps,
      steps, n_h, n_w, top, left, mean_on, n_patches, (float*)tmpl,
      (float*)tgx, (float*)tgy, (float*)H);
  return (int)cudaGetLastError();
}
