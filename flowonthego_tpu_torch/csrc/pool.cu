// K1: 2x2 average pool on the flat [H, W*C] view of an image — the
// pyramid downsample.  Replaces the Pallas kernel
// flowonthego_tpu/ops/pallas/pool.py (pool2x2_flat / _pool_kernel).
//
// Bound: device-memory bandwidth.  Each output reads 4 inputs and writes
// 1 (4K level 0: 100 MB read, 25 MB written as fp32; a uint8 frame reads
// a quarter of that).  One thread per output element, consecutive threads
// on consecutive outputs, so each warp's loads and stores are coalesced.
// The TPU kernel's one-hot matmuls and bf16x3 splits existed only to
// de-interleave on the matrix unit; a direct indexed load needs neither.
//
// Sum order ((a + b) + c) + d then x0.25 matches the plain version
// (reduce_window's row-major window order), so the two agree exactly.
// An optional bias is added to each tap before the sum: the result equals
// pooling (x + bias).  uint8 input is widened to float on load.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void pool2x2_kernel(const T* __restrict__ x, float* __restrict__ out,
                               int64_t n_out, int wc, int C, float bias) {
  const int wc2 = wc / 2;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < n_out; idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = idx / wc2;
    const int n = (int)(idx - r * wc2);
    const int k = n / C;
    const int ch = n - k * C;
    const int64_t c0 = (int64_t)2 * C * k + ch;
    const T* row0 = x + (2 * r) * (int64_t)wc;
    const T* row1 = row0 + wc;
    const float a = (float)row0[c0] + bias;
    const float b = (float)row0[c0 + C] + bias;
    const float c = (float)row1[c0] + bias;
    const float d = (float)row1[c0 + C] + bias;
    out[idx] = (((a + b) + c) + d) * 0.25f;
  }
}

template <typename T>
int launch(const T* x, float* out, int h, int wc, int C, float bias,
           int has_bias, void* stream) {
  const int64_t n_out = (int64_t)(h / 2) * (wc / 2);
  if (n_out == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n_out + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  pool2x2_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, out, n_out, wc, C, has_bias ? bias : 0.0f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fot_pool2x2_f32(const void* x, void* out, int h, int wc, int C,
                               float bias, int has_bias, void* stream) {
  return launch((const float*)x, (float*)out, h, wc, C, bias, has_bias, stream);
}

extern "C" int fot_pool2x2_u8(const void* x, void* out, int h, int wc, int C,
                              float bias, int has_bias, void* stream) {
  return launch((const uint8_t*)x, (float*)out, h, wc, C, bias, has_bias,
                stream);
}

// A kernel that does nothing: its time is the floor under every launch,
// which the sub-microsecond bounds of the small kernels are read against.
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int fot_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* fot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
