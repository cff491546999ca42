// G6's square roots (csrc/dis_ref.cu) against sqrtf on every one of the
// 2^32 float bit patterns: sqrt_rn on all, sqrt_ge1 on those from 1.0 up
// (+infinity and NaN included).  Prints how many results' bits differ
// (NaN results that differ only in their payload apart) and exits 1 if
// any does.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//       -o sqrt_rn_check flowonthego_tpu_torch/probes/sqrt_rn_check.cu
//   ./sqrt_rn_check

#include <cstdio>

#include "../csrc/dis_ref.cu"

__global__ void check(unsigned long long* bad, unsigned long long* bad_nan,
                      unsigned* first) {
  const unsigned long long n = 1ull << 32;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < n; i += step) {
    const float x = __uint_as_float((unsigned)i);
    const float want = sqrtf(x);
    // sqrt_rn everywhere; sqrt_ge1 from 1.0 up (+infinity and NaN too)
    for (int f = 0; f < 2; ++f) {
      if (f == 1 && !(x >= 1.0f || isnan(x))) continue;
      const float got = f == 0 ? sqrt_rn(x) : sqrt_ge1(x);
      if (__float_as_uint(got) == __float_as_uint(want)) continue;
      if (isnan(got) && isnan(want)) {
        atomicAdd(bad_nan, 1ull);
      } else {
        atomicAdd(bad, 1ull);
        atomicMin(first, (unsigned)i);
      }
    }
  }
}

int main() {
  unsigned long long* counts;
  unsigned* first;
  cudaMalloc(&counts, 2 * sizeof(unsigned long long));
  cudaMalloc(&first, sizeof(unsigned));
  cudaMemset(counts, 0, 2 * sizeof(unsigned long long));
  cudaMemset(first, 0xff, sizeof(unsigned));
  check<<<132 * 16, 256>>>(counts, counts + 1, first);
  unsigned long long h[2];
  unsigned f;
  cudaMemcpy(h, counts, sizeof(h), cudaMemcpyDeviceToHost);
  cudaMemcpy(&f, first, sizeof(f), cudaMemcpyDeviceToHost);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::printf("sqrt_rn_check: %s\n", cudaGetErrorString(err));
    return 2;
  }
  std::printf("sqrt_rn, sqrt_ge1 vs sqrtf over 2^32 patterns: %llu differ, "
              "%llu NaN "
              "payloads differ%s", h[0], h[1], h[0] ? "" : "\n");
  if (h[0]) std::printf("; the first at bits 0x%08x\n", f);
  return h[0] ? 1 : 0;
}
