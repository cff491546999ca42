// What a barrier costs on the card: __syncthreads() in one CTA,
// cluster.sync() in a thread-block cluster (alone, and with a read of a
// neighbour's shared memory between two of them), grid.sync() in a
// cooperative launch, and the launch of a kernel that does nothing.  The
// var-ref kernels (csrc/varref_common.cuh) are chains of short phases with
// a barrier after each, so these times decide which of K3, K4's cluster
// route and K4's grid route serves a field (ops/variational.py).
//
// A stand-alone program, not part of the kernel library:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o barrier_probe flowonthego_tpu_torch/probes/barrier_probe.cu
//   ./barrier_probe
//
// Each time is the mean over 1000 barriers inside one launch: CUDA events
// around 20 launches, less the time of the same launch with no barrier.

#include <cstdio>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kBarriers = 1000;
constexpr int kLaunches = 20;

__global__ void empty_kernel() {}

// v depends on the loop, and the store never happens: it keeps the loop.
__global__ void block_kernel(int n, float* out) {
  float v = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    v += 1.0f;
  }
  if (v < 0) out[0] = v;
}

__global__ void cluster_kernel(int n, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  float v = 0;
  for (int i = 0; i < n; ++i) {
    cluster.sync();
    v += 1.0f;
  }
  if (v < 0) out[0] = v;
}

// A round: read the next CTA's shared memory, barrier, write one's own,
// barrier.
__global__ void cluster_read_kernel(int n, float* out) {
  extern __shared__ float mine[];
  cg::cluster_group cluster = cg::this_cluster();
  const int next = (cluster.block_rank() + 1) % cluster.num_blocks();
  const float* theirs = cluster.map_shared_rank(mine, next);
  mine[threadIdx.x] = threadIdx.x;
  cluster.sync();
  float v = 0;
  for (int i = 0; i < n; ++i) {
    v += theirs[threadIdx.x];
    cluster.sync();
    mine[threadIdx.x] = v;
    cluster.sync();
  }
  if (v < 0) out[0] = v;
}

__global__ void grid_kernel(int n, float* out) {
  cg::grid_group grid = cg::this_grid();
  float v = 0;
  for (int i = 0; i < n; ++i) {
    grid.sync();
    v += 1.0f;
  }
  if (v < 0) out[0] = v;
}

template <class F>
float mean_ms(F launch, int reps) {
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  launch();
  cudaDeviceSynchronize();
  cudaEventRecord(start);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0;
  cudaEventElapsedTime(&ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return ms / reps;
}

// Microseconds a barrier: run(n) launches a kernel with n barriers.
template <class F>
float barrier_us(F run, float* launch_us) {
  const float base = mean_ms([&] { run(0); }, kLaunches);
  const float full = mean_ms([&] { run(kBarriers); }, kLaunches);
  *launch_us = 1e3f * base;
  return 1e3f * (full - base) / kBarriers;
}

int main() {
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float));
  float launch_us = 0;
  printf("a kernel that does nothing: %.3f us a launch\n",
         1e3 * mean_ms([] { empty_kernel<<<1, 32>>>(); }, 1000));

  for (int threads : {128, 256, 1024}) {
    const float us = barrier_us(
        [&](int n) { block_kernel<<<1, threads>>>(n, out); }, &launch_us);
    printf("__syncthreads, %4d threads: %.3f us\n", threads, us);
  }

  cudaFuncSetAttribute(cluster_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(cluster_read_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int ctas : {2, 4, 8, 16}) {
    for (int threads : {128, 256, 512, 1024}) {
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3(ctas);
      config.blockDim = dim3(threads);
      config.dynamicSmemBytes = threads * sizeof(float);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = ctas;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      config.attrs = attr;
      config.numAttrs = 1;
      const float alone = barrier_us(
          [&](int n) { cudaLaunchKernelEx(&config, cluster_kernel, n, out); },
          &launch_us);
      const float round = barrier_us(
          [&](int n) {
            cudaLaunchKernelEx(&config, cluster_read_kernel, n, out);
          },
          &launch_us);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) {
        printf("cluster of %2d CTAs x %4d threads: %s\n", ctas, threads,
               cudaGetErrorString(err));
        continue;
      }
      printf("cluster.sync, %2d CTAs x %4d threads: %.3f us; a round of a "
             "neighbour's read and two barriers: %.3f us (launch %.2f us)\n",
             ctas, threads, alone, round, launch_us);
    }
  }

  for (int ctas : {2, 7, 28, 112, 132, 528}) {
    const int threads = 256;
    const float us = barrier_us(
        [&](int n) {
          void* args[] = {&n, &out};
          cudaLaunchCooperativeKernel((void*)grid_kernel, dim3(ctas),
                                      dim3(threads), args, 0, 0);
        },
        &launch_us);
    printf("grid.sync, %3d CTAs x %d threads: %.3f us (launch %.2f us)\n",
           ctas, threads, us, launch_us);
  }
  cudaFree(out);
  return 0;
}
