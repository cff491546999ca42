// K4: the variational-refinement inner loop on fields too large for one
// CTA.  Replaces the Pallas kernel
// flowonthego_tpu/ops/pallas/varref_fused.py (variational_refine_tiled ->
// _tiled_kernel).  Both routes here run fot_varref::refine_loop
// (varref_common.cuh), built from the per-pixel functions that K3's loop
// is built from, so all three compute the same function pixel for pixel,
// bit for bit.
//
// Bound: bytes for the card, dependent phases for the kernel.  The
// function reads 3 + 8 C planes and writes 2 (29 planes at C = 3: 53 MB at
// 448x1024, 0.016 ms at the card's memory rate; 0.8 MB and a fraction of a
// microsecond at 56x128), but a round is 2 + 2 * solve_iter dependent
// phases with a barrier after all but one, 1 + inner_iter * (1 + 2 *
// solve_iter) in all (36 at level 4).  A phase costs what its barrier
// costs plus what one SM needs to get through its share of the pixels
// (the data term with its divisions most of all), so a launch is the
// faster the cheaper its barrier and the more SMs share a phase, and the
// two routes trade one for the other.
//
// Cluster route (fields of a few thousand pixels: scale 4 of a 1024x448
// pair, scale 6 of a 4K frame): one thread-block cluster of up to 8 CTAs
// per field, one cluster per frame of a batch.  The 9 work planes live in
// the CTAs' shared memory, split by rows (36 bytes a pixel); each CTA also
// keeps its neighbours' border rows as halos, which the neighbours write
// through distributed shared memory (cluster.map_shared_rank) as they
// update those rows, so every read is local, and the barrier is
// cluster.sync(), a hardware barrier among at most 8 SMs (~0.45 us with
// CTAs of up to 256 threads, ~0.7 us with 1024) where the grid route pays
// ~1.1 us for a barrier through device memory (probes/barrier_probe.cu on
// an NVIDIA H100 80GB HBM3 at 700 W).  The inputs (dIs, wx, wy, mask) are
// read from device memory once per round.  With 8 SMs to a field the route
// stops paying near 6,000 pixels, where the grid route's 24 and more SMs
// get through a phase faster than the cheaper barrier saves; the
// resolver's threshold is that crossover.  The wrapper plans the split
// (the cluster's size and the rows per CTA, at least two so that a
// two-rows-away read stays in the neighbouring CTA); a launch the card
// refuses (too much shared memory, no room for the cluster) returns its
// error and is never sent to the other route.
//
// Grid route (larger fields, up to 458,752 px at 1024x448): one
// cooperative launch with as many CTAs as can be resident at once
// (occupancy x SM count, capped at one pixel per thread).  The CTAs walk
// the field grid-stride with the work planes in device memory, and a
// grid-wide barrier (grid.sync(), which also orders global memory) stands
// wherever K3 has __syncthreads().  The TPU kernel's alternative, one tile
// per program with a recompute halo of R = inner_iter * (3 + 2 *
// solve_iter) pixels, would cost (S + 2R)(T + 2R) / (S T) in extra work:
// tiles that fit 227 KB of shared memory are ~40 px wide, and R = 27 at
// op-3 scale 2, so ~5x.  A launch that the card refuses (a grid that
// cannot be resident) returns its error; it is never split or sent to K3.
//
// Batch: the cluster route runs one cluster per frame; the grid route
// walks all B*h*w pixels of the batch, and refine_loop derives each
// pixel's frame, row and column from its index, so border rules and
// red-black parity stay per frame.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "varref_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;          // grid route
constexpr int kClusterThreads = 1024;  // cluster route, at most
constexpr int kMaxClusterCtas = 8;     // the portable cluster size

struct GridSync {
  __device__ void operator()() const { cg::this_grid().sync(); }
};

struct ClusterSync {
  __device__ void operator()() const { cg::this_cluster().sync(); }
};

// The work planes in the shared memory of a cluster's CTAs.  This CTA
// holds pixels [lo, hi) of the field, rows_per whole rows (fewer in the
// last CTA), and around them three halo rows: the row above and the two
// below, which are the first rows and the last row of its neighbours.  A
// plane is (rows_per + 3) * w floats, the halo row above first, so every
// read, a neighbour's row included, is one load from this CTA's own
// shared memory.  put() keeps the halos true: a write to one of this
// CTA's first two rows also goes to the halo below of the CTA above, a
// write to its last row to the halo above of the CTA below, both as
// stores to distributed shared memory, which the cluster barrier at the
// end of the phase makes visible.
struct ClusterPlanes {
  float* mine;
  float* up;    // the CTA above's planes, or null
  float* down;  // the CTA below's planes, or null
  int cap;      // floats of one plane: (rows_per + 3) * w
  int org;      // idx + org is a pixel's place in a plane: w - lo
  int lo, hi, w, held;  // held: rows_per * w
  __device__ __forceinline__ float& at(int k, int idx) const {
    return mine[k * cap + idx + org];
  }
  __device__ __forceinline__ void put(int k, int idx, float v) const {
    const int q = k * cap + idx + org;
    mine[q] = v;
    if (up != nullptr && idx < lo + 2 * w) up[q + held] = v;
    if (down != nullptr && idx >= hi - w) down[q - held] = v;
  }
};

template <int CH>
__global__ void __launch_bounds__(kThreads) varref_tiled_kernel(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ dIs,
    int n_frames, int h, int w, int C, int inner_iter, int solve_iter,
    float omega, float qa, float hd3, float hg3, float* scratch,
    float* __restrict__ uu_out, float* __restrict__ vv_out) {
  const int N = n_frames * h * w;
  fot_varref::refine_loop<CH>(
      wx, wy, mask, dIs, h, w, C, inner_iter, solve_iter, omega, qa, hd3, hg3,
                          fot_varref::GlobalPlanes{scratch, N}, uu_out,
                          vv_out, blockIdx.x * blockDim.x + threadIdx.x, N,
                          gridDim.x * blockDim.x, GridSync());
}

// One cluster per frame: CTA `rank` of the cluster holds rows
// [rank * rows_per, (rank + 1) * rows_per) of the frame's work planes.
template <int CH>
__global__ void __launch_bounds__(kClusterThreads) varref_cluster_kernel(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ dIs, int h,
    int w, int C, int inner_iter, int solve_iter, float omega, float qa,
    float hd3, float hg3, int rows_per, float* __restrict__ uu_out,
    float* __restrict__ vv_out) {
  extern __shared__ float planes[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ctas = (int)cluster.num_blocks();
  const int n = h * w;
  const int64_t f = blockIdx.x / n_ctas;  // this cluster's frame
  const int held = rows_per * w;
  const int lo = min(rank * held, n), hi = min(lo + held, n);
  const ClusterPlanes pl{
      planes,
      rank > 0 ? cluster.map_shared_rank(planes, rank - 1) : nullptr,
      hi < n ? cluster.map_shared_rank(planes, rank + 1) : nullptr,
      (rows_per + 3) * w, w - lo, lo, hi, w, held};
  // No CTA may write into another's shared memory before that one runs or
  // after it has exited: the loop's first writes (du = dv = 0, halos
  // included) need every CTA of the cluster started, and its last barrier
  // (after the last half-sweep) comes after the last such write.
  cluster.sync();
  fot_varref::refine_loop<CH>(wx + f * n, wy + f * n, mask + f * n,
                          dIs + f * 8 * C * n, h, w, C, inner_iter,
                          solve_iter, omega, qa, hd3, hg3, pl, uu_out + f * n,
                          vv_out + f * n, lo + (int)threadIdx.x, hi,
                          (int)blockDim.x, ClusterSync());
}

}  // namespace

extern "C" int fot_varref_tiled(const void* wx, const void* wy,
                                const void* mask, const void* dIs, int B,
                                int h, int w, int C, int inner_iter,
                                int solve_iter, float omega, float qa,
                                float hd3, float hg3, void* scratch, void* uu,
                                void* vv, void* stream) {
  const int n = B * h * w;
  if (n == 0) return 0;
  const void* kernel = C == 3   ? (const void*)varref_tiled_kernel<3>
                       : C == 1 ? (const void*)varref_tiled_kernel<1>
                                : (const void*)varref_tiled_kernel<0>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  int blocks = per_sm * sms;
  const int needed = (n + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;

  const float* wx_f = (const float*)wx;
  const float* wy_f = (const float*)wy;
  const float* mask_f = (const float*)mask;
  const float* dIs_f = (const float*)dIs;
  float* scratch_f = (float*)scratch;
  float* uu_f = (float*)uu;
  float* vv_f = (float*)vv;
  void* args[] = {&wx_f,  &wy_f,       &mask_f,     &dIs_f, &B,
                  &h,     &w,          &C,          &inner_iter,
                  &solve_iter, &omega, &qa,         &hd3,   &hg3,
                  &scratch_f,  &uu_f,  &vv_f};
  // blocks == 0 (no CTA fits on an SM) is refused here as an invalid
  // configuration.
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises with this code
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The cluster route: B clusters of n_ctas CTAs of `threads` threads,
// rows_per rows of the field's work planes in each CTA's shared memory
// (the wrapper's plan).
extern "C" int fot_varref_cluster(const void* wx, const void* wy,
                                  const void* mask, const void* dIs, int B,
                                  int h, int w, int C, int inner_iter,
                                  int solve_iter, float omega, float qa,
                                  float hd3, float hg3, int n_ctas,
                                  int rows_per, int threads, void* uu,
                                  void* vv, void* stream) {
  if (B * h * w == 0) return 0;
  const bool pow2 = n_ctas >= 1 && (n_ctas & (n_ctas - 1)) == 0;
  if (!pow2 || n_ctas > kMaxClusterCtas || rows_per < 1 || threads < 32 ||
      threads > kClusterThreads || threads % 32 != 0 ||
      (long long)rows_per * n_ctas < h || (n_ctas > 1 && rows_per < 2))
    return (int)cudaErrorInvalidConfiguration;
  const size_t shared = (size_t)fot_varref::kScratchPlanes * (rows_per + 3) *
                        w * sizeof(float);
  // Above 48 KB a CTA's dynamic shared memory is opt-in; more than the
  // card has is refused here.
  auto kernel = C == 3   ? varref_cluster_kernel<3>
                : C == 1 ? varref_cluster_kernel<1>
                         : varref_cluster_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(B * n_ctas);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = shared;
    config.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &config, kernel, (const float*)wx, (const float*)wy,
        (const float*)mask, (const float*)dIs, h, w, C, inner_iter,
        solve_iter, omega, qa, hd3, hg3, rows_per, (float*)uu, (float*)vv);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises with this code
    return (int)err;
  }
  return (int)cudaGetLastError();
}
