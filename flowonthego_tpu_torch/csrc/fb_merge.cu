// G5: the forward-backward merge of one scale.  Replaces the XLA scatter of
// flowonthego_tpu/ops/densify.py _fb_merge_scatter (acc.at[idx].add); the
// JAX package has no Pallas kernel for it.
//
// Each complementary patch lands at its optimized position mid + p, with
// landing cell (cx, cy) = ceil(mid + p + 1e-5) and bilinear weights from
// the fraction of mid + p.  Its pixel (j, i) (row, column) carries the
// densify weight w (pixel_weight.cuh) and adds (wb w, wb (-u w),
// wb (-v w)) to the cell (cx + lb + i - ox, cy + lb + j - oy) of each
// corner (ox, oy), wb that corner's bilinear weight, lb = floor(-ps / 2);
// the pixel counts only where (cx + lb + i, cy + lb + j) lies in
// [1, w-1) x [1, h-1).  The result is the [B, h, w, 3] (weight, w*u, w*v)
// accumulator that G3 (densify.cu) adds before its normalisation.
//
// Order: each cell's sum is the left fold from +0.0 of its contributions
// in the JAX package's order, corner (0,0), (1,0), (0,1), (1,1), then
// patches in grid order; for a fixed cell, corner and patch at most one
// pixel lands there, and frames never share a cell.  The plain version's
// stably sorted index_put_ folds each cell in that order, and so does
// this kernel, with no float atomics: a cell's sum is one warp's fold.
//
// Design: two launches.
//   * fb_merge_bin_kernel, one CTA a frame: bins the patches by landing
//     cell into bins of S = ps cells a side over the landings that can
//     reach the frame (a patch that cannot is dropped here: no sink row);
//     counts with integer atomics (the counts do not depend on the order),
//     scans the counts, places each patch at the slot it claimed, then
//     sorts every bin by patch index (a patch's place is the number of
//     smaller indices in its bin).  It also keeps each patch's landing
//     cell and its four bilinear weights.
//   * fb_merge_kernel, one warp a cell: for each corner, the landings
//     whose patch covers the cell span ps cells a side, so at most 2 x 2
//     bins; the lanes test the bins' entries (patch, landing cell) 32 at
//     a time and compute the hits' contributions in parallel, then sort
//     the hits by patch in shared memory and fold them in that order.
//     A cell's sum is a chain of dependent adds whatever the design; one
//     thread a cell walking the bins' lists in one merge (tried first,
//     0.048-0.054 ms at op 2's finest merge in chip_smoke.py on an H100)
//     also waited on a load for every step of that walk, and an op-2
//     merge has too few cells to hide it; the warp waits on a few loads
//     a corner.
// Every buffer's size follows from the shapes (a bin list holds at most P
// patches a frame), so the launches record into a CUDA graph.  A pile-up
// of every patch on one cell stays correct: the bin sort is then
// quadratic in P, and a corner with more hits than a warp sorts in shared
// memory walks the bins' lists in one merge.
//
// Bound: bytes (the costs read once, the accumulator written once); the
// work is a few operations a contribution.

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_weight.cuh"

namespace {

constexpr int kBinThreads = 1024;
constexpr int kCellThreads = 256;
constexpr int kNone = 0x7fffffff;  // past a list's end
constexpr int kHits = 64;          // hits a corner a warp sorts in shared

struct MergeArgs {
  const float* p;       // [B, P, 2] complementary flows (u, v)
  const float* mid;     // frame b's [P, 2] midpoints at mid + b * mid_stride
  const float* cost;    // [B, P, ps, ps, C] per-pixel costs
  int64_t mid_stride;
  int B, P, ps, C, h, w;
  float min_errval;
  int use_sqrt;
  int S, nbx, nby;      // bins: S x S landing cells, nbx x nby a frame
  int X0, Y0;           // the first landing cell of bin (0, 0)
  int4* sorted;         // [B, P] bin members in patch order: (k, cx, cy)
  int2* land;           // [B, P] landing cell
  int* bin_of;          // [B, P] bin, -1 where the patch cannot reach
  int* rank;            // [B, P] the slot a patch claimed in its bin
  int* slots;           // [B, P] bin members in claim order
  int* bins;            // [B, nbx * nby + 1] counts, then list starts
  float4* wb;           // [B, P] the four corners' bilinear weights
  float* out;           // [B, h, w, 3]
};

// a[0..n) -> exclusive prefix sums, a[n] = the total; every thread of the
// block calls it.
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int warp_total[kBinThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int x = own;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < (int)(blockDim.x / 32) ? warp_total[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_total[lane] = v;
  }
  __syncthreads();
  int run = x - own + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  if (t == (int)blockDim.x - 1) a[n] = run;
}

__global__ void __launch_bounds__(kBinThreads)
    fb_merge_bin_kernel(const MergeArgs a) {
  const int b = blockIdx.x;
  const int nb = a.nbx * a.nby;
  int* bins = a.bins + (int64_t)b * (nb + 1);
  const int64_t f = (int64_t)b * a.P;  // the frame's first patch
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  // landing cell, bilinear weights, bin; claim a slot in the bin
  const float* mid = a.mid + b * a.mid_stride;
  for (int k = threadIdx.x; k < a.P; k += blockDim.x) {
    const int64_t q = f + k;
    const float px = mid[2 * k] + a.p[2 * q];
    const float py = mid[2 * k + 1] + a.p[2 * q + 1];
    const long long cx = (long long)ceilf(px + 1e-5f);
    const long long cy = (long long)ceilf(py + 1e-5f);
    const float rx = px - floorf(px), ry = py - floorf(py);
    a.wb[q] = make_float4(rx * ry, (1.0f - rx) * ry, rx * (1.0f - ry),
                          (1.0f - rx) * (1.0f - ry));
    // a pixel (cx + lb + i, ...) can reach [1, w-2] only from these cells
    const long long xs = cx - a.X0, ys = cy - a.Y0;
    int bin = -1;
    if (xs >= 0 && xs <= a.w + a.ps - 4 && ys >= 0 &&
        ys <= a.h + a.ps - 4) {
      bin = (int)(ys / a.S) * a.nbx + (int)(xs / a.S);
      a.land[q] = make_int2((int)cx, (int)cy);
      a.rank[q] = atomicAdd(&bins[bin], 1);
    }
    a.bin_of[q] = bin;
  }
  __syncthreads();
  block_exclusive_scan(bins, nb);
  __syncthreads();
  for (int k = threadIdx.x; k < a.P; k += blockDim.x) {
    const int bin = a.bin_of[f + k];
    if (bin >= 0) a.slots[f + bins[bin] + a.rank[f + k]] = k;
  }
  __syncthreads();
  // a bin's members in patch order
  for (int k = threadIdx.x; k < a.P; k += blockDim.x) {
    const int bin = a.bin_of[f + k];
    if (bin < 0) continue;
    const int s = bins[bin], e = bins[bin + 1];
    int r = 0;
    for (int i = s; i < e; ++i) r += a.slots[f + i] < k;
    const int2 L = a.land[f + k];
    a.sorted[f + s + r] = make_int4(k, L.x, L.y, 0);
  }
}

// The contribution of patch q's pixel (j, i) to its cell through corner c.
struct Hit {
  int k;  // the patch (of the frame): the order of the fold
  float v0, v1, v2;
};

__device__ __forceinline__ Hit contribution(const MergeArgs& a, int64_t q,
                                            int k, int i, int j, int c) {
  const float wt = pixel_weight(
      a.cost + ((q * a.ps + j) * a.ps + i) * a.C, a.C, a.min_errval,
      a.use_sqrt);
  const float4 W = a.wb[q];
  const float wc = c == 0 ? W.x : c == 1 ? W.y : c == 2 ? W.z : W.w;
  const float u = a.p[2 * q], v = a.p[2 * q + 1];
  return Hit{k, wc * wt, wc * (-u * wt), wc * (-v * wt)};
}

// One warp, one cell: corner after corner, the candidates of the <= 2 x 2
// bins (their concatenation, 32 at a time: lane t takes the t-th) are
// tested in parallel, the hits' contributions computed in parallel and
// appended to a shared list; the list is then sorted by patch (a hit's
// place is the number of smaller patches in it, every patch being in one
// bin only) and every lane folds it in that order, so every lane holds
// the cell's sum.  A corner with more than kHits hits (a pile-up) is
// folded by a walk of the sorted lists in one merge instead, every lane
// alike.
__global__ void __launch_bounds__(kCellThreads)
    fb_merge_kernel(const MergeArgs a) {
  __shared__ Hit found[kCellThreads / 32][kHits];
  __shared__ Hit ordered[kCellThreads / 32][kHits];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t n = (int64_t)a.B * a.h * a.w;
  const int nb = a.nbx * a.nby;
  const int lb = -((a.ps + 1) / 2);
  const int ps = a.ps;
  const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x / 32);
  for (int64_t idx = blockIdx.x * (int64_t)(blockDim.x / 32) + wib; idx < n;
       idx += warps) {  // uniform per warp
    const int64_t row = idx / a.w;
    const int x = (int)(idx - row * a.w);
    const int b = (int)(row / a.h);
    const int y = (int)(row - (int64_t)b * a.h);
    const int64_t f = (int64_t)b * a.P;
    const int* bins = a.bins + (int64_t)b * (nb + 1);
    const int4* sorted = a.sorted + f;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int c = 0; c < 4; ++c) {
      const int ox = c & 1, oy = c >> 1;
      const int xt = x + ox, yt = y + oy;  // the pixel's place in the frame
      if (a.P == 0 || xt < 1 || yt < 1 || xt > a.w - 2 || yt > a.h - 2)
        continue;
      // landings cx in [xt - lb - ps + 1, xt - lb] put a pixel at xt: in
      // bin columns (xt - 1) / S .. (xt + ps - 2) / S, at most two
      const int bx0 = (xt - 1) / a.S, by0 = (yt - 1) / a.S;
      const bool two_x = (xt + ps - 2) / a.S > bx0;
      const bool two_y = (yt + ps - 2) / a.S > by0;
      int head[4], end[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int dx = l & 1, dy = l >> 1;
        const bool use = (dx == 0 || two_x) && (dy == 0 || two_y);
        const int bin = (by0 + dy) * a.nbx + bx0 + dx;
        head[l] = use ? bins[bin] : 0;
        end[l] = use ? bins[bin + 1] : 0;
      }
      const int c1 = end[0] - head[0];
      const int c2 = c1 + end[1] - head[1];
      const int c3 = c2 + end[2] - head[2];
      const int total = c3 + end[3] - head[3];
      int hits = 0;  // uniform
      for (int base = 0; base < total; base += 32) {
        const int t = base + lane;
        int k = 0, i = -1, j = -1;
        if (t < total) {
          const int at = t < c1   ? head[0] + t
                         : t < c2 ? head[1] + (t - c1)
                         : t < c3 ? head[2] + (t - c2)
                                  : head[3] + (t - c3);
          const int4 e = sorted[at];
          k = e.x;
          i = xt - lb - e.y;
          j = yt - lb - e.z;
        }
        const bool hit = i >= 0 && i < ps && j >= 0 && j < ps;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        const int at = hits + __popc(mask & lower);
        if (hit && at < kHits)
          found[wib][at] = contribution(a, f + k, k, i, j, c);
        hits += __popc(mask);
      }
      if (hits <= kHits) {
        __syncwarp();
        for (int s = lane; s < hits; s += 32) {
          const Hit h = found[wib][s];
          int r = 0;
          for (int m = 0; m < hits; ++m) r += found[wib][m].k < h.k;
          ordered[wib][r] = h;
        }
        __syncwarp();
        for (int r = 0; r < hits; ++r) {
          const Hit h = ordered[wib][r];
          a0 = a0 + h.v0;
          a1 = a1 + h.v1;
          a2 = a2 + h.v2;
        }
        __syncwarp();
        continue;
      }
      // a pile-up: walk the lists in one merge, the four heads in
      // registers (every index below is a compile-time one)
      int4 next[4];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        next[l] = head[l] < end[l] ? sorted[head[l]]
                                   : make_int4(kNone, 0, 0, 0);
      while (true) {  // the lists' patches in increasing order
        const int k = min(min(next[0].x, next[1].x),
                          min(next[2].x, next[3].x));
        if (k == kNone) break;
        int lx = 0, ly = 0;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (next[l].x == k) {  // one list holds k: advance it
            lx = next[l].y;
            ly = next[l].z;
            ++head[l];
            next[l] = head[l] < end[l] ? sorted[head[l]]
                                       : make_int4(kNone, 0, 0, 0);
          }
        }
        const int i = xt - lb - lx, j = yt - lb - ly;
        if (i < 0 || i >= ps || j < 0 || j >= ps) continue;
        const Hit h = contribution(a, f + k, k, i, j, c);
        a0 = a0 + h.v0;
        a1 = a1 + h.v1;
        a2 = a2 + h.v2;
      }
    }
    if (lane == 0) {
      a.out[idx * 3] = a0;
      a.out[idx * 3 + 1] = a1;
      a.out[idx * 3 + 2] = a2;
    }
  }
}

}  // namespace

// p [B, P, 2], cost [B, P, ps, ps, C] float32, contiguous; mid: frame b's
// [P, 2] at mid + b * mid_stride floats.  Bins of S cells, nbx x nby a
// frame, the first at landing cell (X0, Y0) = (2 - lb - ps, 2 - lb - ps).
// ints: the scratch [B * (9 P + nbx nby + 1)] int32, 16-byte aligned, wb:
// [B * P * 4] float32; out [B, h, w, 3].
extern "C" int fot_fb_merge(const void* p, const void* mid,
                            int64_t mid_stride, const void* cost, int B,
                            int P, int ps, int C, int h, int w,
                            float min_errval, int use_sqrt, int S, int nbx,
                            int nby, void* ints, void* wb, void* out,
                            void* stream) {
  const int64_t n = (int64_t)B * h * w;
  if (n == 0) return 0;
  if (ps < 1 || C < 1 || S < ps - 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  MergeArgs a;
  a.p = (const float*)p;
  a.mid = (const float*)mid;
  a.cost = (const float*)cost;
  a.mid_stride = mid_stride;
  a.B = B;
  a.P = P;
  a.ps = ps;
  a.C = C;
  a.h = h;
  a.w = w;
  a.min_errval = min_errval;
  a.use_sqrt = use_sqrt;
  a.S = S;
  a.nbx = nbx;
  a.nby = nby;
  const int lb = -((ps + 1) / 2);
  a.X0 = 2 - lb - ps;
  a.Y0 = 2 - lb - ps;
  const int64_t BP = (int64_t)B * P;
  int* base = (int*)ints;  // 16-byte aligned: the lists' entries first
  a.sorted = (int4*)base;
  a.land = (int2*)(base + 4 * BP);
  a.bin_of = base + 6 * BP;
  a.rank = a.bin_of + BP;
  a.slots = a.rank + BP;
  a.bins = a.slots + BP;
  a.wb = (float4*)wb;
  a.out = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (P > 0) {  // with no patch, the cells read no bin
    fb_merge_bin_kernel<<<B, kBinThreads, 0, s>>>(a);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int64_t per_block = kCellThreads / 32;  // a warp a cell
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond that
  fb_merge_kernel<<<(unsigned)blocks, kCellThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
