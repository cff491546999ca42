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
// this kernel, with no float atomics: a cell's sum is one thread's fold.
//
// Design (ops/cuda/fb_merge.py merge_plan sizes every launch and buffer):
//   * Bins.  The landing cells from which a pixel can reach the frame are
//     cut into bins of S x S (S >= ps, the tiles' side, or S = ps for a
//     small frame's warp a cell); a patch that cannot reach it gets
//     the key nb (past every bin) and no cell reads it: no sink row.  The
//     patches are sorted by bin with a stable LSD radix sort of 8-bit
//     digits over chunks of 1,024 patches, one CTA a chunk: a patch's rank
//     among the chunk's equal digits comes from __match_any_sync in lane
//     order and a per-warp histogram scanned over the warps, so each bin's
//     members come out in patch order with no in-bin ranking; a pass is
//     fb_merge_bin_count_kernel (ranks, the chunk's digit counts), one CTA
//     a frame scanning the (digit, chunk) counts, and
//     fb_merge_bin_scatter_kernel; fb_merge_bin_start_kernel then finds
//     each bin's first entry.  A frame of at most 1,024 patches (every op
//     2 merge) is one chunk: fb_merge_bin_kernel runs the passes and the
//     starts in one CTA.  Integer counts only.
//   * Cells.  fb_merge_kernel gives a CTA a tile of S x S cells: their
//     four corners reach the pixels of (S + 1) x (S + 1) positions, which
//     only landings in the tile's bin and the next bin along each axis
//     cover, so the candidates are 2 x 2 bins' members.  The CTA loads
//     them once into shared memory, merged into patch order (a member's
//     place is its place in its bin plus the members of the other three
//     bins with a smaller patch index, by binary search), with each
//     landing cell, its four bilinear weights and (u, v); per position
//     along each axis a warp ballot gives the bit mask of the candidates
//     that cover it, so a position's hits are the set bits of (column
//     mask & row mask), in patch order.  Those go to shared memory,
//     position after position, and then their densify weights (the only
//     scattered global loads, kBatch issued together, the hits shared
//     evenly among the threads); each thread then folds its cells corner
//     after corner,
//     each corner's hits read in order from its position's list.  More
//     than kWindow candidates (a pile-up) are taken kWindow patch
//     indices at a time, and the positions' lists kEntries hits at a
//     time, corner after corner, in bounded shared memory.
//   * Small frames (the plan's warp_cells: op 4's two coarsest scales,
//     op 2's) take fb_merge_warp_kernel instead, a warp a cell on bins
//     of ps: there a frame is a few tiles, so a few CTAs, and a tile
//     CTA's chain of dependent steps (~30,000 cycles a tile, measured
//     with clock64 on the card) outlasts a warp's few loads and its sort
//     of a corner's hits.
// Why not simpler: one CTA a frame ranking each bin's members by
// re-reading the bin is quadratic in a bin and runs on one SM; a warp a
// cell re-reads its bins and recomputes each hit's weight for each
// corner; a thread a cell gathering each hit's costs as it folds waits on
// a load a hit.
//
// Bound: bytes (the costs read once, the accumulator written once); the
// work is a few operations a contribution.

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_weight.cuh"

namespace {

constexpr int kChunk = 1024;        // patches a sort CTA ranks (its threads)
constexpr int kWarps = kChunk / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kStartThreads = 256;
constexpr int kCellThreads = 256;
constexpr int kWarpThreads = 256;   // fb_merge_warp_kernel: 8 cells a CTA
constexpr int kWindow = 256;        // candidates a cell CTA holds at once
constexpr int kWords = kWindow / 32;
static_assert(kWindow <= kCellThreads, "a cell CTA's thread an entry of "
              "its window");
constexpr int kMaxTile = 32;        // S at most
constexpr int kEntries = 5120;      // weights a cell CTA holds at once
constexpr int kBatch = 4;           // weights whose loads a thread issues
constexpr int kCells = kMaxTile * kMaxTile / kCellThreads;  // a thread's
constexpr int kNone = 0x7fffffff;
constexpr int kHits = 64;           // hits a corner a warp sorts in shared

struct MergeArgs {
  const float* p;       // [B, P, 2] complementary flows (u, v)
  const float* mid;     // frame b's [P, 2] midpoints at mid + b * mid_stride
  const float* cost;    // [B, P, ps, ps, C] per-pixel costs
  int64_t mid_stride;
  int B, P, ps, C, h, w;
  float min_errval;
  int use_sqrt;
  int S, nbx, nby;      // bins and cell tiles of S; nbx x nby bins a frame
  int X0, Y0;           // bin column of landing cell cx: (cx - X0) / S
  int n_chunks;         // sort chunks a frame
  int2* land;           // [B, P] landing cell (of a patch that can reach)
  float4* wb;           // [B, P] the four corners' bilinear weights
  int* key[2];          // [B, P] bins, and patch indices, in a pass's order
  int* val[2];
  int* lrank;           // [B, P] rank among the chunk's equal digits
  int* counts;          // [B, kDigits, n_chunks] then their prefix sums
  int* starts;          // [B, nb + 1] each bin's first entry
  int* sorted_key;      // key[passes & 1], val[passes & 1]: the result
  int* sorted;
  int2* sorted_land;    // [B, P] land, wb and (u, v) in the sorted order
  float4* sorted_wb;
  float2* sorted_uv;
  float* out;           // [B, h, w, 3]
};

// Landing cell, bilinear weights and bin of patch k of frame b; the key nb
// where none of its pixels can reach [1, w-2] x [1, h-2].
__device__ int land_patch(const MergeArgs& a, int b, int k) {
  const int64_t q = (int64_t)b * a.P + k;
  const float* mid = a.mid + b * a.mid_stride;
  const float px = mid[2 * k] + a.p[2 * q];
  const float py = mid[2 * k + 1] + a.p[2 * q + 1];
  const long long cx = (long long)ceilf(px + 1e-5f);
  const long long cy = (long long)ceilf(py + 1e-5f);
  const float rx = px - floorf(px), ry = py - floorf(py);
  a.wb[q] = make_float4(rx * ry, (1.0f - rx) * ry, rx * (1.0f - ry),
                        (1.0f - rx) * (1.0f - ry));
  // a pixel cx + lb + i reaches [1, w-2] only from xs in [1, w + ps - 3]
  const long long xs = cx - a.X0, ys = cy - a.Y0;
  if (xs >= 1 && xs <= a.w + a.ps - 3 && ys >= 1 && ys <= a.h + a.ps - 3) {
    a.land[q] = make_int2((int)cx, (int)cy);
    return (int)(ys / a.S) * a.nbx + (int)(xs / a.S);
  }
  return a.nbx * a.nby;
}

// Entry `at` of frame b's sorted order is patch k: keep its landing
// cell, bilinear weights and flow beside it, so that a cell tile loads
// its candidates in one pass.
__device__ __forceinline__ void put_sorted(const MergeArgs& a, int b, int at,
                                           int k) {
  const int64_t f = (int64_t)b * a.P, q = f + k;
  a.sorted[f + at] = k;
  a.sorted_land[f + at] = a.land[q];
  a.sorted_wb[f + at] = a.wb[q];
  a.sorted_uv[f + at] = make_float2(a.p[2 * q], a.p[2 * q + 1]);
}

__device__ __forceinline__ int digit_of(int key, int pass) {
  return (key >> (kDigitBits * pass)) & (kDigits - 1);
}

// A stable counting sort's rank: the number of lower threads of the CTA
// (kChunk of them) holding the same digit; s_count[d] gets the CTA's
// count of digit d.  digit < 0: the thread holds nothing.  Every thread
// calls it.
__device__ int chunk_rank(int digit, unsigned short (*whist)[kDigits],
                          int* s_count) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __syncthreads();   // the previous call's readers are done
  for (int i = t; i < kWarps * kDigits; i += kChunk) (&whist[0][0])[i] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xffffffffu, digit);
  const int below = __popc(peers & ((1u << lane) - 1u));
  if (digit >= 0 && below == 0) whist[warp][digit] = __popc(peers);
  __syncthreads();
  if (t < kDigits) {   // each digit's exclusive prefix over the warps
    int run = 0;
    for (int v = 0; v < kWarps; ++v) {
      const int c = whist[v][t];
      whist[v][t] = (unsigned short)run;
      run += c;
    }
    s_count[t] = run;
  }
  __syncthreads();
  return digit >= 0 ? whist[warp][digit] + below : 0;
}

// a[0..n) -> exclusive prefix sums over the CTA (kChunk threads).
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int warp_total[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (n + kChunk - 1) / kChunk;
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
    int v = warp_total[lane];
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
}

__device__ __forceinline__ int lower_bound(const int* v, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (v[m] < x) lo = m + 1; else hi = m;
  }
  return lo;
}

// One pass's ranks and digit counts of chunk blockIdx.x of frame
// blockIdx.y; pass 0 lands the patches and writes their keys.
__global__ void __launch_bounds__(kChunk)
    fb_merge_bin_count_kernel(const MergeArgs a, int pass) {
  __shared__ unsigned short whist[kWarps][kDigits];
  __shared__ int s_count[kDigits];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int k = chunk * kChunk + threadIdx.x;
  const int64_t q = (int64_t)b * a.P + k;
  int digit = -1;
  if (k < a.P) {
    int key;
    if (pass == 0) {
      key = land_patch(a, b, k);
      a.key[0][q] = key;
    } else {
      key = a.key[pass & 1][q];
    }
    digit = digit_of(key, pass);
  }
  const int rank = chunk_rank(digit, whist, s_count);
  if (k < a.P) a.lrank[q] = rank;
  if (threadIdx.x < kDigits)
    a.counts[((int64_t)b * kDigits + threadIdx.x) * a.n_chunks + chunk] =
        s_count[threadIdx.x];
}

// Frame blockIdx.x's (digit, chunk) counts, digit-major -> the first
// place of each (digit, chunk) in the pass's output.
__global__ void __launch_bounds__(kChunk)
    fb_merge_bin_scan_kernel(const MergeArgs a) {
  block_exclusive_scan(a.counts + (int64_t)blockIdx.x * kDigits * a.n_chunks,
                       kDigits * a.n_chunks);
}

__global__ void __launch_bounds__(kChunk)
    fb_merge_bin_scatter_kernel(const MergeArgs a, int pass, int last) {
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int k = chunk * kChunk + threadIdx.x;
  if (k >= a.P) return;
  const int64_t f = (int64_t)b * a.P, q = f + k;
  const int key = a.key[pass & 1][q];
  const int val = pass == 0 ? k : a.val[pass & 1][q];
  const int at =
      a.counts[((int64_t)b * kDigits + digit_of(key, pass)) * a.n_chunks +
               chunk] + a.lrank[q];
  a.key[(pass + 1) & 1][f + at] = key;
  if (last)
    put_sorted(a, b, at, val);
  else
    a.val[(pass + 1) & 1][f + at] = val;
}

__global__ void __launch_bounds__(kStartThreads)
    fb_merge_bin_start_kernel(const MergeArgs a) {
  const int nb = a.nbx * a.nby;
  const int bin = blockIdx.x * kStartThreads + threadIdx.x;
  if (bin > nb) return;
  const int b = blockIdx.y;
  a.starts[(int64_t)b * (nb + 1) + bin] =
      lower_bound(a.sorted_key + (int64_t)b * a.P, a.P, bin);
}

// A frame of at most kChunk patches: every pass and the starts in one
// CTA, the keys and patch indices in shared memory between passes.
__global__ void __launch_bounds__(kChunk)
    fb_merge_bin_kernel(const MergeArgs a, int passes) {
  __shared__ unsigned short whist[kWarps][kDigits];
  __shared__ int s_count[kDigits];
  __shared__ int s_total[kDigits / 32];
  __shared__ int s_key[kChunk], s_val[kChunk];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t f = (int64_t)b * a.P;
  const bool mine = t < a.P;
  int key = mine ? land_patch(a, b, t) : 0, val = t;
  for (int pass = 0; pass < passes; ++pass) {
    const int digit = mine ? digit_of(key, pass) : -1;
    const int rank = chunk_rank(digit, whist, s_count);
    // the counts' exclusive prefix over the digits (warps 0-7)
    int own = 0, x = 0;
    if (t < kDigits) {
      own = x = s_count[t];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) s_total[warp] = x;
    }
    __syncthreads();
    if (t < kDigits) {
      for (int v = 0; v < warp; ++v) x += s_total[v];
      s_count[t] = x - own;
    }
    __syncthreads();
    if (mine) {
      s_key[s_count[digit] + rank] = key;
      s_val[s_count[digit] + rank] = val;
    }
    __syncthreads();
    if (mine) {
      key = s_key[t];
      val = s_val[t];
    }
  }
  if (mine)   // every patch landed before the passes' first barrier
    put_sorted(a, b, t, val);
  const int nb = a.nbx * a.nby;
  for (int bin = t; bin <= nb; bin += kChunk)
    a.starts[(int64_t)b * (nb + 1) + bin] = lower_bound(s_key, a.P, bin);
}

// The contribution of sorted entry `at` of frame f (patch k, its pixel
// (j, i)) to its cell through corner c.
struct Hit {
  int k;  // the patch (of the frame): the order of the fold
  float v0, v1, v2;
};

__device__ __forceinline__ Hit contribution(const MergeArgs& a, int64_t f,
                                            int64_t at, int k, int i, int j,
                                            int c) {
  const float wt = pixel_weight(
      a.cost + (((f + k) * a.ps + j) * a.ps + i) * a.C, a.C, a.min_errval,
      a.use_sqrt);
  const float4 W = a.sorted_wb[f + at];
  const float wc = c == 0 ? W.x : c == 1 ? W.y : c == 2 ? W.z : W.w;
  const float2 uv = a.sorted_uv[f + at];
  return Hit{k, wc * wt, wc * (-uv.x * wt), wc * (-uv.y * wt)};
}

// Small frames: one warp, one cell.  Corner after corner, the members of
// the <= 2 x 2 bins whose landings reach the corner's position (their
// concatenation, 32 at a time: lane t takes the t-th) are tested in
// parallel, the hits' contributions computed in parallel and appended to
// a shared list; the list is then sorted by patch (a hit's place is the
// number of smaller patches in it, every patch being in one bin only)
// and every lane folds it in that order, so every lane holds the cell's
// sum.  A corner with more than kHits hits (a pile-up) is folded by a
// walk of the bins' lists in one merge instead, every lane alike.
__global__ void __launch_bounds__(kWarpThreads)
    fb_merge_warp_kernel(const MergeArgs a) {
  __shared__ Hit found[kWarpThreads / 32][kHits];
  __shared__ Hit ordered[kWarpThreads / 32][kHits];
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
    const int* starts = a.starts + (int64_t)b * (nb + 1);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int c = 0; c < 4; ++c) {
      const int ox = c & 1, oy = c >> 1;
      const int xt = x + ox, yt = y + oy;  // the pixel's place in the frame
      if (a.P == 0 || xt < 1 || yt < 1 || xt > a.w - 2 || yt > a.h - 2)
        continue;
      // landings reaching xt: bin columns xt / S .. (xt + ps - 1) / S
      const int bx0 = xt / a.S, by0 = yt / a.S;
      const bool two_x = (xt + ps - 1) / a.S > bx0;
      const bool two_y = (yt + ps - 1) / a.S > by0;
      int head[4], end[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int dx = l & 1, dy = l >> 1;
        const bool use = (dx == 0 || two_x) && (dy == 0 || two_y);
        const int bin = (by0 + dy) * a.nbx + bx0 + dx;
        head[l] = use ? starts[bin] : 0;
        end[l] = use ? starts[bin + 1] : 0;
      }
      const int c1 = end[0] - head[0];
      const int c2 = c1 + end[1] - head[1];
      const int c3 = c2 + end[2] - head[2];
      const int total = c3 + end[3] - head[3];
      int hits = 0;  // uniform
      for (int base = 0; base < total; base += 32) {
        const int t = base + lane;
        int k = 0, i = -1, j = -1, at = 0;
        if (t < total) {
          at = t < c1   ? head[0] + t
               : t < c2 ? head[1] + (t - c1)
               : t < c3 ? head[2] + (t - c2)
                        : head[3] + (t - c3);
          const int2 L = a.sorted_land[f + at];
          k = a.sorted[f + at];
          i = xt - lb - L.x;
          j = yt - lb - L.y;
        }
        const bool hit = i >= 0 && i < ps && j >= 0 && j < ps;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        const int slot = hits + __popc(mask & lower);
        if (hit && slot < kHits)
          found[wib][slot] = contribution(a, f, at, k, i, j, c);
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
      // a pile-up: walk the lists in one merge, their heads' patches in
      // registers (every index below is a compile-time one)
      int next[4];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        next[l] = head[l] < end[l] ? a.sorted[f + head[l]] : kNone;
      while (true) {  // the lists' patches in increasing order
        const int k = min(min(next[0], next[1]), min(next[2], next[3]));
        if (k == kNone) break;
        int at = 0;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (next[l] == k) {  // one list holds k: advance it
            at = head[l]++;
            next[l] = head[l] < end[l] ? a.sorted[f + head[l]] : kNone;
          }
        }
        const int2 L = a.sorted_land[f + at];
        const int i = xt - lb - L.x, j = yt - lb - L.y;
        if (i < 0 || i >= ps || j < 0 || j >= ps) continue;
        const Hit h = contribution(a, f, at, k, i, j, c);
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

// A CTA, a tile of S x S cells: (blockIdx.x, blockIdx.y) of frame
// blockIdx.z.  Its corners reach the (S + 1) x (S + 1) positions [tx S,
// tx S + S] x [ty S, ty S + S]; those within [1, w-2] x [1, h-2] are the
// reach.  The candidates, bins (tx, ty), (tx + 1, ty), (tx, ty + 1) and
// (tx + 1, ty + 1), go to shared memory in patch order (all at once, or
// kWindow patch indices at a time), with a mask word per 32 of them for
// each of the S + 1 columns and rows.  A position's hits are the set
// bits of (column mask & row mask); their densify weights go to shared
// memory position after position, each position's in patch order
// (kEntries at most at a time: the positions cut into runs that fit).
// Each thread then folds its cells corner after corner, a corner's hits
// read in order from its position's list.  Where one window and one run
// hold everything (all but pile-ups) the lists are built once for the
// four corners, else again for each corner.
__global__ void __launch_bounds__(kCellThreads)
    fb_merge_kernel(const MergeArgs a) {
  constexpr int kSide = kMaxTile + 1;
  __shared__ int s_beg[4], s_len[4];     // the bins' lists in the sort
  __shared__ int s_lo[4], s_off[5], s_next, s_cut, s_once;
  __shared__ int s_key[kWindow];         // the window, list after list
  __shared__ int2 s_land[kWindow];       // ... in patch order
  __shared__ int64_t s_base[kWindow];    // cost (/ C) of position (0, 0)
  __shared__ float s_wb[4][kWindow];
  __shared__ float2 s_uv[kWindow];
  __shared__ unsigned s_cols[kSide][kWords + 1];   // (+1: banks)
  __shared__ unsigned s_rows[kSide][kWords + 1];
  __shared__ int s_total[kCellThreads / 32];
  __shared__ int s_first[kSide * kSide + 1];   // a position's first hit
  __shared__ float s_w[kEntries];        // a run's hits: weight,
  __shared__ unsigned char s_cand[kEntries];   // candidate
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int S = a.S, ps = a.ps, lb = -((ps + 1) / 2);
  const int side = S + 1, n_pos = side * side;
  const int nb = a.nbx * a.nby;
  const int64_t f = (int64_t)b * a.P;
  const int x_lo = max(tx * S, 1), x_hi = min(tx * S + S, a.w - 2);
  const int y_lo = max(ty * S, 1), y_hi = min(ty * S + S, a.h - 2);
  if (t < 4) {
    const int bx = tx + (t & 1), by = ty + (t >> 1);
    int beg = 0, len = 0;
    if (a.P > 0 && bx < a.nbx && by < a.nby && x_lo <= x_hi &&
        y_lo <= y_hi) {
      const int* st = a.starts + (int64_t)b * (nb + 1) + by * a.nbx + bx;
      beg = st[0];
      len = st[1] - beg;
    }
    s_beg[t] = beg;
    s_len[t] = len;
  }
  __syncthreads();
  const int n = s_len[0] + s_len[1] + s_len[2] + s_len[3];
  const bool many = n > kWindow;
  float acc[kCells][3];
#pragma unroll
  for (int z = 0; z < kCells; ++z) acc[z][0] = acc[z][1] = acc[z][2] = 0.0f;
  bool once = false;   // the first corner's lists serve all four
  for (int c = 0; n > 0 && c < 4; ++c) {
    const int ox = c & 1, oy = c >> 1;
    int k0 = 0;   // many: the window is patches [k0, k0 + kWindow)
    while (true) {
      if (!once) {
        __syncthreads();   // the last window's readers are done
        if (t < 4) {
          int lo = 0, len = s_len[t];
          if (many) {
            const int* list = a.sorted + f + s_beg[t];
            lo = lower_bound(list, len, k0);
            const int hi = lower_bound(list, len, k0 + kWindow);
            s_lo[t] = lo;
            s_off[t + 1] = hi - lo;
            s_key[t] = hi < len ? list[hi] : kNone;   // scratch: next keys
          } else {
            s_lo[t] = 0;
            s_off[t + 1] = len;
          }
        }
        __syncthreads();
        if (t == 0) {
          s_off[0] = 0;
          for (int l = 0; l < 4; ++l) s_off[l + 1] += s_off[l];
          s_next = many ? min(min(s_key[0], s_key[1]), min(s_key[2], s_key[3]))
                        : kNone;
        }
        __syncthreads();
        // entry t of the window (list after list), loaded with its data;
        // its place in patch order is its place in its list plus the
        // smaller patch indices of the other three
        const int cnt = s_off[4];
        const int l = (t >= s_off[1]) + (t >= s_off[2]) + (t >= s_off[3]);
        int k = 0;
        int2 L = make_int2(0, 0);
        float4 W = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float2 UV = make_float2(0.0f, 0.0f);
        if (t < cnt) {
          const int64_t at = f + s_beg[l] + s_lo[l] + t - s_off[l];
          k = a.sorted[at];
          L = a.sorted_land[at];
          W = a.sorted_wb[at];
          UV = a.sorted_uv[at];
          s_key[t] = k;
        }
        __syncthreads();
        if (t < cnt) {
          int at = t - s_off[l];
          for (int o = 0; o < 4; ++o)
            if (o != l)
              at += lower_bound(s_key + s_off[o], s_off[o + 1] - s_off[o], k);
          s_land[at] = L;
          // the cost of the pixel at position (x, y) is s_base + y ps + x
          s_base[at] = ((f + k) * ps - (L.y + lb)) * ps - (L.x + lb);
          s_wb[0][at] = W.x;
          s_wb[1][at] = W.y;
          s_wb[2][at] = W.z;
          s_wb[3][at] = W.w;
          s_uv[at] = UV;
        }
        __syncthreads();
        // bit m of (column or row, word): candidate m's pixels cover it
        const int words = (cnt + 31) / 32;
        const int per_axis = side * words;
        for (int task = warp; task < 2 * per_axis;
             task += kCellThreads / 32) {
          const int axis = task >= per_axis;
          const int rest = task - axis * per_axis;
          const int pos = rest / words, wd = rest - pos * words;
          const int m = wd * 32 + lane;
          bool hit = false;
          if (m < cnt) {
            const int2 L2 = s_land[m];
            const int d =
                (axis ? ty : tx) * S + pos - lb - (axis ? L2.y : L2.x);
            hit = d >= 0 && d < ps;
          }
          const unsigned bits = __ballot_sync(0xffffffffu, hit);
          if (lane == 0) (axis ? s_rows : s_cols)[pos][wd] = bits;
        }
        __syncthreads();
        // each position's first hit: a scan of the reach's hit counts
        // (kPer positions a thread, in order)
        constexpr int kPer = (kSide * kSide + kCellThreads - 1) / kCellThreads;
        int hits[kPer], own = 0;
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const int p = t * kPer + v;
          const int px = p % side, py = p / side;
          const int X = tx * S + px, Y = ty * S + py;
          hits[v] = 0;
          if (p < n_pos && X >= x_lo && X <= x_hi && Y >= y_lo && Y <= y_hi)
            for (int wd = 0; wd < words; ++wd)
              hits[v] += __popc(s_cols[px][wd] & s_rows[py][wd]);
          own += hits[v];
        }
        int x = own;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (lane == 31) s_total[warp] = x;
        __syncthreads();
        for (int v = 0; v < warp; ++v) x += s_total[v];
        int run = x - own;
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const int p = t * kPer + v;
          if (p < n_pos) s_first[p] = run;
          run += hits[v];
        }
        if (t == kCellThreads - 1) s_first[n_pos] = x;
        if (t == 0) s_cut = 0;
        __syncthreads();
        if (t == 0)
          s_once = !many && s_first[n_pos] <= kEntries;   // after a sync
      }
      const int cnt = s_off[4];
      const int words = (cnt + 31) / 32;
      int p0 = 0;
      while (cnt > 0) {   // runs of positions whose hits fit s_w
        if (!once) {
          if (t == 0) {   // the longest run from p0 that fits
            int lo = p0 + 1, hi = n_pos;
            while (lo < hi) {
              const int mid = (lo + hi + 1) >> 1;
              if (s_first[mid] - s_first[p0] <= kEntries) lo = mid;
              else hi = mid - 1;
            }
            s_cut = lo;
          }
          __syncthreads();
          // each position's hits in patch order (a thread a position),
          // then their weights, a thread a contiguous share of the hits
          // (its first position by binary search), kBatch loads at a time
          const int p1 = s_cut, base = s_first[p0];
          const int total = s_first[p1] - base;
          for (int p = p0 + t; p < p1; p += kCellThreads) {
            const int px = p % side, py = p / side;
            const int e1 = s_first[p + 1] - base;
            int e = s_first[p] - base;
            for (int wd = 0; e < e1; ++wd) {
              unsigned bits = s_cols[px][wd] & s_rows[py][wd];
              for (; bits != 0u; bits &= bits - 1u)
                s_cand[e++] = (unsigned char)(wd * 32 + __ffs(bits) - 1);
            }
          }
          __syncthreads();
          const int share = (total + kCellThreads - 1) / kCellThreads;
          const int e_lo = min(total, t * share);
          const int e_hi = min(total, e_lo + share);
          int p = p0, hi = p1 - 1;   // the last position starting at or
          while (p < hi) {           // below e_lo
            const int mid = (p + hi + 1) >> 1;
            if (s_first[mid] - base <= e_lo) p = mid; else hi = mid - 1;
          }
          int px = p % side, py = p / side;   // then kept by steps
          for (int e = e_lo; e < e_hi; e += kBatch) {
            int64_t at[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              at[q] = -1;
              if (e + q >= e_hi) continue;
              while (e + q >= s_first[p + 1] - base) {
                ++p;
                if (++px == side) {
                  px = 0;
                  ++py;
                }
              }
              at[q] = (s_base[s_cand[e + q]] + (int64_t)(ty * S + py) * ps +
                       tx * S + px) * a.C;
            }
            if (a.C <= 3) {
              float ev[kBatch][3];
#pragma unroll
              for (int q = 0; q < kBatch; ++q) {
                const int64_t i = at[q] < 0 ? 0 : at[q];
                ev[q][0] = a.cost[i];
                ev[q][1] = a.C > 1 ? a.cost[i + 1] : 0.0f;
                ev[q][2] = a.C > 2 ? a.cost[i + 2] : 0.0f;
              }
#pragma unroll
              for (int q = 0; q < kBatch; ++q)
                if (at[q] >= 0)
                  s_w[e + q] = pixel_weight3(ev[q][0], ev[q][1], ev[q][2],
                                             a.C, a.min_errval, a.use_sqrt);
            } else {
#pragma unroll
              for (int q = 0; q < kBatch; ++q)
                if (at[q] >= 0)
                  s_w[e + q] = pixel_weight(a.cost + at[q], a.C,
                                            a.min_errval, a.use_sqrt);
            }
          }
          __syncthreads();
          if (c == 0 && p0 == 0 && k0 == 0) once = s_once;
        }
        const int p1 = s_cut, base = s_first[p0];
#pragma unroll
        for (int z = 0; z < kCells; ++z) {
          const int cell = t + z * kCellThreads;
          const int cyl = cell / S, cxl = cell - cyl * S;
          const int X = tx * S + cxl + ox, Y = ty * S + cyl + oy;
          const int p = (cyl + oy) * side + cxl + ox;
          if (cell >= S * S || X - ox >= a.w || Y - oy >= a.h || X < 1 ||
              X > a.w - 2 || Y < 1 || Y > a.h - 2 || p < p0 || p >= p1)
            continue;
          float a0 = acc[z][0], a1 = acc[z][1], a2 = acc[z][2];
          const int e1 = s_first[p + 1] - base;
#pragma unroll 4
          for (int e = s_first[p] - base; e < e1; ++e) {   // in patch order
            const int m = s_cand[e];
            const float wt = s_w[e];
            const float wc = s_wb[c][m];
            const float2 uv = s_uv[m];
            a0 = a0 + wc * wt;
            a1 = a1 + wc * (-uv.x * wt);
            a2 = a2 + wc * (-uv.y * wt);
          }
          acc[z][0] = a0;
          acc[z][1] = a1;
          acc[z][2] = a2;
        }
        p0 = p1;
        if (p0 >= n_pos) break;
        __syncthreads();   // the run's readers are done before the next
      }
      if (!many) break;
      k0 = s_next;   // read before any thread passes the next sync
      if (k0 == kNone) break;
    }
  }
#pragma unroll
  for (int z = 0; z < kCells; ++z) {
    const int cell = t + z * kCellThreads;
    const int cyl = cell / S, cxl = cell - cyl * S;
    const int x = tx * S + cxl, y = ty * S + cyl;
    if (cell < S * S && x < a.w && y < a.h) {
      float* o = a.out + (((int64_t)b * a.h + y) * a.w + x) * 3;
      o[0] = acc[z][0];
      o[1] = acc[z][1];
      o[2] = acc[z][2];
    }
  }
}

}  // namespace

// p [B, P, 2], cost [B, P, ps, ps, C] float32, contiguous; mid: frame b's
// [P, 2] at mid + b * mid_stride floats.  The plan (ops/cuda/fb_merge.py
// merge_plan): bins and tiles of S cells, nbx x nby bins a frame from
// landing cell X0 = Y0 = 1 - lb - ps, n_chunks sort chunks of kChunk
// patches, `passes` 8-bit digits; by_warp: a warp a cell, else a tile a
// CTA.  ints: the scratch of
// [B * (9 P + 256 n_chunks + nbx nby + 1)] int32 (land, sorted land, key
// 0, val 0, key 1, val 1, lrank, counts, starts), 8-byte aligned; wb:
// [B * P * 10] float32 (wb, sorted wb, sorted (u, v)), 16-byte aligned;
// out [B, h, w, 3].
extern "C" int fot_fb_merge(const void* p, const void* mid,
                            int64_t mid_stride, const void* cost, int B,
                            int P, int ps, int C, int h, int w,
                            float min_errval, int use_sqrt, int S, int nbx,
                            int nby, int n_chunks, int passes, int by_warp,
                            void* ints,
                            void* wb, void* out, void* stream) {
  if ((int64_t)B * h * w == 0) return 0;
  const int64_t nb = (int64_t)nbx * nby;
  if (ps < 1 || C < 1 || S < ps || S > kMaxTile || nbx < 1 || nby < 1 ||
      B > 65535 || n_chunks != (P + kChunk - 1) / kChunk ||
      n_chunks > 65535 || passes < 1 || passes > 3 ||
      nb >= ((int64_t)1 << (kDigitBits * passes)))
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
  a.X0 = 1 - lb - ps;
  a.Y0 = 1 - lb - ps;
  a.n_chunks = n_chunks;
  const int64_t BP = (int64_t)B * P;
  int* base = (int*)ints;
  a.land = (int2*)base;
  a.sorted_land = (int2*)(base + 2 * BP);
  a.key[0] = base + 4 * BP;
  a.val[0] = a.key[0] + BP;
  a.key[1] = a.val[0] + BP;
  a.val[1] = a.key[1] + BP;
  a.lrank = a.val[1] + BP;
  a.counts = a.lrank + BP;
  a.starts = a.counts + (int64_t)B * kDigits * n_chunks;
  a.sorted_key = a.key[passes & 1];
  a.sorted = a.val[passes & 1];
  a.wb = (float4*)wb;
  a.sorted_wb = a.wb + BP;
  a.sorted_uv = (float2*)(a.sorted_wb + BP);
  a.out = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (P > 0) {  // with no patch, the cells read no bin
    if (n_chunks == 1) {
      fb_merge_bin_kernel<<<B, kChunk, 0, s>>>(a, passes);
      err = (int)cudaGetLastError();
    } else {
      const dim3 chunks((unsigned)n_chunks, (unsigned)B);
      for (int pass = 0; err == 0 && pass < passes; ++pass) {
        fb_merge_bin_count_kernel<<<chunks, kChunk, 0, s>>>(a, pass);
        fb_merge_bin_scan_kernel<<<B, kChunk, 0, s>>>(a);
        fb_merge_bin_scatter_kernel<<<chunks, kChunk, 0, s>>>(
            a, pass, pass == passes - 1);
        err = (int)cudaGetLastError();
      }
      if (err == 0) {
        fb_merge_bin_start_kernel<<<
            dim3((unsigned)((nb + kStartThreads) / kStartThreads),
                 (unsigned)B),
            kStartThreads, 0, s>>>(a);
        err = (int)cudaGetLastError();
      }
    }
    if (err != 0) return err;
  }
  if (by_warp) {
    const int64_t per_block = kWarpThreads / 32;   // a warp a cell
    int64_t blocks = ((int64_t)B * h * w + per_block - 1) / per_block;
    if (blocks > 132 * 16) blocks = 132 * 16;      // grid-stride beyond
    fb_merge_warp_kernel<<<(unsigned)blocks, kWarpThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const unsigned tiles_x = (unsigned)((w + S - 1) / S);
  const unsigned tiles_y = (unsigned)((h + S - 1) / S);
  if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
  fb_merge_kernel<<<dim3(tiles_x, tiles_y, (unsigned)B), kCellThreads, 0,
                    s>>>(a);
  return (int)cudaGetLastError();
}
