// K2: one pyramid scale's whole Gauss-Newton patch solve (inverse search).
// Replaces the Pallas kernel flowonthego_tpu/ops/pallas/dis_gn.py
// (gn_scale_loop / _kernel).
//
// Bound: operations, far below the card's rate.  Op 4's scale 1 (12,825
// patches of 12x12x3 values, 128 iterations) needs ~8.7 GFLOP and ~91 MB,
// 0.13 ms at the card's float32 peak; an op-2 scale (32-510 patches, 12
// iterations) needs microseconds and is a chain of dependent iterations.
// What a kernel pays for beyond that is the SMs' issue rate, barriers and
// the L1 wavefronts of its tap loads, so the design spends as little of
// each per patch-iteration (a trip) as it can.
//
// Design: one warp per patch.
//   * Lane l owns values l, l + 32, l + 64, ... of the patch's ps*ps*C
//     values (flat, row-major).  Their template value T, gradients gx, gy
//     and the four taps of their window stay in registers for the whole
//     solve: the kernel is instantiated for (ps, C) in {8, 12} x {1, 3},
//     where the count per lane (2, 6, 5, 14) is a compile-time constant;
//     the last is ragged (432 = 13*32 + 16), and a lane without a value
//     holds zeros.
//   * The stride-32 ownership makes each tap load of a warp 32 neighbouring
//     addresses of one window row (two rows where a patch row ends inside
//     it): 2-3 L1 wavefronts a load.  A contiguous run per lane would let
//     a lane reuse taps along its run, but its loads would touch ~20 lines
//     each (one per patch row), and the L1 wavefronts would bound the
//     kernel (~56 loads x 20 lines x 1.6M patch-iterations is ~8 ms of L1
//     time over 132 SMs).
//   * Taps are reloaded only when the window moves.  A trip's window origin
//     (wrap once, clamp) changes only where floor(mid + p) crosses a whole
//     pixel; otherwise only the four bilinear weights change.  Loading four
//     taps a value every trip (56 loads at ps 12, C = 3: ~150 wavefronts,
//     about one a clock from an SM's L1) held a trip at ~175 SM-cycles, and
//     op 4 runs all 128 trips with sub-pixel steps after the first few.  So
//     each lane keeps its values' taps, the warp the origin they came from;
//     a trip whose origin is that one loads nothing and blends the held
//     taps, any other reloads all of them (the test is uniform over the
//     warp, so the branch does not diverge).  The final cost pass follows
//     the same rule.  The blend, the sums and the step are the same
//     operations on the same operands in the same order, so the results are
//     bit for bit those of loading every trip.  On an H100 (700 W) 90-92% of
//     op 4's trips reload nothing; K2 at op 4's scale 1 went from 1.03 to
//     0.73 ms.  A reused trip is now bound by issue: ~330 instructions
//     (SASS of ps 12, C = 3: 84 FMUL and 99 FADD of blend and sums, 15
//     shuffles, the three divisions and the square root of the step) at
//     four an SM-clock, ~82 cycles, of the ~118 measured; a reload adds 56
//     loads and ~220 integer instructions of their offsets, recomputed from
//     the value index rather than held (14 registers less).
//   * Registers: ps 12, C = 3 holds 98 of per-value state (T, gx, gy, 56
//     taps) and takes 168 registers at 12 warps an SM (__launch_bounds__
//     (32, 12)), no spill; at 16 warps (128) it spills 72 bytes.  Reading
//     T where it is used instead (the sums before the loop, the final
//     cost) spills 52-60 bytes at 16 warps and ran no faster than this
//     form, and at 12 warps 4% slower (H100): the trip is not waiting for
//     warps.  The other forms fit 16 warps (64-113 registers).
//   * The window origin (wrap once, clamp), the fractional offsets and the
//     four bilinear weights are uniform over the patch and are computed
//     once per warp-iteration.
//   * The three sums of an iteration (S, gx.S, gy.S) are a per-lane
//     partial in value order, then one xor butterfly of shuffles each,
//     after which every lane holds the same bits.  So the 2x2 step, the
//     outlier test and the early break are uniform per warp with no
//     broadcast, no shared memory and no __syncthreads() in the loop; a
//     patch that resets and stops frees its own warp only.
//   * One patch a CTA, so a CTA is one warp: an op-2 scale's 32-510
//     patches spread over all SMs.  Two, four or eight patches a CTA, and
//     fewer registers for more resident warps, were tried on an H100 and
//     made nothing faster, so the simplest form stays.  A patch's
//     arithmetic does not depend on where in the launch it runs, so a
//     frame of a batch equals its own launch bit for bit.
//   * Any other (ps, C) with up to 1024 values takes the generic form of
//     the same kernel body: run-time loops, the per-value state (T, gx,
//     gy and the held taps) in shared memory (a [7][values] slab, index
//     k*32 + lane, free of bank conflicts) instead of registers.
//   * Counting (tracing's): with a counts pointer, lane 0 of patch p adds
//     its trips (the final cost pass is one; none if not started) and its
//     window loads to row p, so the buffer holds at least a row a patch
//     (tracing's has more rows than any launch in the benchmark); without
//     one nothing more runs.  Rows do not wrap: a modulo or a mask on p
//     here slowed the bf16 ps 12, C = 3 form by 6.6% on an H100 and moved
//     other forms' registers.
//
// Batch: B frames are one launch over B*P patches; patch k solves patch
// k % P of frame k / P and reads that frame's padded level image.
//
// Strip offset (dis_gn_strip_kernel): the row-sharded and tile-sharded
// forms (parallel/spatial_fine.py, spatial_tile2d.py) hand a shard's
// patches a level image that is only the shard's strip or tile with its
// halo, and a sample offset (off_x, off_y) that maps a global midpoint
// into it.  Sampling reads at (mid_org + p) + offset, in that order of
// additions; the window start, its wrap and its clamp apply to that
// position, and the outlier norm and the midpoint box stay in global
// coordinates.  In the JAX package this path reaches no Pallas kernel: a
// sample_offset sends ops/dis.py's solve to XLA's general gather loop
// (dis.py:458-465, 605-612; env_ok is false), whose function this is.
// The offset is a second __global__ entry over the same body, so the
// kernel of the unsharded path is the code it was, and a profile tells
// the two apart by name.
//
// bf16 operands (the Pallas kernel's form, dis_gn.py:90-94): with
// Load = __nv_bfloat16 the level image, template and gradients are read as
// bf16 and upcast on load; every blend, reduction and carry stays float32.
// The projection's constant sums (gx, gy, gx*T, gy*T) then come in as
// float32 inputs, reduced from the float32 state outside (as the JAX
// package computes them, ops/dis.py:439-444); in float32 the kernel
// reduces them itself from the values it loaded, which are that state.
//
// Semantics of flowonthego_tpu/ops/dis.py (the XLA reduction form):
//   * window start = floor(mid) + padding - ps/2, wrapped once if negative
//     and clamped to [0, Hp-K] like lax.dynamic_slice;
//   * a patch not started (frozen at warm start) keeps p_cur, cost 0;
//   * a step beyond the outlier radius or out of the midpoint box resets
//     the patch to p_org and stops it; its final cost is sampled at p_org —
//     iteration 1's position when p_cur == p_org, hence iteration 1's cost;
//   * the final per-pixel cost is ((S - mean S) - T)^2 at the final p.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 48 * 1024;

struct GnArgs {
  const void* I1;
  const void* tmpl;
  const void* tgx;
  const void* tgy;
  const float* sums;
  const float* H;
  const float* mid;
  const float* pcur;
  const float* porg;
  const uint8_t* started;
  float* p_out;
  float* cost_out;
  int* counts;  // [count_rows, 2] trips and window loads, or null
  // unread here; without it in the arguments ptxas gives several forms
  // more registers and K2 runs up to 1% slower (H100)
  int count_rows;
  int n_patches, P, Hp, Wp, C, ps, padding, n_iters;
  float thresh, l_bound, ub_w, ub_h, mean_on;
  float off_x, off_y;  // the strip offset (dis_gn_strip_kernel only)
};

// Every lane receives the same bits: partners add the same two values.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One warp, one patch: CTA p solves patch p of the batch.  PS > 0: ps = PS
// and C = CH at compile time, the per-value state in registers; PS == 0:
// the generic form, ps and C from the arguments, the state in dynamic
// shared memory.  STRIP: sample at (mid + p) + (off_x, off_y).
template <typename Load, int PS, int CH, bool STRIP>
__device__ __forceinline__ void gn_body(const GnArgs& a) {
  constexpr bool kFixed = PS > 0;
  constexpr int kV = kFixed ? (PS * PS * CH + 31) / 32 : 1;
  extern __shared__ float slab[];
  const int lane = threadIdx.x;
  const int p = blockIdx.x;  // patch of the batch

  const int ps = kFixed ? PS : a.ps;
  const int C = kFixed ? CH : a.C;
  const int psC = ps * C;
  const int N = ps * psC;
  const int nv = kFixed ? kV : (N + 31) / 32;  // values per lane
  const int64_t base = (int64_t)p * N;
  const int rs = a.Wp * C;  // image row stride in values
  const Load* I1 = (const Load*)a.I1 + (int64_t)(p / a.P) * a.Hp * rs;
  const Load* tmpl = (const Load*)a.tmpl + base;
  const Load* tgx = (const Load*)a.tgx + base;
  const Load* tgy = (const Load*)a.tgy + base;
  float* cost_out = a.cost_out + base;

  if (!a.started[p]) {  // uniform across the warp
    if (lane == 0) {
      a.p_out[2 * p] = a.pcur[2 * p];
      a.p_out[2 * p + 1] = a.pcur[2 * p + 1];
    }
    for (int t = lane; t < N; t += 32) cost_out[t] = 0.0f;
    return;
  }

  // Per-value state: T, gx, gy, and the four taps of the value's window
  // (top left, top right, bottom left, bottom right) as last loaded.
  float rT[kV], rGX[kV], rGY[kV], rTap[4][kV];
  float* const sT = slab;
  float* const sGX = sT + nv * 32;
  float* const sGY = sGX + nv * 32;
  float* const sTap = sGY + nv * 32;  // [4][nv * 32]
  auto T = [&](int k) -> float& {
    if constexpr (kFixed) return rT[k]; else return sT[k * 32 + lane];
  };
  auto GX = [&](int k) -> float& {
    if constexpr (kFixed) return rGX[k]; else return sGX[k * 32 + lane];
  };
  auto GY = [&](int k) -> float& {
    if constexpr (kFixed) return rGY[k]; else return sGY[k * 32 + lane];
  };
  auto TAP = [&](int j, int k) -> float& {
    if constexpr (kFixed) return rTap[j][k];
    else return sTap[(j * nv + k) * 32 + lane];
  };

#pragma unroll
  for (int k = 0; k < nv; ++k) {
    const int t = k * 32 + lane;
    const bool live = t < N;
    T(k) = live ? to_f32(tmpl[t]) : 0.0f;
    GX(k) = live ? to_f32(tgx[t]) : 0.0f;
    GY(k) = live ? to_f32(tgy[t]) : 0.0f;
  }

  float gx_sum, gy_sum, gxT, gyT;
  if (a.sums != nullptr) {  // uniform: the bf16 mode's float32 sums
    gx_sum = a.sums[4 * p];
    gy_sum = a.sums[4 * p + 1];
    gxT = a.sums[4 * p + 2];
    gyT = a.sums[4 * p + 3];
  } else {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
#pragma unroll
    for (int k = 0; k < nv; ++k) {
      c0 += GX(k);
      c1 += GY(k);
      c2 += GX(k) * T(k);
      c3 += GY(k) * T(k);
    }
    gx_sum = warp_sum(c0);
    gy_sum = warp_sum(c1);
    gxT = warp_sum(c2);
    gyT = warp_sum(c3);
  }
  const float h00 = a.H[3 * p], h01 = a.H[3 * p + 1], h11 = a.H[3 * p + 2];
  const float det = h00 * h11 - h01 * h01;
  const float mx0 = a.mid[2 * p], my0 = a.mid[2 * p + 1];
  const float p0x = a.porg[2 * p], p0y = a.porg[2 * p + 1];
  const float n_vals = (float)N;
  const int K = ps + 1;
  const int off = a.padding - ps / 2;
  const int last_live = N - (nv - 1) * 32;  // lanes with a value at k = nv-1

  // The window of the patch at displacement (px, py): its origin in the
  // level image and the four bilinear weights, once for the whole warp.
  // Where the origin is the one the held taps came from, the trip loads
  // nothing; else every lane reloads its taps from the new origin (the
  // test is uniform: the window is the patch's).
  const Load* win;
  const Load* held = nullptr;  // the origin of the held taps
  float w_tl, w_tr, w_bl, w_br;
  int trips = 0, loads = 0;
  auto window = [&](float px, float py) {
    float mx = mx0 + px, my = my0 + py;
    if constexpr (STRIP) {
      mx = mx + a.off_x;
      my = my + a.off_y;
    }
    const float fx = floorf(mx), fy = floorf(my);
    const float rx = mx - fx, ry = my - fy;
    int sy = (int)fy + off, sx = (int)fx + off;
    if (sy < 0) sy += a.Hp;
    if (sx < 0) sx += a.Wp;
    sy = min(max(sy, 0), a.Hp - K);
    sx = min(max(sx, 0), a.Wp - K);
    win = I1 + (int64_t)sy * rs + sx * C;
    w_tl = (1.0f - rx) * (1.0f - ry);
    w_tr = rx * (1.0f - ry);
    w_bl = (1.0f - rx) * ry;
    w_br = rx * ry;
    ++trips;
    if (win != held) {
      held = win;
      ++loads;
#pragma unroll
      for (int k = 0; k < nv; ++k) {  // value t sits at (t / psC, t % psC)
        const int t = k * 32 + lane;
        const int r = t < N ? t / psC : 0;
        const Load* q = win + (t < N ? r * rs + (t - r * psC) : 0);
        TAP(0, k) = to_f32(q[0]);
        TAP(1, k) = to_f32(q[C]);
        TAP(2, k) = to_f32(q[rs]);
        TAP(3, k) = to_f32(q[rs + C]);
      }
    }
  };
  // This lane's k-th bilinear sample (0 where it has no k-th value).
  auto sample = [&](int k) -> float {
    const float S = ((w_tl * TAP(0, k) + w_tr * TAP(1, k)) +
                     w_bl * TAP(2, k)) +
                    w_br * TAP(3, k);
    return (k < nv - 1 || lane < last_live) ? S : 0.0f;
  };

  float px = a.pcur[2 * p], py = a.pcur[2 * p + 1];
  for (int it = 0; it < a.n_iters; ++it) {
    window(px, py);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < nv; ++k) {
      const float S = sample(k);
      s0 += S;
      s1 += S * GX(k);
      s2 += S * GY(k);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float m = s0 / n_vals * a.mean_on;
    const float dpx = s1 - m * gx_sum - gxT;
    const float dpy = s2 - m * gy_sum - gyT;
    const float delta_px = (h11 * dpx - h01 * dpy) / det;
    const float delta_py = (h00 * dpy - h01 * dpx) / det;
    const float nx = px - delta_px, ny = py - delta_py;
    const float mxn = mx0 + nx, myn = my0 + ny;
    const float ddx = mxn - mx0, ddy = myn - my0;
    const float norm = sqrtf(ddx * ddx + ddy * ddy);
    const bool outlier = norm > a.thresh || mxn < a.l_bound ||
                         myn < a.l_bound || mxn > a.ub_w || myn > a.ub_h;
    if (outlier) {  // uniform: every lane holds the same totals
      px = p0x;
      py = p0y;
      break;
    }
    px = nx;
    py = ny;
  }

  // The per-pixel cost at the final p; the samples take gx's place.
  window(px, py);
  float tot = 0.0f;
#pragma unroll
  for (int k = 0; k < nv; ++k) {
    const float S = sample(k);
    GX(k) = S;
    tot += S;
  }
  const float m = warp_sum(tot) / n_vals * a.mean_on;
#pragma unroll
  for (int k = 0; k < nv; ++k) {
    const int t = k * 32 + lane;
    const float d = (GX(k) - m) - T(k);
    if (t < N) cost_out[t] = d * d;
  }
  if (lane == 0) {
    a.p_out[2 * p] = px;
    a.p_out[2 * p + 1] = py;
    if (a.counts != nullptr) {
      int* row = a.counts + 2 * p;
      atomicAdd(row, trips);
      atomicAdd(row + 1, loads);
    }
  }
}

// Resident warps an SM the launch bounds ask for: 16 (128 registers a
// thread) where the per-value state fits, 12 (168) for the 14 values a
// lane of ps 12, C = 3 (T, gx, gy and four taps each: 98 registers).
template <int PS, int CH>
constexpr int kMinWarps = PS * PS * CH > 384 ? 12 : 16;

template <typename Load, int PS, int CH>
__global__ void __launch_bounds__(32, kMinWarps<PS, CH>)
    dis_gn_kernel(const GnArgs a) {
  gn_body<Load, PS, CH, false>(a);
}

template <typename Load, int PS, int CH>
__global__ void __launch_bounds__(32, kMinWarps<PS, CH>)
    dis_gn_strip_kernel(const GnArgs a) {
  gn_body<Load, PS, CH, true>(a);
}

template <typename Load, int PS, int CH>
int launch(const GnArgs& a, bool offset, cudaStream_t stream) {
  size_t shared = 0;
  if (PS == 0) {  // the generic form's slab: [7][values per lane * 32]
    shared = (size_t)7 * ((a.ps * a.ps * a.C + 31) / 32) * 32 * sizeof(float);
    if (shared > (size_t)kMaxSharedBytes)
      return (int)cudaErrorInvalidConfiguration;
  }
  if (offset)
    dis_gn_strip_kernel<Load, PS, CH><<<a.n_patches, 32, shared, stream>>>(a);
  else
    dis_gn_kernel<Load, PS, CH><<<a.n_patches, 32, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Load>
int dispatch(const GnArgs& a, bool offset, cudaStream_t stream) {
  if (a.ps == 8 && a.C == 1) return launch<Load, 8, 1>(a, offset, stream);
  if (a.ps == 8 && a.C == 3) return launch<Load, 8, 3>(a, offset, stream);
  if (a.ps == 12 && a.C == 1) return launch<Load, 12, 1>(a, offset, stream);
  if (a.ps == 12 && a.C == 3) return launch<Load, 12, 3>(a, offset, stream);
  return launch<Load, 0, 0>(a, offset, stream);
}

}  // namespace

// bf16 != 0: I1, tmpl, tgx, tgy are __nv_bfloat16 and sums ([B*P, 4]
// float32) is required; else they are float32 and sums is ignored.
// offset != 0: the strip kernel, sampling at (mid + p) + (off_x, off_y).
// counts ([count_rows, 2] int32, count_rows >= B*P, or null): patch p adds
// its trips (the final cost pass is one) and its window loads to row p.
extern "C" int fot_dis_gn(const void* I1, int bf16, int B, int Hp, int Wp,
                          int C, const void* tmpl, const void* tgx,
                          const void* tgy, const void* sums, const void* H,
                          const void* mid, const void* pcur, const void* porg,
                          const void* started, int P, int ps, int padding,
                          int n_iters, float thresh, float l_bound,
                          float ub_w, float ub_h, float mean_on, int offset,
                          float off_x, float off_y, void* p_out,
                          void* cost_out, void* counts, int count_rows,
                          void* stream) {
  const long long n_patches = (long long)B * P;
  if (n_patches == 0) return 0;
  if (n_patches > 0x7fffffffLL || ps < 1 || C < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (bf16 && sums == nullptr) return (int)cudaErrorInvalidValue;
  if (counts != nullptr && count_rows < n_patches)
    return (int)cudaErrorInvalidValue;
  GnArgs a;
  a.I1 = I1;
  a.tmpl = tmpl;
  a.tgx = tgx;
  a.tgy = tgy;
  a.sums = bf16 ? (const float*)sums : nullptr;
  a.H = (const float*)H;
  a.mid = (const float*)mid;
  a.pcur = (const float*)pcur;
  a.porg = (const float*)porg;
  a.started = (const uint8_t*)started;
  a.p_out = (float*)p_out;
  a.cost_out = (float*)cost_out;
  a.counts = (int*)counts;
  a.count_rows = count_rows;
  a.n_patches = (int)n_patches;
  a.P = P;
  a.Hp = Hp;
  a.Wp = Wp;
  a.C = C;
  a.ps = ps;
  a.padding = padding;
  a.n_iters = n_iters;
  a.thresh = thresh;
  a.l_bound = l_bound;
  a.ub_w = ub_w;
  a.ub_h = ub_h;
  a.mean_on = mean_on;
  a.off_x = off_x;
  a.off_y = off_y;
  return bf16 ? dispatch<__nv_bfloat16>(a, offset != 0, (cudaStream_t)stream)
              : dispatch<float>(a, offset != 0, (cudaStream_t)stream);
}
