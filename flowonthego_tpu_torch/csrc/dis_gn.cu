// K2: one pyramid scale's whole Gauss-Newton patch solve (inverse search).
// Replaces the Pallas kernel flowonthego_tpu/ops/pallas/dis_gn.py
// (gn_scale_loop / _kernel).
//
// One CTA per patch, one thread per template value (ps*ps*C = 192 at op 2;
// the block is rounded up to whole warps).  Each thread keeps its template
// value T and gradients gx, gy in registers.  Per iteration it reads its
// four bilinear taps straight from the padded level image in device
// memory (a (ps+1)^2*C window, L1/L2-resident), blends them, and the block
// reduces sum S, sum gx*S, sum gy*S with warp shuffles and one shared-
// memory pass.  Every thread then computes the same 2x2 Gauss-Newton step
// and the same outlier/bounds test from the same totals, so the patch's
// state stays uniform across the block without a broadcast.
//
// Bound: latency.  An op-2 scale has 32-510 patches and 12 dependent
// iterations of a few hundred loads and one block reduction each; the
// TPU's envelopes, band pairs and radix shift selects existed because the
// TPU has no gather, and are not carried over.
//
// Batch: B frames are one launch of B*P CTAs; CTA blk solves patch blk % P
// of frame blk / P and reads that frame's padded level image.  Every
// per-patch array is indexed by blk, so nothing else changes.
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

constexpr int kMaxWarps = 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of NV values; every thread receives the same totals
// (lane 0's warp partials, summed in warp order by every thread).
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV],
                                          float (*smem)[kMaxWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();  // the previous call's readers are done with smem
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) smem[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s = 0.0f;
    for (int q = 0; q < n_warps; ++q) s += smem[k][q];
    v[k] = s;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One CTA per patch of the batch; Load is float or __nv_bfloat16.
template <typename Load>
__global__ void dis_gn_kernel(
    const Load* __restrict__ I1, int Hp, int Wp, int C,
    const Load* __restrict__ tmpl, const Load* __restrict__ tgx,
    const Load* __restrict__ tgy, const float* __restrict__ sums_in,
    const float* __restrict__ H, const float* __restrict__ mid,
    const float* __restrict__ pcur, const float* __restrict__ porg,
    const uint8_t* __restrict__ started, int P, int ps, int padding,
    int n_iters, float thresh, float l_bound, float ub_w, float ub_h,
    float mean_on, float* __restrict__ p_out, float* __restrict__ cost_out) {
  __shared__ float red[4][kMaxWarps];
  const int p = blockIdx.x;  // patch of the batch: frame p / P
  const int t = threadIdx.x;
  const int psC = ps * C;
  const int N = ps * psC;
  const bool live = t < N;
  const int64_t base = (int64_t)p * N;
  I1 += (int64_t)(p / P) * Hp * Wp * C;

  if (!started[p]) {  // uniform across the block
    if (t == 0) {
      p_out[2 * p] = pcur[2 * p];
      p_out[2 * p + 1] = pcur[2 * p + 1];
    }
    if (live) cost_out[base + t] = 0.0f;
    return;
  }

  int r = 0, c = 0, ch = 0;
  if (live) {
    r = t / psC;
    const int rem = t - r * psC;
    c = rem / C;
    ch = rem - c * C;
  }
  const float T = live ? to_f32(tmpl[base + t]) : 0.0f;
  const float GX = live ? to_f32(tgx[base + t]) : 0.0f;
  const float GY = live ? to_f32(tgy[base + t]) : 0.0f;

  float sums[4];
  if (sums_in != nullptr) {  // uniform: the bf16 mode's float32 sums
#pragma unroll
    for (int k = 0; k < 4; ++k) sums[k] = sums_in[4 * p + k];
  } else {
    sums[0] = GX;
    sums[1] = GY;
    sums[2] = GX * T;
    sums[3] = GY * T;
    block_sum<4>(sums, red);
  }
  const float gx_sum = sums[0], gy_sum = sums[1], gxT = sums[2], gyT = sums[3];
  const float h00 = H[3 * p], h01 = H[3 * p + 1], h11 = H[3 * p + 2];
  const float det = h00 * h11 - h01 * h01;
  const float mx0 = mid[2 * p], my0 = mid[2 * p + 1];
  const float p0x = porg[2 * p], p0y = porg[2 * p + 1];
  const float n_vals = (float)N;
  const int K = ps + 1;
  const int off = padding - ps / 2;
  const int64_t row_stride = (int64_t)Wp * C;

  // This thread's bilinear sample of the patch at displacement (px, py).
  auto sample = [&](float px, float py) -> float {
    const float mx = mx0 + px, my = my0 + py;
    const float fx = floorf(mx), fy = floorf(my);
    const float rx = mx - fx, ry = my - fy;
    int sy = (int)fy + off, sx = (int)fx + off;
    if (sy < 0) sy += Hp;
    if (sx < 0) sx += Wp;
    sy = min(max(sy, 0), Hp - K);
    sx = min(max(sx, 0), Wp - K);
    if (!live) return 0.0f;
    const Load* q = I1 + (int64_t)(sy + r) * row_stride + (int64_t)(sx + c) * C + ch;
    const float w_tl = (1.0f - rx) * (1.0f - ry);
    const float w_tr = rx * (1.0f - ry);
    const float w_bl = (1.0f - rx) * ry;
    const float w_br = rx * ry;
    return ((w_tl * to_f32(q[0]) + w_tr * to_f32(q[C])) +
            w_bl * to_f32(q[row_stride])) +
           w_br * to_f32(q[row_stride + C]);
  };

  float px = pcur[2 * p], py = pcur[2 * p + 1];
  for (int it = 0; it < n_iters; ++it) {
    const float S = sample(px, py);
    float red3[3] = {S, S * GX, S * GY};
    block_sum<3>(red3, red);
    const float m = red3[0] / n_vals * mean_on;
    const float dpx = red3[1] - m * gx_sum - gxT;
    const float dpy = red3[2] - m * gy_sum - gyT;
    const float delta_px = (h11 * dpx - h01 * dpy) / det;
    const float delta_py = (h00 * dpy - h01 * dpx) / det;
    const float nx = px - delta_px, ny = py - delta_py;
    const float mxn = mx0 + nx, myn = my0 + ny;
    const float ddx = mxn - mx0, ddy = myn - my0;
    const float norm = sqrtf(ddx * ddx + ddy * ddy);
    const bool outlier = norm > thresh || mxn < l_bound || myn < l_bound ||
                         mxn > ub_w || myn > ub_h;
    if (outlier) {  // uniform: every thread saw the same totals
      px = p0x;
      py = p0y;
      break;
    }
    px = nx;
    py = ny;
  }

  const float S = sample(px, py);
  float tot[1] = {S};
  block_sum<1>(tot, red);
  const float m = tot[0] / n_vals * mean_on;
  if (live) {
    const float d = (S - m) - T;
    cost_out[base + t] = d * d;
  }
  if (t == 0) {
    p_out[2 * p] = px;
    p_out[2 * p + 1] = py;
  }
}

template <typename Load>
void launch(const void* I1, int Hp, int Wp, int C, const void* tmpl,
            const void* tgx, const void* tgy, const void* sums,
            const void* H, const void* mid, const void* pcur,
            const void* porg, const void* started, int n_blocks, int P,
            int ps, int padding, int n_iters, float thresh, float l_bound,
            float ub_w, float ub_h, float mean_on, void* p_out,
            void* cost_out, int threads, cudaStream_t stream) {
  dis_gn_kernel<Load><<<n_blocks, threads, 0, stream>>>(
      (const Load*)I1, Hp, Wp, C, (const Load*)tmpl, (const Load*)tgx,
      (const Load*)tgy, (const float*)sums, (const float*)H,
      (const float*)mid, (const float*)pcur, (const float*)porg,
      (const uint8_t*)started, P, ps, padding, n_iters, thresh, l_bound,
      ub_w, ub_h, mean_on, (float*)p_out, (float*)cost_out);
}

}  // namespace

// bf16 != 0: I1, tmpl, tgx, tgy are __nv_bfloat16 and sums ([B*P, 4]
// float32) is required; else they are float32 and sums is ignored.
extern "C" int fot_dis_gn(const void* I1, int bf16, int B, int Hp, int Wp,
                          int C, const void* tmpl, const void* tgx,
                          const void* tgy, const void* sums, const void* H,
                          const void* mid, const void* pcur, const void* porg,
                          const void* started, int P, int ps, int padding,
                          int n_iters, float thresh, float l_bound,
                          float ub_w, float ub_h, float mean_on, void* p_out,
                          void* cost_out, void* stream) {
  const int N = ps * ps * C;
  const int threads = ((N + 31) / 32) * 32;
  const long long n_blocks = (long long)B * P;
  if (n_blocks == 0) return 0;
  if (threads > 1024 || n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (bf16 && sums == nullptr) return (int)cudaErrorInvalidValue;
  if (bf16)
    launch<__nv_bfloat16>(I1, Hp, Wp, C, tmpl, tgx, tgy, sums, H, mid, pcur,
                          porg, started, (int)n_blocks, P, ps, padding,
                          n_iters, thresh, l_bound, ub_w, ub_h, mean_on,
                          p_out, cost_out, threads, (cudaStream_t)stream);
  else
    launch<float>(I1, Hp, Wp, C, tmpl, tgx, tgy, nullptr, H, mid, pcur, porg,
                  started, (int)n_blocks, P, ps, padding, n_iters, thresh,
                  l_bound, ub_w, ub_h, mean_on, p_out, cost_out, threads,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
