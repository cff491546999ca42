// G3: patch-to-dense flow aggregation of one scale.  Replaces the XLA
// fusions of flowonthego_tpu/ops/densify.py densify (_pixel_weights, the
// overlap-add canvas, the clip and the normalisation); the JAX package
// has no Pallas kernel for it.
//
// Each patch pixel carries the weight w = 1 / sum_c max(min_errval, e_c)
// (e_c its squared residual, or the square root of it) and adds (w, w*u,
// w*v) to the one image pixel it covers; each pixel's flow is the
// weighted mean, 0 where no weight landed.  Patch origins are static
// grid midpoints, so with steps-periodic coordinates Y = Yq*steps + pr
// on the canvas, pixel Y gets the patch rows j = Yq - m at patch row
// py = m*steps + pr, m < r = ceil(ps / steps), and likewise along x.
//
// Order: the plain version's canvas sums the shifted planes over m, then
// over q, with zero planes where a shift has no patch, so each pixel
// folds its r^2 values in that order, the zeros included (x + 0.0 is not
// x for x = -0.0; without fast math the compiler keeps those adds).  The
// channel sum of the weight takes PyTorch's CUDA reduction order over a
// last dim of three floats: (e0 + e2) + e1.  So on the card the kernel
// equals the plain version bit for bit.  The forward-backward merge's
// accumulator (G5, fb_merge.cu) comes in as `add` and is added to the
// canvas before the normalisation, as in the plain version.
//
// Bound: bytes (the per-pixel costs read once, the flow written once;
// each cost value lands on exactly one pixel).  Design: the output rows
// Yq*steps .. Yq*steps + steps - 1 (a band) read, from patch row j = Yq -
// m, exactly its rows [m*steps, (m+1)*steps): contiguous runs of the
// [ps, ps, C] costs, so every cost value belongs to one band.  A CTA
// takes one band and a chunk of nc patch columns (plus r - 1 columns of
// halo on the left, read again by the neighbouring chunk, mostly from
// L2): consecutive threads read consecutive pixels of a run, each thread
// the same pixel of kBatch runs with their loads issued together, and
// each patch pixel's (w, w*u, w*v) goes once into shared memory, laid
// out [m][pr][q][column][qc] so that the fold's reads by consecutive
// output pixels are consecutive words; then each thread folds its output
// pixel from shared memory and stores a float2.  Why not simpler: a
// thread an output pixel gathering straight from the costs touches ~11
// patches a warp a gather, half of each sector used, and the
// neighbouring rows fetch the other half again.  The band and chunk plan
// is ops/cuda/densify.py densify_plan (a small level gets narrow chunks,
// so more CTAs: its time is the latency of a CTA's rounds of loads);
// above 48 KB a CTA's shared memory is opt-in (set once per device and
// instantiation).

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_weight.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;   // slots whose loads a thread issues together

struct DensifyArgs {
  const float* p;      // [B, n_h, n_w, 2]
  const float* cost;   // [B, n_h, n_w, ps, ps, C]
  const float* add;    // null or [B, h, w, 3]
  float* out;          // [B, h, w, 2]
  int h, w, C, ps, steps, n_h, n_w;
  int oy, ox;          // image (y, x) = canvas (Y, X) + (oy, ox)
  int yq0, xq0;        // the first band's Yq, the first chunk's first Xq
  int nc;              // Xq columns of a chunk
  float min_errval;
  int use_sqrt;
};

// PS, ST, C: compile-time ps, steps and channels, or 0 for the generic
// instantiation, which reads them from the arguments.
template <int PS, int ST, int CC>
__global__ void __launch_bounds__(kThreads)
    glue_densify_kernel(const DensifyArgs a) {
  extern __shared__ float smem[];
  const int ps = PS ? PS : a.ps;
  const int st = ST ? ST : a.steps;
  const int C = CC ? CC : a.C;
  const int nc = a.nc;
  const int r = (ps + st - 1) / st;
  const int R = r * st;                 // px slots of a patch row
  const int nci = nc + r - 1;           // patch columns staged
  const int L = st * R;                 // slots of one (m, column) run
  const int n_slots = r * nci * L;
  float* s0p = smem;                    // w, w*u, w*v: [m][pr][q][ic][qc]
  float* s1p = s0p + n_slots;
  float* s2p = s1p + n_slots;
  const int b = blockIdx.z;
  const int Yq = a.yq0 + (int)blockIdx.y;
  const int Xq0 = a.xq0 + (int)blockIdx.x * nc;
  const int i0 = Xq0 - (r - 1);         // the first patch column staged

  // stage: a run is the st * R slots (pr, px) of one (m, column), px
  // fastest, read from st * ps * C contiguous floats; a thread keeps one
  // slot of the run (L <= kThreads: kThreads / L runs a pass) and walks
  // the runs, kBatch of them with their loads issued together.
  const int per_pass = L <= kThreads ? kThreads / L : 1;
  const int n_rows = r * nci;           // runs: (m, ic), ic fastest
  for (int lin = L <= kThreads ? threadIdx.x % L : threadIdx.x; lin < L;
       lin += kThreads) {
    const int row0 = L <= kThreads ? threadIdx.x / L : 0;
    if (row0 >= per_pass) break;
    const int pr = lin / R, px = lin - pr * R;
    const int q = px / st, qc = px - q * st;
    const int dst0 = (pr * r + q) * nci * st + qc;   // + m per_m + ic st
    const int per_m = st * r * nci * st;
    for (int row = row0; row < n_rows; row += kBatch * per_pass) {
      float e[kBatch][3] = {}, u[kBatch] = {}, v[kBatch] = {};
      int dst[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int rw = row + k * per_pass;
        int m = 0;                      // rw / nci, m < r
        for (int z = 1; z < r; ++z) m += rw >= z * nci;
        const int ic = rw - m * nci;
        const int j = Yq - m, i = i0 + ic, py = m * st + pr;
        dst[k] = rw < n_rows ? dst0 + m * per_m + ic * st : -1;
        ok[k] = rw < n_rows && j >= 0 && j < a.n_h && i >= 0 &&
                i < a.n_w && py < ps && px < ps;
        if (ok[k]) {
          const int64_t patch = ((int64_t)b * a.n_h + j) * a.n_w + i;
          const float* src = a.cost + ((patch * ps + py) * ps + px) * C;
          if constexpr (CC != 0) {
            e[k][0] = src[0];
            if (C > 1) e[k][1] = src[1];
            if (C > 2) e[k][2] = src[2];
          } else {
            e[k][0] = pixel_weight(src, C, a.min_errval, a.use_sqrt);
          }
          u[k] = a.p[patch * 2];
          v[k] = a.p[patch * 2 + 1];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (dst[k] < 0) continue;
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
        if (ok[k]) {
          float wt = e[k][0];
          if constexpr (CC != 0)
            wt = pixel_weight3(e[k][0], e[k][1], e[k][2], C, a.min_errval,
                               a.use_sqrt);
          c0 = wt;
          c1 = wt * u[k];
          c2 = wt * v[k];
        }
        s0p[dst[k]] = c0;
        s1p[dst[k]] = c1;
        s2p[dst[k]] = c2;
      }
    }
  }
  __syncthreads();

  // fold: output pixel o -> (pr, xl), consecutive threads on consecutive
  // columns of one row
  const int W = nc * st;
  const int per_q = nci * st;           // words between q and q + 1
  const int per_m = st * r * per_q;     // between m and m + 1
  for (int o = threadIdx.x; o < st * W; o += kThreads) {
    int pr = 0;                         // o / W, pr < steps
    for (int k = 1; k < st; ++k) pr += o >= k * W;
    const int xl = o - pr * W;
    const int y = Yq * st + pr + a.oy;
    const int x = Xq0 * st + xl + a.ox;
    if (y < 0 || y >= a.h || x < 0 || x >= a.w) continue;
    const int xq = xl / st, qc = xl - xq * st;
    // q = 0's column is xq + r - 1; each q one column to the left
    const int base = pr * r * per_q + (xq + r - 1) * st + qc;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int q = 0; q < r; ++q) {
      const int at = base + q * (per_q - st);
      float t0 = s0p[at], t1 = s1p[at], t2 = s2p[at];   // m = 0
      for (int m = 1; m < r; ++m) {
        t0 = t0 + s0p[at + m * per_m];
        t1 = t1 + s1p[at + m * per_m];
        t2 = t2 + s2p[at + m * per_m];
      }
      if (q == 0) {
        a0 = t0; a1 = t1; a2 = t2;
      } else {
        a0 = a0 + t0; a1 = a1 + t1; a2 = a2 + t2;
      }
    }
    const int64_t idx = ((int64_t)b * a.h + y) * a.w + x;
    if (a.add != nullptr) {
      a0 = a0 + a.add[idx * 3];
      a1 = a1 + a.add[idx * 3 + 1];
      a2 = a2 + a.add[idx * 3 + 2];
    }
    reinterpret_cast<float2*>(a.out)[idx] =
        make_float2(a0 > 0.0f ? a1 / a0 : 0.0f, a0 > 0.0f ? a2 / a0 : 0.0f);
  }
}

using Kernel = void (*)(DensifyArgs);

// The instantiation for a geometry: the operating points' own (ps,
// steps), else the generic one.
Kernel pick(int ps, int steps, int C) {
#define FOT_DENSIFY_FORM(P, S)                                  \
  if (ps == P && steps == S)                                    \
    return C == 3 ? glue_densify_kernel<P, S, 3>                \
         : C == 1 ? glue_densify_kernel<P, S, 1>                \
                  : glue_densify_kernel<P, S, 0>;
  FOT_DENSIFY_FORM(12, 3)   // op 3, op 4
  FOT_DENSIFY_FORM(8, 4)    // op 2
  FOT_DENSIFY_FORM(8, 5)    // op 1
#undef FOT_DENSIFY_FORM
  return glue_densify_kernel<0, 0, 0>;
}

// Opt the instantiation into `shared` bytes of dynamic shared memory, at
// most once per device and instantiation: every form is opted into the
// card's whole per-CTA limit the first time, and a launch that needs more
// is refused here.
int allow_shared(Kernel kernel, size_t shared) {
  if (shared <= 48 * 1024) return 0;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (shared > (size_t)limit) return (int)cudaErrorInvalidValue;
  constexpr int kDevices = 64, kForms = 16;
  static Kernel done[kDevices][kForms] = {};
  if (dev < kDevices) {
    for (int f = 0; f < kForms; ++f) {
      if (done[dev][f] == kernel) return 0;
      if (done[dev][f] == nullptr) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
        if (err != cudaSuccess) {
          cudaGetLastError();   // clear it: the caller raises with this code
          return (int)err;
        }
        done[dev][f] = kernel;
        return 0;
      }
    }
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

}  // namespace

// p [B, n_h, n_w, 2], cost [B, n_h, n_w, ps, ps, C] float32, contiguous;
// add: null or [B, h, w, 3] (weight, w*u, w*v) added before the
// normalisation; out [B, h, w, 2].  (off_y, off_x): the grid's offsets.
// The plan (ops/cuda/densify.py densify_plan): bands yq0 .. yq0 + n_bands
// - 1, chunks of nc Xq columns from xq0, n_chunks of them; `shared` its
// bytes of shared memory a CTA.
extern "C" int fot_densify(const void* p, const void* cost, const void* add,
                           int B, int h, int w, int C, int ps, int steps,
                           int n_h, int n_w, int off_y, int off_x,
                           float min_errval, int use_sqrt, int yq0,
                           int n_bands, int xq0, int nc, int n_chunks,
                           int64_t shared, void* out, void* stream) {
  if ((int64_t)B * h * w == 0) return 0;
  const int r = (ps + steps - 1) / steps;
  if (ps < 1 || steps < 1 || C < 1 || nc < 1 || n_bands < 1 ||
      n_chunks < 1 || B > 65535 || n_bands > 65535 ||
      shared != (int64_t)r * (nc + r - 1) * steps * r * steps * 3 * 4)
    return (int)cudaErrorInvalidValue;
  DensifyArgs a;
  a.p = (const float*)p;
  a.cost = (const float*)cost;
  a.add = (const float*)add;
  a.out = (float*)out;
  a.h = h;
  a.w = w;
  a.C = C;
  a.ps = ps;
  a.steps = steps;
  a.n_h = n_h;
  a.n_w = n_w;
  a.oy = off_y - ps / 2;   // canvas (0, 0) sits at image (off - ps/2)
  a.ox = off_x - ps / 2;
  a.yq0 = yq0;
  a.xq0 = xq0;
  a.nc = nc;
  a.min_errval = min_errval;
  a.use_sqrt = use_sqrt;
  const Kernel kernel = pick(ps, steps, C);
  const int err = allow_shared(kernel, (size_t)shared);
  if (err != 0) return err;
  kernel<<<dim3((unsigned)n_chunks, (unsigned)n_bands, (unsigned)B),
           kThreads, (size_t)shared, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
