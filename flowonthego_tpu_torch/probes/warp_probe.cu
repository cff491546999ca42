// The forms of K5 (the bilinear backward warp, csrc/warp.cu) that were
// measured against each other on the card, each held bit for bit against
// the first:
//
//   pixel      one thread a pixel over B*h*w, the channel count at run
//              time, frame / row / column by division (the kernel before
//              its redesign)
//   rows x1    csrc/warp.cu's kernel with one row a thread: one thread a
//              pixel, channels at compile time, row and frame from the grid
//   rows x2    the same with two rows a thread (a warp's lanes stay on
//              neighbouring pixels; a thread has two pixels' loads in flight)
//   rows x4    csrc/warp.cu as it is launched (fot_warp): four rows a thread
//   vec4       four consecutive pixels a thread, 128-bit flow loads and
//              mask stores, each thread storing its own 4 C floats as
//              128-bit stores (48 bytes apart from its neighbour's at C = 3)
//   vec4+smem  vec4 with a warp's outputs passed through shared memory, so
//              each store instruction writes 512 contiguous bytes
//   float      one thread an output float (coordinates recomputed per
//              channel), so stores and tap loads coalesce exactly
//   float xR   the float form with R rows a thread
//
// on a random flow of +-8 px (neighbouring pixels' taps scattered) and on a
// smooth one (what the pipeline gives the warp), at 448x1024 with C = 3
// and C = 1 and on a batch of four.
//
// A stand-alone program, not part of the kernel library:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -o warp_probe flowonthego_tpu_torch/probes/warp_probe.cu
//   ./warp_probe
//
// Times are CUDA events around kLaunches back-to-back launches, each form
// in turn, twice over; the two passes are printed side by side.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "../csrc/warp.cu"

namespace {

constexpr int kLaunches = 200;
constexpr int kGroup = 4;   // pixels a thread owns in the vec4 forms

__global__ void pixel_kernel(const float* __restrict__ src,
                             int64_t frame_stride, int64_t row_stride,
                             const float* __restrict__ wx,
                             const float* __restrict__ wy, int n_frames, int h,
                             int w, int C, float* __restrict__ out,
                             float* __restrict__ mask) {
  const int n = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_frames * n) {
    const int f = idx / n, q = idx - f * n;
    const int j = q / w, i = q - j * w;
    Taps t;
    mask[idx] = setup(src + f * frame_stride, row_stride, h, w, C, j, i,
                      wx[idx], wy[idx], t);
    float* o = out + (int64_t)idx * C;
    for (int c = 0; c < C; ++c)
      o[c] = blend(t, t.r1[t.c1 + c], t.r1[t.c2 + c], t.r2[t.c1 + c],
                   t.r2[t.c2 + c]);
  }
}

// Four consecutive pixels a thread; blockDim.x is whole warps, so a warp
// lies in one row; w % 4 == 0.  STAGED: the warp's outputs go through its
// slice of shared memory and are stored as contiguous 128-bit vectors.
template <int CH, bool STAGED>
__global__ void __launch_bounds__(kThreads) vec4_kernel(
    const float* __restrict__ src, int64_t frame_stride, int64_t row_stride,
    const float* __restrict__ wx, const float* __restrict__ wy, int h, int w,
    float* __restrict__ out, float* __restrict__ mask) {
  __shared__ float4 staged[STAGED ? kThreads / 32 : 1][32 * CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int n_groups = w / kGroup;
  const int64_t row = ((int64_t)blockIdx.z * h + j) * w;
  if (group < n_groups) {
    const int i0 = group * kGroup;
    const float4 fx = *reinterpret_cast<const float4*>(wx + row + i0);
    const float4 fy = *reinterpret_cast<const float4*>(wy + row + i0);
    const float fxs[kGroup] = {fx.x, fx.y, fx.z, fx.w};
    const float fys[kGroup] = {fy.x, fy.y, fy.z, fy.w};
    const float* frame = src + blockIdx.z * frame_stride;
    Taps t[kGroup];
    float m[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      m[k] = setup(frame, row_stride, h, w, CH, j, i0 + k, fxs[k], fys[k],
                   t[k]);
    *reinterpret_cast<float4*>(mask + row + i0) =
        make_float4(m[0], m[1], m[2], m[3]);
    float a[kGroup][CH], b[kGroup][CH], cc[kGroup][CH], d[kGroup][CH];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        a[k][c] = t[k].r1[t[k].c1 + c];
        b[k][c] = t[k].r1[t[k].c2 + c];
        cc[k][c] = t[k].r2[t[k].c1 + c];
        d[k][c] = t[k].r2[t[k].c2 + c];
      }
    }
    float o[kGroup * CH];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        o[k * CH + c] = blend(t[k], a[k][c], b[k][c], cc[k][c], d[k][c]);
    }
    float4* mine = STAGED ? &staged[warp][lane * CH]
                          : reinterpret_cast<float4*>(out + (row + i0) * CH);
#pragma unroll
    for (int q = 0; q < CH; ++q)
      mine[q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  }
  if (STAGED) {
    __syncwarp();
    // the warp's first group and how many of its 32 are inside the row
    const int g0 = group - lane;
    const int n_live = min(32, n_groups - g0);
    float4* o4 = reinterpret_cast<float4*>(out + (row + g0 * kGroup) * CH);
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int v = q * 32 + lane;
      if (v < n_live * CH) o4[v] = staged[warp][v];
    }
  }
}

// One output float a lane (coordinates recomputed per channel), R rows a
// thread.
template <int CH, int R>
__global__ void __launch_bounds__(256) float_rows_kernel(
    const float* __restrict__ src, int64_t frame_stride, int64_t row_stride,
    const float* __restrict__ wx, const float* __restrict__ wy, int h, int w,
    float* __restrict__ out, float* __restrict__ mask) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int j0 = blockIdx.y * R;
  if (e >= w * CH) return;
  const int i = e / CH, c = e - i * CH;
  const float* frame = src + blockIdx.z * frame_stride;
  Taps t[R];
  float fx[R], fy[R], m[R], v[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t idx =
        ((int64_t)blockIdx.z * h + min(j0 + r, h - 1)) * w + i;
    fx[r] = wx[idx];
    fy[r] = wy[idx];
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    m[r] = setup(frame, row_stride, h, w, CH, min(j0 + r, h - 1), i, fx[r],
                 fy[r], t[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r][0] = t[r].r1[t[r].c1 + c];
    v[r][1] = t[r].r1[t[r].c2 + c];
    v[r][2] = t[r].r2[t[r].c1 + c];
    v[r][3] = t[r].r2[t[r].c2 + c];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (j0 + r < h) {
      const int64_t idx = ((int64_t)blockIdx.z * h + j0 + r) * w + i;
      if (c == 0) mask[idx] = m[r];
      out[idx * CH + c] = blend(t[r], v[r][0], v[r][1], v[r][2], v[r][3]);
    }
  }
}

struct Case {
  int B, h, w, C;
  const float *src, *wx, *wy;
  float *out, *mask;
};

template <int R>
void launch_rows_of(const Case& k) {
  const int64_t rs = (int64_t)k.w * k.C, fs = rs * k.h;
  if (k.C == 3)
    launch<3, R>(k.src, fs, rs, k.wx, k.wy, k.B, k.h, k.w, k.C, k.out, k.mask,
                 nullptr);
  else
    launch<1, R>(k.src, fs, rs, k.wx, k.wy, k.B, k.h, k.w, k.C, k.out, k.mask,
                 nullptr);
}

template <bool STAGED>
void launch_vec4(const Case& k) {
  const int64_t rs = (int64_t)k.w * k.C, fs = rs * k.h;
  const int groups = k.w / kGroup;
  const dim3 grid((groups + kThreads - 1) / kThreads, k.h, k.B);
  if (k.C == 3)
    vec4_kernel<3, STAGED><<<grid, kThreads>>>(k.src, fs, rs, k.wx, k.wy, k.h,
                                               k.w, k.out, k.mask);
  else
    vec4_kernel<1, STAGED><<<grid, kThreads>>>(k.src, fs, rs, k.wx, k.wy, k.h,
                                               k.w, k.out, k.mask);
}

template <int R>
void launch_float(const Case& k) {
  const int64_t rs = (int64_t)k.w * k.C, fs = rs * k.h;
  const dim3 grid((k.w * k.C + 255) / 256, (k.h + R - 1) / R, k.B);
  if (k.C == 3)
    float_rows_kernel<3, R><<<grid, 256>>>(k.src, fs, rs, k.wx, k.wy, k.h,
                                           k.w, k.out, k.mask);
  else
    float_rows_kernel<1, R><<<grid, 256>>>(k.src, fs, rs, k.wx, k.wy, k.h,
                                           k.w, k.out, k.mask);
}

void launch_pixel(const Case& k) {
  const int64_t rs = (int64_t)k.w * k.C, fs = rs * k.h;
  const int n = k.B * k.h * k.w;
  pixel_kernel<<<(n + 255) / 256, 256>>>(k.src, fs, rs, k.wx, k.wy, k.B, k.h,
                                         k.w, k.C, k.out, k.mask);
}

void launch_shipped(const Case& k) {
  const int64_t rs = (int64_t)k.w * k.C, fs = rs * k.h;
  fot_warp(k.src, fs, rs, k.wx, k.wy, k.B, k.h, k.w, k.C, k.out, k.mask,
           nullptr);
}

struct Form {
  const char* name;
  void (*launch)(const Case&);
};
const Form kForms[] = {
    {"pixel", launch_pixel},           {"rows x1", launch_rows_of<1>},
    {"rows x2", launch_rows_of<2>},    {"rows x4", launch_shipped},
    {"vec4", launch_vec4<false>},      {"vec4+smem", launch_vec4<true>},
    {"float", launch_float<1>},        {"float x2", launch_float<2>},
    {"float x4", launch_float<4>}};
constexpr int kNForms = sizeof(kForms) / sizeof(kForms[0]);

void run_form(int form, const Case& k) { kForms[form].launch(k); }

void check(cudaError_t err, const char* what) {
  if (err != cudaSuccess) {
    std::fprintf(stderr, "%s: %s\n", what, cudaGetErrorString(err));
    std::exit(1);
  }
}

float time_ms(int form, const Case& k) {
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  for (int i = 0; i < 5; ++i) run_form(form, k);
  cudaEventRecord(start);
  for (int i = 0; i < kLaunches; ++i) run_form(form, k);
  cudaEventRecord(stop);
  check(cudaEventSynchronize(stop), kForms[form].name);
  float ms = 0;
  cudaEventElapsedTime(&ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return ms / kLaunches;
}

// a reproducible value in [0, 1)
float unit(uint32_t& state) {
  state = state * 1664525u + 1013904223u;
  return (state >> 8) * (1.0f / 16777216.0f);
}

}  // namespace

int main() {
  const int h = 448, w = 1024, kMaxB = 4, kMaxC = 3;
  const size_t n = (size_t)kMaxB * h * w;
  std::vector<float> src(n * kMaxC), rx(n), ry(n), sx(n), sy(n);
  uint32_t state = 1;
  for (auto& v : src) v = 255.0f * unit(state);
  for (size_t q = 0; q < n; ++q) {
    const int i = q % w, j = (q / w) % h;
    rx[q] = 16.0f * unit(state) - 8.0f;
    ry[q] = 16.0f * unit(state) - 8.0f;
    // a smooth field with sub-pixel parts and two motions, as a flow is
    sx[q] = (i < w / 2 ? 2.0f : 16.0f) + 0.7f * std::sin(0.013f * i) *
                                             std::cos(0.021f * j);
    sy[q] = (i < w / 2 ? 2.0f : 8.0f) +
            0.6f * std::cos(0.017f * i + 0.011f * j);
  }
  float *d_src, *d_rx, *d_ry, *d_sx, *d_sy, *d_out, *d_mask;
  check(cudaMalloc(&d_src, n * kMaxC * 4), "malloc");
  check(cudaMalloc(&d_out, n * kMaxC * 4), "malloc");
  check(cudaMalloc(&d_mask, n * 4), "malloc");
  for (auto p : {&d_rx, &d_ry, &d_sx, &d_sy})
    check(cudaMalloc(p, n * 4), "malloc");
  cudaMemcpy(d_src, src.data(), n * kMaxC * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_rx, rx.data(), n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_ry, ry.data(), n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_sx, sx.data(), n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_sy, sy.data(), n * 4, cudaMemcpyHostToDevice);

  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  std::printf("%s; %dx%d, %d launches a time; ms a launch, two passes\n",
              prop.name, h, w, kLaunches);
  std::vector<float> ref_out(n * kMaxC), ref_mask(n), got_out(n * kMaxC),
      got_mask(n);
  const int shapes[][2] = {{1, 3}, {1, 1}, {4, 3}};
  for (auto& bc : shapes) {
    for (int smooth = 0; smooth < 2; ++smooth) {
      const Case k{bc[0], h, w, bc[1], d_src, smooth ? d_sx : d_rx,
                   smooth ? d_sy : d_ry, d_out, d_mask};
      const size_t px = (size_t)k.B * h * w;
      for (int form = 0; form < kNForms; ++form) {
        cudaMemset(d_out, 0xff, px * k.C * 4);
        cudaMemset(d_mask, 0xff, px * 4);
        run_form(form, k);
        check(cudaDeviceSynchronize(), kForms[form].name);
        auto& o = form ? got_out : ref_out;
        auto& m = form ? got_mask : ref_mask;
        cudaMemcpy(o.data(), d_out, px * k.C * 4, cudaMemcpyDeviceToHost);
        cudaMemcpy(m.data(), d_mask, px * 4, cudaMemcpyDeviceToHost);
        if (form && (std::memcmp(o.data(), ref_out.data(), px * k.C * 4) ||
                     std::memcmp(m.data(), ref_mask.data(), px * 4))) {
          std::fprintf(stderr, "form %s differs from form %s\n",
                       kForms[form].name, kForms[0].name);
          return 1;
        }
      }
      float ms[2][kNForms];
      for (int pass = 0; pass < 2; ++pass)
        for (int form = 0; form < kNForms; ++form)
          ms[pass][form] = time_ms(form, k);
      std::printf("B=%d C=%d %s flow, all forms bit-identical:", k.B, k.C,
                  smooth ? "smooth" : "random");
      for (int form = 0; form < kNForms; ++form)
        std::printf("  %s %.4f %.4f", kForms[form].name, ms[0][form],
                    ms[1][form]);
      std::printf("\n");
    }
  }
  return 0;
}
