// The densify weight of one patch pixel, shared by G3 (densify.cu) and
// G5 (fb_merge.cu): w = 1 / sum_c max(min_errval, e_c), e_c the pixel's
// cost in channel c (or its square root under densify_weight="abs"), in
// the plain version's order on the card: clamp(min=) lets a NaN through,
// PyTorch's CUDA sum over a last dim of three floats adds (e0 + e2) + e1,
// and 1 / sum is a float reciprocal.
#pragma once

namespace {

__device__ __forceinline__ float pixel_weight(const float* __restrict__ e,
                                              int C, float min_errval,
                                              int use_sqrt) {
  float t[3];
  float sum = 0.0f;
  for (int c = 0; c < C; ++c) {
    float v = e[c];
    if (use_sqrt) v = sqrtf(v);
    v = v < min_errval ? min_errval : v;   // clamp(min=): NaN passes
    if (C == 3) {
      t[c] = v;
    } else {
      sum = c == 0 ? v : sum + v;
    }
  }
  if (C == 3) sum = (t[0] + t[2]) + t[1];
  return 1.0f / sum;
}

// The same weight from the pixel's first C <= 3 costs already loaded
// (e1, e2 unused below C = 2, 3), so that a thread can issue the loads
// of several pixels before it computes their weights.
__device__ __forceinline__ float pixel_weight3(float e0, float e1, float e2,
                                               int C, float min_errval,
                                               int use_sqrt) {
  auto clamp = [&](float v) {
    if (use_sqrt) v = sqrtf(v);
    return v < min_errval ? min_errval : v;   // clamp(min=): NaN passes
  };
  const float v0 = clamp(e0);
  if (C == 3) return 1.0f / ((v0 + clamp(e2)) + clamp(e1));
  if (C == 2) return 1.0f / (v0 + clamp(e1));
  return 1.0f / v0;
}

}  // namespace
