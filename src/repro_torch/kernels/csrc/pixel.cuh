// Paper Eqs. 1-4 at one pixel, shared by framediff.cu and pixel_cascade.cu
// so the staged chain and the fused cascade run one framediff.
#pragma once
#include <stdint.h>

// The motion test on one pixel's (r, g, b) values in three frames, each
// in [0, 255]:
//   da   = |f1 - f0| & |f2 - f1|            per channel (Eqs. 1-3)
//   gray = (299 r + 587 g + 114 b) / 1000   (BT.601 integer weights)
//   true where gray > threshold             (Eq. 4)
// Every term is non-negative (abs, an AND of non-negatives, positive
// weights), so C's truncating `/` equals the reference's floor `//`.
__device__ __forceinline__ bool framediff_moving(const int (&a)[3],
                                                 const int (&b)[3],
                                                 const int (&c)[3],
                                                 int threshold) {
  int da[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    da[ch] = abs(b[ch] - a[ch]) & abs(c[ch] - b[ch]);
  const int gray = (da[0] * 299 + da[1] * 587 + da[2] * 114) / 1000;
  return gray > threshold;
}

// `off` indexes the pixel's red channel in three (..., 3) int32 frames;
// the mask value is maxval where the pixel moves, else 0.
__device__ __forceinline__ int32_t framediff_px(
    const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
    const int32_t* __restrict__ f2, size_t off, int threshold, int maxval) {
  int a[3], b[3], c[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    a[ch] = f0[off + ch];
    b[ch] = f1[off + ch];
    c[ch] = f2[off + ch];
  }
  return framediff_moving(a, b, c, threshold) ? maxval : 0;
}
