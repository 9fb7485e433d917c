// Three-frame difference motion mask (paper Eqs. 1-4), one thread a pixel.
//
// Replaces: src/repro/kernels/framediff.py::framediff_pallas, the first
// launch of the staged chain behind PixelFrontend(fused=False).  Frames
// f0, f1, f2 are (B, H, W, 3) int32 in [0, 255]; the mask is (B, H, W)
// int32 in {0, maxval} (pixel.cuh has the arithmetic).  Every output is an
// integer, so the kernel must equal the plain version
// (kernels/framediff.py::framediff_torch) exactly.
//
// Bound on an H100 (3.35 TB/s HBM): 40 bytes a pixel (three 12-byte
// pixels read, one 4-byte mask value written) against about 20 integer
// operations, so it is bound by bytes.
//
// Design: the TPU kernel took (32, 128) VMEM tiles, which is why the
// reference pads frames to that tile.  Here each thread owns a pixel in a
// grid-stride loop over the batch's pixels, neighbouring threads on
// neighbouring pixels; there are no tiles, so nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, 132 SMs

__global__ void __launch_bounds__(kThreads)
framediff_kernel(const int32_t* __restrict__ f0,
                 const int32_t* __restrict__ f1,
                 const int32_t* __restrict__ f2,
                 int32_t* __restrict__ out,
                 long long pixels, int threshold, int maxval) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < pixels; p += stride) {
    out[p] = framediff_px(f0, f1, f2, static_cast<size_t>(p) * 3,
                          threshold, maxval);
  }
}

}  // namespace

extern "C" int framediff_launch(const void* f0, const void* f1,
                                const void* f2, void* out, int pixels,
                                int threshold, int maxval, void* stream) {
  if (pixels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (static_cast<long long>(pixels) + kThreads - 1) /
                     kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  framediff_kernel<<<static_cast<int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f0), static_cast<const int32_t*>(f1),
      static_cast<const int32_t*>(f2), static_cast<int32_t*>(out), pixels,
      threshold, maxval);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* framediff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
