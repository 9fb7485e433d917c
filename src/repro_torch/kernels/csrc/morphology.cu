// 3x3 morphology (paper Eqs. 5-6): one stencil, one thread an output pixel.
//
// Replaces: src/repro/kernels/morphology.py::_morph_pallas and its two
// bindings, dilate3x3_pallas (op max, fill 0) and erode3x3_pallas (op
// min, fill maxval): the second and third launches of the staged chain
// behind PixelFrontend(fused=False).  x and out are (B, H, W) int32; each
// output is the max (op 0) or min (op 1) of its 3x3 neighbourhood, a
// neighbour outside the (H, W) image reading as `fill`.  Integer max/min
// are exact in any order, so the kernel must equal the plain version
// (kernels/morphology.py::morph3x3_torch) exactly.
//
// Bound on an H100 (3.35 TB/s HBM): 8 bytes a pixel (one read, one
// write; the eight neighbour reads hit L1/L2) against nine compares, so
// it is bound by bytes.
//
// Design: a TPU block cannot overlap its neighbour, so the reference
// gathers overlapping (32 + 2)-row halo bands on the host (halo_bands)
// and pads H.  Here each thread reads its nine neighbours straight from
// device memory and the bounds check supplies the fill: no gather, no
// padding, one launch over the batch's pixels in a grid-stride loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, 132 SMs

__global__ void __launch_bounds__(kThreads)
morph3x3_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                long long pixels, int h, int w, int op_min, int fill) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < pixels; p += stride) {
    const int col = static_cast<int>(p % w);
    const long long img_row = p / w;             // b * h + row
    const int row = static_cast<int>(img_row % h);
    const int32_t* img = x + (img_row - row) * w;  // camera b's frame
    int acc = img[static_cast<long long>(row) * w + col];
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int r = row + dy, c = col + dx;
        const int v = (r >= 0 && r < h && c >= 0 && c < w)
                          ? img[static_cast<long long>(r) * w + c]
                          : fill;
        acc = op_min ? min(acc, v) : max(acc, v);
      }
    }
    out[p] = acc;
  }
}

}  // namespace

// op: 0 = max (dilate), 1 = min (erode)
extern "C" int morphology_launch(const void* x, void* out, int batch,
                                 int h, int w, int op, int fill,
                                 void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || (op != 0 && op != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * h * w;
  long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  morph3x3_kernel<<<static_cast<int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), pixels, h,
      w, op, fill);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* morphology_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
