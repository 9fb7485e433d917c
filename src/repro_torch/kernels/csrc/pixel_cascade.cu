// Fused pixel cascade (paper Eqs. 1-6): framediff -> 3x3 dilate -> 3x3
// erode -> per-camera foreground count, one launch a tick.
//
// Replaces: src/repro/kernels/pixel_cascade.py::pixel_cascade_pallas /
// _cascade_call (body _cascade_kernel + _framediff_band).  Frames f0, f1,
// f2 are (B, H, W, 3) int32 in [0, 255]; the outputs are
//   mask   (B, H, W) int32: erode(dilate(framediff)), in {0, maxval}
//   counts (B,)      int32: foreground (mask > 0) pixels per camera.
// Boundary semantics are the staged chain's: framediff outside the image
// is 0 (dilate's fill) and the dilated mask outside it is maxval (erode's
// fill).  Every output is an integer, so the kernel must equal the plain
// version (kernels/pixel_cascade.py::pixel_cascade_torch) and the staged
// framediff -> morph3x3 -> morph3x3 launches exactly.
//
// Bound on an H100 (3.35 TB/s HBM): 40 bytes a pixel (three 12-byte
// pixels read, one 4-byte mask value written) and B counts, against about
// 40 integer operations a pixel, so it is bound by bytes.  The staged
// chain moves 56 bytes a pixel: the framediff and dilated masks make a
// round trip through device memory each.
//
// Design: the TPU kernel walks each frame in 32-row bands with a rolling
// three-slot VMEM scratch, a band order that only a sequential grid gives.
// Blocks here run in parallel and in no order, so each block owns one
// 32x32 output tile of one camera and recomputes what its halo needs:
//   1. framediff of the tile plus a 2-pixel halo (36x36) into shared
//      memory, straight from the frames (the halo's framediff is computed
//      again by the neighbouring block instead of crossing device memory);
//   2. 3x3 max into a 34x34 shared tile, maxval outside the true image;
//   3. 3x3 min into the 32x32 output, written only inside the true image,
//      and counted with __syncthreads_count; one atomicAdd a block adds
//      the tile's count to its camera's (integer adds: exact in any order).
// The kernel takes the true (H, W) and checks bounds itself, so frames are
// not padded to the TPU's (32, 128) tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel.cuh"

namespace {

constexpr int kTile = 32;           // output tile side
constexpr int kDil = kTile + 2;     // dilated tile: 1-pixel halo
constexpr int kFd = kTile + 4;      // framediff tile: 2-pixel halo
constexpr int kThreads = 256;
// every thread runs the same number of output passes, as
// __syncthreads_count requires
static_assert(kTile * kTile % kThreads == 0, "uniform output passes");

__global__ void __launch_bounds__(kThreads)
pixel_cascade_kernel(const int32_t* __restrict__ f0,
                     const int32_t* __restrict__ f1,
                     const int32_t* __restrict__ f2,
                     int32_t* __restrict__ mask,
                     int32_t* __restrict__ counts,
                     int h, int w, int threshold, int maxval) {
  __shared__ int32_t fd[kFd][kFd];
  __shared__ int32_t dil[kDil][kDil];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(b) * h * w;  // camera b's pixel 0

  // 1. framediff over rows y0-2 .. y0+33, columns x0-2 .. x0+33
  for (int i = threadIdx.x; i < kFd * kFd; i += kThreads) {
    const int r = i / kFd, c = i % kFd;
    const int gy = y0 - 2 + r, gx = x0 - 2 + c;
    int v = 0;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = framediff_px(f0, f1, f2,
                       (base + static_cast<size_t>(gy) * w + gx) * 3,
                       threshold, maxval);
    fd[r][c] = v;
  }
  __syncthreads();

  // 2. dilate over rows y0-1 .. y0+32: dil[r][c] is global (y0-1+r,
  //    x0-1+c), whose neighbourhood is fd[r..r+2][c..c+2]
  for (int i = threadIdx.x; i < kDil * kDil; i += kThreads) {
    const int r = i / kDil, c = i % kDil;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    int v = maxval;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = fd[r][c];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v = max(v, fd[r + dy][c + dx]);
    }
    dil[r][c] = v;
  }
  __syncthreads();

  // 3. erode the 32x32 tile: output (y0+r, x0+c) reads dil[r..r+2][c..c+2]
  int tile_count = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    const bool inside = gy < h && gx < w;
    int v = 0;
    if (inside) {
      v = dil[r][c];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v = min(v, dil[r + dy][c + dx]);
      mask[base + static_cast<size_t>(gy) * w + gx] = v;
    }
    tile_count += __syncthreads_count(inside && v > 0);
  }
  if (threadIdx.x == 0 && tile_count > 0) atomicAdd(&counts[b], tile_count);
}

}  // namespace

extern "C" int pixel_cascade_launch(const void* f0, const void* f1,
                                    const void* f2, void* mask, void* counts,
                                    int batch, int h, int w, int threshold,
                                    int maxval, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  pixel_cascade_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(f0), static_cast<const int32_t*>(f1),
      static_cast<const int32_t*>(f2), static_cast<int32_t*>(mask),
      static_cast<int32_t*>(counts), h, w, threshold, maxval);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pixel_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
