// 3x3 morphology (paper Eqs. 5-6): one stencil, a block a 128 x 16 tile.
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
// write) against nine compares, so it is bound by bytes.
//
// Design: a TPU block cannot overlap its neighbour, so the reference
// gathers overlapping (32 + 2)-row halo bands on the host (halo_bands)
// and pads H.  Here the frames are cut into (x tiles, y tiles, B) and
// each block takes one 128 x 16 output tile of one camera.  The tiles are
// numbered along grid x (x tiles fastest, then y tiles, then cameras),
// whose 2^31 - 1 blocks take any B and H that grid y and z (65,535 each)
// would not; a block finds its tile with two divisions, not a pixel:
//   1. the tile and its 1-pixel halo (18 x 130 values) go to shared
//      memory, a warp a row, each lane's loads all issued before the
//      first store; `fill` is applied as they land, so nothing after this
//      checks bounds;
//   2. a thread owns 4 consecutive columns of 2 rows: a 3-tap row pass
//      over 4 rows (one 16-byte shared load a row, its two outside
//      neighbours from the next lanes by shuffle), then a 3-tap column
//      pass in registers;
//   3. each row's 4 outputs go out as one int4 store where the row is
//      16-byte aligned, as scalar stores elsewhere (W not a multiple of
//      4, the ragged right edge).
// Index arithmetic is 32-bit from the block's coordinates (the wrapper
// refuses frames of 2^31 pixels or more): no division or modulo a pixel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 128;            // output columns: 32 lanes x 4
constexpr int kTH = 16;             // output rows: 8 warps x 2
constexpr int kRows = kTH / (kThreads / 32);   // output rows a thread
constexpr int kHaloRows = kTH + 2;
constexpr int kHaloCols = kTW + 2;
// a shared row: column j holds image column x0 - 4 + j, so the tile's own
// columns start 16-byte aligned at j = 4 (j = 3 and kTW + 4 are the halo)
constexpr int kStride = kTW + 8;
constexpr int kLoadRows = (kHaloRows + 7) / 8;       // halo rows a warp
constexpr int kLoadCols = (kHaloCols + 31) / 32;     // halo columns a lane

template <bool kMin>
__device__ __forceinline__ int op(int a, int b) {
  return kMin ? min(a, b) : max(a, b);
}

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
morph3x3_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int h, int w, int x_tiles, int y_tiles, int fill) {
  __shared__ __align__(16) int32_t tile[kHaloRows][kStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the block's (x tile, y tile, camera), x tiles fastest
  const int rest = blockIdx.x / x_tiles, b = rest / y_tiles;
  const int x0 = (blockIdx.x - rest * x_tiles) * kTW;
  const int y0 = (rest - b * y_tiles) * kTH;
  const size_t cam = static_cast<size_t>(b) * h * w;
  const int32_t* img = x + cam;

  // 1. halo rows warp, warp + 8, ...; lane's columns lane, lane + 32, ...
  int v[kLoadRows][kLoadCols];
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) {
    const int gy = y0 - 1 + warp + 8 * i;
    const bool row_in = warp + 8 * i < kHaloRows && gy >= 0 && gy < h;
#pragma unroll
    for (int j = 0; j < kLoadCols; ++j) {
      const int gx = x0 - 1 + lane + 32 * j;
      v[i][j] = fill;
      if (row_in && lane + 32 * j < kHaloCols && gx >= 0 && gx < w)
        v[i][j] = img[gy * w + gx];
    }
  }
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) {
    if (warp + 8 * i >= kHaloRows) continue;
#pragma unroll
    for (int j = 0; j < kLoadCols; ++j)
      if (lane + 32 * j < kHaloCols)
        tile[warp + 8 * i][3 + lane + 32 * j] = v[i][j];
  }
  __syncthreads();

  // 2. row pass over shared rows r0 .. r0 + kRows + 1, then column pass
  const int c0 = 4 * lane, r0 = kRows * warp;
  int hr[kRows + 2][4];
#pragma unroll
  for (int i = 0; i < kRows + 2; ++i) {
    const int4 m = *reinterpret_cast<const int4*>(&tile[r0 + i][4 + c0]);
    int left = __shfl_up_sync(0xffffffffu, m.w, 1);
    int right = __shfl_down_sync(0xffffffffu, m.x, 1);
    if (lane == 0) left = tile[r0 + i][3];
    if (lane == 31) right = tile[r0 + i][4 + kTW];
    hr[i][0] = op<kMin>(op<kMin>(left, m.x), m.y);
    hr[i][1] = op<kMin>(op<kMin>(m.x, m.y), m.z);
    hr[i][2] = op<kMin>(op<kMin>(m.y, m.z), m.w);
    hr[i][3] = op<kMin>(op<kMin>(m.z, m.w), right);
  }

  // 3. kRows rows of 4 outputs
  const int gx = x0 + c0;
  if (gx >= w) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gy = y0 + r0 + i;
    if (gy >= h) break;
    int o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = op<kMin>(op<kMin>(hr[i][k], hr[i + 1][k]), hr[i + 2][k]);
    int32_t* p = out + cam + gy * w + gx;
    if (gx + 4 <= w && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<int4*>(p) = make_int4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (gx + k < w) p[k] = o[k];
    }
  }
}

}  // namespace

// op: 0 = max (dilate), 1 = min (erode)
extern "C" int morphology_launch(const void* x, void* out, int batch,
                                 int h, int w, int op, int fill,
                                 void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 ||
      static_cast<long long>(h) * w >= (1ll << 31) || (op != 0 && op != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int x_tiles = (w - 1) / kTW + 1, y_tiles = (h - 1) / kTH + 1;
  if (static_cast<long long>(x_tiles) * y_tiles * batch >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(x_tiles * y_tiles * batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  if (op == 1)
    morph3x3_kernel<true><<<grid, kThreads, 0, s>>>(in, o, h, w, x_tiles,
                                                    y_tiles, fill);
  else
    morph3x3_kernel<false><<<grid, kThreads, 0, s>>>(in, o, h, w, x_tiles,
                                                     y_tiles, fill);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* morphology_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
