// Fused pixel cascade (paper Eqs. 1-6): framediff -> 3x3 dilate -> 3x3
// erode -> per-camera foreground count, one device operation a call.
//
// Replaces: src/repro/kernels/pixel_cascade.py::pixel_cascade_pallas /
// _cascade_call (body _cascade_kernel + _framediff_band), and the int32
// widening its wrapper does first.  Frames f0, f1, f2 are (B, H, W, 3)
// uint8 or int32 in [0, 255] (one template instance each, widened in
// registers); each frame has its own camera stride, and only its inner
// (H, W, 3) block must be contiguous, so the strided views `detect` takes
// of one (B, 3, H, W, 3) batch go in as they are.  The outputs are
//   mask   (B, H, W) int32: erode(dilate(framediff)), in {0, maxval}
//   counts (B,)      int32: foreground (mask > 0) pixels per camera.
// Boundary semantics are the staged chain's: framediff outside the image
// is 0 (dilate's fill) and the dilated mask outside it is maxval (erode's
// fill).  Every output is an integer, so the kernel must equal the plain
// version (kernels/pixel_cascade.py::pixel_cascade_torch) and the staged
// framediff -> morph3x3 -> morph3x3 launches exactly.
//
// Bound on an H100 (3.35 TB/s HBM): per pixel, three pixels read (9 bytes
// in uint8, 36 in int32) and one 4-byte mask value written, against about
// 40 integer operations: bound by bytes (13 or 40 bytes a pixel).
//
// Design (the TPU kernel walks each frame in 32-row bands through a
// rolling VMEM scratch, an order only a sequential grid gives; here
// blocks run in parallel, so each owns one output tile of one camera and
// recomputes its halo):
//   1. Staging: every halo row of the three frames (the tile's columns
//      plus 2 each side, rows plus 2 above and below, clipped to the
//      image) is copied into shared memory by cp.async in 16-byte words,
//      from the aligned word below the row's first byte to the one that
//      holds its last, so any row alignment (W * 3 odd, uint8 views at
//      any offset) reads whole aligned words, and every load of the block
//      is in flight before the first compare.
//   2. Framediff from shared memory: a warp takes 32 pixels of a halo row
//      and packs their motion bits with one ballot.  A tile row is one
//      machine word of bits (bit j = column x0 - 2 + j), so
//   3. dilate and erode are word operations: OR / AND of three rows, each
//      OR-ed / AND-ed with itself shifted one bit either way.  A bit says
//      "the larger of {0, maxval}", so max is OR and min is AND for any
//      sign of maxval; the true (H, W) mask sets framediff to 0 and the
//      dilated mask to maxval outside the image.  Warp 0 does this, a
//      lane an output row, and sums the tile's count (popc).
//   4. After the block's last barrier (a barrier waits for a pending
//      atomic), thread 0 adds (1 << 32) + count to its camera's 64-bit
//      word in a workspace the wrapper owns (zeroed once at allocation).
//      The block whose add returns the camera's last ticket in the high
//      half writes counts[b] and puts the word back to 0 for the next
//      call: no memset, one atomic a block, its round trip under
//   5. the mask stores, 4 outputs a thread: an int4 store where the row
//      is 16-byte aligned, scalar stores elsewhere.
// The `// PHASE(name)` lines mark where tools/pixel_phases.py stamps the
// SM clock (and what its copies-only build keeps: the staging alone).
// Index arithmetic inside a camera is 32-bit (the wrapper refuses frames
// of 2^31 elements or more); a camera's base offset is 64-bit, once.
//
// Tiles (picked here from (H, W), not a knob): a frame of fewer than
// kLargeFrame pixels is latency-bound, and takes 28 x 16 tiles on 32-bit
// rows: (12, 96, 128) gives 5 x 6 x 12 = 360 blocks, at most 3 on any of
// the 132 SMs against a mean of 2.73 (the 32x32 tiles' 144 blocks put 2
// on 12 SMs and 1 on the rest).  A larger frame is bound by bytes and
// takes 60-wide tiles on 64-bit rows, 1920 = 32 x 60 columns: 32 rows for
// uint8 (the halo reads (64 x 36) / (60 x 32) = 1.20x the tile; 32x32
// tiles: 1.27x), 16 for int32 (1.33x, in L2 for the most part), whose
// 47 KB of staged rows then leave room for four blocks an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// frames of at least this many pixels take the large tile
constexpr long long kLargeFrame = 32768;

// output rows a tile: 16 on 32-bit rows; on 64-bit rows 32 for uint8
// frames and 16 for int32 (see the tiles above)
template <typename T, typename Row>
struct TileRows {
  static constexpr int kH = sizeof(Row) == 8 && sizeof(T) == 1 ? 32 : 16;
};

template <typename T, typename Row>
struct Geometry {
  static constexpr int kBits = 8 * sizeof(Row);  // framediff columns
  static constexpr int kWords = kBits / 32;      // ballots a halo row
  static constexpr int kW = kBits - 4;           // output columns
  static constexpr int kH = TileRows<T, Row>::kH;  // output rows
  static constexpr int kFdRows = kH + 4;
  static constexpr int kItems = kFdRows * kWords;  // ballots a tile
  static constexpr int kItemsPerWarp = (kItems + kWarps - 1) / kWarps;
  // a staged row: its pixels and one 16-byte word of alignment slack
  static constexpr int kRowBytes =
      kBits * 3 * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kStageBytes = 3 * kFdRows * kRowBytes;
  // the staged rows, the framediff and eroded bit rows, and each staged
  // row's first pixel (its byte offset into shared memory)
  static constexpr int kSmem = kStageBytes +
      (kFdRows + kH) * static_cast<int>(sizeof(Row)) + 3 * kFdRows * 4;
  static_assert(kSmem <= 48 * 1024, "no opt-in to more shared memory");
  static_assert(kRowBytes % 16 == 0, "staged rows are whole words");
  static_assert(kW % 4 == 0, "the mask is written 4 outputs a thread");
  static_assert(kH <= 32, "warp 0 runs the stencil, a row a lane");
};

// Eqs. 1-4 at one staged pixel of three frames, whose (r, g, b) values
// start at byte offsets o[f] of shared memory, widened to int in registers
template <typename T>
__device__ __forceinline__ bool staged_moving(const unsigned char* smem,
                                              const int (&o)[3],
                                              int threshold) {
  int px[3][3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const T* p = reinterpret_cast<const T*>(smem + o[f]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) px[f][ch] = p[ch];
  }
  return framediff_moving(px[0], px[1], px[2], threshold);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// bits [lo, hi) of a Row, 0 <= lo
template <typename Row>
__device__ __forceinline__ Row bit_range(int lo, int hi) {
  constexpr int kBits = 8 * sizeof(Row);
  if (hi <= lo) return 0;
  const Row below_hi = hi >= kBits ? ~Row(0) : (Row(1) << hi) - 1;
  return below_hi & ~((Row(1) << lo) - 1);
}

template <typename T, typename Row>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
               const T* __restrict__ f2, long long s0, long long s1,
               long long s2, int32_t* __restrict__ mask,
               int32_t* __restrict__ counts,
               unsigned long long* __restrict__ acc, int h, int w,
               int threshold, int maxval) {
  using G = Geometry<T, Row>;
  extern __shared__ __align__(16) unsigned char smem[];
  Row* fd = reinterpret_cast<Row*>(smem + G::kStageBytes);
  Row* er = fd + G::kFdRows;
  int* first_px = reinterpret_cast<int*>(er + G::kH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * G::kW, y0 = blockIdx.y * G::kH;
  const int fx0 = x0 - 2;                          // column of bit 0
  const int cx0 = max(fx0, 0);                     // first staged column
  const int run = (min(fx0 + G::kBits, w) - cx0) * 3 * sizeof(T);  // bytes
  const T* cam[3] = {f0 + b * s0, f1 + b * s1, f2 + b * s2};

  // PHASE(staging)
  // 1. stage: word c of halo row r of frame f; row fr's first pixel lands
  //    at its address's offset into its word
  for (int i = tid; i < 3 * G::kFdRows * G::kRowChunks; i += kThreads) {
    const int fr = i / G::kRowChunks, c = i - fr * G::kRowChunks;
    const int f = fr / G::kFdRows, gy = y0 - 2 + (fr - f * G::kFdRows);
    const T* src = f == 0 ? cam[0] : f == 1 ? cam[1] : cam[2];
    const uintptr_t start = reinterpret_cast<uintptr_t>(
        src + (gy * w + cx0) * 3);
    if (c == 0) first_px[fr] = fr * G::kRowBytes + (start & 15);
    if (gy < 0 || gy >= h) continue;
    const uintptr_t word = (start & ~uintptr_t(15)) + 16 * c;
    if (word < start + run)
      cp_async16(smem + fr * G::kRowBytes + 16 * c,
                 reinterpret_cast<const void*>(word));
  }
  cp_async_wait_all();
  __syncthreads();

  // PHASE(framediff)
  // 2. framediff bits: 32 pixels of one halo row a warp, one ballot; a
  //    warp's rows unrolled, so their loads overlap.  A bit says "the
  //    larger of {0, maxval}": a still pixel's bit is 1 where maxval < 0
  const uint32_t flip = maxval < 0 ? ~0u : 0u;
#pragma unroll
  for (int j = 0; j < G::kItemsPerWarp; ++j) {
    const int it = warp + j * kWarps;
    if (it >= G::kItems) break;
    const int r = it / G::kWords, k = it - r * G::kWords;
    const int gy = y0 - 2 + r, x = fx0 + 32 * k + lane;
    bool moving = false;
    if (gy >= 0 && gy < h && x >= 0 && x < w) {
      const int col = (x - cx0) * 3 * static_cast<int>(sizeof(T));
      const int o[3] = {first_px[r] + col, first_px[G::kFdRows + r] + col,
                        first_px[2 * G::kFdRows + r] + col};
      moving = staged_moving<T>(smem, o, threshold);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, moving);
    if (lane == 0)
      reinterpret_cast<uint32_t*>(fd)[it] = bits ^ flip;
  }
  __syncthreads();

  // PHASE(stencil)
  // 3. warp 0: a lane an output row, dilate then erode in words, and the
  //    tile's count summed into lane 0
  int count = 0;
  if (warp == 0) {
    if (lane < G::kH) {
      const int r = lane + 2;                        // its framediff row
      const Row cols = bit_range<Row>(-fx0 > 0 ? -fx0 : 0, w - fx0);
      const Row fill = maxval > 0 ? ~Row(0) : Row(0);  // bits of maxval
      Row ero = ~Row(0);
#pragma unroll
      for (int d = -1; d <= 1; ++d) {
        const Row v = fd[r + d - 1] | fd[r + d] | fd[r + d + 1];
        const int gy = y0 - 2 + r + d;
        const Row in = (gy >= 0 && gy < h) ? cols : Row(0);
        ero &= ((v | (v << 1) | (v >> 1)) & in) | (fill & ~in);
      }
      ero &= (ero << 1) & (ero >> 1);
      const Row out = (ero >> 2) & bit_range<Row>(0, G::kW);
      er[lane] = out;
      if (maxval > 0 && y0 + lane < h)
        count = __popcll(static_cast<unsigned long long>(
            out & bit_range<Row>(0, w - x0)));
    }
    count = __reduce_add_sync(0xffffffffu, count);
  }
  __syncthreads();

  // PHASE(atomic_and_stores)
  // 4-5. thread 0 adds the count after the last barrier (which would wait
  //      for the add) and reads what the add returned only after its
  //      stores of the mask, 4 outputs a thread
  unsigned long long ticket = 0;
  if (tid == 0)
    ticket = atomicAdd(&acc[b], (1ull << 32) | static_cast<unsigned>(count));
  const int hi = max(maxval, 0), lo = min(maxval, 0);
  int32_t* dst = mask + static_cast<size_t>(b) * h * w;
  for (int i = tid; i < G::kH * (G::kW / 4); i += kThreads) {
    const int r = i / (G::kW / 4), g = i - r * (G::kW / 4);
    const int gy = y0 + r, x = x0 + 4 * g;
    if (gy >= h || x >= w) continue;
    const unsigned bits = static_cast<unsigned>(er[r] >> (4 * g));
    const int4 v = make_int4(bits & 1 ? hi : lo, bits & 2 ? hi : lo,
                             bits & 4 ? hi : lo, bits & 8 ? hi : lo);
    int32_t* p = dst + gy * w + x;
    if (x + 4 <= w && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<int4*>(p) = v;
    } else {
      p[0] = v.x;
      if (x + 1 < w) p[1] = v.y;
      if (x + 2 < w) p[2] = v.z;
      if (x + 3 < w) p[3] = v.w;
    }
  }

  // PHASE(ticket_wait)
  // the block whose add took the camera's last ticket writes its count
  // and leaves the word zeroed for the next call
  if (tid == 0 && (ticket >> 32) == static_cast<unsigned long long>(
                                        gridDim.x) * gridDim.y - 1) {
    counts[b] = static_cast<int32_t>(static_cast<unsigned>(ticket) + count);
    acc[b] = 0;
  }
  // PHASE(end)
}

template <typename T, typename Row>
cudaError_t launch(const void* f0, const void* f1, const void* f2,
                   long long s0, long long s1, long long s2, void* mask,
                   void* counts, void* acc, int batch, int h, int w,
                   int threshold, int maxval, cudaStream_t s) {
  using G = Geometry<T, Row>;
  const dim3 grid((w + G::kW - 1) / G::kW, (h + G::kH - 1) / G::kH, batch);
  cascade_kernel<T, Row><<<grid, kThreads, G::kSmem, s>>>(
      static_cast<const T*>(f0), static_cast<const T*>(f1),
      static_cast<const T*>(f2), s0, s1, s2, static_cast<int32_t*>(mask),
      static_cast<int32_t*>(counts),
      static_cast<unsigned long long*>(acc), h, w, threshold, maxval);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const void* f0, const void* f1, const void* f2,
                        long long s0, long long s1, long long s2, void* mask,
                        void* counts, void* acc, int batch, int h, int w,
                        int threshold, int maxval, cudaStream_t s) {
  if (static_cast<long long>(h) * w >= kLargeFrame)
    return launch<T, uint64_t>(f0, f1, f2, s0, s1, s2, mask, counts, acc,
                               batch, h, w, threshold, maxval, s);
  return launch<T, uint32_t>(f0, f1, f2, s0, s1, s2, mask, counts, acc,
                             batch, h, w, threshold, maxval, s);
}

}  // namespace

// f0, f1, f2: frames of elem_bytes-wide elements (1: uint8, 4: int32)
// whose cameras lie s0, s1, s2 elements apart; acc: `batch` zeroed 64-bit
// words, left zeroed
extern "C" int pixel_cascade_launch(const void* f0, const void* f1,
                                    const void* f2, void* mask, void* counts,
                                    void* acc, int batch, int h, int w,
                                    int threshold, int maxval, int elem_bytes,
                                    long long s0, long long s1, long long s2,
                                    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || batch > 65535 ||
      static_cast<long long>(h) * w * 3 >= (1ll << 31) || s0 < 0 || s1 < 0 ||
      s2 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 1)
    err = launch_tile<uint8_t>(f0, f1, f2, s0, s1, s2, mask, counts, acc,
                               batch, h, w, threshold, maxval, s);
  else if (elem_bytes == 4)
    err = launch_tile<int32_t>(f0, f1, f2, s0, s1, s2, mask, counts, acc,
                               batch, h, w, threshold, maxval, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* pixel_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
