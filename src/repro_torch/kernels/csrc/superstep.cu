// Scan superstep: S scheduler ticks of Eqs. 8-9 threshold updates and
// fleet triage in one launch, one warp per (query, edge) row.
//
// Replaces: src/repro/system/superstep.py::_superstep_fn (body: a
// lax.scan of the Eqs. 8-9 update over the tick axis, then one
// row-folded triage_fleet_pallas launch over all S*R rows).  Inputs:
// conf (S, R, N) f32 (pad lanes -1.0), th0 (R, 2) f32 [alpha, beta] at
// the run's start, mask (S, R) u8 (row r had items at tick s), drain (R,)
// f32 and gains (4,) f32 [gamma1, gamma1_up, gamma2, interval_s].  Per
// row, carried across s = 0..S-1:
//   gain  = drain >= interval ? gamma1 : gamma1_up
//   where mask[s, r]:
//     alpha = clip(alpha - gain * (drain - interval), 0.5, 1.0)
//     beta  = gamma2 * (1 - alpha)
//   ths[s, r] = (alpha, beta); triage conf[s, r, :] against them
// -> routes, slots (S, R, N) i32 (triage_row.cuh) and ths (S, R, 2) f32.
// The reference's scan rounds every f32 operation separately, and the
// port's contract is that superstep=1 and superstep=K give bit-identical
// runs, so the update is written with __fsub_rn/__fmul_rn: nvcc may not
// contract `alpha - gain * d` into an FMA, which would round once.  Every
// output must then equal the plain version
// (kernels/superstep.py::superstep_torch) exactly.
//
// Bound on an H100 (3.35 TB/s HBM): it moves S*R*N*12 + S*R*9 + R*12
// bytes (conf read, routes and slots written; mask read and ths written;
// th0 and drain read) for a handful of operations an element, so it is
// bound by bytes.  At metropolis's cap slab (32, 16384, 8) that is about
// 55 MB, some 16 us.
//
// Design: the TPU program ran the scan over the whole (R, 2) carry and
// then one VMEM-resident triage block.  Rows are independent, so here a
// warp owns a row (grid-stride loop over rows): it keeps (alpha, beta) in
// registers across the S ticks, lane 0 writes each tick's thresholds, and
// the warp triages that tick's row straight away, so the thresholds never
// round-trip through device memory and no block barrier is needed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "triage_row.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, 132 SMs

__global__ void __launch_bounds__(kThreads)
superstep_kernel(const float* __restrict__ conf,
                 const float* __restrict__ th0,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ drain,
                 const float* __restrict__ gains,
                 int32_t* __restrict__ routes,
                 int32_t* __restrict__ slots,
                 float* __restrict__ ths,
                 int steps, int rows, int n, int capacity) {
  const float g1 = gains[0], g1u = gains[1], g2 = gains[2];
  const float interval = gains[3];
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int warp_stride = gridDim.x * kWarpsPerBlock;
  for (int r = warp; r < rows; r += warp_stride) {
    const float d = drain[r];
    const float gain = d >= interval ? g1 : g1u;
    // gain * (drain - interval), each operation rounded on its own
    const float pull = __fmul_rn(gain, __fsub_rn(d, interval));
    float alpha = th0[2 * r];
    float beta = th0[2 * r + 1];
    for (int s = 0; s < steps; ++s) {
      const size_t sr = static_cast<size_t>(s) * rows + r;
      if (mask[sr]) {
        alpha = fminf(fmaxf(__fsub_rn(alpha, pull), 0.5f), 1.0f);
        beta = __fmul_rn(g2, __fsub_rn(1.0f, alpha));
      }
      if (lane == 0) {
        ths[2 * sr] = alpha;
        ths[2 * sr + 1] = beta;
      }
      const size_t base = sr * n;
      triage_row(conf + base, routes + base, slots + base, n, alpha, beta,
                 capacity);
    }
  }
}

}  // namespace

extern "C" int superstep_launch(const void* conf, const void* th0,
                                const void* mask, const void* drain,
                                const void* gains, void* routes, void* slots,
                                void* ths, int steps, int rows, int n,
                                int capacity, void* stream) {
  if (steps <= 0 || rows <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  superstep_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), static_cast<const float*>(th0),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(drain),
      static_cast<const float*>(gains), static_cast<int32_t*>(routes),
      static_cast<int32_t*>(slots), static_cast<float*>(ths), steps, rows, n,
      capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
