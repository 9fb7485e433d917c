// Scan superstep: S scheduler ticks of Eqs. 8-9 threshold updates and
// fleet triage in one launch, a warp per one or more (query, edge) rows.
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
// warp carries (alpha, beta) in registers across the S ticks and triages
// each tick's row straight away: the thresholds never round-trip through
// device memory and no block barrier is needed.
//  - N <= 32 (every metropolis slab has N = 8): a warp packs 32/W rows,
//    W the power of two >= N, one W-lane segment a row.  The rows of a
//    tick are adjacent in memory, so a warp's tick is one coalesced load
//    (128 bytes at N = 8) and two coalesced stores.  Every lane of a
//    segment carries its row's (alpha, beta), computed with the same
//    rounded operations; the escalation prefix is a segmented ballot,
//    __popc(ballot & segment & lanemask_lt); each segment's first lane
//    writes the thresholds as one float2.  The conf and mask loads of
//    kTicks ticks are all made before any is used (they do not depend on
//    the carry), so enough bytes are in flight to cover memory latency.
//  - N > 32: a warp owns a row and walks it in 32-lane chunks, several
//    chunks' loads in flight (triage_row.cuh's row triage, shared with
//    triage.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "triage_row.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, 132 SMs
constexpr int kTicks = 8;             // ticks whose loads are in flight

struct Gains {
  float g1, g1u, g2, interval;
};

__device__ __forceinline__ Gains load_gains(const float* __restrict__ g) {
  return {g[0], g[1], g[2], g[3]};
}

// gain * (drain - interval), each operation rounded on its own
__device__ __forceinline__ float pull_of(float d, const Gains& g) {
  const float gain = d >= g.interval ? g.g1 : g.g1u;
  return __fmul_rn(gain, __fsub_rn(d, g.interval));
}

// Eqs. 8-9 for a row that had items this tick
__device__ __forceinline__ void update(float& alpha, float& beta, float pull,
                                       float g2) {
  alpha = fminf(fmaxf(__fsub_rn(alpha, pull), 0.5f), 1.0f);
  beta = __fmul_rn(g2, __fsub_rn(1.0f, alpha));
}

// N <= W <= 32: 32 / W rows a warp, one W-lane segment each
template <int W>
__global__ void __launch_bounds__(kThreads)
superstep_packed_kernel(const float* __restrict__ conf,
                        const float* __restrict__ th0,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ drain,
                        const float* __restrict__ gains,
                        int32_t* __restrict__ routes,
                        int32_t* __restrict__ slots,
                        float* __restrict__ ths,
                        int steps, int rows, int n, int capacity) {
  constexpr int kRowsPerWarp = 32 / W;
  const Gains g = load_gains(gains);
  const int lane = threadIdx.x & 31;
  const int seg = lane / W;
  const int col = lane % W;
  const unsigned segment =
      W == 32 ? 0xffffffffu : ((1u << (W & 31)) - 1u) << (seg * W);
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int warp_stride = gridDim.x * kWarpsPerBlock;
  const size_t tick = static_cast<size_t>(rows) * n;  // elements a tick
  float2* ths2 = reinterpret_cast<float2*>(ths);
  for (int grp = warp; grp < groups; grp += warp_stride) {
    const int r = grp * kRowsPerWarp + seg;
    const bool live_row = r < rows;
    const bool live = live_row && col < n;
    float pull = 0.0f, alpha = 0.0f, beta = 0.0f;
    if (live_row) {
      pull = pull_of(drain[r], g);
      alpha = th0[2 * r];
      beta = th0[2 * r + 1];
    }
    const size_t at = static_cast<size_t>(r) * n + col;  // tick 0's element
    for (int s0 = 0; s0 < steps; s0 += kTicks) {
      float x[kTicks];
      bool on[kTicks];
#pragma unroll
      for (int u = 0; u < kTicks; ++u) {
        const int s = s0 + u;
        x[u] = (live && s < steps) ? conf[s * tick + at] : 0.0f;
        on[u] = live_row && s < steps &&
                mask[static_cast<size_t>(s) * rows + r];
      }
#pragma unroll
      for (int u = 0; u < kTicks; ++u) {
        const int s = s0 + u;
        if (s >= steps) break;  // the same s on every lane
        if (on[u]) update(alpha, beta, pull, g.g2);
        const size_t sr = static_cast<size_t>(s) * rows + r;
        if (live_row && col == 0) ths2[sr] = make_float2(alpha, beta);
        const int route = route_of(x[u], alpha, beta);  // NaN escalates
        const bool esc = live && route == 2;
        const unsigned ballot = __ballot_sync(0xffffffffu, esc);
        const int pos = __popc(ballot & segment & lanemask_lt);
        if (live) {
          routes[s * tick + at] = route;
          slots[s * tick + at] = (esc && pos < capacity) ? pos : -1;
        }
      }
    }
  }
}

// N > 32: one warp a row, triage_row.cuh's 32-lane chunk walk
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
  const Gains g = load_gains(gains);
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int warp_stride = gridDim.x * kWarpsPerBlock;
  float2* ths2 = reinterpret_cast<float2*>(ths);
  for (int r = warp; r < rows; r += warp_stride) {
    const float pull = pull_of(drain[r], g);
    float alpha = th0[2 * r];
    float beta = th0[2 * r + 1];
    for (int s = 0; s < steps; ++s) {
      const size_t sr = static_cast<size_t>(s) * rows + r;
      if (mask[sr]) update(alpha, beta, pull, g.g2);
      if (lane == 0) ths2[sr] = make_float2(alpha, beta);
      const size_t base = sr * n;
      triage_row(conf + base, routes + base, slots + base, n, alpha, beta,
                 capacity);
    }
  }
}

template <int W>
cudaError_t launch_packed(int blocks, cudaStream_t stream, const float* conf,
                          const float* th0, const uint8_t* mask,
                          const float* drain, const float* gains,
                          int32_t* routes, int32_t* slots, float* ths,
                          int steps, int rows, int n, int capacity) {
  superstep_packed_kernel<W><<<blocks, kThreads, 0, stream>>>(
      conf, th0, mask, drain, gains, routes, slots, ths, steps, rows, n,
      capacity);
  return cudaGetLastError();
}

}  // namespace

extern "C" int superstep_launch(const void* conf_, const void* th0_,
                                const void* mask_, const void* drain_,
                                const void* gains_, void* routes_,
                                void* slots_, void* ths_, int steps, int rows,
                                int n, int capacity, void* stream_) {
  if (steps <= 0 || rows <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto conf = static_cast<const float*>(conf_);
  const auto th0 = static_cast<const float*>(th0_);
  const auto mask = static_cast<const uint8_t*>(mask_);
  const auto drain = static_cast<const float*>(drain_);
  const auto gains = static_cast<const float*>(gains_);
  const auto routes = static_cast<int32_t*>(routes_);
  const auto slots = static_cast<int32_t*>(slots_);
  const auto ths = static_cast<float*>(ths_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  int width = 1;  // the power of two >= n, for n <= 32
  while (width < n && width < 64) width <<= 1;
  const int rows_per_warp = n <= 32 ? 32 / width : 1;
  const int warps = (rows + rows_per_warp - 1) / rows_per_warp;
  int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
#define SUPERSTEP_PACKED(W)                                                 \
  launch_packed<W>(blocks, stream, conf, th0, mask, drain, gains, routes,  \
                   slots, ths, steps, rows, n, capacity)
  cudaError_t err;
  switch (n <= 32 ? width : 0) {
    case 1: err = SUPERSTEP_PACKED(1); break;
    case 2: err = SUPERSTEP_PACKED(2); break;
    case 4: err = SUPERSTEP_PACKED(4); break;
    case 8: err = SUPERSTEP_PACKED(8); break;
    case 16: err = SUPERSTEP_PACKED(16); break;
    case 32: err = SUPERSTEP_PACKED(32); break;
    default:
      superstep_kernel<<<blocks, kThreads, 0, stream>>>(
          conf, th0, mask, drain, gains, routes, slots, ths, steps, rows, n,
          capacity);
      err = cudaGetLastError();
  }
#undef SUPERSTEP_PACKED
  return static_cast<int>(err);
}

extern "C" const char* superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
