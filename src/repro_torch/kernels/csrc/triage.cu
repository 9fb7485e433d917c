// Fused fleet triage + per-row escalation compaction, rows resident in
// warps.
//
// Replaces: src/repro/kernels/triage.py::triage_fleet_pallas (and
// triage_dynamic_pallas, which the port runs as the R = 1 launch of this
// kernel).  For each row r of conf (R, N) f32 with thresholds (R, 2)
// f32 [alpha, beta]:
//   route = conf > alpha ? 0 : (conf < beta ? 1 : 2)   (NaN escalates)
//   slot  = (inclusive prefix count of escalations in the row) - 1 for an
//           escalated lane while that is < capacity, else -1
//   count = number of escalations in the row, overflow included.
// Every output is an integer, so the kernel must equal the plain version
// (kernels/triage.py::triage_fleet_torch) exactly.
//
// Bound on an H100 (3.35 TB/s HBM): it moves R*N*12 + R*12 bytes (conf
// read, routes and slots written, thresholds read, counts written) and
// does a handful of integer operations per element, so it is bound by
// bytes.  At the query pipeline's shapes (R = 8..64 rows by N = 16..64
// lanes) that is tens of nanoseconds: what the kernel costs on the main
// path is the launch and its chain of dependent memory round trips, so
// the design keeps that chain to one load round trip and one store.
//
// Design: the TPU kernel ran the whole fleet as one VMEM-resident block
// and a jnp.cumsum along each row.  Here a warp holds a whole row in its
// registers, and the launch picks one of two paths from N:
//  - N <= 128: each lane holds V = ceil(N/32) consecutive lanes of the
//    row, read as one float2/float4 when N = 32 V and the pointers allow.
//    The lane's slot is the escalations of the lanes below it (the sum of
//    V ballots' __popc under lanemask_lt) plus its own running prefix;
//    routes and slots are stored as int2/int4.
//  - N > 128: triage_row.cuh's chunk walk with several chunks' loads in
//    flight.
// On both paths the row's thresholds (one float2) and all its
// confidences are loaded before any is compared.  Blocks are up to four
// warps, so R = 64 rows spread over 16 SMs and a one-row launch is one
// warp; a grid-stride loop over rows takes every R up to 2^17.
// (Timed at the main paths' shapes on an H100: four warps a block was the
// fastest or within 2% of one, two or eight at every one but (64, 64);
// packing 32/W rows of N <= W <= 32 into a warp was no faster than one
// row a warp, and the chunk walk 0.13-0.17 us slower than either at
// N <= 64.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "triage_row.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxThreads = kWarpsPerBlock * 32;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, 132 SMs

// the row's [alpha, beta]: one 8-byte load where the pointer allows
__device__ __forceinline__ float2 load_thresholds(
    const float* __restrict__ thresholds, int row, bool pair) {
  return pair ? reinterpret_cast<const float2*>(thresholds)[row]
              : make_float2(thresholds[2 * row], thresholds[2 * row + 1]);
}

// this lane's warp and the number of warps in the grid
__device__ __forceinline__ int warp_index() {
  return blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
}

__device__ __forceinline__ int warp_count() {
  return gridDim.x * (blockDim.x >> 5);
}

// V consecutive floats from p: one vector load (V = 2 or 4, aligned)
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(int32_t* __restrict__ p,
                                          const int (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(x[0], x[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
  }
}

// N <= 32 V: a warp a row, lane l holds lanes [V l, V l + V) of it;
// `vec` (taken for V = 2 or 4): N == 32 V and conf, routes and slots are
// 4 V-byte aligned
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
triage_lanes_kernel(const float* __restrict__ conf,
                    const float* __restrict__ thresholds,
                    int32_t* __restrict__ routes,
                    int32_t* __restrict__ slots,
                    int32_t* __restrict__ counts,
                    int rows, int n, int capacity, bool pair, bool vec) {
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int c0 = lane * V;  // the lane's first column
  for (int row = warp_index(); row < rows; row += warp_count()) {
    const size_t base = static_cast<size_t>(row) * n + c0;
    const float2 th = load_thresholds(thresholds, row, pair);
    // V = 1 and 3 take the scalar loads and stores (no vector type)
    const bool whole = (V == 2 || V == 4) && vec;
    float x[V];
    if (whole) {
      load_vec<V>(conf + base, x);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = c0 + v < n ? conf[base + v] : 0.0f;
    }
    int route[V];
    bool esc[V];
    int below = 0;  // escalations held by the lower lanes
    int total = 0;  // escalations in the row
#pragma unroll
    for (int v = 0; v < V; ++v) {
      route[v] = route_of(x[v], th.x, th.y);
      esc[v] = c0 + v < n && route[v] == 2;
      const unsigned ballot = __ballot_sync(0xffffffffu, esc[v]);
      below += __popc(ballot & lanemask_lt);
      total += __popc(ballot);
    }
    int slot[V];
    int pos = below;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      slot[v] = (esc[v] && pos < capacity) ? pos : -1;
      pos += esc[v];
    }
    if (whole) {
      store_vec<V>(routes + base, route);
      store_vec<V>(slots + base, slot);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (c0 + v < n) {
          routes[base + v] = route[v];
          slots[base + v] = slot[v];
        }
      }
    }
    if (lane == 0) counts[row] = total;
  }
}

// N > 128: a warp a row, triage_row.cuh's chunk walk
__global__ void __launch_bounds__(kMaxThreads)
triage_chunks_kernel(const float* __restrict__ conf,
                     const float* __restrict__ thresholds,
                     int32_t* __restrict__ routes,
                     int32_t* __restrict__ slots,
                     int32_t* __restrict__ counts,
                     int rows, int n, int capacity, bool pair) {
  for (int row = warp_index(); row < rows; row += warp_count()) {
    const size_t base = static_cast<size_t>(row) * n;
    const float2 th = load_thresholds(thresholds, row, pair);
    const int count = triage_row(conf + base, routes + base, slots + base, n,
                                 th.x, th.y, capacity);
    if ((threadIdx.x & 31) == 0) counts[row] = count;
  }
}

__global__ void empty_kernel() {}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int triage_launch(const void* conf_, const void* thresholds_,
                             void* routes_, void* slots_, void* counts_,
                             int rows, int n, int capacity, void* stream_) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto conf = static_cast<const float*>(conf_);
  const auto thresholds = static_cast<const float*>(thresholds_);
  const auto routes = static_cast<int32_t*>(routes_);
  const auto slots = static_cast<int32_t*>(slots_);
  const auto counts = static_cast<int32_t*>(counts_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const bool pair = aligned(thresholds, 8);
  // whole rows as float2/float4 loads and int2/int4 stores
  const auto vectors = [&](int v) {
    return (v == 2 || v == 4) && n == 32 * v && aligned(conf, 4 * v) &&
           aligned(routes, 4 * v) && aligned(slots, 4 * v);
  };
  const int lanes = (n + 31) / 32;  // V: a lane's share of a row, n <= 128
  const int warps = rows < kWarpsPerBlock ? rows : kWarpsPerBlock;
  int blocks = (rows + warps - 1) / warps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
#define TRIAGE_ARGS conf, thresholds, routes, slots, counts, rows, n, capacity
#define TRIAGE_LANES(V)                                   \
  triage_lanes_kernel<V><<<blocks, 32 * warps, 0, stream>>>( \
      TRIAGE_ARGS, pair, vectors(V))
  if (n <= 128) {
    switch (lanes) {
      case 1: TRIAGE_LANES(1); break;
      case 2: TRIAGE_LANES(2); break;
      case 3: TRIAGE_LANES(3); break;
      default: TRIAGE_LANES(4); break;
    }
  } else {
    triage_chunks_kernel<<<blocks, 32 * warps, 0, stream>>>(TRIAGE_ARGS,
                                                             pair);
  }
#undef TRIAGE_LANES
#undef TRIAGE_ARGS
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel (one warp, no work) on the stream: the
// card's launch floor, timed beside the kernels with the same build.
extern "C" int triage_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* triage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
