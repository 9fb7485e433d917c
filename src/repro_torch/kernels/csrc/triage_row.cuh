// Row triage shared by triage.cu and superstep.cu, so the per-tick launch
// and the scan superstep run one route-and-compact.
//
// For each of a row's n confidences (f32) against its (alpha, beta):
//   route = conf > alpha ? 0 : (conf < beta ? 1 : 2)   (NaN escalates)
//   slot  = (inclusive prefix count of escalations in the row) - 1 for an
//           escalated lane while that is < capacity, else -1
//   count = the row's escalations, overflow included.
// Every prefix is a __ballot_sync of the escalate flags and __popc of its
// masked bits: exact integer sums with no shared memory and no block-level
// synchronisation.
#pragma once
#include <stdint.h>

// same comparison order as jnp.where(conf > a, 0, where(conf < b, 1, 2))
__device__ __forceinline__ int route_of(float x, float alpha, float beta) {
  return (x > alpha) ? 0 : ((x < beta) ? 1 : 2);
}

// 32-lane chunks whose loads are issued together by triage_row
constexpr int kChunksInFlight = 4;

// Called by all 32 lanes of a warp with the same row of n confidences
// (conf[0..n)); writes routes[0..n) and slots[0..n) and returns, on every
// lane, the row's escalation count.  The warp walks the row in steps of
// kChunksInFlight 32-lane chunks: every chunk's coalesced load of a step
// is issued before the first is used (a fixed trip count, so the loads
// overlap), then each chunk's ballot adds to a carry.
__device__ __forceinline__ int triage_row(
    const float* __restrict__ conf, int32_t* __restrict__ routes,
    int32_t* __restrict__ slots, int n, float alpha, float beta,
    int capacity) {
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  int carry = 0;  // escalations in the earlier chunks of this row
  for (int c0 = 0; c0 < n; c0 += 32 * kChunksInFlight) {
    float x[kChunksInFlight];
#pragma unroll
    for (int k = 0; k < kChunksInFlight; ++k) {
      const int col = c0 + 32 * k + lane;
      x[k] = col < n ? conf[col] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunksInFlight; ++k) {
      const int col = c0 + 32 * k + lane;
      const bool in_row = col < n;
      const int route = route_of(x[k], alpha, beta);
      const bool esc = in_row && route == 2;
      const unsigned ballot = __ballot_sync(0xffffffffu, esc);
      const int pos = carry + __popc(ballot & lanemask_lt);
      if (in_row) {
        routes[col] = route;
        slots[col] = (esc && pos < capacity) ? pos : -1;
      }
      carry += __popc(ballot);
    }
  }
  return carry;
}
