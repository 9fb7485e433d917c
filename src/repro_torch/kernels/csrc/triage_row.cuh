// One warp triages one row, shared by triage.cu and superstep.cu so the
// per-tick launch and the scan superstep run one route-and-compact.
#pragma once
#include <stdint.h>

// Called by all 32 lanes of a warp with the same row.  For each of the
// row's n confidences (conf[0..n), f32) it writes
//   route = conf > alpha ? 0 : (conf < beta ? 1 : 2)   (NaN escalates)
//   slot  = (inclusive prefix count of escalations in the row) - 1 for an
//           escalated lane while that is < capacity, else -1
// and returns, on every lane, the row's escalation count (overflow
// included).  The warp walks the row in 32-lane chunks with one coalesced
// 4-byte load per lane; a chunk's escalate mask is one __ballot_sync, the
// lane's exclusive in-chunk prefix is __popc(ballot & lanemask_lt), and a
// carry adds the earlier chunks: exact integer prefix sums with no shared
// memory and no block-level synchronisation.
__device__ __forceinline__ int triage_row(
    const float* __restrict__ conf, int32_t* __restrict__ routes,
    int32_t* __restrict__ slots, int n, float alpha, float beta,
    int capacity) {
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  int carry = 0;  // escalations in the earlier chunks of this row
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int col = c0 + lane;
    const bool in_row = col < n;
    const float x = in_row ? conf[col] : 0.0f;
    // same comparison order as jnp.where(conf > a, 0, where(conf < b, 1, 2))
    const int route = (x > alpha) ? 0 : ((x < beta) ? 1 : 2);
    const bool esc = in_row && route == 2;
    const unsigned ballot = __ballot_sync(0xffffffffu, esc);
    const int pos = carry + __popc(ballot & lanemask_lt);
    if (in_row) {
      routes[col] = route;
      slots[col] = (esc && pos < capacity) ? pos : -1;
    }
    carry += __popc(ballot);
  }
  return carry;
}
