// Fused fleet triage + per-row escalation compaction, one warp per row.
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
// bytes.  At the query pipeline's shapes (R = 64..256 rows by N = 8..64
// lanes at city_scale) that is tens of nanoseconds: what this kernel
// shows on the main path is its launch latency, not its bandwidth.
//
// Design: the TPU kernel ran the whole fleet as one VMEM-resident block
// and a jnp.cumsum along each row.  Here each warp owns a row (grid-stride
// loop over rows, so every R up to 2^17 fits one launch) and runs
// triage_row.cuh's ballot/popc prefix over it, the same row triage the
// scan superstep (superstep.cu) runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "triage_row.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, 132 SMs

__global__ void __launch_bounds__(kThreads)
triage_fleet_kernel(const float* __restrict__ conf,
                    const float* __restrict__ thresholds,
                    int32_t* __restrict__ routes,
                    int32_t* __restrict__ slots,
                    int32_t* __restrict__ counts,
                    int rows, int n, int capacity) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int warp_stride = gridDim.x * kWarpsPerBlock;
  for (int row = warp; row < rows; row += warp_stride) {
    const size_t base = static_cast<size_t>(row) * n;
    const int count = triage_row(conf + base, routes + base, slots + base, n,
                                 thresholds[2 * row], thresholds[2 * row + 1],
                                 capacity);
    if ((threadIdx.x & 31) == 0) counts[row] = count;
  }
}

}  // namespace

extern "C" int triage_launch(const void* conf, const void* thresholds,
                             void* routes, void* slots, void* counts,
                             int rows, int n, int capacity, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  triage_fleet_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), static_cast<const float*>(thresholds),
      static_cast<int32_t*>(routes), static_cast<int32_t*>(slots),
      static_cast<int32_t*>(counts), rows, n, capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* triage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
