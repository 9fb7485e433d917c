// Fused re-ID similarity + greedy one-to-one track association, one block.
//
// Replaces: src/repro/kernels/similarity.py::associate_pallas (body
// _associate_kernel).  Inputs: emb (M, D) f32 crop embeddings and trk
// (K, D) f32 track embeddings (both L2-normalized by the caller), crop_q
// (M,) / trk_q (K,) i32 query ids, thr (M,) f32 per-crop acceptance
// floors.  Crops claim tracks in row order:
//   score[i, j] = emb[i] . trk[j]   if crop_q[i] == trk_q[j] and track j
//                                   is unclaimed, else NEG_INF (-1e30)
//   j* = argmax_j score[i, j]       (lowest index wins a tie)
//   sim[i] = score[i, j*]; assign[i] = sim[i] >= thr[i] ? j* : -1, and a
//   matched j* is claimed for the later crops
// -> assign (M,) i32 and sim (M,) f32 (NEG_INF where the crop's query had
// no unclaimed track).  `assign` must equal the plain version
// (kernels/similarity.py::associate_torch) exactly; `sim` differs from it
// by the order of the D-long f32 sums, within a stated tolerance.
//
// Bound on an H100: M*K*D*2 f32 operations (the scores) against 67 TFLOP/s
// outside the tensor cores, and the bytes of the inputs and outputs read
// and written once.  At the track presets' shapes (M = 8..16 crops, K =
// 8..64 tracks, D = 32) both are a few nanoseconds: the launch latency is
// what this kernel shows on the main path.
//
// Design: the TPU kernel computed the whole (M, K) score matrix as one
// VMEM block, then a fori_loop of one-hot row selects.  Here one block of
// kThreads threads owns the problem, as the greedy order is sequential in
// the crops.  Each step i computes row i's K scores in true f32 (one
// thread per track, a D-long chain of float FMAs: no tensor cores, so no
// TF32), reduces the block to the best (score, index) pair with warp
// shuffles and one shared stage, and thread 0 decides and claims.  The
// claimed flags (K bytes) live in dynamic shared memory; the tracks are
// read through L1/L2, so any D fits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kNoTrack = 0x7fffffff;

// (v, j) beats (best, bj): a higher score, or the same score at a lower
// index — jnp.argmax's first-maximum rule
__device__ __forceinline__ bool beats(float v, int j, float best, int bj) {
  return v > best || (v == best && j < bj);
}

__global__ void __launch_bounds__(kThreads)
associate_kernel(const float* __restrict__ emb, const float* __restrict__ trk,
                 const int32_t* __restrict__ crop_q,
                 const int32_t* __restrict__ trk_q,
                 const float* __restrict__ thr, int32_t* __restrict__ assign,
                 float* __restrict__ sim, int m, int k, int d) {
  extern __shared__ uint8_t claimed[];  // k flags
  __shared__ float warp_v[kWarps];
  __shared__ int warp_j[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < k; j += kThreads) claimed[j] = 0;
  __syncthreads();
  for (int i = 0; i < m; ++i) {
    const int qi = crop_q[i];
    const float* e = emb + static_cast<size_t>(i) * d;
    float best = -INFINITY;
    int bj = kNoTrack;
    for (int j = tid; j < k; j += kThreads) {
      float v = kNegInf;
      if (trk_q[j] == qi && !claimed[j]) {
        const float* t = trk + static_cast<size_t>(j) * d;
        float acc = 0.0f;
        for (int c = 0; c < d; ++c) acc = fmaf(e[c], t[c], acc);
        v = acc;
      }
      if (v > best) {  // j rises along the loop: a tie keeps the lower
        best = v;
        bj = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oj = __shfl_down_sync(0xffffffffu, bj, off);
      if (beats(ov, oj, best, bj)) {
        best = ov;
        bj = oj;
      }
    }
    if (lane == 0) {
      warp_v[warp] = best;
      warp_j[warp] = bj;
    }
    __syncthreads();
    if (tid == 0) {
      best = warp_v[0];
      bj = warp_j[0];
      for (int w = 1; w < kWarps; ++w)
        if (beats(warp_v[w], warp_j[w], best, bj)) {
          best = warp_v[w];
          bj = warp_j[w];
        }
      if (bj == kNoTrack) {  // k == 0: nothing to match
        assign[i] = -1;
        sim[i] = kNegInf;
      } else {
        const bool ok = best >= thr[i];
        assign[i] = ok ? bj : -1;
        sim[i] = best;
        if (ok) claimed[bj] = 1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int associate_launch(const void* emb, const void* trk,
                                const void* crop_q, const void* trk_q,
                                const void* thr, void* assign, void* sim,
                                int m, int k, int d, void* stream) {
  if (m <= 0 || k < 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  associate_kernel<<<1, kThreads, static_cast<size_t>(k),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(trk),
      static_cast<const int32_t*>(crop_q), static_cast<const int32_t*>(trk_q),
      static_cast<const float*>(thr), static_cast<int32_t*>(assign),
      static_cast<float*>(sim), m, k, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* associate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
