// Fused causal / non-causal GQA attention with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel).  Inputs q (B, H, Sq, hd), k and v (B, KV, Sk, hd),
// f32 or bf16 (all three the same), H % KV == 0; query head h reads KV
// head h / (H / KV).  Any layout whose last axis is contiguous: the
// wrapper passes the batch, head and sequence strides in elements, so the
// model's (B, S, H, hd) tensors go in without a transpose.  Per query row:
//   s_j = (q * 1/sqrt(hd)) . k_j       (the reference scales q first)
//   s_j = -1e30 where causal and j > i (top-left aligned: positions are
//         counted from 0 on both sides, also when Sq != Sk)
//   o   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-20)
// accumulated in f32 and cast to q's dtype.  Keys j >= Sk do not exist:
// the kernel takes the true Sq and Sk, masks the ragged tiles itself, and
// the wrapper pads nothing.  Causal blocks stop at the last key tile that
// meets the diagonal of their query tile.
//
// Bound on an H100: 4 * B * H * hd * (causal pairs) f32 operations (two
// products of a query against each key it sees) against 67 TFLOP/s
// outside the tensor cores, or the bytes of q, k, v and o once each over
// 3.35 TB/s.  At the serving path's prefill shapes (hd 64, S up to 1024)
// the operations bound is several times the bytes bound.
//
// Design: the TPU kernel kept a whole (block_q, hd) accumulator in VMEM
// with all of K resident.  Here one block of 256 threads owns 64 query
// rows of one (batch, head): q (scaled, f32) stays in shared memory, K and
// V stream through shared memory one BK-key tile at a time, and each
// thread keeps 4 rows x ceil(hd/16) columns of the output accumulator,
// the rows' running max and sum in registers.  Thread (ty, tx) of a 16 x
// 16 grid owns rows 4*ty .. 4*ty+3, score columns tx + 16*j and output
// columns tx + 16*j; a row's 16 threads sit in one half-warp, so its max
// and sum reduce with width-16 shuffles.  The probabilities go through
// shared memory to the P.V product.  Every product is a true f32 FMA (no
// tensor cores, so no TF32): the reference holds f32 to 2e-5.  Shared
// rows are padded by one float so the 16 key rows a half-warp reads sit in
// 16 different banks.  The head dim is padded (with zeros) to 16 * NC,
// NC in {1, 2, 4, 6, 8, 16}: hd up to 256.  wgmma, TMA and warp
// specialisation are left for a later, faster version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;   // query rows a block
constexpr int kRows = 4;      // query rows a thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // in elements: batch, head, sequence (the last axis is 1)
  long long b, h, s;
};

template <int NC>
struct Tile {
  static constexpr int kHd = 16 * NC;          // padded head dim
  static constexpr int kBK = NC <= 4 ? 64 : 32;  // keys a tile
  static constexpr int kJS = kBK / 16;         // score columns a thread
  static constexpr int kQStride = kHd + 1;
  static constexpr int kKStride = kHd + 1;
  static constexpr int kPStride = kBK + 1;
  static constexpr int kFloats = kBlockQ * kQStride + kBK * kKStride +
                                 kBK * kHd + kBlockQ * kPStride;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int heads,
             int group, int sq, int sk, int hd, int causal, float scale,
             Strides qs, Strides ks, Strides vs, Strides os) {
  using P = Tile<NC>;
  constexpr int HD = P::kHd, BK = P::kBK, JS = P::kJS;
  extern __shared__ float smem[];
  float* q_s = smem;                               // (64, HD + 1)
  float* k_s = q_s + kBlockQ * P::kQStride;        // (BK, HD + 1)
  float* v_s = k_s + BK * P::kKStride;             // (BK, HD)
  float* p_s = v_s + BK * HD;                      // (64, BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    float x = 0.0f;
    if (q0 + r < sq && d < hd) x = to_f32(qb[(q0 + r) * qs.s + d]) * scale;
    q_s[r * P::kQStride + d] = x;
  }

  float acc[kRows][NC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // the last key a query of this tile may see, and the tiles up to it
  int k_end = sk;
  if (causal) k_end = min(sk, q0 + kBlockQ);
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx - r * HD;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < sk && d < hd) {
        kx = to_f32(kb[(k0 + r) * ks.s + d]);
        vx = to_f32(vb[(k0 + r) * vs.s + d]);
      }
      k_s[r * P::kKStride + d] = kx;
      v_s[r * HD + d] = vx;
    }
    __syncthreads();

    float s[kRows][JS];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < JS; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[JS];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = q_s[(ty * kRows + i) * P::kQStride + d];
#pragma unroll
      for (int j = 0; j < JS; ++j) kv[j] = k_s[(tx + 16 * j) * P::kKStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < JS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= sk || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int kpos = k0 + tx + 16 * j;
        // a key past Sk does not exist: it weighs exactly 0, whatever m is
        const float p = kpos < sk ? expf(s[i][j] - m_new) : 0.0f;
        p_s[(ty * kRows + i) * P::kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, sk - k0);
    for (int j = 0; j < kn; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = p_s[(ty * kRows + i) * P::kPStride + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[r * os.s + d] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int kv_heads, int sq, int sk, int hd, int causal,
           const Strides* st, cudaStream_t stream) {
  using P = Tile<NC>;
  static bool attr_set = false;  // opt in to > 48 KB of shared memory once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_kernel<T, NC><<<grid, kThreads, P::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, heads / kv_heads,
      sq, sk, hd, causal, 1.0f / sqrtf(static_cast<float>(hd)), st[0], st[1],
      st[2], st[3]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int kv_heads, int sq, int sk, int hd, int causal,
             const Strides* st, cudaStream_t stream) {
  const int nc = (hd + 15) / 16;
#define FLASH_NC(N)                                                       \
  if (nc <= N)                                                            \
    return launch<T, N>(q, k, v, o, batch, heads, kv_heads, sq, sk, hd,  \
                        causal, st, stream);
  FLASH_NC(1)
  FLASH_NC(2)
  FLASH_NC(4)
  FLASH_NC(6)
  FLASH_NC(8)
  FLASH_NC(16)
#undef FLASH_NC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides in elements, (batch, head, seq)
// for q, k, v and o in that order.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int kv_heads, int sq, int sk, int hd, int causal, int dtype,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      sq <= 0 || sk <= 0 || hd <= 0 || hd > 256 || heads > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                         {osb, osh, oss}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, batch, heads, kv_heads, sq, sk, hd,
                           causal, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads, sq,
                                   sk, hd, causal, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
