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
// meets the diagonal of their query tile.  One launch per call.
//
// Three kernels, chosen by head dim and dtype in flash_attention_launch
// (never on a failure), one launch either way:
//
// * tc_kernel, f32 at hd 64 and hd 128 (every attention config of the
//   repo): the tensor cores in split TF32 ("3xTF32").  Each f32 operand x
//   is split as hi = tf32(x) (cvt.rna), lo = tf32(x - hi), and each
//   product is lo*hi + hi*lo + hi*hi accumulated in f32 (one TF32 product
//   would miss the 2e-5 tolerance 40-70x).  The dropped lo*lo term and
//   lo's rounding are ~2^-22 of a product.
//   Accumulation: a chain of wgmma steps into one accumulator does not
//   round as f32 FMAs do.  With O += P V chained over a row's every key
//   and the three terms interleaved per k step, the H100 read ~5x the
//   f32-FMA kernel's error (8.7e-6 against 1.6e-6 over the same checks),
//   and qwen3-8b's 36-layer prefill logits drifted about twice as far
//   from the chunked path's as SDPA's or the FMA kernel's.  So each
//   tile's P V sums in a fresh accumulator that an f32 FMA adds to the
//   rescaled O, and both products sum every lo*hi and hi*lo before the
//   hi*hi terms.  With both, the worst error is 2.3e-6 and the logits
//   drift no further than SDPA's or the FMA kernel's (PERF.md).
//   The CPU tests' emulation rounds every sum to nearest and models none
//   of this.
//   Bound on an H100: 3 x 4 x B x H x hd x (causal pairs) TF32 operations
//   over 495 TFLOP/s, against q, k, v, o moved once over 3.35 TB/s; at
//   qwen1.5-0.5b's 1,024-token prefill (1, 16, 16, 1024, 64) the
//   operations (0.0130 ms) outweigh the bytes (0.0050 ms).
//   Design, one 256-thread block per 64 query rows of one (batch, head):
//   - a 2-stage K/V ring filled by TMA (cp.async.bulk.tensor.4d over (hd,
//     S, heads, B) maps built on the host per call over the real strides,
//     128-byte swizzle; keys past Sk land as zeros), issued by consumer
//     thread 0: the first two tiles at the start, then each stage again
//     as the consumers free it.  A TMA warp of its own would make the
//     block 288 threads, which ptxas budgets as 384, capping a thread at
//     168 registers; hd 128 then spills.  The encoder comes through
//     cudaGetDriverEntryPoint: the library links against the runtime
//     only.
//   - warps 4-7 split each arrived tile: K hi in place and K lo beside it
//     (the layout TMA wrote, which is the K-major layout wgmma reads), V
//     into V^T hi and lo.  tf32 wgmma takes B only K-major, and V arrives
//     key-major, so the split is where V is transposed.
//   - warps 0-3 (one warpgroup) split Q once into shared memory, then per
//     tile: S = Q K^T on wgmma.m64nBKk8.f32.tf32.tf32 from shared memory;
//     the online softmax on the accumulator layout (a row lives in one
//     quad: two shuffles for its max and sum; only tiles crossing the
//     diagonal or Sk are masked, none past the diagonal visited); P split
//     in registers; P V on wgmma with P as the register A operand.  The
//     accumulator's columns (2u, 2u + 1) of each 8-key group are the A
//     fragment's k = (u, u + 4), so V^T's columns follow that order
//     (mma_key).
//   - mbarriers a stage: full (TMA landed), ready (split), empty
//     (consumed).  The split overlaps the consumers' products; the next
//     tiles' loads overlap both.
//   - heaviest first: block L takes query tile nqt - 1 - L / (H * B), so
//     the blocks that walk the most key tiles start first and the short
//     ones fill in behind them.
//   Timed on an H100 (700 W) while choosing, in development builds not
//   kept: P V on mma.sync.m16n8k8 with V fragments read by index was
//   slower than wgmma with V^T; splitting in the consumer warpgroup was
//   slower than in a warpgroup of its own; issuing the next tile's S
//   before this tile's softmax, with separate K and V rings, was slower
//   too; the three S terms interleaved per k step were 2-8% faster and
//   had twice the error.
// * tc_bf16_kernel, bf16 at hd 64 and 128: one bf16 wgmma (k16) a
//   product, P rounded to bf16, f32 accumulation.  The same TMA ring,
//   schedule and softmax with no split pass: a 160-thread block of one
//   consumer warpgroup and the TMA warp.  K serves as TMA wrote it (the
//   K-major B of S = Q K^T) and so does V (16-bit wgmma takes an MN-major
//   B, transposed in the instruction); the S accumulator is the k16 A
//   fragment of P V as it stands.  Q goes in unscaled and the f32 scores
//   are scaled.  Two stages of 64 keys.
// * simt_kernel (the first port's kernel), other head dims (the tests'
//   16, 32, 96 and 256), f32 or bf16: a 256-thread block owns 64 query
//   rows, q in shared memory, K and V through shared memory one tile at a
//   time, true f32 FMAs, bound by the f32 rate outside the tensor cores
//   (67 TFLOP/s).
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows a block, both kernels
constexpr float kNegInf = -1e30f;

struct Strides {  // in elements: batch, head, sequence (the last axis is 1)
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// simt_kernel: f32 FMAs, any head dim up to 256, f32 or bf16
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;
constexpr int kRows = 4;      // query rows a thread

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

// Thread (ty, tx) of a 16 x 16 grid owns rows 4*ty .. 4*ty+3, score
// columns tx + 16*j and output columns tx + 16*j; a row's 16 threads sit in
// one half-warp, so its max and sum reduce with width-16 shuffles.  Shared
// rows are padded by one float so the 16 key rows a half-warp reads sit in
// 16 banks.  The head dim is padded with zeros to 16 * NC.
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
simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
        simt_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  simt_kernel<T, NC><<<grid, kThreads, P::kBytes, stream>>>(
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

}  // namespace simt

// ---------------------------------------------------------------------------
// tc_kernel (f32, split TF32) and tc_bf16_kernel on wgmma, a TMA ring,
// hd 64 and 128
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWG = 128;                // a warpgroup
constexpr int kThreads = 2 * kWG;       // f32: consumers, splitters
constexpr int kBf16Threads = kWG + 32;  // bf16: consumers, TMA warp
constexpr int kChunk = 32;              // f32 lanes of a 128-byte row

// f32, HD head dim, BK keys a tile, STAGES tiles in flight.  Shared
// memory: Q hi and Q lo (64 x HD each), then per stage K hi, V, K lo,
// V^T hi and V^T lo; then the mbarriers.  K and V land by TMA in the K hi
// and V slots (K is split in place).  An f32 (rows x cols) tile is
// cols / 32 chunks of rows x 128 bytes, each with the 128-byte swizzle:
// float (r, c) of chunk c / 32 sits at 16-byte slot ((c % 32) / 4) ^ (r % 8)
// of row r.  Every chunk is a multiple of 1 KB, so each starts on the 1 KB
// boundary the swizzle is defined against.
template <int HD, int BK, int STAGES>
struct Cfg {
  static constexpr int kQFloats = kBlockQ * HD;
  static constexpr int kKVFloats = BK * HD;
  static constexpr int kStageFloats = 5 * kKVFloats;
  static constexpr int kBarOffset = 4 * (2 * kQFloats + STAGES * kStageFloats);
  static constexpr int kSmem = kBarOffset + 8 * 3 * STAGES + 1024;
  static_assert(HD % kChunk == 0 && (BK == 32 || BK == 64) &&
                    kKVFloats % (8 * kWG) == 0,
                "tile shape");
  static_assert(kSmem <= 232448, "shared memory");
};

// bf16: Q (64 x HD), then per stage K and V (BK x HD each) as TMA wrote
// them, then the mbarriers.  A bf16 tile is HD / 64 chunks of rows x 128
// bytes with the same swizzle (16-byte slot = 8 lanes).
template <int HD, int BK, int STAGES>
struct Bf16Cfg {
  static constexpr int kQBytes = kBlockQ * HD * 2;
  static constexpr int kTileBytes = BK * HD * 2;
  static constexpr int kBarOffset = kQBytes + 2 * STAGES * kTileBytes;
  static constexpr int kSmem = kBarOffset + 8 * 2 * STAGES + 1024;
  static_assert(HD % 64 == 0 && BK % 16 == 0, "tile shape");
  static_assert(kSmem <= 232448, "shared memory");
};

struct Coord {  // the TMA coordinate (1..3) that carries seq, head, batch
  int s, h, b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy shared-memory writes, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the consumer warpgroup only
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kWG) : "memory");
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// K-major operand, 128-byte swizzle: 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// MN-major operand (bf16 V as stored: keys are K, head dims N), 128-byte
// swizzle: 64-lane N chunks `lbo` bytes apart, 8-key groups 1 KB apart
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr,
                                                  uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// the wgmma accumulator operands: registers and their constraints
#define FLASH_R16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FLASH_R32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define FLASH_R64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FLASH_D8(d, o)                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define FLASH_D16(d) FLASH_D8(d, 0), FLASH_D8(d, 8)
#define FLASH_D32(d) FLASH_D16(d), FLASH_D8(d, 16), FLASH_D8(d, 24)
#define FLASH_D64(d)                                                     \
  FLASH_D32(d), FLASH_D8(d, 32), FLASH_D8(d, 40), FLASH_D8(d, 48),       \
      FLASH_D8(d, 56)

// "p" is wgmma's scale-d predicate, set: D += A B
#define FLASH_WGMMA(k) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #k ", 0;\n"

// D (64 x BK) += A (64 x 8) B^T (BK x 8), tf32, A and B from shared memory
template <int BK>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BK / 2], uint64_t a,
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(FLASH_WGMMA(34)
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
               FLASH_R32 ", %32, %33, p, 1, 1;\n}\n"
               : FLASH_D32(d) : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a,
                                               uint64_t b) {
  asm volatile(FLASH_WGMMA(18)
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
               FLASH_R16 ", %16, %17, p, 1, 1;\n}\n"
               : FLASH_D16(d) : "l"(a), "l"(b), "r"(1));
}

// D (64 x N) += A (64 x 8, registers) B^T (N x 8, shared memory), tf32
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const float (&a)[4],
                                              uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                 const float (&a)[4],
                                                 uint64_t b) {
  asm volatile(FLASH_WGMMA(37)
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
               FLASH_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : FLASH_D32(d)
               : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
                 "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
                 "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                 const float (&a)[4],
                                                 uint64_t b) {
  asm volatile(FLASH_WGMMA(69)
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
               FLASH_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
               : FLASH_D64(d)
               : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
                 "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
                 "l"(b), "r"(1));
}

// D (64 x 64) += A (64 x 16) B^T (64 x 16), bf16, both K-major in shared
// memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(FLASH_WGMMA(34)
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               FLASH_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : FLASH_D32(d) : "l"(a), "l"(b), "r"(1));
}

// D (64 x N) += A (64 x 16, registers) B (16 x N, MN-major in shared
// memory: the trailing 1 transposes B), bf16
template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16_rs<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(FLASH_WGMMA(37)
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               FLASH_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : FLASH_D32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(FLASH_WGMMA(69)
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               FLASH_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
               : FLASH_D64(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(1));
}

#undef FLASH_WGMMA
#undef FLASH_R16
#undef FLASH_R32
#undef FLASH_R64
#undef FLASH_D8
#undef FLASH_D16
#undef FLASH_D32
#undef FLASH_D64

__device__ __forceinline__ float4 tf32x4(float4 x) {
  return make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// offset in floats of element (r, d) of a (ROWS x HD) swizzled f32 tile
template <int ROWS>
__device__ __forceinline__ int swz(int r, int d) {
  return (d / kChunk) * ROWS * kChunk + r * kChunk +
         ((((d % kChunk) >> 2) ^ (r & 7)) << 2) + (d & 3);
}

// offset in bytes of lanes (r, d .. d + 7) of a (ROWS x HD) swizzled bf16
// tile, d a multiple of 8
template <int ROWS>
__device__ __forceinline__ int swz_bf16(int r, int d) {
  return (d / 64) * ROWS * 128 + r * 128 + ((((d % 64) >> 3) ^ (r & 7)) << 4);
}

__device__ __forceinline__ int coord(const Coord& c, int slot, int s, int h,
                                     int b) {
  return c.s == slot ? s : (c.h == slot ? h : b);
}

// key's column in the f32 PV operands: keys 2u, 2u + 1 of each 8-key
// group at u, u + 4, the A fragment's order for the accumulator's
// (2u, 2u + 1)
__device__ __forceinline__ int mma_key(int key) {
  return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A block's work: heaviest first, block L takes query tile nqt - 1 -
// L / (H * B) when causal, so the blocks that walk the most key tiles
// start first and the short ones fill in behind them.
struct Work {
  int h, b, kvh, q0, n_tiles;
};

template <int BK>
__device__ __forceinline__ Work schedule(int heads, int batch, int group,
                                         int sq, int sk, int causal) {
  const int nqt = (sq + kBlockQ - 1) / kBlockQ;
  const int hb = heads * batch;
  const int rank = static_cast<int>(blockIdx.x) / hb;
  Work w;
  w.h = (static_cast<int>(blockIdx.x) % hb) % heads;
  w.b = (static_cast<int>(blockIdx.x) % hb) / heads;
  w.kvh = w.h / group;
  w.q0 = (causal ? nqt - 1 - rank : rank) * kBlockQ;
  const int k_end = causal ? min(sk, w.q0 + kBlockQ) : sk;
  w.n_tiles = (k_end + BK - 1) / BK;
  return w;
}

// Key tile t's K and V by TMA into kdst and vdst, completing on *full: a
// tile is `chunks` boxes of (lanes, BK), 128 bytes by BK rows each.
template <int BK>
__device__ __forceinline__ void load_tile(
    const CUtensorMap* kmap, const CUtensorMap* vmap, Coord kc, Coord vc,
    uint8_t* kdst, uint8_t* vdst, int chunks, int lanes, uint64_t* full,
    int t, const Work& w) {
  mbar_expect_tx(full, 2 * chunks * BK * 128);
  const int s0 = t * BK;
  for (int c = 0; c < chunks; ++c) {
    tma_load(kdst + c * BK * 128, kmap, full, c * lanes,
             coord(kc, 1, s0, w.kvh, w.b), coord(kc, 2, s0, w.kvh, w.b),
             coord(kc, 3, s0, w.kvh, w.b));
    tma_load(vdst + c * BK * 128, vmap, full, c * lanes,
             coord(vc, 1, s0, w.kvh, w.b), coord(vc, 2, s0, w.kvh, w.b),
             coord(vc, 3, s0, w.kvh, w.b));
  }
}

// One key tile of the online softmax on the wgmma accumulator layout:
// s[4i + 2r + e] holds row row0 + 8r, key k0 + 8i + 2 t4 + e, and a row
// lives in one quad (two shuffles for its max and sum).  Masks the keys
// past Sk or the diagonal (only on tiles that cross either), turns s
// into p in place, updates m and l, and sets alpha[r], the factor that
// rescales row row0 + 8r of the output so far.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int q0, int row0, int sk,
                                             int causal, int t4) {
  if ((causal && k0 + BK - 1 > q0) || k0 + BK > sk) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * i + 2 * t4 + e;
          if (kpos >= sk || (causal && kpos > row0 + 8 * r))
            s[4 * i + 2 * r + e] = kNegInf;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = expf(m[r] - m_new);
    // a masked key: exp(-1e30 - m) is exactly 0 (every row sees key 0)
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[4 * i + 2 * r + e] - m_new);
        s[4 * i + 2 * r + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// the consumer's rows of O = acc / l, in o's dtype
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* ob, const float (&acc)[HD / 2],
                                           const float (&l)[2], int row0,
                                           int sq, long long ss, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(ob + row * ss + 8 * j + 2 * t4, acc[4 * j + 2 * r] / den,
             acc[4 * j + 2 * r + 1] / den);
  }
}

// f32: warps 0-3 consume (wgmma and the softmax), warps 4-7 split each
// arrived K/V tile, and consumer thread 0 issues TMA: the first STAGES
// tiles at the start, then tile t + STAGES into the stage that tile t
// frees.  No warp of its own for TMA: a ninth warp would cost the block
// a third warpgroup's registers and cap a thread at 168.  Per stage:
// full (TMA landed), ready (split) and empty (consumed) mbarriers.
template <int HD, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          const float* __restrict__ q, float* __restrict__ o, int heads,
          int batch, int group, int sq, int sk, int causal, float scale,
          Strides qs, Strides os, Coord kc, Coord vc) {
  using C = Cfg<HD, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* q_hi = smem;
  float* q_lo = q_hi + C::kQFloats;
  float* stages = q_lo + C::kQFloats;
  // stage s: K hi, V, K lo, V^T hi, V^T lo
  auto tile = [&](int s, int which) {
    return stages + s * C::kStageFloats + which * C::kKVFloats;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(smem) + C::kBarOffset);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  const Work wk = schedule<BK>(heads, batch, group, sq, sk, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kWG);
      mbar_init(&empty[s], kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // K into a stage's K hi slot, V into its V slot
  auto load = [&](int t, int st) {
    load_tile<BK>(&kmap, &vmap, kc, vc,
                  reinterpret_cast<uint8_t*>(tile(st, 0)),
                  reinterpret_cast<uint8_t*>(tile(st, 1)), HD / kChunk,
                  kChunk, &full[st], t, wk);
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < min(STAGES, wk.n_tiles); ++t) load(t, t);

  if (threadIdx.x >= kWG) {  // warps 4-7: split each arrived tile
    const int tid = threadIdx.x - kWG;
    for (int t = 0; t < wk.n_tiles; ++t) {
      const int st = t % STAGES;
      float* kh = tile(st, 0);
      const float* vt = tile(st, 1);
      float* kl = tile(st, 2);
      float* vth = tile(st, 3);
      float* vtl = tile(st, 4);
      mbar_wait(&full[st], (t / STAGES) & 1);
      // K hi in place, K lo beside it (the same layout).  The split loops
      // run a fixed count, unrolled, so each thread's loads issue together
#pragma unroll
      for (int j = 0; j < C::kKVFloats / 4 / kWG; ++j) {
        const int i = tid + j * kWG;
        const float4 x = reinterpret_cast<const float4*>(kh)[i];
        const float4 hi = tf32x4(x);
        reinterpret_cast<float4*>(kh)[i] = hi;
        reinterpret_cast<float4*>(kl)[i] = tf32x4(sub4(x, hi));
      }
      // V^T hi and lo, K-major for the B operand: row d, column key in
      // the order the P fragments take (keys 2u, 2u + 1 of each 8-key
      // group at u, u + 4).  A warp's lanes walk keys, so the float4
      // reads and the scattered writes hit 32 banks.
#pragma unroll
      for (int j = 0; j < C::kKVFloats / 4 / kWG; ++j) {
        const int idx = tid + j * kWG;
        const int key = idx % BK, d = 4 * (idx / BK);
        const float4 x =
            *reinterpret_cast<const float4*>(vt + swz<BK>(key, d));
        const int kp = mma_key(key);
        const float4 hi = tf32x4(x);
        const float4 lo = tf32x4(sub4(x, hi));
        const float xs[4][2] = {{hi.x, lo.x}, {hi.y, lo.y}, {hi.z, lo.z},
                                {hi.w, lo.w}};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = swz<HD>(d + e, kp);
          vth[off] = xs[e][0];
          vtl[off] = xs[e][1];
        }
      }
      fence_async_shared();  // for the consumers' wgmma
      mbar_arrive(&ready[st]);
    }
    return;
  }

  // ---- warps 0-3: warp w owns rows 16w + g and 16w + g + 8 of the tile
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;

  // Q, scaled and split once, into the swizzled K-major layout
  {
    const float* qb = q + wk.b * qs.b + wk.h * qs.h;
#pragma unroll
    for (int j = 0; j < kBlockQ * HD / 4 / kWG; ++j) {
      const int idx = tid + j * kWG;
      const int r = idx / (HD / 4), d = 4 * (idx % (HD / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (wk.q0 + r < sq)
        x = *reinterpret_cast<const float4*>(qb + (wk.q0 + r) * qs.s + d);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      const float4 hi = tf32x4(x);
      const int off = swz<kBlockQ>(r, d);
      *reinterpret_cast<float4*>(q_hi + off) = hi;
      *reinterpret_cast<float4*>(q_lo + off) = tf32x4(sub4(x, hi));
    }
    fence_async_shared();
    consumer_sync();
  }

  constexpr int NS = BK / 2;  // score accumulators a thread
  constexpr int NO = HD / 2;  // output accumulators a thread
  // acc[4j + 2r + e]: row row0 + 8r, column 8j + 2 t4 + e (the wgmma
  // accumulator layout; s[] alike with keys for columns)
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int row0 = wk.q0 + 16 * w + g;  // and row0 + 8
  const uint32_t qh_addr = smem_u32(q_hi), ql_addr = smem_u32(q_lo);

  for (int t = 0; t < wk.n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t kh_addr = smem_u32(tile(st, 0));
    const uint32_t kl_addr = smem_u32(tile(st, 2));
    const uint32_t vh_addr = smem_u32(tile(st, 3));
    const uint32_t vl_addr = smem_u32(tile(st, 4));
    mbar_wait(&ready[st], (t / STAGES) & 1);

    // S = Q K^T: lo*hi and hi*lo over every 8-wide k step, then hi*hi
    // (the small sums first: see the note on accumulation at the top)
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.0f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint32_t qo = (kk / 4) * kBlockQ * 128 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_tf32<BK>(s, desc_sw128((term == 0 ? ql_addr : qh_addr) + qo),
                       desc_sw128((term == 1 ? kl_addr : kh_addr) + ko));
      }
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    float alpha[2];
    softmax_tile<BK>(s, m, l, alpha, t * BK, wk.q0, row0, sk, causal, t4);

    // O = alpha O + P V, P V on wgmma with P from registers: the A
    // fragment's k = (t4, t4 + 4) of each 8-key group holds P's keys
    // (2 t4, 2 t4 + 1), as the accumulator left them, and V^T's columns
    // follow that order.  The tile's P V sums in a fresh accumulator,
    // added to O by an f32 FMA: a wgmma chain spans one tile, not the
    // row's every key
    float ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float p[4] = {s[4 * i], s[4 * i + 2], s[4 * i + 1],
                          s[4 * i + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[i][e] = tf32(p[e]);
        pl[i][e] = tf32(p[e] - ph[i][e]);
      }
    }
    float pv[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) pv[i] = 0.0f;
    fence_regs(pv);
    wg_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const uint32_t vo = (i / 4) * HD * 128 + (i % 4) * 32;
        wgmma_tf32_rs<HD>(pv, term == 0 ? pl[i] : ph[i],
                          desc_sw128((term == 1 ? vl_addr : vh_addr) + vo));
      }
    wg_commit();
    wg_wait_all();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < NO; ++i)
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
    mbar_arrive(&empty[st]);  // this thread is done with the stage
    if (tid == 0 && t + STAGES < wk.n_tiles) {  // refill it once all are
      mbar_wait(&empty[st], (t / STAGES) & 1);
      load(t + STAGES, st);
    }
  }
  store_rows<float, HD>(o + wk.b * os.b + wk.h * os.h, acc, l, row0, sq,
                        os.s, t4);
}

// bf16: warps 0-3 consume, warp 4 issues TMA.  K and V are used as TMA
// wrote them: K as the K-major B of S = Q K^T, V as the MN-major B of
// O += P V (bf16 wgmma reads either).  Per stage: full and empty.
template <int HD, int BK, int STAGES>
__global__ void __launch_bounds__(kBf16Threads)
tc_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __nv_bfloat16* __restrict__ q,
               __nv_bfloat16* __restrict__ o, int heads, int batch,
               int group, int sq, int sk, int causal, float scale,
               Strides qs, Strides os, Coord kc, Coord vc) {
  using C = Bf16Cfg<HD, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + C::kQBytes;  // stage s: K, then V
  uint8_t* v_s = k_s + C::kTileBytes;
  constexpr int kStageBytes = 2 * C::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + STAGES;
  const Work wk = schedule<BK>(heads, batch, group, sq, sk, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWG) {  // warp 4: TMA, once a stage is consumed
    if (threadIdx.x == kWG)
      for (int t = 0; t < wk.n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
        load_tile<BK>(&kmap, &vmap, kc, vc, k_s + st * kStageBytes,
                      v_s + st * kStageBytes, HD / 64, 64, &full[st], t, wk);
      }
    return;
  }

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;

  // Q as it is (the scale goes on the f32 scores), 8 lanes a load
  {
    const __nv_bfloat16* qb = q + wk.b * qs.b + wk.h * qs.h;
#pragma unroll
    for (int j = 0; j < kBlockQ * HD / 8 / kWG; ++j) {
      const int idx = tid + j * kWG;
      const int r = idx / (HD / 8), d = 8 * (idx % (HD / 8));
      uint4 x = make_uint4(0, 0, 0, 0);
      if (wk.q0 + r < sq)
        x = *reinterpret_cast<const uint4*>(qb + (wk.q0 + r) * qs.s + d);
      *reinterpret_cast<uint4*>(q_s + swz_bf16<kBlockQ>(r, d)) = x;
    }
    fence_async_shared();
    consumer_sync();
  }

  constexpr int NS = BK / 2;
  constexpr int NO = HD / 2;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int row0 = wk.q0 + 16 * w + g;
  const uint32_t q_addr = smem_u32(q_s);

  for (int t = 0; t < wk.n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t k_addr = smem_u32(k_s + st * kStageBytes);
    const uint32_t v_addr = smem_u32(v_s + st * kStageBytes);
    mbar_wait(&full[st], (t / STAGES) & 1);

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.0f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t qo = (kk / 4) * kBlockQ * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
      wgmma_bf16(s, desc_sw128(q_addr + qo), desc_sw128(k_addr + ko));
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] *= scale;
    float alpha[2];
    softmax_tile<BK>(s, m, l, alpha, t * BK, wk.q0, row0, sk, causal, t4);
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P in bf16 as the register A operand: the accumulator's keys
    // 16i + (2 t4, 2 t4 + 1) and 16i + 8 + (2 t4, 2 t4 + 1) of rows g and
    // g + 8 are the k16 A fragment's four registers as they stand
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[i][e] = pack_bf16(s[8 * i + 2 * e], s[8 * i + 2 * e + 1]);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int i = 0; i < BK / 16; ++i)
      wgmma_bf16_rs<HD>(acc, pa[i],
                        desc_mn_sw128(v_addr + i * 16 * 128, BK * 128));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }
  store_rows<__nv_bfloat16, HD>(o + wk.b * os.b + wk.h * os.h, acc, l, row0,
                                sq, os.s, t4);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-4 map over (hd, seq, heads, batch) with a (128 bytes, rows, 1, 1)
// box and the 128-byte swizzle.  Seq, heads and batch are ordered by
// stride (extent-1 axes last), so any view with a contiguous last axis
// maps; *pos says which coordinate carries each.
template <typename T>
int make_map(CUtensorMap* map, Coord* pos, const T* base, int hd, int seq,
             int heads, int batch, const Strides& st, int rows) {
  const unsigned long long es = sizeof(T);
  struct Axis {
    unsigned long long size, stride;
    int which;
  } ax[3] = {{(unsigned long long)seq, st.s * es, 0},
             {(unsigned long long)heads, st.h * es, 1},
             {(unsigned long long)batch, st.b * es, 2}};
  for (int i = 1; i < 3; ++i)  // insertion sort: (extent 1 last, stride)
    for (int j = i; j > 0; --j) {
      const Axis& a = ax[j - 1];
      const Axis& c = ax[j];
      const bool swap = (a.size == 1 && c.size != 1) ||
                        ((a.size == 1) == (c.size == 1) &&
                         a.stride > c.stride);
      if (!swap) break;
      const Axis tmp = ax[j - 1];
      ax[j - 1] = ax[j];
      ax[j] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)(128 / es), 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  unsigned long long extent = hd * es;  // bytes so far
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    if (ax[i].size == 1) ax[i].stride = extent;  // never stepped along
    if (ax[i].stride % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    dims[i + 1] = ax[i].size;
    strides[i] = ax[i].stride;
    extent = ax[i].stride * ax[i].size;
    slot[ax[i].which] = i + 1;
    if (ax[i].which == 0) box[i + 1] = (cuuint32_t)rows;
  }
  pos->s = slot[0];
  pos->h = slot[1];
  pos->b = slot[2];
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUresult r = encode(
      map,
      es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<T*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int HD, int BK, int STAGES>
constexpr int smem_bytes() {
  if constexpr (sizeof(T) == 4)
    return Cfg<HD, BK, STAGES>::kSmem;
  else
    return Bf16Cfg<HD, BK, STAGES>::kSmem;
}

template <typename T, int HD, int BK, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int kv_heads, int sq, int sk, int causal,
           const Strides* st, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kSmem = smem_bytes<T, HD, BK, STAGES>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e;
    if constexpr (kF32)
      e = cudaFuncSetAttribute(tc_kernel<HD, BK, STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    else
      e = cudaFuncSetAttribute(tc_bf16_kernel<HD, BK, STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // q is read 16 bytes at a time, o written 2 elements at a time
  const long long es = sizeof(T);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(o)) % 16 ||
      st[0].s * es % 16 || st[0].h * es % 16 || st[0].b * es % 16 ||
      st[3].s % 2 || st[3].h % 2 || st[3].b % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kmap, vmap;
  Coord kc, vc;
  int rc = make_map(&kmap, &kc, static_cast<const T*>(k), HD, sk, kv_heads,
                    batch, st[1], BK);
  if (rc == 0)
    rc = make_map(&vmap, &vc, static_cast<const T*>(v), HD, sk, kv_heads,
                  batch, st[2], BK);
  if (rc != 0) return rc;
  const long long blocks =
      (long long)((sq + kBlockQ - 1) / kBlockQ) * heads * batch;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  if constexpr (kF32)
    tc_kernel<HD, BK, STAGES><<<static_cast<unsigned>(blocks), kThreads,
                                kSmem, stream>>>(
        kmap, vmap, static_cast<const float*>(q), static_cast<float*>(o),
        heads, batch, heads / kv_heads, sq, sk, causal, scale, st[0], st[3],
        kc, vc);
  else
    tc_bf16_kernel<HD, BK, STAGES><<<static_cast<unsigned>(blocks),
                                     kBf16Threads, kSmem, stream>>>(
        kmap, vmap, static_cast<const __nv_bfloat16*>(q),
        static_cast<__nv_bfloat16*>(o), heads, batch, heads / kv_heads, sq,
        sk, causal, scale, st[0], st[3], kc, vc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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
  // f32: two stages of 64 keys at hd 64 (192 KB of shared memory), of 32
  // keys at hd 128 (224 KB), the largest tiles that fit; bf16: two stages
  // of 64 keys (41 KB and 81 KB)
  if (hd == 64 && dtype == 0)
    return tc::launch<float, 64, 64, 2>(
        q, k, v, o, batch, heads, kv_heads, sq, sk, causal, st, s);
  if (hd == 128 && dtype == 0)
    return tc::launch<float, 128, 32, 2>(
        q, k, v, o, batch, heads, kv_heads, sq, sk, causal, st, s);
  if (hd == 64 && dtype == 1)
    return tc::launch<__nv_bfloat16, 64, 64, 2>(
        q, k, v, o, batch, heads, kv_heads, sq, sk, causal, st, s);
  if (hd == 128 && dtype == 1)
    return tc::launch<__nv_bfloat16, 128, 64, 2>(
        q, k, v, o, batch, heads, kv_heads, sq, sk, causal, st, s);
  if (dtype == 0)
    return simt::dispatch<float>(q, k, v, o, batch, heads, kv_heads, sq, sk,
                                 hd, causal, st, s);
  if (dtype == 1)
    return simt::dispatch<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads,
                                         sq, sk, hd, causal, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
