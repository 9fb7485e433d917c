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
// no unclaimed track; with K = 0, -1 and NEG_INF for every crop).
// `assign` must equal the plain version (kernels/similarity.py::
// associate_torch) exactly; `sim` differs from it by the order of the
// D-long f32 sums, within a stated tolerance.  NaN inputs are outside the
// contract.
//
// Bound on an H100: M*K*D*2 f32 operations (the scores) against 67 TFLOP/s
// outside the tensor cores, and the bytes of the inputs and outputs read
// and written once.  At the track presets' shapes (M = 8..128 padded
// crops, K = 8..128 tracks, D = 32) both are nanoseconds: what the kernel
// can reach is a few microseconds of one SM, and the greedy claim is the
// part that cannot spread over the card.
//
// Design: the greedy order is sequential in the crops, so one block owns
// the problem, but only the claims are sequential.  Per tile of crop rows:
//  1. stage the tile's embeddings and a chunk of tracks, both transposed,
//     into shared memory with 16-byte loads where D and the pointers
//     allow, the crops' query ids and floors with them, every load of a
//     thread in flight before its first store (one memory latency a chunk);
//  2. score pass: every warp computes 8 rows x 32*LT tracks of the
//     masked score tile at once (LT = 1, 2 or 4 tracks a lane, the
//     fewest that cover the chunk: two broadcast 16-byte loads of the
//     rows' embedding values and LT of track values feed 8*LT FMAs), each
//     dot the same chain of f32 FMAs in c = 0..D-1 order as a single
//     thread would run it (no tensor cores, no TF32), the tile kept whole
//     in shared memory (the kernel opts in to more than 48 KB of it);
//     then each row's best and runner-up in (score desc, index asc)
//     order: a group of g lanes a row (a power of two <= 32, <= K/8, and
//     small enough that every row has a group at once) scans it with
//     selects, no branches, and merges in log2(g) shuffle steps (the
//     tile's rows are padded so that the lanes' reads hit distinct
//     banks);
//  3. claims in warp 0, no block barrier inside, 32 crops a batch, one a
//     lane, resolved in rounds.  A crop takes its best entry if that is
//     unclaimed (claims only remove tracks, so it is still the first
//     maximum of what is left), and so does a crop whose every score is
//     NEG_INF (the plain version's argmax of an all-NEG_INF row is index
//     0, claimed or not).  A round lets every pending crop of the batch
//     take that shortcut at once: its best is claimed if the bitmask says
//     so or an earlier pending crop with the same best (__match_any_sync)
//     clears its floor.  Up to the first crop that cannot take it, that is
//     exactly the greedy order; those crops claim (atomicOr), and that one
//     crop takes its runner-up if that is free (or, where the runner-up
//     is NEG_INF, index 0 at NEG_INF); else the warp rescans its row over
//     the unclaimed tracks, K/32 entries a lane and two REDUX reductions,
//     ties to the lowest index.  The next round starts after that crop.
//     The claimed flags are a bitmask in shared memory.
// Tiles of rows follow one another; where a tile of one row does not fit
// the K-long score row, the wrapper refuses K (similarity.MAX_TRACKS).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;         // score rows a warp item covers
constexpr int kItemTracks = 128;  // tracks of the widest item (4 a lane)
constexpr int kDimChunk = 32;     // embedding columns staged at once
constexpr int kTrackChunk = 256;  // tracks staged at once
constexpr int kCands = 2;         // entries kept a row: best, runner-up
constexpr float kNegInf = -1e30f;
constexpr int kNoTrack = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
// a row whose best index is this saw a score below NEG_INF (or no number
// at all), so no shortcut applies and the claim loop rescans it
constexpr int kRescan = -1;

// f32 -> i32 with the same order (scores are never -0.0: every dot starts
// at +0.0 and an FMA chain cannot round to -0.0 from there)
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// every lane ends with the warp's first maximum: the highest score, then
// the lowest index holding it (jnp.argmax's rule); a lane's own (v, j)
// must already be the first maximum of its entries
__device__ __forceinline__ void warp_best(float& v, int& j) {
  const int key = ordered(v);
  const int top = __reduce_max_sync(kFull, key);
  j = __reduce_min_sync(kFull, key == top ? j : kNoTrack);
  v = __int_as_float(top >= 0 ? top : top ^ 0x7fffffff);
}

__device__ __forceinline__ bool is_claimed(const unsigned* claimed, int j) {
  return (claimed[j >> 5] >> (j & 31)) & 1u;
}

// Element idx of rows [row0, row0 + nrows) x columns [c0, c0 + ncols) of
// a (., d) matrix, neighbouring idx on neighbouring rows (so the
// transposed stores hit distinct banks): a float4 of 4 columns where `vec`
// (d, c0 and ncols multiples of 4, the matrix 16-byte aligned), else one
// float in .x.  Sets (r, c) and `ok` (idx is in the block).
__device__ __forceinline__ float4 stage_load(const float* __restrict__ src,
                                             int d, int row0, int nrows,
                                             int c0, int ncols, bool vec,
                                             int idx, int& r, int& c,
                                             bool& ok) {
  ok = idx < nrows * (vec ? ncols >> 2 : ncols);
  c = idx / nrows;
  r = idx - c * nrows;
  if (vec) c *= 4;
  if (!ok) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* at = src + static_cast<size_t>(row0 + r) * d + c0 + c;
  return vec ? *reinterpret_cast<const float4*>(at)
             : make_float4(*at, 0.0f, 0.0f, 0.0f);
}

// stage_load's element into shared memory, transposed: out[c * pitch + r]
__device__ __forceinline__ void stage_store(float* out, int pitch, bool vec,
                                            float4 x, int r, int c,
                                            bool ok) {
  if (!ok) return;
  out[c * pitch + r] = x.x;
  if (vec) {
    out[(c + 1) * pitch + r] = x.y;
    out[(c + 2) * pitch + r] = x.z;
    out[(c + 3) * pitch + r] = x.w;
  }
}

// One column chunk of the score tile: items of 8 rows x 32*LT tracks,
// each lane the tracks c0 + 32 q (q < LT) of its item.  `first`: the dots
// start at +0.0, else they go on from the chunk before; `last`: the dots
// are done, so the query mask is applied as they are stored.
template <int LT>
__device__ __forceinline__ void score_items(
    float* score, const float* emb_s, const float* trk_s, const int* cq_s,
    const int* tq_s, int kp, int kc0, int kcn, int tm, int dcn,
    int row_pitch, int pitch, bool first, bool last) {
  const int lane = threadIdx.x & 31;
  const int items_k = (kcn + 32 * LT - 1) / (32 * LT);
  const int items = (tm + kRows - 1) / kRows * items_k;
  for (int it = threadIdx.x >> 5; it < items; it += kWarps) {
    const int r0 = it / items_k * kRows;
    const int c0 = (it - it / items_k * items_k) * 32 * LT + lane;
    float acc[kRows][LT];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < LT; ++q) {
        const int row = r0 + r, col = c0 + 32 * q;
        acc[r][q] = (!first && row < tm && col < kcn)
                        ? score[static_cast<size_t>(row) * kp + kc0 + col]
                        : 0.0f;
      }
#pragma unroll 4
    for (int c = 0; c < dcn; ++c) {
      // rows r0..r0+7 of column c: the same two float4 on every lane
      const float4 e0 =
          *reinterpret_cast<const float4*>(emb_s + c * row_pitch + r0);
      const float4 e1 =
          *reinterpret_cast<const float4*>(emb_s + c * row_pitch + r0 + 4);
      const float e[kRows] = {e0.x, e0.y, e0.z, e0.w,
                              e1.x, e1.y, e1.z, e1.w};
      float t[LT];
#pragma unroll
      for (int q = 0; q < LT; ++q) t[q] = trk_s[c * pitch + c0 + 32 * q];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < LT; ++q) acc[r][q] = fmaf(e[r], t[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < LT; ++q) {
        const int row = r0 + r, col = c0 + 32 * q;
        if (row < tm && col < kcn)
          score[static_cast<size_t>(row) * kp + kc0 + col] =
              (last && cq_s[row] != tq_s[col]) ? kNegInf : acc[r][q];
      }
  }
}

// (v, j) comes before (w, i) in (score desc, index asc) order: a higher
// score, or the same score at a lower index — jnp.argmax's rule
__device__ __forceinline__ bool beats(float v, int j, float w, int i) {
  return v > w || (v == w && j < i);
}

// Merge this lane's (best, runner-up) with lane ^ off's, both in (score
// desc, index asc) order; every lane of the pair ends with the merged two.
__device__ __forceinline__ void merge_top2(float& v1, int& j1, float& v2,
                                           int& j2, int off) {
  const float w1 = __shfl_xor_sync(kFull, v1, off);
  const int i1 = __shfl_xor_sync(kFull, j1, off);
  const float w2 = __shfl_xor_sync(kFull, v2, off);
  const int i2 = __shfl_xor_sync(kFull, j2, off);
  if (beats(w1, i1, v1, j1)) {  // the other lane's best leads
    const bool keep = beats(v1, j1, w2, i2);
    v2 = keep ? v1 : w2;
    j2 = keep ? j1 : i2;
    v1 = w1;
    j1 = i1;
  } else if (beats(w1, i1, v2, j2)) {
    v2 = w1;
    j2 = i1;
  }
}

// Entries u, u + g, ... of a score row into (best, runner-up), with
// selects (no branches to diverge); returns whether one was below NEG_INF
// or not a number.
__device__ __forceinline__ bool scan_row(const float* row, int u, int g,
                                         int k, float& v1, int& j1,
                                         float& v2, int& j2) {
  bool low = false;
#pragma unroll 4
  for (int jj = u; jj < k; jj += g) {  // jj rises: a tie keeps the lower
    const float x = row[jj];
    low |= !(x >= kNegInf);
    const bool above1 = x > v1, above2 = x > v2;
    v2 = above1 ? v1 : (above2 ? x : v2);
    j2 = above1 ? j1 : (above2 ? jj : j2);
    v1 = above1 ? x : v1;
    j1 = above1 ? jj : j1;
  }
  return low;
}

// a row's candidates; a row with an entry below NEG_INF gets none
// (kRescan), so the claims rescan it
__device__ __forceinline__ void put_cands(float* cand_v, int* cand_j, int r,
                                          bool low, float v1, int j1,
                                          float v2, int j2) {
  cand_v[r * kCands] = v1;
  cand_v[r * kCands + 1] = v2;
  cand_j[r * kCands] = low ? kRescan : j1;
  cand_j[r * kCands + 1] = low ? kRescan : j2;
}

// the row's first maximum over the unclaimed tracks (claimed ones score
// NEG_INF), on every lane
__device__ __forceinline__ void rescan(const float* row,
                                       const unsigned* claimed, int k,
                                       float& v, int& j) {
  v = -INFINITY;
  j = kNoTrack;
  for (int jj = threadIdx.x & 31; jj < k; jj += 32) {
    const float a = is_claimed(claimed, jj) ? kNegInf : row[jj];
    if (a > v) {  // jj rises along the loop: a tie keeps the lower
      v = a;
      j = jj;
    }
  }
  warp_best(v, j);
}

__global__ void __launch_bounds__(kThreads)
associate_kernel(const float* __restrict__ emb, const float* __restrict__ trk,
                 const int32_t* __restrict__ crop_q,
                 const int32_t* __restrict__ trk_q,
                 const float* __restrict__ thr, int32_t* __restrict__ assign,
                 float* __restrict__ sim, int m, int k, int d, int tile_rows,
                 int track_chunk, int vec, int kp, int lg) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (k == 0) {  // nothing to match
    for (int i = tid; i < m; i += kThreads) {
      assign[i] = -1;
      sim[i] = kNegInf;
    }
    return;
  }
  const int dim_chunk = d < kDimChunk ? d : kDimChunk;
  const int row_pitch = (tile_rows + kRows - 1) / kRows * kRows;
  const int pitch = track_chunk + 1;
  const int words = (k + 31) >> 5;
  extern __shared__ float4 smem4[];
  float* emb_s = reinterpret_cast<float*>(smem4);  // dim_chunk x row_pitch
  float* trk_s = emb_s + dim_chunk * row_pitch;    // dim_chunk x pitch
  // the score tile's rows are kp apart (kp = K rounded so that the g =
  // 2^lg lanes scanning each row of a warp read distinct banks)
  float* score = trk_s + dim_chunk * pitch;        // tile_rows x kp
  float* thr_s = score + static_cast<size_t>(tile_rows) * kp;  // tile_rows
  float* cand_v = thr_s + tile_rows;                   // tile_rows x kCands
  int* cand_j = reinterpret_cast<int*>(cand_v + tile_rows * kCands);
  int* cq_s = cand_j + tile_rows * kCands;                     // tile_rows
  int* tq_s = cq_s + tile_rows;                               // track_chunk
  unsigned* claimed = reinterpret_cast<unsigned*>(tq_s + track_chunk);
  for (int w = tid; w < words; w += kThreads) claimed[w] = 0u;

  for (int i0 = 0; i0 < m; i0 += tile_rows) {
    const int tm = min(tile_rows, m - i0);
    // 1-2. the masked score tile, a chunk of tracks and columns at a time
    for (int kc0 = 0; kc0 < k; kc0 += track_chunk) {
      const int kcn = min(track_chunk, k - kc0);
      for (int dc0 = 0; dc0 < d; dc0 += kDimChunk) {
        const int dcn = min(kDimChunk, d - dc0);
        const bool first = dc0 == 0, last = dc0 + dcn >= d;
        __syncthreads();  // the previous chunk's (or tile's) readers are done
        // every thread starts all its loads (two elements of each array)
        // before its first store, so one memory latency covers the chunk
        const bool crops = first && kc0 == 0;
        const int per = vec ? dcn >> 2 : dcn;
        const int n = max(tm, kcn) * per;
        for (int base = tid; base < n; base += 2 * kThreads) {
          float4 ev[2], tv[2];
          int er[2], ec[2], tr[2], tc[2], tq[2], cq[2];
          bool eo[2], to[2];
          float th[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = base + u * kThreads;
            ev[u] = stage_load(emb, d, i0, tm, dc0, dcn, vec, idx, er[u],
                               ec[u], eo[u]);
            tv[u] = stage_load(trk, d, kc0, kcn, dc0, dcn, vec, idx, tr[u],
                               tc[u], to[u]);
            tq[u] = first && idx < kcn ? trk_q[kc0 + idx] : 0;
            cq[u] = crops && idx < tm ? crop_q[i0 + idx] : 0;
            th[u] = crops && idx < tm ? thr[i0 + idx] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = base + u * kThreads;
            stage_store(emb_s, row_pitch, vec, ev[u], er[u], ec[u], eo[u]);
            stage_store(trk_s, pitch, vec, tv[u], tr[u], tc[u], to[u]);
            if (first && idx < kcn) tq_s[idx] = tq[u];
            if (crops && idx < tm) {
              cq_s[idx] = cq[u];
              thr_s[idx] = th[u];
            }
          }
        }
        __syncthreads();
        if (kcn <= 32)
          score_items<1>(score, emb_s, trk_s, cq_s, tq_s, kp, kc0, kcn, tm,
                         dcn, row_pitch, pitch, first, last);
        else if (kcn <= 64)
          score_items<2>(score, emb_s, trk_s, cq_s, tq_s, kp, kc0, kcn, tm,
                         dcn, row_pitch, pitch, first, last);
        else
          score_items<4>(score, emb_s, trk_s, cq_s, tq_s, kp, kc0, kcn, tm,
                         dcn, row_pitch, pitch, first, last);
      }
    }
    __syncthreads();
    // each row's best and runner-up in (score desc, index asc) order,
    // before any claim of this tile: a group of g = 2^lg lanes scans a
    // row, lane u of the group the entries u, u + g, ... with selects,
    // then the group merges in lg shuffle steps (g from the launch: a
    // power of two <= 32, <= K/8, small enough that every row of a tile
    // has a group at once)
    if (lg == 0) {
      for (int r = tid; r < tm; r += kThreads) {
        float v1 = -INFINITY, v2 = -INFINITY;
        int j1 = kNoTrack, j2 = kNoTrack;
        const bool low = scan_row(score + static_cast<size_t>(r) * kp, 0, 1,
                                  k, v1, j1, v2, j2);
        put_cands(cand_v, cand_j, r, low, v1, j1, v2, j2);
      }
    } else {
      const int g = 1 << lg;
      const int u = lane & (g - 1);
      for (int r0 = 0; r0 < tm; r0 += kThreads >> lg) {
        const int r = r0 + (tid >> lg);  // one row a group
        float v1 = -INFINITY, v2 = -INFINITY;
        int j1 = kNoTrack, j2 = kNoTrack;
        bool low = r < tm && scan_row(score + static_cast<size_t>(r) * kp, u,
                                      g, k, v1, j1, v2, j2);
        for (int off = 1; off < g; off <<= 1)
          merge_top2(v1, j1, v2, j2, off);
        const unsigned group = (g == 32 ? kFull : (1u << g) - 1u)
                               << (lane & ~(g - 1));
        low = __ballot_sync(kFull, low) & group;
        if (r < tm && u == 0)
          put_cands(cand_v, cand_j, r, low, v1, j1, v2, j2);
      }
    }
    __syncthreads();
    // 3. the greedy claims, in crop order, in one warp, 32 crops a batch
    if (warp == 0) {
      const unsigned lanemask_lt = (1u << lane) - 1u;
      for (int rb = 0; rb < tm; rb += 32) {
        const int nb = min(32, tm - rb);
        const bool in = lane < nb;
        const float my_v = in ? cand_v[(rb + lane) * kCands] : kNegInf;
        const int my_j = in ? cand_j[(rb + lane) * kCands] : kRescan;
        const float my_t = in ? thr_s[rb + lane] : 0.0f;
        // the crops of the batch with the same precomputed best
        const unsigned same = __match_any_sync(kFull, in ? my_j : -2 - lane);
        int out_a = -1;
        float out_s = kNegInf;
        for (int start = 0; start < nb;) {
          __syncwarp();  // the earlier claims are in the bitmask
          const bool pending = in && lane >= start;
          // if every pending crop took its precomputed best: which would
          // claim it, and which would find it claimed
          const bool ok = pending && my_j >= 0 && my_v >= my_t;
          const unsigned claims = __ballot_sync(kFull, ok);
          const bool taken =
              pending && my_j >= 0 &&
              (is_claimed(claimed, my_j) || (same & claims & lanemask_lt));
          const unsigned blocked = __ballot_sync(
              kFull, pending && (my_j == kRescan ||
                                 (my_v != kNegInf && taken)));
          // crops start..stop-1 follow the greedy order exactly
          const int stop = blocked ? __ffs(blocked) - 1 : nb;
          if (pending && lane < stop) {
            out_a = ok ? my_j : -1;
            out_s = my_v;
            if (ok) atomicOr(&claimed[my_j >> 5], 1u << (my_j & 31));
          }
          if (stop < nb) {  // crop `stop` found its best claimed
            __syncwarp();
            const int r = rb + stop;
            float v = cand_v[r * kCands + 1];
            int j = cand_j[r * kCands + 1];
            if (j == kRescan || (v > kNegInf && is_claimed(claimed, j))) {
              rescan(score + static_cast<size_t>(r) * kp, claimed, k, v, j);
            } else if (!(v > kNegInf)) {
              // every entry but the claimed best is NEG_INF
              v = kNegInf;
              j = 0;
            }  // else the runner-up is free: the first maximum of what is left
            const bool take = v >= __shfl_sync(kFull, my_t, stop) && j < k;
            if (lane == stop) {
              out_a = take ? j : -1;
              out_s = v;
            }
            if (take && lane == 0) claimed[j >> 5] |= 1u << (j & 31);
          }
          start = stop + 1;
        }
        if (in) {
          assign[i0 + rb + lane] = out_a;
          sim[i0 + rb + lane] = out_s;
        }
      }
    }
  }
}

}  // namespace

extern "C" int associate_launch(const void* emb, const void* trk,
                                const void* crop_q, const void* trk_q,
                                const void* thr, void* assign, void* sim,
                                int m, int k, int d, void* stream) {
  if (m <= 0 || k < 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile_rows = 0, track_chunk = 0, kp = 0, lg = 0;
  size_t bytes = 0;
  if (k > 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int dim_chunk = d < kDimChunk ? d : kDimChunk;
    const int rounded = (k + kItemTracks - 1) / kItemTracks * kItemTracks;
    track_chunk = rounded < kTrackChunk ? rounded : kTrackChunk;
    // trk_s, tq_s, the claimed bitmask and the staged embedding's padding
    // rows; then a row's staged embedding, score (kp wide, at most K + 63),
    // threshold, candidates and query id
    const size_t fixed =
        4 * (static_cast<size_t>(dim_chunk) * (track_chunk + 1 + kRows - 1) +
             track_chunk + (k + 31) / 32);
    const size_t others =
        4 * (static_cast<size_t>(dim_chunk) + 2 + 2 * kCands);
    const size_t widest = 4 * (static_cast<size_t>(k) + 63) + others;
    if (fixed + widest > static_cast<size_t>(optin))
      return static_cast<int>(cudaErrorInvalidValue);  // K too large
    const size_t fit = (optin - fixed) / widest;
    tile_rows = static_cast<int>(fit < static_cast<size_t>(m) ? fit : m);
    // g = 2^lg lanes scan a row for its candidates; rows kp apart, kp
    // = g mod 32 (odd for g = 1) puts a warp's groups on distinct banks
    while (lg < 5 && (2 << lg) * tile_rows <= kThreads && 8 * (2 << lg) <= k)
      ++lg;
    kp = lg == 0 ? (k | 1) : (k + 31) / 32 * 32 + ((1 << lg) & 31);
    bytes = fixed + tile_rows * (4 * static_cast<size_t>(kp) + others);
    static size_t opted = 48 * 1024;  // what a launch gets without opting in
    if (bytes > opted) {
      err = cudaFuncSetAttribute(associate_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted = optin;
    }
  }
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(emb) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(trk) % 16) == 0;
  associate_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(trk),
      static_cast<const int32_t*>(crop_q), static_cast<const int32_t*>(trk_q),
      static_cast<const float*>(thr), static_cast<int32_t*>(assign),
      static_cast<float*>(sim), m, k, d, tile_rows, track_chunk,
      vec ? 1 : 0, kp, lg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* associate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
