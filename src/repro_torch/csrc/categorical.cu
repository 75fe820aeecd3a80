// The DIS draw: row r of a (cap, n) categorical draw is
// argmax_c(gumbel[r, c] + logits[c]), with the gumbel bits of
// jax.random.categorical(key, logits, shape=(cap,)) under the
// non-partitionable threefry layout, computed in one pass per row.
//
// There is no TPU kernel behind it: the reference leaves
// jax.random.categorical to XLA (src/repro/core/dis.py:184 and :196, the
// two DIS rounds; src/repro/core/vkmc.py:60 and :67, k-means++).  The plain
// version is repro_torch.rng.categorical_plain, which this kernel equals
// bit for bit.
//
// Per candidate (r, c), at flat position p = r * n + c of the cap * n-word
// draw, the kernel
//   1. hashes the counter pair of p as repro_torch.rng._bits_at does: past
//      2**32 - 1 words the draw is blocks of 2**32 - 1 words, block b under
//      key b of split(key, nblocks + 1) (the table the wrapper passes in);
//      within a block of size s, p pairs with p + ceil(s / 2), an odd s pads
//      the last pair with a zero, and the word is lane 0 below the half and
//      lane 1 above;
//   2. forms the uniform (mantissa trick, + tiny, clamped at tiny) and the
//      gumbel -log(-log(u)) with rng.log's operations in rng.log's order:
//      each _fma there is one __fmaf_rn here, every other product and sum
//      is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, which the
//      compiler never contracts into an FMA), no fast-math, subnormals of
//      the input count as zero;
//   3. adds the logit and keeps the row's maximum, the first index on ties,
//      NaN above everything (torch.argmax's order).
//
// What bounds it: integer operations.  The algorithm needs 91 int32
// operations per candidate (threefry's 20 rounds of add, rotate and xor,
// its key injections, the counter pair, the bit fields of the uniform and
// the two logs, the running maximum) and 70 fp32 ones (two logs of 9 FMAs
// and their other steps, the uniform, the sum, the compare);
// chip_smoke.py's K5_INT32_OPS and K5_FP32_OPS list them.  The H100 runs
// 64 int32 operations per SM and clock against 128 fp32 ones, so the int32
// pipe is the roof; memory traffic is negligible (the logits are read
// from L2 once a row).
// The design keeps the whole card busy:
//   - long rows (more columns than categorical.ROW_THREAD_MAX): 256
//     threads a CTA on one tile of one row, each thread walking its
//     columns in order and keeping the first maximum; a warp-shuffle and
//     shared-memory merge gives the tile's (value, index); when a row has
//     several tiles (few rows, e.g. one k-means++ pick over 463,715 rows),
//     a second kernel merges the tiles' partials, one warp a row.  The
//     merge order is a total order on (value, index), so the result is the
//     same whatever the order, and no atomics are used: two launches give
//     the same bits;
//   - short rows (e.g. the round-1 draw over T parties): one thread a row.
// The wrapper (repro_torch/kernels/categorical.py) picks the tiles from
// the shapes alone.
//
// Two entry shapes share the kernels: one stream (counts == nullptr: rows
// are rows 0..rows-1 of the stream) and T party streams (counts on the
// device: global row g belongs to the party j whose exclusive cumulative
// count offset_j <= g < offset_j + counts[j], as row g - offset_j of that
// party's stream, so the output comes out party-major).  A row past the
// counts' sum, or at or past cap, comes out as -1.
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kBlockWords = 0xFFFFFFFFull;   // 2**32 - 1

// float32 constants of rng.log as bit patterns (rng._LOG_P, _LOG_Q1,
// _LOG_Q2, _SQRTHF, _TINY), so no decimal literal is rounded twice
__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }
#define kP0 f32(0x3d9021bbu)
#define kP1 f32(0xbdebd1b8u)
#define kP2 f32(0x3def251au)
#define kP3 f32(0xbdfe5d4fu)
#define kP4 f32(0x3e11e9bfu)
#define kP5 f32(0xbe2aae50u)
#define kP6 f32(0x3e4cceacu)
#define kP7 f32(0xbe7ffffcu)
#define kP8 f32(0x3eaaaaaau)
#define kQ1 f32(0xb95e8083u)
#define kQ2 f32(0x3f318000u)
#define kSqrtHalf f32(0x3f3504f3u)
#define kTiny f32(0x00800000u)

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// threefry2x32 (20 rounds, jax's unrolled lowering) of the counter pair
// (x1, x2) under (k1, k2); lane 0 when `lane0`, else lane 1
__device__ __forceinline__ uint32_t threefry(uint32_t k1, uint32_t k2, uint32_t x1,
                                             uint32_t x2, bool lane0) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  uint32_t a = x1 + k1, b = x2 + k2;
#define REPRO_ROUND(r) \
  a += b;              \
  b = rotl32(b, r) ^ a;
#define REPRO_ROUNDS_A REPRO_ROUND(13) REPRO_ROUND(15) REPRO_ROUND(26) REPRO_ROUND(6)
#define REPRO_ROUNDS_B REPRO_ROUND(17) REPRO_ROUND(29) REPRO_ROUND(16) REPRO_ROUND(24)
  REPRO_ROUNDS_A a += k2; b += k3 + 1u;
  REPRO_ROUNDS_B a += k3; b += k1 + 2u;
  REPRO_ROUNDS_A a += k1; b += k2 + 3u;
  REPRO_ROUNDS_B a += k2; b += k3 + 4u;
  REPRO_ROUNDS_A a += k3; b += k1 + 5u;
#undef REPRO_ROUNDS_B
#undef REPRO_ROUNDS_A
#undef REPRO_ROUND
  return lane0 ? a : b;
}

// word `off` of a `bsize`-word threefry draw under (k1, k2) (bsize <= 2**32 - 1)
__device__ __forceinline__ uint32_t word_in_block(uint32_t k1, uint32_t k2, uint32_t off,
                                                  uint32_t bsize) {
  const uint32_t half = (uint32_t)(((unsigned long long)bsize + 1ull) >> 1);
  const bool lo = off < half;
  const uint32_t x1 = lo ? off : off - half;
  uint32_t x2 = lo ? off + half : off;
  if (x2 >= bsize) x2 = 0u;   // the odd-size pad
  return threefry(k1, k2, x1, x2, lo);
}

// rng.log: XLA's float32 log on the CPU, operation for operation
__device__ __forceinline__ float xla_log(float x) {
  const float xc = fmaxf(x, kTiny);
  const int bits = __float_as_int(xc);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float mant = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool low = mant < kSqrtHalf;
  const float t = __fadd_rn(__fsub_rn(mant, 1.0f), low ? mant : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float z = __fmul_rn(t, t);
  const float t3 = __fmul_rn(z, t);
  const float p = __fmaf_rn(__fmaf_rn(t, kP0, kP1), t, kP2);
  const float q = __fmaf_rn(__fmaf_rn(t, kP3, kP4), t, kP5);
  const float r = __fmaf_rn(__fmaf_rn(t, kP6, kP7), t, kP8);
  float y = __fmaf_rn(__fmaf_rn(p, t3, q), t3, r);
  y = __fmaf_rn(y, t3, __fmul_rn(e, kQ1));
  float out = __fadd_rn(__fadd_rn(__fsub_rn(t, __fmul_rn(0.5f, z)), y), __fmul_rn(e, kQ2));
  if (isinf(x) && x > 0.0f) out = x;
  if (fabsf(x) < kTiny) out = -INFINITY;
  if (x <= -kTiny || isnan(x)) out = NAN;
  return out;
}

// gumbel[p] + logit for the word `bits` (rng._gumbel_of, then the sum)
__device__ __forceinline__ float candidate(uint32_t bits, float logit) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(__fadd_rn(f, kTiny), kTiny);
  const float g = -xla_log(-xla_log(u));
  return __fadd_rn(g, logit);
}

// (v, i) before (bv, bi) in torch.argmax's order: NaN first, then larger
// values, ties to the lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, bv, o);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

struct Draw {
  const long long* keys;    // (T, nkeys, 2) words of each party's block keys
  int nkeys;                // nblocks + 1
  unsigned long long nblocks;
  uint32_t rem;             // words in the last block (the whole draw if nblocks == 0)
  const float* logits;      // party j's at logits + j * lstride
  long long lstride;
  long long n, cap;
  const long long* counts;  // (T,) rows per party, or nullptr: one stream
  int T;
  long long rows;           // output rows
};

// party and stream row of global row g; false for a row past the counts'
// sum or at or past cap
__device__ __forceinline__ bool locate(const Draw& d, long long g, int* j, long long* r) {
  if (d.counts == nullptr) {
    *j = 0;
    *r = g;
    return g < d.cap;
  }
  long long off = 0;
  for (int t = 0; t < d.T; ++t) {
    const long long a = d.counts[t];
    if (g < off + a) {
      *j = t;
      *r = g - off;
      return *r < d.cap;
    }
    off += a;
  }
  return false;
}

// the word at position p of party j's cap * n-word draw, whose block keys
// are `keys` (below the counter limit, the one key (k1, k2))
template <bool kBlocked>
__device__ __forceinline__ uint32_t word_at(const Draw& d, const long long* keys, uint32_t k1,
                                            uint32_t k2, unsigned long long p) {
  if (!kBlocked) return word_in_block(k1, k2, (uint32_t)p, d.rem);
  const unsigned long long blk = p / kBlockWords;
  const uint32_t off = (uint32_t)(p - blk * kBlockWords);
  const uint32_t bsize = blk < d.nblocks ? 0xFFFFFFFFu : d.rem;
  return word_in_block((uint32_t)keys[2 * blk], (uint32_t)keys[2 * blk + 1], off, bsize);
}

// One tile of one row per CTA: (row, tile) work items, grid-strided.  With
// one tile a row it writes the row's index; with several, the tile's
// (value, index) partial for the merge kernel.
template <bool kBlocked>
__global__ void __launch_bounds__(kThreads)
    categorical_tile_kernel(Draw d, int tiles, long long tile_cols, float* pval, int* pidx,
                            long long* out) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int tid = threadIdx.x;
  const long long items = d.rows * tiles;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const long long g = w / tiles;
    const int tile = (int)(w - g * tiles);
    int j = 0;
    long long r = 0;
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (locate(d, g, &j, &r)) {
      const long long* keys = d.keys + (long long)j * d.nkeys * 2;
      const uint32_t k1 = (uint32_t)keys[0], k2 = (uint32_t)keys[1];
      const float* lg = d.logits + j * d.lstride;
      const unsigned long long base = (unsigned long long)r * (unsigned long long)d.n;
      const long long c0 = (long long)tile * tile_cols;
      const long long c1 = min(d.n, c0 + tile_cols);
      for (long long c = c0 + tid; c < c1; c += kThreads) {
        const float v = candidate(word_at<kBlocked>(d, keys, k1, k2, base + c), lg[c]);
        // columns in increasing order: a strict > keeps the first maximum
        if (bi == INT_MAX || v > bv || (isnan(v) && !isnan(bv))) {
          bv = v;
          bi = (int)c;
        }
      }
      warp_best(bv, bi);
      if ((tid & 31) == 0) {
        sv[tid >> 5] = bv;
        si[tid >> 5] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int k = 1; k < kThreads / 32; ++k)
          if (better(sv[k], si[k], bv, bi)) {
            bv = sv[k];
            bi = si[k];
          }
      }
      __syncthreads();
    } else {
      bv = NAN;   // merges ahead of every candidate, so the row comes out -1
      bi = -1;
    }
    if (tid == 0) {
      if (pval == nullptr) {
        out[g] = bi;
      } else {
        pval[w] = bv;
        pidx[w] = bi;
      }
    }
  }
}

// The tiles' partials of each row merged into its index, one warp a row.
__global__ void __launch_bounds__(kThreads)
    categorical_merge_kernel(const float* pval, const int* pidx, long long rows, int tiles,
                             long long* out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long g = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); g < rows;
       g += warps) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int t = lane; t < tiles; t += 32) {
      const float v = pval[g * tiles + t];
      const int i = pidx[g * tiles + t];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) out[g] = bi;
  }
}

// Short rows: one thread a row, its columns in order.
template <bool kBlocked>
__global__ void __launch_bounds__(kThreads) categorical_row_kernel(Draw d, long long* out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < d.rows; g += stride) {
    int j = 0;
    long long r = 0;
    if (!locate(d, g, &j, &r)) {
      out[g] = -1;
      continue;
    }
    const long long* keys = d.keys + (long long)j * d.nkeys * 2;
    const uint32_t k1 = (uint32_t)keys[0], k2 = (uint32_t)keys[1];
    const float* lg = d.logits + j * d.lstride;
    const unsigned long long base = (unsigned long long)r * (unsigned long long)d.n;
    float bv = -INFINITY;
    long long bi = 0;
    for (long long c = 0; c < d.n; ++c) {
      const float v = candidate(word_at<kBlocked>(d, keys, k1, k2, base + c), lg[c]);
      if (v > bv || (isnan(v) && !isnan(bv))) {
        bv = v;
        bi = c;
      }
    }
    out[g] = bi;
  }
}

// grid of a grid-strided launch: the items' CTAs, at most 2**20
unsigned grid_for(long long ctas) {
  return (unsigned)(ctas < 1 ? 1 : (ctas > (1 << 20) ? (1 << 20) : ctas));
}

}  // namespace

// keys: (T, nkeys, 2) int64 words; logits: party j's n floats at
// logits + j * lstride; counts: (T,) int64 on the device, or nullptr with
// T == 1 (one stream); size = cap * n.  tiles == 0 takes the row-per-thread
// kernel; tiles > 1 needs pval / pidx of rows * tiles entries.
REPRO_API int repro_categorical(const long long* keys, int nkeys, unsigned long long size,
                                const float* logits, long long lstride, long long n,
                                long long cap, const long long* counts, int T, long long rows,
                                int tiles, long long tile_cols, float* pval, int* pidx,
                                long long* out, void* stream) {
  if (rows <= 0) return 0;
  if (n < 1 || n > INT_MAX || cap < 1 || nkeys < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Draw d;
  d.keys = keys;
  d.nkeys = nkeys;
  d.nblocks = (unsigned long long)(nkeys - 1);
  d.rem = (uint32_t)(size - d.nblocks * kBlockWords);
  d.logits = logits;
  d.lstride = lstride;
  d.n = n;
  d.cap = cap;
  d.counts = counts;
  d.T = T;
  d.rows = rows;
  if (size / (unsigned long long)n != (unsigned long long)cap ||
      size - d.nblocks * kBlockWords > kBlockWords)
    return (int)cudaErrorInvalidValue;
  const bool blocked = nkeys > 1;
  if (tiles == 0) {
    const unsigned grid = grid_for((rows + kThreads - 1) / kThreads);
    if (blocked)
      categorical_row_kernel<true><<<grid, kThreads, 0, s>>>(d, out);
    else
      categorical_row_kernel<false><<<grid, kThreads, 0, s>>>(d, out);
    return (int)cudaGetLastError();
  }
  float* pv = tiles > 1 ? pval : nullptr;
  const unsigned grid = grid_for(rows * tiles);
  if (blocked)
    categorical_tile_kernel<true><<<grid, kThreads, 0, s>>>(d, tiles, tile_cols, pv, pidx, out);
  else
    categorical_tile_kernel<false><<<grid, kThreads, 0, s>>>(d, tiles, tile_cols, pv, pidx, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return (int)e;
  categorical_merge_kernel<<<grid_for((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                             s>>>(pval, pidx, rows, tiles, out);
  return (int)cudaGetLastError();
}
