// Fused k-means assign + cluster update: one Lloyd iteration's read of X,
// and Algorithm 3's cluster sizes and costs.  Per row the nearest center
// and its squared distance; per cluster csum = sum_i w_i x_i (k, d),
// wsum = sum_i w_i (k) and ccost = sum_i w_i d2_i (k).
//
// Replaces the TPU kernel
// src/repro/kernels/kmeans_assign_update.py::kmeans_assign_update (Pallas
// body `_kernel`), which folds each tile into VMEM accumulators carried
// across a sequential grid with a one-hot matmul on the MXU, and flushes
// them on the last step.  GPU blocks run in no order and share nothing, so
// the sums become a deterministic two-stage reduction.
//
// Bound on the H100 at the main-path shapes (k = 10): Lloyd and scoring on
// the stacked parties, X (3, 463,715, 30) with w = None, read 167 MB of X
// and write 11 MB of assign and d2: 53 us at 3.35 TB/s.  The full-data
// baseline fit, X (463,715, 90) with unit weights, reads 167 MB of X and
// 1.9 MB of w and writes 3.7 MB: 52 us.  The arithmetic is about
// 2 n k d + 4 n d = 1.0 GFLOP of fp32, 15 us at 67 TFLOP/s, so the kernel
// is bound by bytes.  The coreset fit's (m, 90) is bound by the launch.
// This kernel runs at 3-5x the byte bound at full n: its distance and fold
// phases issue more instructions than the SMs hide behind the copies
// (PERF.md, the K2 findings).
//
// Design.  Stage 1 splits each batch entry's rows into P fixed contiguous
// ranges, one CTA each (grid (P, B)); the split is a function of n alone
// (kernels/kmeans_assign_update.py::row_split).  Each CTA writes a partial
// of the (k d + 2 k) sums to a (B, P, k d + 2 k) scratch, and stage 2 sums
// the P partials of each entry in order p = 0..P-1.  No float atomics
// anywhere: two launches on the same input give the same bits, which the
// coreset draws downstream rely on (ccost feeds the vkmc scores).  fp32 with
// explicit fmaf, no tensor cores and no TF32; no padding of d or k to 128
// lanes.
//
// The bit contract.  Each entry of a partial is one chain: it starts at 0.f
// and takes fmaf(w_i, x_ij, s) (csum), s + w_i (wsum) or fmaf(w_i, d2_i, s)
// (ccost, d2 clamped) over the range's rows of its cluster, in ascending row
// order across tile boundaries; w = None is w_i = 1.f.  The distance to each
// center is kmeans_common.cuh's assign_row: fmaf chains over j = 0..d-1,
// (x2 + cn) - 2 t, the argmin at the first index of the smallest unclamped
// value, then the minimum clamped.  Stage 1 has three kernels that keep
// this contract: kau_partial_kernel (the fast route, where C, the sums and a
// row tile fit in shared memory), kau_assign_kernel + kau_fold_kernel (the
// general route, everywhere else) and kau_partial_global_kernel, the first
// general variant, which reads its operands from global memory one row a
// thread.  That one is the oracle that chip_smoke.py and the gpu tests hold
// both routes to, bit for bit (kernels/kmeans_assign_update.py::_launch with
// global_variant=True); no user's call runs it.
//
// The fast stage 1, kau_partial_kernel, 256 threads (8 warps) a CTA:
// - C transposed, ||c||^2 (kmeans_common.cuh's load_centers) and the CTA's
//   partial sums stay in shared memory for the CTA's life.
// - The range moves through shared memory in tiles of R rows (128 at the
//   main-path shapes) in a ring of two buffers where two fit, one where only
//   one does, so that tile t + 1 is in flight while tile t is assigned and
//   folded.  The copies are 4-byte cp.async, a warp per row: rows of 90
//   floats start 360 bytes apart, so no 16-byte copy lines up.  A staged row
//   holds x, then w (1 for w = None), then, once assigned, its clamped d2,
//   at the odd stride ld = (d + 2) | 1, so thread r reading row r hits
//   distinct banks.
// - Distances: 256 / R threads share a row, each scanning a contiguous run
//   of 8-center blocks (at R = 128 and k = 10, one block each); the last,
//   shorter block costs only its real centers.  The threads of one run are
//   whole warps, so every read of C is a broadcast.  The runs' (min,
//   argmin) are combined in run order through the row's d2 slot and the
//   tile's assignment array: a later run wins only with a strictly smaller
//   value, which is the sequential scan's answer, ties included.
// - Folding, in place of a rescan of the tile for every entry: the work is
//   split into tasks (cluster l, up to 128 columns of the staged row, where
//   column d stands for wsum[l] and column d + 1 for ccost[l]), a warp
//   each, compiled for the number of 32-column chunks it holds.  The warp
//   finds its cluster's rows with one ballot per 32 rows of the tile; lane
//   i finds the i-th of them in row order (popcounts), and the warp takes
//   them in that order (shuffles), eight at a time so that their loads go
//   out together.  A row costs a lane one load and one fmaf per
//   chain, and each chain takes exactly its cluster's rows in row order:
//   about 1/k of a rescan's iterations, with 32 lanes on consecutive columns
//   of one staged row (no bank conflicts).  One owner per entry, no atomics,
//   not even in shared memory.
// - Registers are capped for three CTAs per SM, so the (3, n, 30) stack's
//   792 CTAs run in two waves.
// The shared-memory floats per tile row equal the earlier layout's (three
// per-row arrays became two row columns and one int), so every (k, d) that
// kept a shared-memory layout before keeps one: k = 424 at d = 64.  A (k, d)
// whose layout does not fit takes the general route below, then the same
// stage 2.
//
// The general route's bound on the H100: its product is 2 n k d fp32
// operations, so at (20001, 64) x (2000, 64) it is bound by them (5.2 GFLOP,
// 78 us at 67 TFLOP/s), and at (20001, 2048) x (10, 2048) by reading X
// (164 MB, 49 us at 3.35 TB/s), which its fold reads a second time.  The
// product is a register-tiled fp32 GEMM without tensor cores (TF32 would
// round x and c and break the bits), kmeans_tiled.cuh's, which K4's tiled
// route runs too; its fold is O(n d), where the first general variant's
// rescan of every tile for every entry was O(n k d).
#include "kmeans_tiled.cuh"

namespace {

constexpr int kThreads = 256;   // K2's own CTA (kmeans::kThreads is K4's and
                                // the global variants')
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;   // tile rows at most: four 32-row ballots
constexpr int kChunks = 4;      // 32-column chunks of a fold task

// Floats of a staged row: x, w and d2, rounded up to an odd count.
__host__ __device__ inline int kau_row_stride(int d) { return (d + 2) | 1; }

// Entry e of a CTA's (k d + 2 k) partial sums, `s` so far, plus the tile's
// nr rows of its cluster in row order: entries [0, kd) are csum[l][j] (x
// row i at xt[i * ld + j]), [kd, kd + k) wsum[l], then ccost[l].  The tile's
// assignments sa, weights sw and clamped d2 sd are in shared memory.  (The
// global variant's fold.)
__device__ inline float add_tile_rows(float s, int e, int nr, const int* sa,
                                      const float* sw, const float* sd,
                                      const float* xt, long long ld, int d,
                                      int k) {
  const int kd = k * d;
  if (e < kd) {
    const int l = e / d, j = e - l * d;
    for (int i = 0; i < nr; ++i)
      if (sa[i] == l) s = fmaf(sw[i], xt[i * ld + j], s);
  } else if (e < kd + k) {
    const int l = e - kd;
    for (int i = 0; i < nr; ++i)
      if (sa[i] == l) s += sw[i];
  } else {
    const int l = e - kd - k;
    for (int i = 0; i < nr; ++i)
      if (sa[i] == l) s = fmaf(sw[i], sd[i], s);
  }
  return s;
}

// The scan of one staged row xr over the W centers from l0 (a block of 8,
// or the last, shorter one, which then costs only W fmaf a column):
// assign_row's arithmetic (each t and x2 an fmaf chain over j = 0..d-1; x2
// is recomputed per block, the same chain each time), folded into (*best,
// *arg) with assign_row's rule: center 0 always, then strictly smaller
// values only.
template <int W>
__device__ __forceinline__ void scan_block(const float* xr, const float* CT,
                                           const float* cn, int d, int kp,
                                           int l0, float* best, int* arg) {
  float t[W];
#pragma unroll
  for (int i = 0; i < W; ++i) t[i] = 0.f;
  float x2 = 0.f;
#pragma unroll 2
  for (int j = 0; j < d; ++j) {
    const float xj = xr[j];
    const float4 c0 = *reinterpret_cast<const float4*>(CT + j * kp + l0);
    const float4 c1 = W > 4 ? *reinterpret_cast<const float4*>(CT + j * kp + l0 + 4) : c0;
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    x2 = fmaf(xj, xj, x2);
#pragma unroll
    for (int i = 0; i < W; ++i) t[i] = fmaf(xj, c[i], t[i]);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int l = l0 + i;
    // 2 t is exact, so contracting this into an fma changes no bit
    const float dl = (x2 + cn[l]) - 2.0f * t[i];
    if (l == 0 || dl < *best) {
      *best = dl;
      *arg = l;
    }
  }
}

// scan_block over the center blocks [blo, bhi) in order.
__device__ __forceinline__ void scan_blocks(const float* xr, const float* CT,
                                            const float* cn, int d, int k,
                                            int blo, int bhi, float* best,
                                            int* arg) {
  const int kp = kmeans::padded_k(k);
  for (int bl = blo; bl < bhi; ++bl) {
    const int l0 = bl * kmeans::kL;
    switch (min(kmeans::kL, k - l0)) {
      case 1: scan_block<1>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 2: scan_block<2>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 3: scan_block<3>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 4: scan_block<4>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 5: scan_block<5>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 6: scan_block<6>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 7: scan_block<7>(xr, CT, cn, d, kp, l0, best, arg); break;
      default: scan_block<8>(xr, CT, cn, d, kp, l0, best, arg); break;
    }
  }
}

// Add rows of one cluster to a fold task's NCH chains per lane, in the
// order given: the i-th row is lane i's `row` of the tile, for i < nrows.
// Lane chain u reads column col[u] of a staged row and takes fmaf(w, v, s);
// for the wsum column v is 1, and fmaf(w, 1, s) is s + w exactly.  Eight
// rows per turn, so that their loads go out together.
template <int NCH>
__device__ __forceinline__ void fold_rows(float* s, const float* xs, int ld,
                                          int d, const int* col,
                                          const bool* unit, int row,
                                          int nrows) {
  for (int i0 = 0; i0 < nrows; i0 += 8) {
    int off[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) off[i] = __shfl_sync(0xffffffffu, row, i0 + i) * ld;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wr = xs[off[i] + d];
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        const float v = unit[u] ? 1.f : xs[off[i] + col[u]];
        if (i0 + i < nrows) s[u] = fmaf(wr, v, s[u]);
      }
    }
  }
}

// The position of the i-th set bit (from 0) of m, for i < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int i) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const unsigned low = m & ((1u << half) - 1u);
    const int c = __popc(low);
    if (i >= c) {
      i -= c;
      m >>= half;
      pos += half;
    } else {
      m = low;
    }
  }
  return pos;
}

// One fold task: cluster l's chains for NCH 32-column chunks of the staged
// row from column c0, over the tile's rows of l (ballot masks m, counts cnt,
// total rows), added to the CTA's partial sums in acc.  Lane u-th column c
// is csum[l][c] for c < d, wsum[l] at d and ccost[l] at d + 1.
template <int NCH>
__device__ __forceinline__ void fold_task(float* acc, const float* xs, int ld,
                                          int d, int k, int l, int c0,
                                          const unsigned* m, const int* cnt,
                                          int total) {
  const int lane = threadIdx.x & 31;
  const int kd = k * d;
  int col[NCH], ent[NCH];
  bool unit[NCH];
  float s[NCH];
#pragma unroll
  for (int u = 0; u < NCH; ++u) {
    const int c = c0 + 32 * u + lane;
    ent[u] = c < d ? l * d + c : c == d ? kd + l : c == d + 1 ? kd + k + l : -1;
    col[u] = min(c, d + 1);
    unit[u] = c == d;
    s[u] = ent[u] >= 0 ? acc[ent[u]] : 0.f;
  }
  // up to 32 of the cluster's rows at a time: lane i finds the i-th in row
  // order, then the warp adds them in that order
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    int row = 0;
    if (e < total) {
      // the 32-row group that holds entry e, and the entries before it
      int q = 0, before = 0, upto = cnt[0];
      unsigned mq = m[0];
#pragma unroll
      for (int g = 1; g < kMaxRows / 32; ++g) {
        if (e >= upto) {
          q = g;
          mq = m[g];
          before = upto;
        }
        upto += cnt[g];
      }
      row = 32 * q + nth_set_bit(mq, e - before);
    }
    fold_rows<NCH>(s, xs, ld, d, col, unit, row, min(32, total - base));
  }
#pragma unroll
  for (int u = 0; u < NCH; ++u)
    if (ent[u] >= 0) acc[ent[u]] = s[u];
}

template <int kDepth>
__global__ void __launch_bounds__(kThreads, 3) kau_partial_kernel(
    const float* __restrict__ X, const float* __restrict__ C,
    const float* __restrict__ w, int* __restrict__ assign,
    float* __restrict__ d2, float* __restrict__ part, long long n, int d,
    int k, int rows, long long rows_per_cta, long long x_bstride,
    long long c_bstride, long long w_bstride) {
  extern __shared__ float4 smem4[];
  const int kp = kmeans::padded_k(k);
  const int ld = kau_row_stride(d);
  const int kd = k * d;
  const int E = kd + 2 * k;
  float* CT = reinterpret_cast<float*>(smem4);
  float* cn = CT + (size_t)d * kp;
  float* acc = cn + kp;                                // [E] partial sums
  int* sa = reinterpret_cast<int*>(acc + E);           // [rows] assignments
  float* ring = reinterpret_cast<float*>(sa + rows);   // [kDepth][rows][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = gridDim.x;
  const long long p = blockIdx.x, b = blockIdx.y;
  const float* Xb = X + b * x_bstride;
  const float* wb = w ? w + b * w_bstride : nullptr;
  const long long lo = p * rows_per_cta;
  const long long hi = min(n, lo + rows_per_cta);
  const int ntiles = (int)((hi - lo + rows - 1) / rows);

  // stage tile t (if there is one) into its buffer and commit a group (an
  // empty one past the last tile, so every thread counts the same groups)
  auto issue = [&](int t) {
    if (t < ntiles) {
      const long long r0 = lo + (long long)t * rows;
      const int nr = (int)min((long long)rows, hi - r0);
      float* xs = ring + (size_t)(t % kDepth) * rows * ld;
      const float* src = Xb + r0 * d;
      for (int r = warp; r < nr; r += kWarps)
        for (int c = lane; c < d; c += 32)
          cp_async4(xs + r * ld + c, src + (long long)r * d + c);
      for (int r = threadIdx.x; r < nr; r += kThreads) {
        if (wb)
          cp_async4(xs + r * ld + d, wb + r0 + r);
        else
          xs[r * ld + d] = 1.f;
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < kDepth - 1; ++t) issue(t);
  for (int e = threadIdx.x; e < E; e += kThreads) acc[e] = 0.f;
  kmeans::load_centers(C + b * c_bstride, CT, cn, d, k);   // ends in a barrier

  // distances: thread (r, h) scans run h, center blocks [blo, bhi), of row r
  const int runs = kThreads / rows;
  const int h = threadIdx.x / rows, r = threadIdx.x - h * rows;
  const int nb = kp / kmeans::kL;
  const int per = (nb + runs - 1) / runs;
  const int blo = min(nb, h * per), bhi = min(nb, blo + per);
  // fold tasks: (cluster l, 32 kChunks columns of the staged row)
  const int groups = (d + 2 + 32 * kChunks - 1) / (32 * kChunks);
  const int ntasks = k * groups;

  for (int t = 0; t < ntiles; ++t) {
    if (kDepth == 1) {
      if (t > 0) __syncthreads();   // every thread is done with the buffer
      issue(t);
      cp_async_wait<0>();
    } else {
      cp_async_wait<kDepth - 2>();
    }
    __syncthreads();   // tile t has landed for every thread, and (kDepth >
                       // 1) every thread is done with tile t - 1's buffer
    if (kDepth > 1) issue(t + kDepth - 1);   // into that buffer
    const long long r0 = lo + (long long)t * rows;
    const int nr = (int)min((long long)rows, hi - r0);
    float* xs = ring + (size_t)(t % kDepth) * rows * ld;

    float best = __int_as_float(0x7f800000);   // +inf: an empty run
    int arg = -1;
    if (r < nr) scan_blocks(xs + r * ld, CT, cn, d, k, blo, bhi, &best, &arg);
    // combine the runs, last to first, through the row's d2 slot and sa;
    // run 0 writes the row's result
    for (int q = runs - 1; q >= 0; --q) {
      if (h == q && r < nr) {
        float* slot = xs + r * ld + d + 1;
        if (q < runs - 1) {
          const float bl = *slot;
          const int al = sa[r];
          if (al >= 0 && bl < best) {
            best = bl;
            arg = al;
          }
        }
        if (q > 0) {
          *slot = best;
          sa[r] = arg;
        } else {
          const float dd = fmaxf(best, 0.f);
          *slot = dd;
          sa[r] = arg;
          assign[b * n + r0 + r] = arg;
          d2[b * n + r0 + r] = dd;
        }
      }
      __syncthreads();
    }

    // fold the tile into the partial sums
    for (int task = warp; task < ntasks; task += kWarps) {
      const int l = task / groups;
      const int c0 = (task - l * groups) * 32 * kChunks;
      // the tile's rows of cluster l: one ballot per 32 rows
      unsigned m[kMaxRows / 32];
      int cnt[kMaxRows / 32];
      int total = 0;
#pragma unroll
      for (int q = 0; q < kMaxRows / 32; ++q) {
        const int i = q * 32 + lane;
        m[q] = __ballot_sync(0xffffffffu, i < nr && sa[i] == l);
        cnt[q] = __popc(m[q]);
        total += cnt[q];
      }
      if (total == 0) continue;   // no row of l in this tile
      switch (min(kChunks, (d + 2 - c0 + 31) / 32)) {
        case 1: fold_task<1>(acc, xs, ld, d, k, l, c0, m, cnt, total); break;
        case 2: fold_task<2>(acc, xs, ld, d, k, l, c0, m, cnt, total); break;
        case 3: fold_task<3>(acc, xs, ld, d, k, l, c0, m, cnt, total); break;
        default: fold_task<4>(acc, xs, ld, d, k, l, c0, m, cnt, total); break;
      }
    }
  }
  __syncthreads();   // every task's sums are in acc
  float* dst = part + (b * P + p) * (long long)E;
  for (int e = threadIdx.x; e < E; e += kThreads) dst[e] = acc[e];
}

// The global variant of stage 1, for (k, d) whose layout (C, a row tile and
// the (k d + 2 k) sums) does not fit in shared memory.  The CTA walks the same
// row range as kau_partial_kernel, 128 rows at a time: one row per thread
// through kmeans::assign_row_global (C and the row read through the caches,
// assign_row's result bit for bit), the tile's assignments, clamped d2 and
// weights in shared memory.  Then each thread updates the entries it owns
// straight in the CTA's own slice of the partial scratch, adding the tile's
// rows of the entry's cluster in row order, x read again from global memory
// (the tile was just read, so from L2).  So every entry is the same fmaf
// chain over the same rows as in kau_partial_kernel: the same partials, and
// after stage 2 the same sums.  One owner per entry, no atomics.
__global__ void kau_partial_global_kernel(
    const float* __restrict__ X, const float* __restrict__ C,
    const float* __restrict__ w, int* __restrict__ assign,
    float* __restrict__ d2, float* __restrict__ part, long long n, int d,
    int k, long long rows_per_cta, long long x_bstride, long long c_bstride,
    long long w_bstride) {
  __shared__ float sw[kmeans::kThreads];
  __shared__ float sd[kmeans::kThreads];
  __shared__ int sa[kmeans::kThreads];
  const int kd = k * d;
  const int E = kd + 2 * k;
  const int P = gridDim.x;
  const long long p = blockIdx.x, b = blockIdx.y;
  const float* Xb = X + b * x_bstride;
  const float* Cb = C + b * c_bstride;
  const float* wb = w ? w + b * w_bstride : nullptr;
  float* dst = part + (b * P + p) * (long long)E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) dst[e] = 0.f;

  const long long lo = p * rows_per_cta;
  const long long hi = min(n, lo + rows_per_cta);
  for (long long r0 = lo; r0 < hi; r0 += kmeans::kThreads) {
    const int nr = (int)min((long long)kmeans::kThreads, hi - r0);
    __syncthreads();   // the previous tile's sums are done with sa, sd, sw
    const int r = threadIdx.x;
    if (r < nr) {
      int a;
      float dd;
      kmeans::assign_row_global(Xb + (r0 + r) * d, Cb, d, k, &a, &dd);
      sa[r] = a;
      sd[r] = dd;
      sw[r] = wb ? wb[r0 + r] : 1.f;
      assign[b * n + r0 + r] = a;
      d2[b * n + r0 + r] = dd;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      dst[e] = add_tile_rows(dst[e], e, nr, sa, sw, sd, Xb + r0 * d, d, d, k);
  }
}

__global__ void kau_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ csum,
                                  float* __restrict__ wsum,
                                  float* __restrict__ ccost, int P, int k,
                                  int kd, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int E = kd + 2 * k;
  const long long b = i / E;
  const int e = (int)(i - b * E);
  const float* src = part + b * P * (long long)E + e;
  float s = 0.f;
  for (int q = 0; q < P; ++q) s += src[(long long)q * E];
  if (e < kd)
    csum[b * kd + e] = s;
  else if (e < kd + k)
    wsum[b * k + (e - kd)] = s;
  else
    ccost[b * k + (e - kd - k)] = s;
}


// ---- The general route: (k, d) whose fast layout does not fit --------------
//
// Stage 1a, kau_assign_kernel: kmeans_tiled.cuh's tiled fp32 assign on 256
// threads, 128 rows (256 at TX = 1) a CTA, over the grid (row tiles, center
// groups, B) (kernels/kmeans_assign_update.py::general_plan).  Each group's
// unclamped (minimum, index) per row goes to pv / pa.
// Stage 1b, kau_fold_kernel: grid (P, B), the fast route's row split.  A CTA
// takes its range in tiles of 256 rows in row order: it combines the groups'
// minima into assign and the clamped d2 (kmeans_tiled.cuh's combine_groups),
// sorts the tile's (cluster, row) keys (a bitonic sort, so any k) and cuts
// them into one segment per cluster present, its rows in row order.  X's tile moves through shared memory in
// chunks of FC columns (a ring of two); a warp takes a segment, and lane c
// the chains of columns c and c + 32, each fmaf over the segment's rows, added
// to the CTA's partial in shared memory when its k d + 2 k floats fit beside
// the ring, else in its slice of the scratch.  So each entry takes the same
// rows in the same order as in kau_partial_global_kernel: the same partials,
// and stage 2 is unchanged.  The work is O(n d), not O(n k d).

constexpr int kGenThreads = kmeans::kTiledThreads;
constexpr int kFoldRows = 256;   // rows of a fold tile: one key per thread

__host__ __device__ constexpr int gen_rows(int tx) {
  return kmeans::tiled_rows(tx, kGenThreads);
}

template <int TX, int KC>
__global__ void __launch_bounds__(kGenThreads) kau_assign_kernel(
    const float* __restrict__ X, const float* __restrict__ C,
    float* __restrict__ pv, int* __restrict__ pa, long long n, int d, int k,
    int tiles_per_group, int vec, long long x_bstride, long long c_bstride) {
  constexpr int BM = gen_rows(TX), BN = 8 * TX;
  const long long r0 = (long long)blockIdx.x * BM;
  const int g = blockIdx.y, G = gridDim.y;
  const long long b = blockIdx.z;
  const int ct0 = g * tiles_per_group;
  const int ct1 = min((k + BN - 1) / BN, ct0 + tiles_per_group);
  kmeans::tiled_assign<kGenThreads, TX, KC, BM>(
      X + b * x_bstride + r0 * d, C + b * c_bstride, n - r0, d, k, ct0, ct1, vec,
      [&](int r, float v, int a) {
        const long long o = (b * G + g) * n + r0 + r;
        pv[o] = v;
        pa[o] = a;
      });
}

// Floats of kau_fold_kernel's layout: the X ring (two chunks of kFoldRows
// rows at the stride FC + 4), the sorted keys, the rows' weights and d2,
// the segments, and (acc_in_smem) the k d + 2 k partial sums.
__host__ __device__ inline long long kau_fold_floats(int fc, int d, int k,
                                                     bool acc_in_smem) {
  return 2LL * kFoldRows * (fc + 4) + 2LL * kFoldRows /* keys */ +
         2LL * kFoldRows /* sw, sd */ + 2LL * (kFoldRows + 1) /* segments */ +
         32 /* warp counts */ + (acc_in_smem ? (long long)k * d + 2LL * k : 0);
}

__global__ void __launch_bounds__(kThreads) kau_fold_kernel(
    const float* __restrict__ X, const float* __restrict__ w,
    const float* pv, const int* pa, int* assign, float* d2,   // may alias
    float* __restrict__ part, long long n, int d, int k, int G, int fc, int vec, bool acc_in_smem,
    long long rows_per_cta, long long x_bstride, long long w_bstride) {
  static_assert(kThreads == kFoldRows, "one key per thread");
  extern __shared__ float4 smem4[];
  const int ld = fc + 4;
  float* ring = reinterpret_cast<float*>(smem4);                    // [2][rows][ld]
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(ring + 2 * kFoldRows * ld);   // [rows]
  float* sw = reinterpret_cast<float*>(keys + kFoldRows);           // [rows]
  float* sd = sw + kFoldRows;                                       // [rows]
  int* seg = reinterpret_cast<int*>(sd + kFoldRows);                // [rows + 1]
  int* seg_l = seg + kFoldRows + 1;                                 // [rows + 1]
  int* wcount = seg_l + kFoldRows + 1;                              // [32]
  float* sacc = reinterpret_cast<float*>(wcount + 32);              // [E]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kd = k * d, E = kd + 2 * k;
  const int P = gridDim.x;
  const long long p = blockIdx.x, b = blockIdx.y;
  const float* Xb = X + b * x_bstride;
  const float* wb = w ? w + b * w_bstride : nullptr;
  float* dst = part + (b * P + p) * (long long)E;
  float* acc = acc_in_smem ? sacc : dst;
  for (int e = tid; e < E; e += kThreads) acc[e] = 0.f;
  const long long lo = p * rows_per_cta;
  const long long hi = min(n, lo + rows_per_cta);
  const int nch = (d + fc - 1) / fc;

  for (long long r0 = lo; r0 < hi; r0 += kFoldRows) {
    const int nr = (int)min((long long)kFoldRows, hi - r0);
    // stage chunk ch of the tile's rows (columns from fc ch) into its buffer
    auto issue = [&](int ch) {
      float* xs = ring + (ch & 1) * kFoldRows * ld;
      const int j0 = ch * fc, cw = min(fc, d - j0);
      const float* src = Xb + r0 * d + j0;
      // fc / vec is a power of two up to 64: each thread keeps one column
      // group and walks the rows
      const int vpr = fc / vec, c = (tid % vpr) * vec;
      if (c < cw) {   // d % vec == 0, so cw too
        const int step = kThreads / vpr;
        for (int r = tid / vpr; r < nr; r += step) {
          float* to = xs + r * ld + c;
          const float* from = src + (long long)r * d + c;
          if (vec == 4) kmeans::copy_vec<4>(to, from);
          else if (vec == 2) kmeans::copy_vec<2>(to, from);
          else kmeans::copy_vec<1>(to, from);
        }
      }
      cp_async_commit();
    };
    issue(0);

    // the rows' assignment: the groups' minima in group order, d2 clamped
    unsigned long long key = ~0ULL;
    if (tid < nr) {
      const long long row = b * n + r0 + tid;
      float v;
      int a;
      kmeans::combine_groups(pv, pa, b, G, n, r0 + tid, &v, &a);
      const float dd = fmaxf(v, 0.f);
      assign[row] = a;
      d2[row] = dd;
      sw[tid] = wb ? wb[r0 + tid] : 1.f;
      sd[tid] = dd;
      key = ((unsigned long long)(unsigned)a << 32) | (unsigned)tid;
    }
    keys[tid] = key;
    __syncthreads();
    // bitonic sort of the (cluster, row) keys, ascending
    for (int size = 2; size <= kFoldRows; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int other = tid ^ stride;
        if (other > tid) {
          const unsigned long long a = keys[tid], c = keys[other];
          if ((a > c) == ((tid & size) == 0)) {
            keys[tid] = c;
            keys[other] = a;
          }
        }
        __syncthreads();
      }
    }
    // segments: the first sorted position of each cluster, in order
    const int cl = (int)(keys[tid] >> 32);
    const bool start = tid < nr && (tid == 0 || (int)(keys[tid - 1] >> 32) != cl);
    const unsigned ballot = __ballot_sync(0xffffffffu, start);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, nseg = 0;
    for (int q = 0; q < kThreads / 32; ++q) {
      before += q < warp ? wcount[q] : 0;
      nseg += wcount[q];
    }
    if (start) {
      const int id = before + __popc(ballot & ((1u << lane) - 1u));
      seg[id] = tid;
      seg_l[id] = cl;
    }
    if (tid == 0) seg[nseg] = nr;
    // the tile's rows into the partial sums, one chunk of columns at a time
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<0>();
      __syncthreads();   // chunk ch and the segments are in; every thread is
                         // done with chunk ch - 1's buffer
      if (ch + 1 < nch) issue(ch + 1);
      const float* xs = ring + (ch & 1) * kFoldRows * ld;
      const int j0 = ch * fc, cw = min(fc, d - j0);
      // a warp per segment: lane c's chains (columns c and c + 32) take
      // the segment's rows
      const bool c0 = lane < cw, c1 = lane + 32 < cw;
      for (int sg = warp; sg < nseg; sg += kThreads / 32) {
        float* e = acc + seg_l[sg] * d + j0 + lane;
        float s0 = c0 ? e[0] : 0.f, s1 = c1 ? e[32] : 0.f;
        const int pe = seg[sg + 1];
        const float* xc = xs + lane;
#pragma unroll 4
        for (int q = seg[sg]; q < pe; ++q) {
          const int i = (int)(unsigned)keys[q];
          const float wi = sw[i];
          s0 = fmaf(wi, xc[i * ld], s0);
          if (c1) s1 = fmaf(wi, xc[i * ld + 32], s1);
        }
        if (c0) e[0] = s0;
        if (c1) e[32] = s1;
      }
    }
    // wsum (s + w_i) and ccost (fmaf(w_i, d2_i, s)) of each segment
    for (int it = tid; it < 2 * nseg; it += kThreads) {
      const int sg = it >> 1, cost = it & 1;
      const int e = kd + cost * k + seg_l[sg];
      float s = acc[e];
      const int pe = seg[sg + 1];
      for (int q = seg[sg]; q < pe; ++q) {
        const int i = (int)(unsigned)keys[q];
        s = cost ? fmaf(sw[i], sd[i], s) : s + sw[i];
      }
      acc[e] = s;
    }
    __syncthreads();   // before the next tile's keys, segments and chunk 0
  }
  if (acc_in_smem)
    for (int e = tid; e < E; e += kThreads) dst[e] = acc[e];
}

}  // namespace

// Floats of the fast stage 1's layout for a tile of `rows` rows in a ring of
// `depth` buffers (the wrapper's kmeans_assign_update.smem_bytes computes the
// same).
static long long kau_floats(int d, int k, int rows, int depth) {
  const int kp = kmeans::padded_k(k);
  return (long long)d * kp + kp + (long long)k * d + 2LL * k + rows +
         (long long)depth * rows * kau_row_stride(d);
}

// Stage 2: the B (P, k d + 2 k) partials summed in order into csum, wsum and
// ccost.
static cudaError_t launch_reduce(cudaStream_t st, const float* part, float* csum,
                                 float* wsum, float* ccost, int B, long long P,
                                 int d, int k) {
  const int kd = k * d;
  const long long total = (long long)B * (kd + 2 * k);
  const int rt = 256;
  kau_reduce_kernel<<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
      part, csum, wsum, ccost, (int)P, k, kd, total);
  return cudaGetLastError();
}

template <int kDepth>
static cudaError_t launch_partial(dim3 grid, size_t bytes, cudaStream_t st,
                                  const float* X, const float* C,
                                  const float* w, int* assign, float* d2,
                                  float* part, long long n, int d, int k,
                                  int rows, long long rows_per_cta,
                                  long long x_bstride, long long c_bstride,
                                  long long w_bstride) {
  cudaError_t e = repro_set_smem(kau_partial_kernel<kDepth>, bytes);
  if (e != cudaSuccess) return e;
  kau_partial_kernel<kDepth><<<grid, kThreads, bytes, st>>>(
      X, C, w, assign, d2, part, n, d, k, rows, rows_per_cta, x_bstride,
      c_bstride, w_bstride);
  return cudaGetLastError();
}

// X: B (or 1, with x_bstride 0) blocks of (n, d) fp32, row-major; C: B (or
// 1) blocks of (k, d); w: B (or 1) vectors of n, or null for unit weights;
// assign, d2: (B, n); part: (B, P, k d + 2 k) scratch with P =
// ceil(n / rows_per_cta); csum (B, k, d), wsum (B, k), ccost (B, k).
// `rows` (32, 64 or 128) and `depth` (1 or 2) are the tile height and ring
// depth the wrapper chose so that the layout fits in shared memory; rows = 0
// runs the global variant of stage 1.
REPRO_API int repro_kmeans_assign_update(
    const float* X, const float* C, const float* w, int* assign, float* d2,
    float* part, float* csum, float* wsum, float* ccost, int B, long long n,
    int d, int k, int rows, int depth, long long rows_per_cta,
    long long x_bstride, long long c_bstride, long long w_bstride,
    void* stream) {
  const bool global = rows == 0;
  if (B < 1 || B > 65535 || n < 1 || d < 1 || k < 1 || rows_per_cta < 1 ||
      (!global && (rows < 32 || rows > kMaxRows || rows % 32 != 0 ||
                   kThreads % rows != 0 || depth < 1 || depth > 2)))
    return (int)cudaErrorInvalidValue;
  const long long P = (n + rows_per_cta - 1) / rows_per_cta;
  if (P > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)P, (unsigned)B);
  cudaError_t e;
  if (global) {
    kau_partial_global_kernel<<<grid, kmeans::kThreads, 0, st>>>(
        X, C, w, assign, d2, part, n, d, k, rows_per_cta, x_bstride,
        c_bstride, w_bstride);
    e = cudaGetLastError();
  } else {
    const size_t bytes = (size_t)kau_floats(d, k, rows, depth) * sizeof(float);
    e = (depth == 2 ? launch_partial<2> : launch_partial<1>)(
        grid, bytes, st, X, C, w, assign, d2, part, n, d, k, rows,
        rows_per_cta, x_bstride, c_bstride, w_bstride);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce(st, part, csum, wsum, ccost, B, P, d, k);
}

template <int TX, int KC>
static cudaError_t launch_assign_kc(dim3 grid, cudaStream_t st, const float* X,
                                    const float* C, float* pv, int* pa,
                                    long long n, int d, int k,
                                    int tiles_per_group, int vec,
                                    long long x_bstride, long long c_bstride) {
  const size_t bytes = sizeof(float) * kmeans::tiled_floats(gen_rows(TX), 8 * TX, KC);
  cudaError_t e = repro_set_smem(kau_assign_kernel<TX, KC>, bytes);
  if (e != cudaSuccess) return e;
  kau_assign_kernel<TX, KC><<<grid, kGenThreads, bytes, st>>>(
      X, C, pv, pa, n, d, k, tiles_per_group, vec, x_bstride, c_bstride);
  return cudaGetLastError();
}

template <int TX>
static cudaError_t launch_assign(int kc, dim3 grid, cudaStream_t st,
                                 const float* X, const float* C, float* pv,
                                 int* pa, long long n, int d, int k,
                                 int tiles_per_group, int vec,
                                 long long x_bstride, long long c_bstride) {
  return (kc == 64 ? launch_assign_kc<TX, 64> : launch_assign_kc<TX, 32>)(
      grid, st, X, C, pv, pa, n, d, k, tiles_per_group, vec, x_bstride,
      c_bstride);
}

// The general path (stage 1a, 1b, then stage 2), for (k, d) whose fast layout
// does not fit.  X, C, w, the outputs, part and the strides are as above;
// pv, pa: (B, groups, n) minima and their indices (with groups = 1 they may be
// d2 and assign themselves).  tx, kc, groups, tiles_per_group, fc, vec and
// acc_in_smem are kernels/kmeans_assign_update.py::general_plan's.
REPRO_API int repro_kmeans_assign_update_general(
    const float* X, const float* C, const float* w, int* assign, float* d2,
    float* pv, int* pa, float* part, float* csum, float* wsum, float* ccost,
    int B, long long n, int d, int k, int tx, int kc, int groups,
    int tiles_per_group, int fc, int vec, int acc_in_smem,
    long long rows_per_cta, long long x_bstride, long long c_bstride,
    long long w_bstride, void* stream) {
  const bool tx_ok = tx == 1 || tx == 2 || tx == 4 || tx == 8;
  if (B < 1 || B > 65535 || n < 1 || d < 1 || k < 1 || rows_per_cta < 1 || !tx_ok ||
      (kc != 32 && kc != 64) || groups < 1 || groups > 65535 || tiles_per_group < 1 ||
      fc < 4 || fc % 4 != 0 || (vec != 1 && vec != 2 && vec != 4) || d % vec != 0)
    return (int)cudaErrorInvalidValue;
  const long long nct = (k + 8LL * tx - 1) / (8LL * tx);
  if ((long long)(groups - 1) * tiles_per_group >= nct ||
      (long long)groups * tiles_per_group < nct)
    return (int)cudaErrorInvalidValue;
  const long long row_tiles = (n + gen_rows(tx) - 1) / gen_rows(tx);
  const long long P = (n + rows_per_cta - 1) / rows_per_cta;
  if (row_tiles > 2147483647LL || P > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)row_tiles, (unsigned)groups, (unsigned)B);
  cudaError_t e;
  switch (tx) {
    case 1: e = launch_assign<1>(kc, grid, st, X, C, pv, pa, n, d, k, tiles_per_group, vec, x_bstride, c_bstride); break;
    case 2: e = launch_assign<2>(kc, grid, st, X, C, pv, pa, n, d, k, tiles_per_group, vec, x_bstride, c_bstride); break;
    case 4: e = launch_assign<4>(kc, grid, st, X, C, pv, pa, n, d, k, tiles_per_group, vec, x_bstride, c_bstride); break;
    default: e = launch_assign<8>(kc, grid, st, X, C, pv, pa, n, d, k, tiles_per_group, vec, x_bstride, c_bstride); break;
  }
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = sizeof(float) * (size_t)kau_fold_floats(fc, d, k, acc_in_smem);
  e = repro_set_smem(kau_fold_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kau_fold_kernel<<<dim3((unsigned)P, (unsigned)B), kThreads, bytes, st>>>(
      X, w, pv, pa, assign, d2, part, n, d, k, groups, fc, vec, acc_in_smem,
      rows_per_cta, x_bstride, w_bstride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce(st, part, csum, wsum, ccost, B, P, d, k);
}
