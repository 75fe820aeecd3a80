// k-means assignment: for each row, the nearest center and its squared
// distance (kmeans_cost in fit_kmeans and evaluate, distdim's local
// assignment).
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py::kmeans_assign
// (Pallas body `_kernel`): there a (bn, 128-padded d) tile of X meets the
// 128-padded centers on the MXU, and the argmin runs on the (bn, 128) tile.
//
// Bound on the H100 at the main-path shape (n = 463,715 rows, d = 90,
// k = 10): X must be read once, 167 MB, and assign and d2 written once,
// 3.7 MB: 51 us at 3.35 TB/s.  The arithmetic is about 2 n k d = 0.83 GFLOP
// of fp32, 12 us at 67 TFLOP/s, so the kernel is bound by bytes (about
// 5 FLOP per byte at k = 10).  At the coreset fit's (m, 90) it is a few
// microseconds of work and bound by the launch.
//
// The bit contract.  Every row's assign and d2 are kmeans_common.cuh's
// assign_row arithmetic: x2, t_l and cn[l] fmaf chains over j = 0..d-1,
// dl = (x2 + cn[l]) - 2 t_l, the first index of the smallest unclamped dl,
// then that minimum clamped at 0.  kmeans_assign_global_kernel computes
// exactly this with C and the row in global memory, one row a thread: it is
// the oracle that chip_smoke.py and the gpu tests hold both routes to, bit
// for bit (kernels/kmeans_assign.py::_launch with global_variant=True); no
// user's call runs it.  K2's stage 1 (kmeans_assign_update.cu) assigns with
// the same bits.
//
// A user's call takes one of two routes (kernels/kmeans_assign.py::route_for):
// - fast, where assign_layout fits C and a row tile in half of a block's
//   shared memory: kmeans_assign_fast_kernel, below;
// - tiled, where that layout takes more (one CTA an SM keeps too few warps
//   busy: (300, 90), (856, 64)) or gives GLOBAL (k d past the earlier
//   one-tile layout's line: (2000, 64), or d = 2048 whatever k): the grid
//   (row tiles, center groups, B) of kmeans_assign_tiled_kernel,
//   kmeans_tiled.cuh's tiled fp32 assign (K2's general route runs the same
//   body) on 256, 128 or 64 threads, as kernels/kmeans_assign.py::tiled_plan
//   gives it (shorter tiles where the grid would hold fewer than two CTAs
//   an SM).  With one center group it writes
//   assign and the clamped d2 itself; with more it writes each group's
//   unclamped (minimum, index) per row to a (B, G, n) scratch, and
//   kmeans_assign_combine_kernel combines the groups in group order
//   (kmeans_tiled.cuh's combine_groups) and clamps.  Its bound is the
//   product's 2 n k d operations at (20001, 64) x (2000, 64) (5.2 GFLOP, 78 us
//   at 67 TFLOP/s) and the read of X at (20001, 2048) x (10, 2048) (164 MB,
//   49 us at 3.35 TB/s).
//
// Design of the fast kernel, kmeans_assign_fast_kernel, 128 threads a CTA:
// - Persistent CTAs: (SMs x CTAs per SM) / B per batch entry, from the
//   occupancy calculator at launch (common.cuh's repro_persistent_ctas),
//   each walking its entry's row tiles with a grid stride.  Rows need no
//   sums, so any split gives the same bits.  C transposed and ||c||^2 are
//   staged once per CTA, not once per tile: the k ||c||^2 chains run on
//   their own threads while the others transpose C.
// - One tile buffer of up to 128 rows a CTA, the tallest that fits
//   (kernels/kmeans_assign.py::assign_layout): at (10, 90) four CTAs an
//   SM, whose copies and distances overlap each other's (four CTAs of one
//   buffer ran faster there than two of a ring of two).  Where d is not a
//   multiple of 4 a tile is copied as the one contiguous run of floats it
//   is in X, with 16-byte cp.async (4-byte at its unaligned ends), and its
//   rows sit at the stride d (two-way bank conflicts at d = 2 mod 4);
//   otherwise with 4-byte cp.async, a warp per row, at the odd stride
//   d | 1.  The 4-byte copies
//   go through L1, which holds few of them in flight once shared memory
//   takes nearly all of the SM's 256 KB; the 16-byte copies bypass L1, and
//   ran markedly faster at (463,715, 90).
// - Each thread scans two rows (rows / 2 apart) at once, so every center
//   value it loads feeds both; 128 / (rows / 2) runs of threads share a
//   tile's rows, each run scanning a contiguous run of 8-center blocks (at
//   (10, 90), 128-row tiles: two runs, one block of 8 and one of 2; the
//   shorter block costs only its real centers).  From 64 rows up a run is
//   whole warps, so every read of C is a broadcast; shorter tiles (only at
//   large k d) put several runs in a warp, whose reads of C then differ.
//   The runs' (min, argmin) are combined last to first through two per-row
//   arrays: a later run wins only with a strictly smaller value, the
//   sequential scan's answer.
// The fast kernel's layout fits where the earlier one-tile kernel's layout
// fitted, its tiles going down to 8 rows so that one always fits there;
// past that line, and where it fills more than half of the shared memory,
// the tiled route runs.  fp32 with explicit fmaf, no tensor cores and no
// TF32.
// The real d and k are kept: there is no padding to 128 lanes, which is a
// TPU layout.
#include <cstdint>

#include "kmeans_tiled.cuh"

namespace {

constexpr int kFastThreads = 128;   // the fast kernel's CTA
constexpr int kFastWarps = kFastThreads / 32;
constexpr int kFastRpt = 2;         // rows a thread scans at once
// CTAs an SM must be able to hold: the registers are capped so
constexpr int kFastMinCtas = 4;

// Floats of one tile buffer of the fast kernel: `rows` rows at the odd
// stride d | 1, and 4 floats of slack for a dense tile's alignment shift,
// rounded up to whole 16-byte units.
__host__ __device__ inline int fast_buffer_floats(int d, int rows) {
  return (rows * kmeans::row_stride(d) + 4 + 3) / 4 * 4;
}
// Floats of the fast kernel's layout: CT, cn, the runs' per-row (min,
// argmin), and the tile buffer (kernels/kmeans_assign.py::assign_bytes).
__host__ __device__ inline long long fast_floats(int d, int k, int rows) {
  const int kp = kmeans::padded_k(k);
  return (long long)d * kp + kp + 2LL * rows + fast_buffer_floats(d, rows);
}

// The scan of R staged rows xr[q] over the W centers from l0 (a block of 8,
// or the last, shorter one, which costs only its W centers): assign_row's
// arithmetic (each t and x2 an fmaf chain over j = 0..d-1; x2 is recomputed
// per block, the same chain each time), folded into (best[q], arg[q]) with
// assign_row's rule: center 0 always, then strictly smaller values only.
// Each center value loaded feeds the R rows.
template <int W, int R>
__device__ __forceinline__ void scan_rows(const float* const* xr,
                                          const float* CT, const float* cn,
                                          int d, int kp, int l0,
                                          float (&best)[R], int (&arg)[R]) {
  float t[R][W], x2[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    x2[q] = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) t[q][i] = 0.f;
  }
#pragma unroll 2
  for (int j = 0; j < d; ++j) {
    const float* cj = CT + j * kp + l0;
    float c[8];
    if constexpr (W <= 2) {
      const float2 v = *reinterpret_cast<const float2*>(cj);
      c[0] = v.x;
      c[1] = v.y;
    } else {
      const float4 v = *reinterpret_cast<const float4*>(cj);
      c[0] = v.x;
      c[1] = v.y;
      c[2] = v.z;
      c[3] = v.w;
      if constexpr (W > 4) {
        const float4 u = *reinterpret_cast<const float4*>(cj + 4);
        c[4] = u.x;
        c[5] = u.y;
        c[6] = u.z;
        c[7] = u.w;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float xj = xr[q][j];
      x2[q] = fmaf(xj, xj, x2[q]);
#pragma unroll
      for (int i = 0; i < W; ++i) t[q][i] = fmaf(xj, c[i], t[q][i]);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int l = l0 + i;
      // 2 t is exact, so contracting this into an fma changes no bit
      const float dl = (x2[q] + cn[l]) - 2.0f * t[q][i];
      if (l == 0 || dl < best[q]) {
        best[q] = dl;
        arg[q] = l;
      }
    }
}

// scan_rows over the center blocks [blo, bhi) in order.
template <int R>
__device__ __forceinline__ void scan_run(const float* const* xr,
                                         const float* CT, const float* cn,
                                         int d, int k, int blo, int bhi,
                                         float (&best)[R], int (&arg)[R]) {
  const int kp = kmeans::padded_k(k);
  for (int bl = blo; bl < bhi; ++bl) {
    const int l0 = bl * kmeans::kL;
    switch (min(kmeans::kL, k - l0)) {
      case 1: scan_rows<1, R>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 2: scan_rows<2, R>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 3: scan_rows<3, R>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 4: scan_rows<4, R>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 5: scan_rows<5, R>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 6: scan_rows<6, R>(xr, CT, cn, d, kp, l0, best, arg); break;
      case 7: scan_rows<7, R>(xr, CT, cn, d, kp, l0, best, arg); break;
      default: scan_rows<8, R>(xr, CT, cn, d, kp, l0, best, arg); break;
    }
  }
}

// Stage C (k, d) transposed and zero-padded into CT, and ||c||^2 into cn:
// threads [0, kp) each run one center's fmaf chain over j = 0..d-1 (from C
// in global memory, the same values as CT), then every thread joins the
// transpose, a warp per center and a lane per column.  Ends in a barrier.
__device__ inline void stage_centers(const float* __restrict__ C, float* CT,
                                     float* cn, int d, int k) {
  const int kp = kmeans::padded_k(k);
  for (int l = threadIdx.x; l < kp; l += blockDim.x) {
    float s = 0.f;
    if (l < k) {
      const float* cl = C + (long long)l * d;
#pragma unroll 8
      for (int j = 0; j < d; ++j) s = fmaf(cl[j], cl[j], s);
    }
    cn[l] = s;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int l = warp; l < kp; l += nwarps)
    for (int j = lane; j < d; j += 32)
      CT[j * kp + l] = l < k ? C[(long long)l * d + j] : 0.f;
  __syncthreads();
}

__global__ void __launch_bounds__(kFastThreads, kFastMinCtas)
    kmeans_assign_fast_kernel(const float* __restrict__ X,
                              const float* __restrict__ C,
                              int* __restrict__ assign, float* __restrict__ d2,
                              long long n, int d, int k, int rows,
                              long long x_bstride, long long c_bstride) {
  extern __shared__ float4 smem4[];
  const int kp = kmeans::padded_k(k);
  const int ld = kmeans::row_stride(d);
  float* CT = reinterpret_cast<float*>(smem4);
  float* cn = CT + (size_t)d * kp;
  float* sbest = cn + kp;                                // [rows] a run's min
  int* sarg = reinterpret_cast<int*>(sbest + rows);      // [rows] its argmin
  float* buf = reinterpret_cast<float*>(sarg + rows);    // the tile buffer
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.y;
  const float* Xb = X + b * x_bstride;
  int* ab = assign + b * n;
  float* db = d2 + b * n;
  // this CTA's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long tiles = (n + rows - 1) / rows;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long mine = first < tiles ? (tiles - 1 - first) / stride + 1 : 0;

  // where tile t's row 0 lands in the buffer: a dense tile keeps its
  // source's offset modulo 16 bytes, so its 16-byte copies line up
  const bool dense = d % 4 != 0;
  const int lds = dense ? d : ld;
  auto tile_at = [&](long long t) -> float* {
    if (!dense) return buf;
    const float* src = Xb + (first + t * stride) * rows * d;
    return buf + (int)((reinterpret_cast<unsigned long long>(src) >> 2) & 3);
  };
  // stage this CTA's tile t into the buffer and wait for it
  auto stage = [&](long long t) {
    const long long r0 = (first + t * stride) * rows;
    const int nr = (int)min((long long)rows, n - r0);
    const float* src = Xb + r0 * d;
    float* dst = tile_at(t);
    if (dense) {
      cp_async_run(dst, src, nr * d, threadIdx.x, kFastThreads);
    } else {
      for (int r = warp; r < nr; r += kFastWarps)
        for (int c = lane; c < d; c += 32)
          cp_async4(dst + r * ld + c, src + (long long)r * d + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
  };

  stage_centers(C + b * c_bstride, CT, cn, d, k);   // ends in a barrier

  // thread (i, h) scans run h, center blocks [blo, bhi), of the tile's
  // rows i + q span, q < kFastRpt
  const int span = rows / kFastRpt;
  const int runs = kFastThreads / span;
  const int h = threadIdx.x / span, i = threadIdx.x - h * span;
  const int nb = kp / kmeans::kL;
  const int per = (nb + runs - 1) / runs;
  const int blo = min(nb, h * per), bhi = min(nb, blo + per);

  for (long long t = 0; t < mine; ++t) {
    if (t > 0) __syncthreads();   // every thread is done with the buffer
    stage(t);
    __syncthreads();   // tile t has landed for every thread
    const long long r0 = (first + t * stride) * rows;
    const int nr = (int)min((long long)rows, n - r0);
    const float* xs = tile_at(t);

    float best[kFastRpt];
    int arg[kFastRpt];
    const float* xr[kFastRpt];
#pragma unroll
    for (int q = 0; q < kFastRpt; ++q) {
      best[q] = __int_as_float(0x7f800000);   // +inf: an empty run
      arg[q] = -1;
      // a row past nr scans row 0 of the tile, and is not written
      xr[q] = xs + (i + q * span < nr ? i + q * span : 0) * lds;
    }
    scan_run<kFastRpt>(xr, CT, cn, d, k, blo, bhi, best, arg);
    // combine the runs, last to first; run 0 writes the rows' results
    for (int g = runs - 1; g >= 0; --g) {
      if (h == g) {
#pragma unroll
        for (int q = 0; q < kFastRpt; ++q) {
          const int r = i + q * span;
          if (r >= nr) continue;
          if (g < runs - 1) {
            const float bl = sbest[r];
            const int al = sarg[r];
            if (al >= 0 && bl < best[q]) {
              best[q] = bl;
              arg[q] = al;
            }
          }
          if (g > 0) {
            sbest[r] = best[q];
            sarg[r] = arg[q];
          } else {
            ab[r0 + r] = arg[q];
            db[r0 + r] = fmaxf(best[q], 0.f);
          }
        }
      }
      if (g > 0) __syncthreads();
    }
  }
}

// The global variant, the bit oracle of both routes (no user's call runs
// it): one row per thread, the row and C read through the caches
// (kmeans::assign_row_global, assign_row's arithmetic in its order).
__global__ void kmeans_assign_global_kernel(const float* __restrict__ X,
                                            const float* __restrict__ C,
                                            int* __restrict__ assign,
                                            float* __restrict__ d2, long long n,
                                            int d, int k, long long x_bstride,
                                            long long c_bstride) {
  const long long b = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int a;
  float dd;
  kmeans::assign_row_global(X + b * x_bstride + i * d, C + b * c_bstride, d, k,
                            &a, &dd);
  assign[b * n + i] = a;
  d2[b * n + i] = dd;
}

// The tiled route's assign: kmeans_tiled.cuh's body on NT threads, a tile of
// tiled_rows(TX, NT) rows against center group blockIdx.y.  With one group
// the row's result goes to assign and d2 (clamped), with more its group's
// unclamped (minimum, index) to the (B, G, n) scratch pv / pa.
template <int NT, int TX, int KC>
__global__ void __launch_bounds__(NT) kmeans_assign_tiled_kernel(
    const float* __restrict__ X, const float* __restrict__ C,
    int* __restrict__ assign, float* __restrict__ d2, float* __restrict__ pv,
    int* __restrict__ pa, long long n, int d, int k, int tiles_per_group,
    int vec, long long x_bstride, long long c_bstride) {
  constexpr int BM = kmeans::tiled_rows(TX, NT), BN = 8 * TX;
  const long long r0 = (long long)blockIdx.x * BM;
  const int g = blockIdx.y, G = gridDim.y;
  const long long b = blockIdx.z;
  const int ct0 = g * tiles_per_group;
  const int ct1 = min((k + BN - 1) / BN, ct0 + tiles_per_group);
  kmeans::tiled_assign<NT, TX, KC, BM>(
      X + b * x_bstride + r0 * d, C + b * c_bstride, n - r0, d, k, ct0, ct1, vec,
      [&](int r, float v, int a) {
        if (G == 1) {
          assign[b * n + r0 + r] = a;
          d2[b * n + r0 + r] = fmaxf(v, 0.f);
        } else {
          const long long o = (b * G + g) * n + r0 + r;
          pv[o] = v;
          pa[o] = a;
        }
      });
}

// The tiled route's combine, where it has G > 1 center groups: each row's
// groups in group order, then the minimum clamped at 0.
__global__ void kmeans_assign_combine_kernel(const float* __restrict__ pv,
                                             const int* __restrict__ pa,
                                             int* __restrict__ assign,
                                             float* __restrict__ d2, long long n,
                                             int G) {
  const long long b = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v;
  int a;
  kmeans::combine_groups(pv, pa, b, G, n, i, &v, &a);
  assign[b * n + i] = a;
  d2[b * n + i] = fmaxf(v, 0.f);
}

template <int NT, int TX, int KC>
cudaError_t launch_tiled_kc(dim3 grid, cudaStream_t st, const float* X,
                            const float* C, int* assign, float* d2, float* pv,
                            int* pa, long long n, int d, int k,
                            int tiles_per_group, int vec, long long x_bstride,
                            long long c_bstride) {
  const size_t bytes =
      sizeof(float) * kmeans::tiled_floats(kmeans::tiled_rows(TX, NT), 8 * TX, KC);
  cudaError_t e = repro_set_smem(kmeans_assign_tiled_kernel<NT, TX, KC>, bytes);
  if (e != cudaSuccess) return e;
  kmeans_assign_tiled_kernel<NT, TX, KC><<<grid, NT, bytes, st>>>(
      X, C, assign, d2, pv, pa, n, d, k, tiles_per_group, vec, x_bstride,
      c_bstride);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_tiled(int tx, int kc, dim3 grid, cudaStream_t st,
                         const float* X, const float* C, int* assign, float* d2,
                         float* pv, int* pa, long long n, int d, int k,
                         int tiles_per_group, int vec, long long x_bstride,
                         long long c_bstride) {
  const bool w = kc == 64;
  auto go = [&](auto launch) {
    return launch(grid, st, X, C, assign, d2, pv, pa, n, d, k, tiles_per_group,
                  vec, x_bstride, c_bstride);
  };
  switch (tx) {
    case 1: return go(w ? launch_tiled_kc<NT, 1, 64> : launch_tiled_kc<NT, 1, 32>);
    case 2: return go(w ? launch_tiled_kc<NT, 2, 64> : launch_tiled_kc<NT, 2, 32>);
    case 4: return go(w ? launch_tiled_kc<NT, 4, 64> : launch_tiled_kc<NT, 4, 32>);
    default: return go(w ? launch_tiled_kc<NT, 8, 64> : launch_tiled_kc<NT, 8, 32>);
  }
}

}  // namespace

// X: B (or 1, with x_bstride 0) blocks of (n, d) fp32, row-major; C: B (or
// 1, with c_bstride 0) blocks of (k, d); assign, d2: (B, n).  `rows` (even,
// with rows / 2 dividing 128) is the tile height the wrapper chose so that
// the layout fits in shared memory; rows = 0 runs the global variant.
REPRO_API int repro_kmeans_assign(const float* X, const float* C, int* assign,
                                  float* d2, int B, long long n, int d, int k,
                                  int rows, long long x_bstride,
                                  long long c_bstride, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || d < 1 || k < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    const long long blocks = (n + kmeans::kThreads - 1) / kmeans::kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    kmeans_assign_global_kernel<<<dim3((unsigned)blocks, (unsigned)B),
                                  kmeans::kThreads, 0, st>>>(
        X, C, assign, d2, n, d, k, x_bstride, c_bstride);
    return (int)cudaGetLastError();
  }
  if (rows % kFastRpt != 0 || kFastThreads % (rows / kFastRpt) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)fast_floats(d, k, rows) * sizeof(float);
  cudaError_t e = repro_set_smem(kmeans_assign_fast_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  // all of the SM's shared memory, so it holds as many CTAs as it can
  e = cudaFuncSetAttribute(kmeans_assign_fast_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  unsigned ctas = 0;
  e = repro_persistent_ctas(kmeans_assign_fast_kernel, kFastThreads, bytes,
                            (n + rows - 1) / rows, B, &ctas);
  if (e != cudaSuccess) return (int)e;
  kmeans_assign_fast_kernel<<<dim3(ctas, (unsigned)B), kFastThreads, bytes,
                              st>>>(X, C, assign, d2, n, d, k, rows, x_bstride,
                                    c_bstride);
  return (int)cudaGetLastError();
}

// The tiled route: X, C, assign, d2 and the strides as above; pv, pa: the
// (B, groups, n) scratch of the groups' minima (unused, and may be null, with
// one group).  tx, rows, kc, groups, tiles_per_group and vec are
// kernels/kmeans_assign.py::tiled_plan's; rows is tiled_rows(tx, threads) for
// a CTA of 256, 128 or 64 threads.  X and C must start on a multiple of vec
// floats (the copies' width).
REPRO_API int repro_kmeans_assign_tiled(const float* X, const float* C,
                                        int* assign, float* d2, float* pv,
                                        int* pa, int B, long long n, int d,
                                        int k, int tx, int rows, int kc,
                                        int groups, int tiles_per_group,
                                        int vec, long long x_bstride,
                                        long long c_bstride, void* stream) {
  const bool tx_ok = tx == 1 || tx == 2 || tx == 4 || tx == 8;
  const int full = tx_ok ? kmeans::tiled_rows(tx, 256) : 0;
  if (B < 1 || B > 65535 || n < 1 || d < 1 || k < 1 || !tx_ok ||
      (rows != full && rows != full / 2 && rows != full / 4) ||
      (kc != 32 && kc != 64) ||
      groups < 1 || groups > 65535 || tiles_per_group < 1 ||
      (vec != 1 && vec != 2 && vec != 4) || d % vec != 0 ||
      reinterpret_cast<uintptr_t>(X) % (4 * vec) != 0 ||
      reinterpret_cast<uintptr_t>(C) % (4 * vec) != 0 ||
      (groups > 1 && (pv == nullptr || pa == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long nct = (k + 8LL * tx - 1) / (8LL * tx);
  if ((long long)(groups - 1) * tiles_per_group >= nct ||
      (long long)groups * tiles_per_group < nct)
    return (int)cudaErrorInvalidValue;
  const long long row_tiles = (n + rows - 1) / rows;
  const long long blocks = (n + 255) / 256;
  if (row_tiles > 2147483647LL || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)row_tiles, (unsigned)groups, (unsigned)B);
  cudaError_t e = (rows == full       ? launch_tiled<256>
                   : rows == full / 2 ? launch_tiled<128>
                                      : launch_tiled<64>)(
      tx, kc, grid, st, X, C, assign, d2, pv, pa, n, d, k, tiles_per_group, vec,
      x_bstride, c_bstride);
  if (e != cudaSuccess || groups == 1) return (int)e;
  kmeans_assign_combine_kernel<<<dim3((unsigned)blocks, (unsigned)B), 256, 0,
                                 st>>>(pv, pa, assign, d2, n, groups);
  return (int)cudaGetLastError();
}
