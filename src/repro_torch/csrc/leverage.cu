// Row-wise quadratic form lev_i = x_i^T M x_i (Algorithm 2's leverage sweep).
//
// Replaces the TPU kernel src/repro/kernels/leverage.py::leverage (Pallas
// body `_kernel`): there a (bn, 128-padded d) tile of X meets the padded M on
// the MXU and the multiply-reduce epilogue runs in the same VMEM residency.
//
// Bound on the H100 at the main-path shape (T = 3 parties, n = 463,715 rows,
// s = 31 columns with the label): X must be read once, 178 MB, which is 53 us
// at 3.35 TB/s; the arithmetic is 2 T n s^2 = 2.7 GFLOP of fp32 FMA, 40 us at
// 67 TFLOP/s outside the tensor cores.  So the kernel is memory-bound, with
// the arithmetic close behind.
//
// The bit contract.  For each row, t_a is the fmaf chain of M[a][b] x_b over
// b = 0..s-1 in ascending order, and acc the fmaf chain of x_a t_a over
// a = 0..sp-1 in ascending order from 0.f, where sp is s rounded up to a
// multiple of 8 and the padded a in [s, sp) take M[a][b] = 0 and x_a = 0.
// All four kernels below compute exactly this, in fp32 with explicit fmaf;
// leverage_wide_kernel, which reads M from global memory, is the oracle that
// chip_smoke.py and the gpu tests hold the others to, bit for bit
// (kernels/leverage.py::_launch with wide=True).  It is the simplest of the
// four: one row a thread, M read in place, no register tile, no product
// written out, so an agreement is between two independent implementations
// of the same sums; no user's call reaches it.  The real width s is kept:
// there is no padding to 128 lanes, which is a TPU layout.  No clip and no
// +1/n here: those stay in vrlr_scores_stacked, as in the reference.
//
// The kernels, picked by s (the wrapper takes the tiled one past s = 238,
// repro_leverage picks between the reg and shared ones):
// - s <= 32 and not a multiple of 8 (the main path, s = 31):
//   leverage_reg_kernel.  Persistent CTAs of 128 threads, (SMs x CTAs per
//   SM) / T per party from the occupancy calculator at launch (common.cuh's
//   repro_persistent_ctas), each staging M transposed and zero-padded once
//   and walking its party's 256-row tiles through a ring of two.  A tile is the one contiguous run of floats it
//   is in X, copied with 16-byte cp.async (4-byte at its unaligned ends),
//   which bypasses L1; its rows sit at the stride s.  Each thread takes two
//   rows and keeps all sp sums t_a of both in registers, taking b in the
//   outer loop: per b one x_b of each row and sp / 4 broadcast 128-bit
//   loads of M, each feeding 8 fmaf, on 2 sp independent chains.
// - other s <= 238: leverage_kernel, one CTA per 128-row tile, M transposed
//   in shared memory, x read from the staged tile.
// - s > 238, where the (s, s) M no longer fits in a block's 227 KB of shared
//   memory: leverage_tiled_kernel, then leverage_fold_kernel.  The first is
//   a tiled fp32 product T = X M^T into a scratch the wrapper allocates
//   (B, rows, sp): a CTA of 128 threads owns 64 rows x 64 a-values, takes b
//   in ascending slices of 32 through a ring of three stages in shared
//   memory (16-byte cp.async where s is a multiple of 4 and both operands
//   16-byte aligned, 4-byte elsewhere), and each thread keeps an 8 x 4
//   register tile.  Each t_a stays one fmaf chain over ascending b: there is
//   no split over b and no atomic.  The second folds acc = fmaf(x_a, t_a,
//   acc) over ascending a, one row a lane, through a ring of 32 x 32 chunks
//   of X and T.  repro_leverage_tiled runs the pair over the batch groups
//   and row chunks that kernels/leverage.py::tiled_plan picks, so that the
//   scratch stays under kernels/leverage.py::TILED_SCRATCH_FLOATS (2^24
//   floats, 64 MB; unchunked it would be X's size, 3.8 GB at n = 463,715,
//   s = 2048).  M is read row-major: the wrapper copies any other layout.  Its bound is the fp32 FMA rate outside the tensor cores, 67
//   TFLOP/s: 2 n s^2 FLOP, 32 us at (n, s) = (256, 2048) and 157 us at
//   (20001, 512); the scratch's write and read add 4 n sp bytes each way.
//   TF32 or 3xTF32 on the tensor cores would round x and M and break the
//   bit contract, so it runs on the CUDA cores.  What holds it above the
//   bound: shared memory feeds the registers 128 bytes a clock, so an 8 x 4
//   tile (12 floats read for 32 fmaf) can reach 2/3 of the fp32 rate, and
//   at (256, 2048) the 4K entries of T an SM owns leave it 4 warps, too few
//   to hide its latencies; the fold is a serial chain of sp fmaf a row.
// - leverage_wide_kernel (the oracle), M through L1 and L2 at any s.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // one row per thread
constexpr int kA = 8;           // a-values per register block

constexpr int kRegThreads = 128;                  // leverage_reg_kernel's CTA
constexpr int kRegRpt = 2;                        // rows a thread holds
constexpr int kRegRows = kRegRpt * kRegThreads;   // rows of a tile
constexpr int kRegMaxWidth = 32;                  // widest s it takes
constexpr int kRegMinCtas = 3;   // CTAs an SM must hold (registers capped so)

constexpr int kTileRows = 64;     // leverage_tiled_kernel's CTA: rows of X
constexpr int kTileCols = 64;     // ... and a-values (rows of M)
constexpr int kTileK = 32;        // b a slice
constexpr int kTileLd = kTileK + 4;   // a staged row's stride, 16-byte aligned
constexpr int kTileStages = 3;
constexpr int kTm = 8, kTn = 4;       // a thread's register tile: rows x a-values
constexpr int kTileTy = kTileRows / kTm;          // 8 threads along the rows
constexpr int kTileTx = kTileCols / kTn;          // 16 along the a-values
constexpr int kTileThreads = kTileTy * kTileTx;   // 128
constexpr int kWarpTx = 8;        // a warp: 8 threads along a x 4 along the rows
constexpr int kTileMinCtas = 4;
constexpr int kTileStage = kTileRows * kTileLd;   // floats a stage of a side
static_assert(kTileCols == kTileRows, "a stage of either side is kTileStage floats");
constexpr int kFoldRows = 32;     // leverage_fold_kernel: rows a CTA, one a lane
constexpr int kFoldCols = 32;     // a-values a chunk
constexpr int kFoldLd = kFoldCols + 4;   // a staged row's stride, 16-byte aligned
constexpr int kFoldThreads = 64;  // warp 0 folds; both warps copy
constexpr int kFoldStages = 8;

// Whether leverage_reg_kernel takes width s: up to 32, but not a multiple of
// 8.  Its tiles are contiguous at the stride s, so the 32 rows a warp reads
// at once start in distinct banks for odd s, and in 16 or 8 for s = 2 mod 4
// or s = 4 mod 8; at multiples of 8 in 4 or fewer (leverage_kernel took
// s = 16 and 32 faster than this kernel with its rows padded).
__host__ __device__ inline bool reg_width(int s) {
  return s <= kRegMaxWidth && s % kA != 0;
}
// Floats of one tile buffer: kRegRows rows at the stride s and 4 floats of
// slack for the 16-byte alignment shift of the tile.
__host__ __device__ inline int reg_buffer_floats(int s) {
  return kRegRows * s + 4;
}
// Floats of the layout at width s: M transposed, (sp, sp), then a ring of
// two tile buffers.
__host__ __device__ inline long long reg_floats(int s) {
  const int sp = (s + kA - 1) / kA * kA;
  return (long long)sp * sp + 2LL * reg_buffer_floats(s);
}

// lev for R staged rows xr[r]: leverage_kernel's arithmetic (t_a over
// b < s, then acc over a < SP, x_a = 0 past s), with b outside: each step
// adds x_b times row b of M to all SP sums t_a of every row, so one
// broadcast 128-bit load of M feeds 4 R fmaf and the R SP sums are
// independent chains.  sp - 8 < s, so only the last 8 b and a are tested
// against s.
template <int SP, int R>
__device__ __forceinline__ void quad_forms(const float* const* xr,
                                           const float* MT, int s,
                                           float (&acc)[R]) {
  float t[R][SP];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int a = 0; a < SP; ++a) t[r][a] = 0.f;
#pragma unroll
  for (int b = 0; b < SP; ++b) {
    if (b < SP - kA || b < s) {
      float xb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xb[r] = xr[r][b];
#pragma unroll
      for (int a0 = 0; a0 < SP; a0 += 4) {
        const float4 m = *reinterpret_cast<const float4*>(MT + b * SP + a0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          t[r][a0] = fmaf(m.x, xb[r], t[r][a0]);
          t[r][a0 + 1] = fmaf(m.y, xb[r], t[r][a0 + 1]);
          t[r][a0 + 2] = fmaf(m.z, xb[r], t[r][a0 + 2]);
          t[r][a0 + 3] = fmaf(m.w, xb[r], t[r][a0 + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.f;
#pragma unroll
    for (int a = 0; a < SP; ++a)
      acc[r] = fmaf(a < SP - kA || a < s ? xr[r][a] : 0.f, t[r][a], acc[r]);
  }
}

template <int SP>
__global__ void __launch_bounds__(kRegThreads, kRegMinCtas)
    leverage_reg_kernel(const float* __restrict__ X, const float* __restrict__ M,
                        float* __restrict__ out, long long n, int s,
                        long long x_bstride, long long m_bstride) {
  extern __shared__ float4 smem4[];
  float* MT = reinterpret_cast<float*>(smem4);   // [SP][SP], MT[b][a] = M[a][b]
  float* ring = MT + SP * SP;                    // [2][reg_buffer_floats(s)]
  const int bufsz = reg_buffer_floats(s);
  const long long bidx = blockIdx.y;
  const float* Xb = X + bidx * x_bstride;
  const float* Mb = M + bidx * m_bstride;
  float* ob = out + bidx * n;
  // this CTA's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long tiles = (n + kRegRows - 1) / kRegRows;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long mine = first < tiles ? (tiles - 1 - first) / stride + 1 : 0;

  // where tile t's row 0 lands in its buffer: the tile keeps its source's
  // offset modulo 16 bytes, so its 16-byte copies line up
  auto tile_at = [&](long long t) -> float* {
    const float* src = Xb + (first + t * stride) * kRegRows * s;
    return ring + (size_t)(t & 1) * bufsz +
           (int)((reinterpret_cast<unsigned long long>(src) >> 2) & 3);
  };
  // stage this CTA's tile t (if there is one) and commit a group (an empty
  // one past the last, so every thread counts the same)
  auto issue = [&](long long t) {
    if (t < mine) {
      const long long r0 = (first + t * stride) * kRegRows;
      const int nr = (int)min((long long)kRegRows, n - r0);
      cp_async_run(tile_at(t), Xb + r0 * s, nr * s, threadIdx.x, kRegThreads);
    }
    cp_async_commit();
  };

  issue(0);
  for (int i = threadIdx.x; i < SP * SP; i += kRegThreads) {
    const int b = i / SP, a = i - b * SP;
    MT[i] = (a < s && b < s) ? Mb[a * s + b] : 0.f;
  }

  for (long long t = 0; t < mine; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed for every thread (and M is staged),
                       // and every thread is done with tile t - 1's buffer
    issue(t + 1);      // into that buffer
    const long long r0 = (first + t * stride) * kRegRows;
    const int nr = (int)min((long long)kRegRows, n - r0);
    const float* xs = tile_at(t);
    // rows threadIdx.x + i kRegThreads of the tile (a row past nr reads
    // row 0, and is not written)
    const float* xr[kRegRpt];
#pragma unroll
    for (int i = 0; i < kRegRpt; ++i) {
      const int row = threadIdx.x + i * kRegThreads;
      xr[i] = xs + (row < nr ? row : 0) * s;
    }
    float acc[kRegRpt];
    quad_forms<SP, kRegRpt>(xr, MT, s, acc);
#pragma unroll
    for (int i = 0; i < kRegRpt; ++i) {
      const int row = threadIdx.x + i * kRegThreads;
      if (row < nr) ob[r0 + row] = acc[i];
    }
  }
}

__global__ void leverage_kernel(const float* __restrict__ X,
                                const float* __restrict__ M,
                                float* __restrict__ out, long long n, int s,
                                int sp, int ld, int rows, long long x_bstride,
                                long long m_bstride) {
  extern __shared__ float4 smem4[];
  float* MT = reinterpret_cast<float*>(smem4);   // [s][sp], MT[b][a] = M[a][b]
  float* xs = MT + (size_t)s * sp;                // [rows][ld], zero past s
  const long long bidx = blockIdx.y;
  const float* Mb = M + bidx * m_bstride;
  const float* Xb = X + bidx * x_bstride;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, n - r0);

  for (int i = threadIdx.x; i < s * s; i += blockDim.x) {
    const int a = i / s, b = i - a * s;
    MT[b * sp + a] = Mb[i];
  }
  for (int i = threadIdx.x; i < s * (sp - s); i += blockDim.x) {
    const int b = i / (sp - s), a = s + (i - b * (sp - s));
    MT[b * sp + a] = 0.f;
  }
  for (int i = threadIdx.x; i < rows * ld; i += blockDim.x) {
    const int r = i / ld, c = i - r * ld;
    xs[i] = (r < nrows && c < s) ? Xb[(r0 + r) * s + c] : 0.f;
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= nrows) return;
  const float* xr = xs + r * ld;
  float acc = 0.f;
  for (int a0 = 0; a0 < sp; a0 += kA) {
    float t[kA];
#pragma unroll
    for (int k = 0; k < kA; ++k) t[k] = 0.f;
    for (int b = 0; b < s; ++b) {
      const float xb = xr[b];
      const float4 m0 = *reinterpret_cast<const float4*>(MT + b * sp + a0);
      const float4 m1 = *reinterpret_cast<const float4*>(MT + b * sp + a0 + 4);
      t[0] = fmaf(m0.x, xb, t[0]);
      t[1] = fmaf(m0.y, xb, t[1]);
      t[2] = fmaf(m0.z, xb, t[2]);
      t[3] = fmaf(m0.w, xb, t[3]);
      t[4] = fmaf(m1.x, xb, t[4]);
      t[5] = fmaf(m1.y, xb, t[5]);
      t[6] = fmaf(m1.z, xb, t[6]);
      t[7] = fmaf(m1.w, xb, t[7]);
    }
#pragma unroll
    for (int k = 0; k < kA; ++k) acc = fmaf(xr[a0 + k], t[k], acc);
  }
  out[bidx * n + r0 + r] = acc;
}

// The same quadratic form for widths whose M does not fit in shared memory
// beside a tile (s > 238).  M is read from global memory: one 8-row panel of
// it, 32 s bytes, is what every thread of the SM reads in the same order, so
// it stays in L1 and each load is a broadcast to the warp.  The X tile is
// staged as in leverage_kernel, at the same odd stride, and only `rows` tall
// (kernels/leverage.py::wide_rows).  The arithmetic and its order are
// leverage_kernel's: t_a = sum_b M[a][b] x_b in ascending b, acc = sum_a
// x_a t_a in ascending a, fp32 fmaf; past s the tile is zero, so t and the
// products there add exact zeros, as the padded MT does there.
__global__ void leverage_wide_kernel(const float* __restrict__ X,
                                     const float* __restrict__ M,
                                     float* __restrict__ out, long long n,
                                     int s, int sp, int ld, int rows,
                                     long long x_bstride, long long m_bstride) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [rows][ld], zero past s
  const long long bidx = blockIdx.y;
  const float* Mb = M + bidx * m_bstride;
  const float* Xb = X + bidx * x_bstride;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, n - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int r = warp; r < rows; r += nwarps)
    for (int c = lane; c < ld; c += 32)
      xs[r * ld + c] = (r < nrows && c < s) ? Xb[(r0 + r) * s + c] : 0.f;
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= nrows) return;
  const float* xr = xs + r * ld;
  float acc = 0.f;
  for (int a0 = 0; a0 < sp; a0 += kA) {
    float t[kA];
#pragma unroll
    for (int k = 0; k < kA; ++k) t[k] = 0.f;
    for (int b = 0; b < s; ++b) {
      const float xb = xr[b];
#pragma unroll
      for (int k = 0; k < kA; ++k) {
        const float m = a0 + k < s ? __ldg(Mb + (long long)(a0 + k) * s + b) : 0.f;
        t[k] = fmaf(m, xb, t[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kA; ++k) acc = fmaf(xr[a0 + k], t[k], acc);
  }
  out[bidx * n + r0 + r] = acc;
}

// Asynchronous copies that write zeros where `ok` is false (src-size 0: the
// source is not read, and is given a valid address all the same).
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src,
                                                  bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16_or_zero(float* dst, const float* src,
                                                   bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// Stage columns [k0, k0 + kTileK) of the first 64 rows of a row-major
// operand with rows of s floats into dst[64][kTileLd], as they lie (k
// fastest); rows from `valid` on and columns from s on as zeros.  With
// `vec` (s a multiple of 4, src 16-byte aligned) 16-byte copies, 8 threads
// a row; else 4-byte copies, a warp a row.
__device__ __forceinline__ void stage_slice(float* dst, const float* src,
                                            int valid, int s, int k0, bool vec,
                                            int tid) {
  if (vec) {
#pragma unroll
    for (int u = 0; u < kTileRows * kTileK / 4 / kTileThreads; ++u) {
      const int q = tid + u * kTileThreads;
      const int row = q / (kTileK / 4), k = (q % (kTileK / 4)) * 4;
      const bool ok = row < valid && k0 + k < s;
      cp_async16_or_zero(dst + row * kTileLd + k,
                         ok ? src + (long long)row * s + k0 + k : src, ok);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kTileRows * kTileK / kTileThreads; ++u) {
      const int e = tid + u * kTileThreads;
      const int row = e / kTileK, k = e % kTileK;
      const bool ok = row < valid && k0 + k < s;
      cp_async4_or_zero(dst + row * kTileLd + k,
                        ok ? src + (long long)row * s + k0 + k : src, ok);
    }
  }
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One staged slice into the thread's 8 x 4 tile, b ascending: rows as[8 i]
// and a-values bs[16 j], each a staged row at the stride kTileLd.  With
// kTail only the first kmax b of the slice (the last slice of a width that
// is not a multiple of kTileK), so every chain runs over b < s exactly.
template <bool kTail>
__device__ __forceinline__ void tile_fma(const float* as, const float* bs,
                                         int kmax, float (&acc)[kTm][kTn]) {
#pragma unroll
  for (int k4 = 0; k4 < kTileK; k4 += 4) {
    if (kTail && k4 >= kmax) break;
    float4 a[kTm], b[kTn];
#pragma unroll
    for (int i = 0; i < kTm; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + i * kTileTy * kTileLd + k4);
#pragma unroll
    for (int j = 0; j < kTn; ++j)
      b[j] = *reinterpret_cast<const float4*>(bs + j * kTileTx * kTileLd + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (!kTail || k4 + kk < kmax) {
#pragma unroll
        for (int i = 0; i < kTm; ++i)
#pragma unroll
          for (int j = 0; j < kTn; ++j)
            acc[i][j] = fmaf(lane4(a[i], kk), lane4(b[j], kk), acc[i][j]);
      }
    }
  }
}

// T[r][a] = sum_b x_rb M[a][b] for the rows [64 blockIdx.x, +64) of this
// row chunk (nrows of them) and a in [64 blockIdx.y, +64), a < sp: the fmaf
// chain over b = 0..s-1 ascending from 0.f (fmaf(x_b, M[a][b], t), the
// oracle's fmaf(M[a][b], x_b, t): an fma's product is exact, so the order of
// its factors does not matter).  M's rows a >= s are staged as zeros, so t_a
// there is the oracle's chain of fmaf(0, x_b, t).  Thread (tx, ty) owns rows
// ty + 8 i and a-values tx + 16 j, i < 8, j < 4, so a float4 read from
// shared memory feeds 16 or 32 fmaf.  Shared memory's 128 bytes a clock to
// the registers, not its banks, bind a register tile (a 16-byte read of a
// warp takes four clocks, broadcast or not): 12 floats read for 32 fmaf cap
// an 8 x 4 tile at 2/3 of the fp32 rate, 8 for 16 a 4 x 4 tile at 1/2.  A
// warp is 8 threads along a by 4 along the rows: its reads of a slice fall
// in distinct bank quads at the stride kTileLd = 36.
__global__ void __launch_bounds__(kTileThreads, kTileMinCtas)
    leverage_tiled_kernel(const float* __restrict__ X,
                          const float* __restrict__ M, float* __restrict__ T,
                          long long nrows, int s, int sp, long long x_bstride,
                          long long m_bstride, long long t_bstride, bool vec) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);    // [3][64][kTileLd]
  float* Bs = As + kTileStages * kTileStage;      // [3][64][kTileLd]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarpCols = kTileTx / kWarpTx;
  const int tx = (warp % kWarpCols) * kWarpTx + lane % kWarpTx;
  const int ty = (warp / kWarpCols) * (32 / kWarpTx) + lane / kWarpTx;
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int a0 = blockIdx.y * kTileCols;
  const long long bidx = blockIdx.z;
  const float* Xt = X + bidx * x_bstride + r0 * s;
  const float* Mt = M + bidx * m_bstride + (long long)a0 * s;
  const int xrows = (int)min((long long)kTileRows, nrows - r0);
  const int mrows = min(kTileCols, s - a0);   // a0 < s: a0 <= sp - 8
  const int nk = (s + kTileK - 1) / kTileK;

  auto issue = [&](int sl) {
    if (sl < nk) {
      const int st = sl % kTileStages;
      stage_slice(As + st * kTileStage, Xt, xrows, s, sl * kTileK, vec, tid);
      stage_slice(Bs + st * kTileStage, Mt, mrows, s, sl * kTileK, vec, tid);
    }
    cp_async_commit();
  };

  float acc[kTm][kTn];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int sl = 0; sl < kTileStages - 1; ++sl) issue(sl);
  for (int sl = 0; sl < nk; ++sl) {
    cp_async_wait<kTileStages - 2>();
    __syncthreads();   // slice sl has landed for every thread, and every
                       // thread is done with slice sl - 1's stage
    issue(sl + kTileStages - 1);   // into that stage
    const int st = sl % kTileStages;
    const float* as = As + st * kTileStage + ty * kTileLd;
    const float* bs = Bs + st * kTileStage + tx * kTileLd;
    const int kmax = s - sl * kTileK;
    if (kmax >= kTileK)
      tile_fma<false>(as, bs, kmax, acc);
    else
      tile_fma<true>(as, bs, kmax, acc);
  }

  float* Tb = T + bidx * t_bstride;
#pragma unroll
  for (int i = 0; i < kTm; ++i) {
    const int row = ty + i * kTileTy;
    if (row >= xrows) continue;
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      const int a = a0 + tx + j * kTileTx;
      if (a < sp) Tb[(r0 + row) * sp + a] = acc[i][j];
    }
  }
}

// out[r] = the fmaf chain of x_a T[r][a] over a = 0..sp-1 ascending from 0.f,
// x_a = 0 for a >= s: the oracle's fold.  A CTA takes 32 rows, one a lane of
// warp 0.  Both warps stage chunks of 32 a-values of those rows of X and of
// T as they lie, rows at the stride kFoldLd (16-byte copies, 8 threads a
// row; X 4-byte unless kVec), through a ring of kFoldStages chunks, so the
// chunks ahead load while warp 0 folds this one, reading its own row a
// float4 at a time (a quarter-warp's 8 rows fall in distinct bank quads).
// The chain, sp dependent fmaf a row, bounds it at a few hundred rows; at
// many rows the bytes of X and T do.  Warp 0's copies sit on the chain's
// path, so their sources and shared addresses are fixed a thread and step
// by a chunk, and the second warp takes half of them.
template <bool kVec>
__global__ void __launch_bounds__(kFoldThreads)
    leverage_fold_kernel(const float* __restrict__ X,
                         const float* __restrict__ T, float* __restrict__ out,
                         long long nrows, int s, int sp, long long x_bstride,
                         long long t_bstride, long long out_bstride) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [stages][2][32][kFoldLd]
  constexpr int kChunk = 2 * kFoldRows * kFoldLd;
  constexpr int kRowStep = kFoldThreads / 8;        // rows a 16-byte copy step
  constexpr int kPer = kFoldRows / kRowStep;        // ... and steps a chunk
  constexpr int kRowStep4 = kFoldThreads / 32;      // the same, 4-byte
  constexpr int kPer4 = kFoldRows / kRowStep4;
  const int tid = threadIdx.x, lane = tid % 32;
  const long long r0 = (long long)blockIdx.x * kFoldRows;
  const long long bidx = blockIdx.y;
  const int nr = (int)min((long long)kFoldRows, nrows - r0);
  const float* Xr = X + bidx * x_bstride + r0 * s;
  const float* Tr = T + bidx * t_bstride + r0 * sp;
  const int nch = (sp + kFoldCols - 1) / kFoldCols;
  // this thread's 16-byte copies: rows tid / 8 + kRowStep u at the column
  // col of every chunk, their sources at chunk 0 (row 0 past nr: a
  // zero-filled copy still names a valid address) and shared addresses in
  // stage 0
  const int col = (tid % 8) * 4;
  const float* xp[kPer];
  const float* tp[kPer];
  bool rok[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int r = tid / 8 + kRowStep * u;
    rok[u] = r < nr;
    xp[u] = Xr + (long long)(rok[u] ? r : 0) * s + col;
    tp[u] = Tr + (long long)(rok[u] ? r : 0) * sp + col;
  }
  const unsigned sx = static_cast<unsigned>(__cvta_generic_to_shared(ring)) +
                      ((tid / 8) * kFoldLd + col) * 4;
  const unsigned st = sx + kFoldRows * kFoldLd * 4;

  auto issue = [&](int c) {
    if (c < nch) {
      const unsigned so = (c % kFoldStages) * kChunk * 4;
      const int c0 = c * kFoldCols;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const unsigned du = so + kRowStep * u * kFoldLd * 4;
        const unsigned tb = rok[u] && c0 + col < sp ? 16 : 0;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(st + du), "l"(tp[u] + c0), "r"(tb));
        if (kVec) {
          const unsigned xb = rok[u] && c0 + col < s ? 16 : 0;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                       ::"r"(sx + du), "l"(xp[u] + c0), "r"(xb));
        }
      }
      if (!kVec) {
        float* xs = ring + (c % kFoldStages) * kChunk;
#pragma unroll 4
        for (int u = 0; u < kPer4; ++u) {
          const int r = tid / 32 + kRowStep4 * u;
          const bool ok = r < nr && c0 + lane < s;
          cp_async4_or_zero(xs + r * kFoldLd + lane,
                            ok ? Xr + (long long)r * s + c0 + lane : Xr, ok);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < kFoldStages - 1; ++c) issue(c);
  float acc = 0.f;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kFoldStages - 2>();
    __syncthreads();   // chunk c has landed for every thread, and warp 0 is
                       // done with chunk c - 1's stage
    issue(c + kFoldStages - 1);
    if (tid < kFoldRows) {
      const float* xs = ring + (c % kFoldStages) * kChunk + tid * kFoldLd;
      const float* ts = xs + kFoldRows * kFoldLd;
      // a whole chunk unguarded, so that its reads are all issued ahead of
      // the chain (a guard on each float4 keeps them behind it); the last
      // chunk may hold 8, 16 or 24 a-values
      const int na = min(kFoldCols, sp - c * kFoldCols);
      if (na == kFoldCols) {
#pragma unroll
        for (int k4 = 0; k4 < kFoldCols; k4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(xs + k4);
          const float4 t = *reinterpret_cast<const float4*>(ts + k4);
          acc = fmaf(x.x, t.x, acc);
          acc = fmaf(x.y, t.y, acc);
          acc = fmaf(x.z, t.z, acc);
          acc = fmaf(x.w, t.w, acc);
        }
      } else {
        for (int k = 0; k < na; ++k) acc = fmaf(xs[k], ts[k], acc);
      }
    }
  }
  if (tid < nr) out[bidx * out_bstride + r0 + tid] = acc;
}

template <bool kVec>
cudaError_t launch_fold(dim3 grid, size_t bytes, cudaStream_t st,
                        const float* X, const float* T, float* out,
                        long long nrows, int s, int sp, long long x_bstride,
                        long long t_bstride, long long out_bstride) {
  leverage_fold_kernel<kVec><<<grid, kFoldThreads, bytes, st>>>(
      X, T, out, nrows, s, sp, x_bstride, t_bstride, out_bstride);
  return cudaGetLastError();
}

template <int SP>
cudaError_t launch_reg(int B, cudaStream_t st, const float* X,
                       const float* M, float* out, long long n, int s,
                       long long x_bstride, long long m_bstride) {
  const size_t bytes = (size_t)reg_floats(s) * sizeof(float);
  cudaError_t e = repro_set_smem(leverage_reg_kernel<SP>, bytes);
  if (e != cudaSuccess) return e;
  // all of the SM's shared memory, so it holds as many CTAs as it can
  e = cudaFuncSetAttribute(leverage_reg_kernel<SP>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  unsigned ctas = 0;
  e = repro_persistent_ctas(leverage_reg_kernel<SP>, kRegThreads, bytes,
                            (n + kRegRows - 1) / kRegRows, B, &ctas);
  if (e != cudaSuccess) return e;
  const dim3 grid(ctas, (unsigned)B);
  leverage_reg_kernel<SP><<<grid, kRegThreads, bytes, st>>>(
      X, M, out, n, s, x_bstride, m_bstride);
  return cudaGetLastError();
}

}  // namespace

// X: B (or 1, with x_bstride 0) blocks of (n, s) fp32, row-major;
// M: B (or 1, with m_bstride 0) blocks of (s, s); out: (B, n).  Where
// reg_width(s) leverage_reg_kernel runs, at other s leverage_kernel.
REPRO_API int repro_leverage(const float* X, const float* M, float* out, int B,
                             long long n, int s, long long x_bstride,
                             long long m_bstride, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || s < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reg_width(s)) {
    switch ((s + kA - 1) / kA) {
      case 1: return (int)launch_reg<8>(B, st, X, M, out, n, s, x_bstride, m_bstride);
      case 2: return (int)launch_reg<16>(B, st, X, M, out, n, s, x_bstride, m_bstride);
      case 3: return (int)launch_reg<24>(B, st, X, M, out, n, s, x_bstride, m_bstride);
      default: return (int)launch_reg<32>(B, st, X, M, out, n, s, x_bstride, m_bstride);
    }
  }
  const int sp = (s + kA - 1) / kA * kA;
  const int ld = sp + 1;                       // odd: conflict-free row reads
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const long long m_bytes = (long long)s * sp * sizeof(float);
  const long long row_bytes = (long long)ld * sizeof(float);
  const long long fit = (limit - m_bytes) / row_bytes;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int rows = (int)(fit < kThreads ? fit : kThreads);
  const size_t bytes = (size_t)(m_bytes + rows * row_bytes);
  e = repro_set_smem(leverage_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)B);
  leverage_kernel<<<grid, kThreads, bytes, st>>>(
      X, M, out, n, s, sp, ld, rows, x_bstride, m_bstride);
  return (int)cudaGetLastError();
}

// The wide variant: X and M as for repro_leverage, any s; `rows` is the tile
// height the wrapper chose (at most kThreads), `rows * (sp + 1)` floats of
// shared memory.
REPRO_API int repro_leverage_wide(const float* X, const float* M, float* out,
                                  int B, long long n, int s, int rows,
                                  long long x_bstride, long long m_bstride,
                                  void* stream) {
  if (B < 1 || B > 65535 || n < 1 || s < 1 || rows < 1 || rows > kThreads)
    return (int)cudaErrorInvalidValue;
  const int sp = (s + kA - 1) / kA * kA;
  const int ld = sp + 1;
  const size_t bytes = (size_t)rows * ld * sizeof(float);
  cudaError_t e = repro_set_smem(leverage_wide_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + rows - 1) / rows;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int threads = (rows + 31) / 32 * 32;
  leverage_wide_kernel<<<dim3((unsigned)tiles, (unsigned)B), threads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      X, M, out, n, s, sp, ld, rows, x_bstride, m_bstride);
  return (int)cudaGetLastError();
}

// The kernel past s = 238: X and M as for repro_leverage, any s and B; T a
// scratch of batches * chunk_rows * sp floats (sp = s rounded up to a
// multiple of 8).  For each group of `batches` batch entries (at most the
// grid's 65,535 along z) and each chunk of chunk_rows rows,
// leverage_tiled_kernel writes T = X M^T for the chunk's rows, then
// leverage_fold_kernel folds each row of T with its row of X into out.  Two
// launches a chunk, in order on `stream`.
REPRO_API int repro_leverage_tiled(const float* X, const float* M, float* out,
                                   float* T, int B, long long n, int s, int batches,
                                   long long chunk_rows, long long x_bstride,
                                   long long m_bstride, void* stream) {
  if (B < 1 || n < 1 || s < 1 || batches < 1 || batches > 65535 || chunk_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sp = (s + kA - 1) / kA * kA;
  const long long a_tiles = (sp + kTileCols - 1) / kTileCols;
  const long long row_tiles = (chunk_rows + kTileRows - 1) / kTileRows;
  if (a_tiles > 65535 || row_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  // 16-byte copies where the rows of X and M keep 16-byte alignment
  const bool vec = s % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(X) & 15) == 0 &&
                   (reinterpret_cast<unsigned long long>(M) & 15) == 0;
  const size_t tile_bytes = (size_t)kTileStages * 2 * kTileStage * sizeof(float);
  const size_t fold_bytes =
      (size_t)kFoldStages * 2 * kFoldRows * kFoldLd * sizeof(float);
  cudaError_t e = repro_set_smem(leverage_tiled_kernel, tile_bytes);
  if (e != cudaSuccess) return (int)e;
  e = repro_set_smem(leverage_fold_kernel<true>, fold_bytes);
  if (e != cudaSuccess) return (int)e;
  e = repro_set_smem(leverage_fold_kernel<false>, fold_bytes);
  if (e != cudaSuccess) return (int)e;
  const long long t_bstride = chunk_rows * sp;
  for (int b0 = 0; b0 < B; b0 += batches) {
    const int nb = B - b0 < batches ? B - b0 : batches;
    const float* Xg = X + b0 * x_bstride;
    const float* Mg = M + b0 * m_bstride;
    float* outg = out + b0 * n;
    for (long long r0 = 0; r0 < n; r0 += chunk_rows) {
      const long long nr = n - r0 < chunk_rows ? n - r0 : chunk_rows;
      const dim3 grid((unsigned)((nr + kTileRows - 1) / kTileRows), (unsigned)a_tiles,
                      (unsigned)nb);
      leverage_tiled_kernel<<<grid, kTileThreads, tile_bytes, st>>>(
          Xg + r0 * s, Mg, T, nr, s, sp, x_bstride, m_bstride, t_bstride, vec);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      const dim3 fgrid((unsigned)((nr + kFoldRows - 1) / kFoldRows), (unsigned)nb);
      e = vec ? launch_fold<true>(fgrid, fold_bytes, st, Xg + r0 * s, T, outg + r0, nr,
                                  s, sp, x_bstride, t_bstride, n)
              : launch_fold<false>(fgrid, fold_bytes, st, Xg + r0 * s, T, outg + r0, nr,
                                   s, sp, x_bstride, t_bstride, n);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaSuccess;
}
