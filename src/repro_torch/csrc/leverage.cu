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
// All three kernels below compute exactly this, in fp32 with explicit fmaf;
// leverage_wide_kernel, which reads M from global memory, is the oracle that
// chip_smoke.py and the gpu tests hold the others to, bit for bit
// (kernels/leverage.py::_launch with wide=True).  The real width s is kept:
// there is no padding to 128 lanes, which is a TPU layout.  No clip and no
// +1/n here: those stay in vrlr_scores_stacked, as in the reference.
//
// The kernels, picked by s (the wrapper takes the wide one past s = 238,
// repro_leverage picks between the other two):
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
//   memory: leverage_wide_kernel, M through L1 and L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // one row per thread
constexpr int kA = 8;           // a-values per register block

constexpr int kRegThreads = 128;                  // leverage_reg_kernel's CTA
constexpr int kRegRpt = 2;                        // rows a thread holds
constexpr int kRegRows = kRegRpt * kRegThreads;   // rows of a tile
constexpr int kRegMaxWidth = 32;                  // widest s it takes
constexpr int kRegMinCtas = 3;   // CTAs an SM must hold (registers capped so)

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
