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
// Design: one thread per row, one CTA per 128-row tile of one party (grid
// (row tiles, T); a batch-less M is shared by every party).  The CTA stages
// its tile of X in shared memory with coalesced loads, at an odd row stride
// so the per-thread row reads hit distinct banks, and holds M transposed and
// zero-padded to a multiple of 8 columns in shared memory for its lifetime.
// Each thread forms t_a = sum_b M[a][b] x_b for eight a at once (two
// broadcast 128-bit loads of M and one load of x_b per eight FMAs), then
// acc = sum_a x_a t_a, in a fixed order, in fp32.  The real width s is kept:
// there is no padding to 128 lanes, which is a TPU layout.  No clip and no
// +1/n here: those stay in vrlr_scores_stacked, as in the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // one row per thread
constexpr int kA = 8;           // a-values per register block

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

}  // namespace

// X: B (or 1, with x_bstride 0) blocks of (n, s) fp32, row-major;
// M: B (or 1, with m_bstride 0) blocks of (s, s); out: (B, n).
REPRO_API int repro_leverage(const float* X, const float* M, float* out, int B,
                             long long n, int s, long long x_bstride,
                             long long m_bstride, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || s < 1) return (int)cudaErrorInvalidValue;
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
  leverage_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      X, M, out, n, s, sp, ld, rows, x_bstride, m_bstride);
  return (int)cudaGetLastError();
}
