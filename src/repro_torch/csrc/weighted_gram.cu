// Weighted Gram G = X^T diag(w) X (the closed-form ridge of fit_ridge and of
// evaluate's full-data baseline).
//
// Replaces the TPU kernel src/repro/kernels/weighted_gram.py::weighted_gram
// (Pallas body `_kernel`), which carries the (d, d) sum in its output block
// across a sequential grid of row tiles.  Blocks on the GPU run in no order
// and share nothing, so the sum becomes a deterministic two-stage reduction.
//
// Bound on the H100 at the main-path shapes (d = 90): at the full n =
// 463,715 rows of evaluate's baseline the kernel reads X and w once, 169 MB
// (50 us at 3.35 TB/s).  G is symmetric, so the least arithmetic is one
// triangle: n d (d + 1) + n d = 3.8 GFLOP of fp32 (57 us at 67 TFLOP/s
// without tensor cores), and it is bound by fp32 arithmetic, barely.  This
// kernel computes every tile of G, both triangles, so it does about twice
// that.  The coreset fit (n = 5,000) is a few microseconds of work and
// launch-bound.
//
// Design: stage 1 splits the rows into P fixed contiguous ranges, one CTA
// each (grid (P, B, Z)).  A CTA walks its range 16 rows at a time through
// shared memory (coalesced row loads, columns zero-padded to a multiple of
// 8); each thread owns one 8x8 tile of the (d, d) output in registers and
// updates it from two 128-bit loads per side per row, 64 FMAs for 4 shared
// loads.  The product is (x_i w) x_j, the reference's (X*w)^T X.  When d
// has more 8x8 tiles than a CTA has threads, Z CTAs share a range, each
// taking its own tiles.  The CTA writes its partial to a (B, P, d, d)
// scratch; stage 2 sums the P partials of each entry in order p = 0..P-1.
// No float atomics: two runs on the same input give the same bits, which
// the coreset weights downstream rely on.
#include "common.cuh"

namespace {

constexpr int kRows = 16;        // rows per shared-memory tile
constexpr int kTile = 8;         // output tile edge per thread
constexpr int kMaxThreads = 256;

__global__ void wgram_partial_kernel(const float* __restrict__ X,
                                     const float* __restrict__ w,
                                     float* __restrict__ part, long long n,
                                     int d, int dp, long long rows_per_cta,
                                     long long x_bstride, long long w_bstride) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kRows][dp]
  float* ws = xs + kRows * dp;                    // [kRows]
  const int P = gridDim.x;
  const long long p = blockIdx.x, bidx = blockIdx.y;
  const float* Xb = X + bidx * x_bstride;
  const float* wb = w + bidx * w_bstride;
  const int nt = dp / kTile;
  const int tile = blockIdx.z * blockDim.x + threadIdx.x;
  const bool active = tile < nt * nt;
  const int ti = active ? tile / nt : 0;
  const int tj = active ? tile - ti * nt : 0;

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;

  const long long lo = p * rows_per_cta;
  const long long hi = min(n, lo + rows_per_cta);
  for (long long r0 = lo; r0 < hi; r0 += kRows) {
    const int nr = (int)min((long long)kRows, hi - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * dp; i += blockDim.x) {
      const int r = i / dp, c = i - r * dp;
      xs[i] = (r < nr && c < d) ? Xb[(r0 + r) * d + c] : 0.f;
    }
    if (threadIdx.x < kRows)
      ws[threadIdx.x] = threadIdx.x < nr ? wb[r0 + threadIdx.x] : 0.f;
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < nr; ++r) {
      const float* xr = xs + r * dp;
      const float wr = ws[r];
      const float4 a0 = *reinterpret_cast<const float4*>(xr + ti * kTile);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + ti * kTile + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(xr + tj * kTile);
      const float4 c1 = *reinterpret_cast<const float4*>(xr + tj * kTile + 4);
      const float xa[kTile] = {a0.x * wr, a0.y * wr, a0.z * wr, a0.w * wr,
                               a1.x * wr, a1.y * wr, a1.z * wr, a1.w * wr};
      const float xc[kTile] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(xa[i], xc[j], acc[i][j]);
    }
  }
  if (!active) return;
  float* dst = part + (bidx * P + p) * (long long)d * d;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int gi = ti * kTile + i;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int gj = tj * kTile + j;
      if (gi < d && gj < d) dst[(long long)gi * d + gj] = acc[i][j];
    }
  }
}

__global__ void wgram_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int P,
                                    long long dd, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long bidx = i / dd, e = i - bidx * dd;
  const float* src = part + bidx * P * dd + e;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += src[p * dd];
  out[i] = s;
}

}  // namespace

// X: B (or 1, with x_bstride 0) blocks of (n, d) fp32, row-major; w: B (or 1,
// with w_bstride 0) vectors of n; part: (B, P, d, d) scratch with P =
// ceil(n / rows_per_cta); out: (B, d, d).
REPRO_API int repro_weighted_gram(const float* X, const float* w, float* part,
                                  float* out, int B, long long n, int d,
                                  long long rows_per_cta, long long x_bstride,
                                  long long w_bstride, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || d < 1 || rows_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  const long long P = (n + rows_per_cta - 1) / rows_per_cta;
  if (P > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int dp = (d + kTile - 1) / kTile * kTile;
  const int nt = dp / kTile;
  const int tiles = nt * nt;
  const int threads = tiles < kMaxThreads ? (tiles + 31) / 32 * 32 : kMaxThreads;
  const int Z = (tiles + threads - 1) / threads;
  if (Z > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(kRows * dp + kRows) * sizeof(float);
  cudaError_t e = repro_set_smem(wgram_partial_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wgram_partial_kernel<<<dim3((unsigned)P, (unsigned)B, (unsigned)Z), threads,
                         bytes, st>>>(X, w, part, n, d, dp, rows_per_cta,
                                      x_bstride, w_bstride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long dd = (long long)d * d, total = B * dd;
  const int rt = 256;
  wgram_reduce_kernel<<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
      part, out, (int)P, dd, total);
  return (int)cudaGetLastError();
}
