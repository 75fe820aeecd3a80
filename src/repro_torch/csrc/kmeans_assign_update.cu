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
//
// Design: stage 1 splits each batch entry's rows into P fixed contiguous
// ranges, one CTA each (grid (P, B)); the split is a function of n alone
// (kernels/kmeans_assign_update.py::row_split).  A CTA holds C and ||c||^2
// in shared memory for its life and walks its range a tile of up to 128
// rows at a time: coalesced loads of the tile, one row per thread through
// kmeans_common.cuh's distance and argmin (shared with kmeans_assign.cu),
// assign and d2 written out and kept in shared memory.  Then the CTA's
// partial sums are updated: each thread owns fixed entries of the
// (k d + 2 k) accumulator and adds the tile's rows of its cluster to them in
// row order.  An entry has one owner, so there are no atomics, not even in
// shared memory.  The CTA writes its partial to a (B, P, k d + 2 k) scratch;
// stage 2 sums the P partials of each entry in order p = 0..P-1.  Two
// launches on the same input give the same bits, which the coreset draws
// downstream rely on (ccost feeds the vkmc scores).  fp32 with explicit
// fmaf, no tensor cores and no TF32; no padding of d or k to 128 lanes.
// A (k, d) whose layout does not fit in shared memory runs
// kau_partial_global_kernel as stage 1 instead (the same partials, bit for
// bit), then the same stage 2.
#include "kmeans_common.cuh"

namespace {

// Entry e of a CTA's (k d + 2 k) partial sums, `s` so far, plus the tile's
// nr rows of its cluster in row order: entries [0, kd) are csum[l][j] (x
// row i at xt[i * ld + j]), [kd, kd + k) wsum[l], then ccost[l].  The tile's
// assignments sa, weights sw and clamped d2 sd are in shared memory.
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

__global__ void kau_partial_kernel(
    const float* __restrict__ X, const float* __restrict__ C,
    const float* __restrict__ w, int* __restrict__ assign,
    float* __restrict__ d2, float* __restrict__ part, long long n, int d,
    int k, int rows, long long rows_per_cta, long long x_bstride,
    long long c_bstride, long long w_bstride) {
  extern __shared__ float4 smem4[];
  const int kp = kmeans::padded_k(k);
  const int ld = kmeans::row_stride(d);
  float* CT = reinterpret_cast<float*>(smem4);
  float* cn = CT + (size_t)d * kp;
  float* xs = cn + kp;
  float* sw = xs + (size_t)rows * ld;     // [rows] weights of the tile
  float* sd = sw + rows;                  // [rows] clamped d2 of the tile
  int* sa = reinterpret_cast<int*>(sd + rows);   // [rows] assignments
  float* acc = reinterpret_cast<float*>(sa + rows);  // [k d + 2 k]
  const int kd = k * d;
  const int E = kd + 2 * k;
  const int P = gridDim.x;
  const long long p = blockIdx.x, b = blockIdx.y;
  const float* Xb = X + b * x_bstride;
  const float* wb = w ? w + b * w_bstride : nullptr;

  kmeans::load_centers(C + b * c_bstride, CT, cn, d, k);
  for (int e = threadIdx.x; e < E; e += blockDim.x) acc[e] = 0.f;

  const long long lo = p * rows_per_cta;
  const long long hi = min(n, lo + rows_per_cta);
  for (long long r0 = lo; r0 < hi; r0 += rows) {
    const int nr = (int)min((long long)rows, hi - r0);
    __syncthreads();   // the previous tile's sums are done with xs, sa, sd, sw
    kmeans::load_tile(Xb + r0 * d, xs, nr, d);
    for (int r = threadIdx.x; r < nr; r += blockDim.x)
      sw[r] = wb ? wb[r0 + r] : 1.f;
    __syncthreads();
    const int r = threadIdx.x;
    if (r < nr) {
      int a;
      float dd;
      kmeans::assign_row(xs + r * ld, CT, cn, d, k, &a, &dd);
      sa[r] = a;
      sd[r] = dd;
      assign[b * n + r0 + r] = a;
      d2[b * n + r0 + r] = dd;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      acc[e] = add_tile_rows(acc[e], e, nr, sa, sw, sd, xs, ld, d, k);
  }
  // each thread writes the entries it owns: no barrier needed
  float* dst = part + (b * P + p) * (long long)E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) dst[e] = acc[e];
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

}  // namespace

// Floats of the stage-1 layout for a tile of `rows` rows (the wrapper's
// kmeans_assign_update.smem_bytes computes the same).
static long long kau_floats(int d, int k, int rows) {
  return kmeans::common_floats(d, k, rows) + 3LL * rows + (long long)k * d + 2LL * k;
}

// X: B (or 1, with x_bstride 0) blocks of (n, d) fp32, row-major; C: B (or
// 1) blocks of (k, d); w: B (or 1) vectors of n, or null for unit weights;
// assign, d2: (B, n); part: (B, P, k d + 2 k) scratch with P =
// ceil(n / rows_per_cta); csum (B, k, d), wsum (B, k), ccost (B, k).
// `rows` is the tile height the wrapper chose so that the layout fits in
// shared memory, or 0 for the global variant of stage 1.
REPRO_API int repro_kmeans_assign_update(
    const float* X, const float* C, const float* w, int* assign, float* d2,
    float* part, float* csum, float* wsum, float* ccost, int B, long long n,
    int d, int k, int rows, long long rows_per_cta, long long x_bstride,
    long long c_bstride, long long w_bstride, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || d < 1 || k < 1 || rows < 0 ||
      rows > kmeans::kThreads || rows_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  const long long P = (n + rows_per_cta - 1) / rows_per_cta;
  if (P > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rows == 0) {
    kau_partial_global_kernel<<<dim3((unsigned)P, (unsigned)B),
                                kmeans::kThreads, 0, st>>>(
        X, C, w, assign, d2, part, n, d, k, rows_per_cta, x_bstride,
        c_bstride, w_bstride);
  } else {
    const size_t bytes = (size_t)kau_floats(d, k, rows) * sizeof(float);
    e = repro_set_smem(kau_partial_kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    kau_partial_kernel<<<dim3((unsigned)P, (unsigned)B), kmeans::kThreads,
                         bytes, st>>>(X, C, w, assign, d2, part, n, d, k, rows,
                                      rows_per_cta, x_bstride, c_bstride,
                                      w_bstride);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int kd = k * d;
  const long long total = (long long)B * (kd + 2 * k);
  const int rt = 256;
  kau_reduce_kernel<<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
      part, csum, wsum, ccost, (int)P, k, kd, total);
  return (int)cudaGetLastError();
}
