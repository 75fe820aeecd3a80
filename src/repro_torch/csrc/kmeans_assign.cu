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
// Design: one CTA per tile of up to 128 rows of one batch entry (grid
// (row tiles, B); a batch-less C is shared by every entry).  The CTA holds
// C transposed and zero-padded to a multiple of 8 centers, and ||c||^2, in
// shared memory, stages its rows with coalesced loads at an odd row stride,
// and gives one row to each thread.  The distance and argmin code is
// kmeans_common.cuh's, shared with kmeans_assign_update.cu.  fp32 with
// explicit fmaf, no tensor cores and no TF32.  The real d and k are kept:
// there is no padding to 128 lanes, which is a TPU layout.  A (k, d) whose
// layout does not fit in shared memory runs kmeans_assign_global_kernel,
// which reads C from global memory instead (the same result, bit for bit).
#include "kmeans_common.cuh"

namespace {

__global__ void kmeans_assign_kernel(const float* __restrict__ X,
                                     const float* __restrict__ C,
                                     int* __restrict__ assign,
                                     float* __restrict__ d2, long long n, int d,
                                     int k, int rows, long long x_bstride,
                                     long long c_bstride) {
  extern __shared__ float4 smem4[];
  const int kp = kmeans::padded_k(k);
  float* CT = reinterpret_cast<float*>(smem4);
  float* cn = CT + (size_t)d * kp;
  float* xs = cn + kp;
  const long long b = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, n - r0);

  kmeans::load_tile(X + b * x_bstride + r0 * d, xs, nr, d);
  kmeans::load_centers(C + b * c_bstride, CT, cn, d, k);   // ends in a barrier

  const int r = threadIdx.x;
  if (r >= nr) return;
  int a;
  float dd;
  kmeans::assign_row(xs + r * kmeans::row_stride(d), CT, cn, d, k, &a, &dd);
  assign[b * n + r0 + r] = a;
  d2[b * n + r0 + r] = dd;
}

// The global variant, for (k, d) whose layout does not fit in shared memory:
// one row per thread, the row and C read through the caches
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

}  // namespace

// X: B (or 1, with x_bstride 0) blocks of (n, d) fp32, row-major; C: B (or
// 1, with c_bstride 0) blocks of (k, d); assign, d2: (B, n).  `rows` is the
// tile height the wrapper chose so that the layout fits in shared memory, or
// 0 for the global variant.
REPRO_API int repro_kmeans_assign(const float* X, const float* C, int* assign,
                                  float* d2, int B, long long n, int d, int k,
                                  int rows, long long x_bstride,
                                  long long c_bstride, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || d < 1 || k < 1 || rows < 0 ||
      rows > kmeans::kThreads)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) {
    const long long blocks = (n + kmeans::kThreads - 1) / kmeans::kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    kmeans_assign_global_kernel<<<dim3((unsigned)blocks, (unsigned)B),
                                  kmeans::kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        X, C, assign, d2, n, d, k, x_bstride, c_bstride);
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)kmeans::common_floats(d, k, rows) * sizeof(float);
  cudaError_t e = repro_set_smem(kmeans_assign_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + rows - 1) / rows;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)B);
  kmeans_assign_kernel<<<grid, kmeans::kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      X, C, assign, d2, n, d, k, rows, x_bstride, c_bstride);
  return (int)cudaGetLastError();
}
