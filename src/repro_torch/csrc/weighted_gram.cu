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
// without tensor cores): bound by fp32 arithmetic, barely.  What binds this
// kernel is shared memory: an 8x8 register tile (the largest that fits in
// the 128 registers a thread has at 16 warps per SM) reads one byte of
// shared memory per FMA, as much as the SM's 128 bytes per clock give, and
// the copies of the stage go through the same pipe.  The coreset fit
// (n = 5,000) is a few microseconds of work.
//
// Design, stage 1 (wgram_partial_kernel):
// - Only the 8x8 tiles (ti, tj) of G with ti <= tj are computed: 78 of 144
//   at d = 90.  Stage 2 fills (i, j) and (j, i) from the one partial entry
//   (min(i, j), max(i, j)), so G is exactly symmetric.
// - One thread owns one upper tile in 64 registers; a CTA of up to 256
//   threads holds RG row groups of the tiles (RG = 3 at d = 90: 234 of 256
//   threads busy), each group taking every RG-th row of a stage.  Two CTAs
//   fit on an SM (16 warps); the row split gives 264 CTAs at full n and 157
//   at n = 5,000, so every one of the 132 SMs is busy in both.
// - Rows move through shared memory in stages of up to 32 rows, in a ring
//   of three buffers: the next two stages' rows are in flight (cp.async, a
//   warp per row, a lane per column) while the current stage is multiplied,
//   with one barrier per stage.  (In exploratory runs three buffers beat
//   two, and four did no better than three.)
// - Per row a thread reads two 128-bit words of its ti block and two of its
//   tj block, forms x_i w once for its 8 rows of the tile, and does 64 fmaf:
//   every product is (x_i w) x_j, the reference's (X * w)^T X.  (A separate
//   pass that wrote x * w into a second buffer was slower in exploratory
//   runs: it is one more trip through the same shared-memory pipe.)  fp32
//   on the CUDA cores: no tensor cores, no TF32.
// - At the end the RG groups' tiles are added in group order 0..RG-1 through
//   shared memory, and the CTA writes one partial of its upper tiles to a
//   (B, P, d, d) scratch.  When one group of a CTA cannot hold all upper
//   tiles (d > 176), Z CTAs share a row range, each taking its own tiles.
// Stage 2 (wgram_reduce_kernel): each entry of G sums its P partials in a
// fixed order, 8 fixed strided slices of p, then the slices in order.
// No float atomics anywhere, and the split is a function of the shape alone,
// never of the device: two launches give the same bits.
#include "common.cuh"

namespace {

constexpr int kTile = 8;          // output tile edge per thread
constexpr int kMaxRows = 32;      // rows per stage, fewer for very wide d
constexpr int kMaxThreads = 256;  // 8 warps; two CTAs per SM
constexpr int kStages = 3;        // stage buffers: two in flight
constexpr int kSlices = 8;        // stage 2: partial slices per entry
constexpr size_t kMaxSmem = 232448;   // a block's shared memory on Hopper

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait for this thread's copies of the oldest stage in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// Shared memory: kStages buffers of R rows of x at row stride dp (zero past
// d), then kStages runs of R weights.
__host__ __device__ inline long long stage_floats(int dp, int R) {
  return (long long)kStages * R * (dp + 1);
}

__global__ void __launch_bounds__(kMaxThreads, 2)
wgram_partial_kernel(const float* __restrict__ X, const float* __restrict__ w,
                     float* __restrict__ part, long long n, int d, int dp,
                     int R, int tiles_per_cta, int groups,
                     long long rows_per_cta, long long x_bstride,
                     long long w_bstride) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* wbase = base + kStages * R * dp;
  const int nt = dp / kTile;
  const int ntri = nt * (nt + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // this thread's row group and upper tile (ti <= tj), in row-major order
  const int g = threadIdx.x / tiles_per_cta;
  const int u = blockIdx.z * tiles_per_cta + (threadIdx.x - g * tiles_per_cta);
  const bool active = g < groups && u < ntri;
  int ti = 0, tj = 0;
  if (active) {
    int rest = u;
    while (rest >= nt - ti) rest -= nt - ti++;
    tj = ti + rest;
  }

  // zero the padding columns of every buffer once; the copies never write
  // them
  for (int i = threadIdx.x; i < kStages * R * (dp - d); i += blockDim.x) {
    const int r = i / (dp - d), c = d + i - r * (dp - d);
    base[r * dp + c] = 0.f;
  }

  // this CTA's rows, [lo, lo + rows)
  const long long lo = blockIdx.x * rows_per_cta;
  const int rows = (int)(min(n, lo + rows_per_cta) - lo);
  const float* Xc = X + blockIdx.y * x_bstride + lo * d;
  const float* wc = w + blockIdx.y * w_bstride + lo;
  const int nstages = (rows + R - 1) / R;
  // copy stage st (if there is one) into its buffer and commit a group (an
  // empty one past the last stage, so every thread counts the same groups)
  auto issue = [&](int st) {
    const int r0 = st * R;
    const int nr = st < nstages ? min(R, rows - r0) : 0;
    float* xs = base + (st % kStages) * R * dp;
    float* ws = wbase + (st % kStages) * R;
    for (int r = warp; r < nr; r += nwarps) {
      const float* src = Xc + (long long)(r0 + r) * d;
      for (int c = lane; c < d; c += 32) cp_async4(xs + r * dp + c, src + c);
      if (lane == 0) cp_async4(ws + r, wc + r0 + r);
    }
    cp_async_commit();
  };

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;

  for (int st = 0; st < kStages - 1; ++st) issue(st);
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait_stage();
    __syncthreads();   // stage st has landed for every thread, and every
                       // thread is done with stage st - 1's buffer
    issue(st + kStages - 1);   // into that buffer
    const int nr = min(R, rows - st * R);
    if (active && g < nr) {
      const float* xs = base + (st % kStages) * R * dp;
      const float* ws = wbase + (st % kStages) * R;
      const float* a = xs + ti * kTile;
      const float* b = xs + tj * kTile;
#pragma unroll 1
      for (int r = g; r < nr; r += groups) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + r * dp);
        const float4 a1 = *reinterpret_cast<const float4*>(a + r * dp + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(b + r * dp);
        const float4 b1 = *reinterpret_cast<const float4*>(b + r * dp + 4);
        const float wr = ws[r];
        const float xa[kTile] = {a0.x * wr, a0.y * wr, a0.z * wr, a0.w * wr,
                                 a1.x * wr, a1.y * wr, a1.z * wr, a1.w * wr};
        const float xb[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(xa[i], xb[j], acc[i][j]);
      }
    }
  }

  // add the groups' tiles in group order, through the (now idle) buffers:
  // slot[e * tiles_per_cta + tile] for entry e = 8 i + j of a tile
  float* slot = base;
  const int lt = threadIdx.x - g * tiles_per_cta;
  for (int q = 1; q < groups; ++q) {
    __syncthreads();   // the slots (and, at q = 1, the buffers) are free
    if (active && g == q)
#pragma unroll
      for (int e = 0; e < kTile * kTile; ++e)
        slot[e * tiles_per_cta + lt] = acc[e / kTile][e % kTile];
    __syncthreads();
    if (active && g == 0)
#pragma unroll
      for (int e = 0; e < kTile * kTile; ++e)
        acc[e / kTile][e % kTile] += slot[e * tiles_per_cta + lt];
  }
  if (!active || g != 0) return;
  float* dst = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * d * d;
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

// One entry o = (b, i, j) of G per threadIdx.x: kSlices threads (threadIdx.y)
// each sum the partials p = y, y + kSlices, ... in ascending p, then the
// slices are added in order y = 0..kSlices-1.  (i, j) and (j, i) both read
// the upper partial entry (min, max), so G is exactly symmetric.
__global__ void wgram_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int P, int d,
                                    long long total) {
  __shared__ float red[kSlices][32];
  const long long o = blockIdx.x * 32LL + threadIdx.x;
  const long long dd = (long long)d * d;
  float s = 0.f;
  if (o < total) {
    const long long bidx = o / dd, e = o - bidx * dd;
    const int i = (int)(e / d), j = (int)(e - (long long)i * d);
    const float* src = part + bidx * P * dd + (long long)min(i, j) * d + max(i, j);
#pragma unroll 4
    for (int q = threadIdx.y; q < P; q += kSlices) s += src[q * dd];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || o >= total) return;
  float t = red[0][threadIdx.x];
#pragma unroll
  for (int q = 1; q < kSlices; ++q) t += red[q][threadIdx.x];
  out[o] = t;
}

}  // namespace

// X: B (or 1, with x_bstride 0) blocks of (n, d) fp32, row-major; w: B (or 1,
// with w_bstride 0) vectors of n; part: (B, P, d, d) scratch with P =
// ceil(n / rows_per_cta) (only its upper tiles are written and read); out:
// (B, d, d).
REPRO_API int repro_weighted_gram(const float* X, const float* w, float* part,
                                  float* out, int B, long long n, int d,
                                  long long rows_per_cta, long long x_bstride,
                                  long long w_bstride, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || d < 1 || rows_per_cta < 1 ||
      rows_per_cta > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long P = (n + rows_per_cta - 1) / rows_per_cta;
  if (P > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int dp = (d + kTile - 1) / kTile * kTile;
  const int nt = dp / kTile;
  const int ntri = nt * (nt + 1) / 2;
  const int tiles = ntri < kMaxThreads ? ntri : kMaxThreads;
  int groups = kMaxThreads / tiles;
  if (groups > kMaxRows) groups = kMaxRows;
  const int threads = (groups * tiles + 31) / 32 * 32;
  const int Z = (ntri + tiles - 1) / tiles;
  if (Z > 65535) return (int)cudaErrorInvalidValue;
  // rows per stage: kMaxRows, fewer where the stages would not fit (a
  // function of d alone, so the order of the sums is too)
  long long R = (long long)(kMaxSmem / sizeof(float)) / (kStages * (dp + 1));
  if (R > kMaxRows) R = kMaxRows;
  if (R < 1) return (int)cudaErrorInvalidValue;
  long long floats = stage_floats(dp, (int)R);
  if (groups > 1 && (long long)tiles * kTile * kTile > floats)
    floats = (long long)tiles * kTile * kTile;   // the group-sum slots
  const size_t bytes = (size_t)floats * sizeof(float);
  cudaError_t e = repro_set_smem(wgram_partial_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wgram_partial_kernel<<<dim3((unsigned)P, (unsigned)B, (unsigned)Z), threads,
                         bytes, st>>>(X, w, part, n, d, dp, (int)R, tiles,
                                      groups, rows_per_cta, x_bstride,
                                      w_bstride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)B * d * d;
  wgram_reduce_kernel<<<(unsigned)((total + 31) / 32), dim3(32, kSlices), 0, st>>>(
      part, out, (int)P, d, total);
  return (int)cudaGetLastError();
}
