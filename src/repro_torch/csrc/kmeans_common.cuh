// Distance, argmin and shared-memory staging that the two k-means kernels
// (kmeans_assign.cu, kmeans_assign_update.cu) share.
//
// The bits, which the kernels' comments call assign_row's arithmetic.  The
// distance of a row x to center l is
//   dl = (x2 + cn[l]) - 2 t_l,
// where x2 = ||x||^2, cn[l] = ||c_l||^2 and t_l = x.c_l are each one fmaf
// chain over j = 0..d-1; the assignment is the first index of the smallest
// UNCLAMPED dl (the Pallas kernels' order; a strict < keeps the first index
// on ties, as jnp.argmin does), and d2 is that minimum clamped at 0.  The
// fast kernels' scans (kmeans_assign_update.cu's scan_blocks,
// kmeans_assign.cu's scan_run, over runs of 8-center blocks combined in
// order), the tiled product past their layouts (kmeans_tiled.cuh) and
// assign_row_global (the global variants, the oracles, with C in global
// memory) compute these bits.
//
// A fast kernel's CTA keeps, from the start of its dynamic shared memory:
//   CT  [d][kp]    the centers transposed, CT[j][l] = C[l][j], zero for
//                  l >= k (kp = k rounded up to a multiple of 8, so the
//                  distance loop takes eight centers per two 128-bit loads)
//   cn  [kp]       ||c_l||^2, summed in column order j = 0..d-1
// and puts its own arrays and its row tiles after these.  The Python
// wrappers (kernels/kmeans_assign*.py) compute the same byte counts to plan
// the tile height (and K2's ring depth); where even the shortest tile does
// not fit (K2: k d past about 27,000 floats at d = 64, or d past about
// 1,400 whatever k; K4: k past 856 at d = 64, the earlier one-tile
// layout's line), both take a tiled fp32 product that stages X and C in
// chunks (kmeans_tiled.cuh): K2's general route and K4's tiled route.  The
// global variants (assign_row_global below), which keep nothing of C in
// shared memory, are only the bit oracles of the card's checks.
#pragma once

#include "common.cuh"

namespace kmeans {

constexpr int kThreads = 128;   // threads per CTA of the global variants
constexpr int kL = 8;           // centers per register block

__host__ __device__ inline int padded_k(int k) { return (k + kL - 1) / kL * kL; }
__host__ __device__ inline int row_stride(int d) { return d | 1; }

// Stage C (k, d) transposed and zero-padded into CT, then ||c||^2 into cn.
// Every thread of the CTA calls it; it ends with a barrier.
__device__ inline void load_centers(const float* __restrict__ C, float* CT,
                                    float* cn, int d, int k) {
  const int kp = padded_k(k);
  for (int i = threadIdx.x; i < k * d; i += blockDim.x) {
    const int l = i / d, j = i - l * d;
    CT[j * kp + l] = C[i];
  }
  for (int i = threadIdx.x; i < d * (kp - k); i += blockDim.x) {
    const int j = i / (kp - k), l = k + (i - j * (kp - k));
    CT[j * kp + l] = 0.f;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kp; l += blockDim.x) {
    float s = 0.f;
    if (l < k)
      for (int j = 0; j < d; ++j) s = fmaf(CT[j * kp + l], CT[j * kp + l], s);
    cn[l] = s;
  }
  __syncthreads();
}

// The assignment of one row for the global variants (the oracles), which
// keep nothing in shared memory: the row xr and C (k, d), row-major, are read from
// global memory (through L1 and L2), and ||c_l||^2 is summed beside x.c_l in
// the same pass.  Every sum is the fmaf chain over j = 0..d-1 above, the
// centers are taken in ascending order, 8 at a time, with the min and
// argmin rule above.
__device__ inline void assign_row_global(const float* __restrict__ xr,
                                         const float* __restrict__ C, int d,
                                         int k, int* arg_out, float* d2_out) {
  float x2 = 0.f;
  for (int j = 0; j < d; ++j) x2 = fmaf(xr[j], xr[j], x2);
  float best = 0.f;
  int arg = 0;
  for (int l0 = 0; l0 < k; l0 += kL) {
    float t[kL], c2[kL];
#pragma unroll
    for (int i = 0; i < kL; ++i) t[i] = c2[i] = 0.f;
    for (int j = 0; j < d; ++j) {
      const float xj = xr[j];
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        if (l0 + i < k) {
          const float c = __ldg(C + (long long)(l0 + i) * d + j);
          t[i] = fmaf(xj, c, t[i]);
          c2[i] = fmaf(c, c, c2[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int l = l0 + i;
      if (l < k) {
        const float dl = (x2 + c2[i]) - 2.0f * t[i];
        if (l == 0 || dl < best) {
          best = dl;
          arg = l;
        }
      }
    }
  }
  *arg_out = arg;
  *d2_out = fmaxf(best, 0.f);
}

}  // namespace kmeans
