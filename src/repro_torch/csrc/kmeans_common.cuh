// Distance, argmin and shared-memory staging that the two k-means kernels
// (kmeans_assign.cu, kmeans_assign_update.cu) share.
//
// Shared-memory layout of a CTA, in floats, from the start of the dynamic
// buffer:
//   CT  [d][kp]    the centers transposed, CT[j][l] = C[l][j], zero for
//                  l >= k (kp = k rounded up to a multiple of 8, so the
//                  distance loop takes eight centers per two 128-bit loads)
//   cn  [kp]       ||c_l||^2, summed in column order j = 0..d-1
//   xs  [rows][ld] a tile of rows of X, ld = d rounded up to an odd number,
//                  so that thread r reading row r hits distinct banks
// The kernels put their own arrays after these.  The Python wrappers
// (kernels/kmeans_assign*.py) compute the same byte counts to decide the
// tile height; where even the shortest tile does not fit (k d past about
// 27,000 floats at d = 64, or d past about 1,400 whatever k), they ask for the
// kernel's global variant, which keeps nothing of C in shared memory.
#pragma once

#include "common.cuh"

namespace kmeans {

constexpr int kThreads = 128;   // threads per CTA; at most one row each
constexpr int kL = 8;           // centers per register block

__host__ __device__ inline int padded_k(int k) { return (k + kL - 1) / kL * kL; }
__host__ __device__ inline int row_stride(int d) { return d | 1; }

// Floats of the common part of the layout (CT, cn, xs) for a tile of
// `rows` rows.
__host__ __device__ inline long long common_floats(int d, int k, int rows) {
  const int kp = padded_k(k);
  return (long long)d * kp + kp + (long long)rows * row_stride(d);
}

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

// Copy rows [0, nr) of a row-major (., d) block into xs at row stride ld,
// with consecutive threads on consecutive addresses.  No barrier.
__device__ inline void load_tile(const float* __restrict__ src, float* xs,
                                 int nr, int d) {
  const int ld = row_stride(d);
  for (int i = threadIdx.x; i < nr * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    xs[r * ld + c] = src[i];
  }
}

// The assignment of one row xr (d floats in shared memory): the first index
// of the smallest d2_l = (||x||^2 + ||c_l||^2) - 2 x.c_l, the TPU kernel's
// order, and that minimum clamped at 0.  The argmin is taken over the
// UNCLAMPED distances, as the Pallas kernels do; a strict < keeps the first
// index on ties, as jnp.argmin does.  All sums are fp32 fmaf chains over
// j = 0..d-1.
__device__ inline void assign_row(const float* xr, const float* CT,
                                  const float* cn, int d, int k, int* arg_out,
                                  float* d2_out) {
  const int kp = padded_k(k);
  float x2 = 0.f;
  for (int j = 0; j < d; ++j) x2 = fmaf(xr[j], xr[j], x2);
  float best = 0.f;
  int arg = 0;
  for (int l0 = 0; l0 < kp; l0 += kL) {
    float t[kL];
#pragma unroll
    for (int i = 0; i < kL; ++i) t[i] = 0.f;
    for (int j = 0; j < d; ++j) {
      const float xj = xr[j];
      const float4 c0 = *reinterpret_cast<const float4*>(CT + j * kp + l0);
      const float4 c1 = *reinterpret_cast<const float4*>(CT + j * kp + l0 + 4);
      t[0] = fmaf(xj, c0.x, t[0]);
      t[1] = fmaf(xj, c0.y, t[1]);
      t[2] = fmaf(xj, c0.z, t[2]);
      t[3] = fmaf(xj, c0.w, t[3]);
      t[4] = fmaf(xj, c1.x, t[4]);
      t[5] = fmaf(xj, c1.y, t[5]);
      t[6] = fmaf(xj, c1.z, t[6]);
      t[7] = fmaf(xj, c1.w, t[7]);
    }
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int l = l0 + i;
      if (l < k) {
        // 2 t is exact, so contracting this into an fma changes no bit
        const float dl = (x2 + cn[l]) - 2.0f * t[i];
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

// assign_row for the global variants, whose layout does not fit in shared
// memory: the row xr and C (k, d), row-major, are read from global memory
// (through L1 and L2), and ||c_l||^2 is summed beside x.c_l in the same pass.
// Every sum is assign_row's fmaf chain over j = 0..d-1, the centers are taken
// in ascending order, 8 at a time, and the min and argmin rule is the same,
// so the result is assign_row's bit for bit.
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
