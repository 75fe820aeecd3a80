// The tiled fp32 assign that the k-means kernels share past their
// shared-memory layouts: K2's general route (kmeans_assign_update.cu's
// kau_assign_kernel, then its fold) and K4's tiled route (kmeans_assign.cu's
// kmeans_assign_tiled_kernel, then its combine).
//
// The distances as a tiled fp32 product X C^T over a grid of (row tiles,
// center groups, B), rows being independent.  A CTA of NT threads takes BM
// rows against one group of center tiles of BN = 8 TX centers (TX = 1, 2, 4
// or 8, the narrowest that covers k up to 64; the wrappers' plans choose).
// X's and C's tiles move through shared memory in chunks of KC columns, a
// ring of two, row-major at the stride KC + 4, copied 16, 8 or 4 bytes at a
// time as d and the bases allow; what lies past n, k or d is zero.  (Rings of
// three and four stages ran slower for K4 on an H100.)  Thread
// (ty, tx) keeps t for its TM rows ty + TY i and its 8 centers tx + TX l in
// registers, each t one fmaf chain over ascending j across the chunks; a zero
// past d adds fmaf(0, 0, t), which keeps t's value (it can only turn -0 into
// +0, and (x2 + cn) - 2 t is the same for both).  x2 (on the group's first
// center tile) and ||c||^2 (once a center tile) are the same chains, summed
// from the staged chunks by one thread a row and a center.  After each
// center tile every thread folds its distances into its rows' running minima
// in ascending center order with the scan's rule (center 0 always, then
// strictly smaller values only); at the end the TX threads of a row combine
// theirs by shuffles, keeping the smaller value and, on a tie, the smaller
// index (takes): the sequential scan's first index of the smallest value, a
// NaN winning only at center 0.  The group's unclamped (minimum, index) per
// row goes to the caller's emit.  Groups are combined in group order by the
// same rule (combine_groups), so every row's result is kmeans_common.cuh's
// assign_row bits.  No tensor cores and no TF32: both round x and c.
#pragma once

#include "kmeans_common.cuh"

namespace kmeans {

constexpr int kTiledThreads = 256;   // K2's CTA, and K4's where its grid fills

// Rows of a tile of NT threads: 256 / TX rows of threads, one row each at TX
// = 1, two at TX = 2, ... (K2's tile at 256 threads; K4 may halve both).
__host__ __device__ constexpr int tiled_rows(int tx, int nt) {
  return (tx == 1 ? 256 : 128) * nt / kTiledThreads;
}

// Floats of the layout: two stages of the row tile and the center tile at
// the stride kc + 4, then x2 and ||c||^2.
__host__ __device__ constexpr long long tiled_floats(int bm, int bn, int kc) {
  return 2LL * (bm + bn) * (kc + 4) + bm + bn;
}

// Whether the candidate (v, a) replaces the minimum so far (bv, ba) (ba = -1:
// none yet).  A NaN at center 0 is the scan's answer whatever follows; other
// NaNs never win; otherwise the smaller value, then the smaller index.
__device__ __forceinline__ bool takes(float bv, int ba, float v, int a) {
  if (a == 0 && isnan(v)) return true;
  if (ba == 0 && isnan(bv)) return false;
  return v < bv || (v == bv && (unsigned)a < (unsigned)ba);
}

// Row r of entry b from the G groups' (B, G, n) minima pv and indices pa,
// combined in group order with takes (pv, pa may alias the caller's outputs:
// each row is read before it is written).
__device__ __forceinline__ void combine_groups(const float* pv, const int* pa,
                                               long long b, int G, long long n,
                                               long long r, float* v_out,
                                               int* a_out) {
  float v = __int_as_float(0x7f800000);
  int a = -1;
  for (int q = 0; q < G; ++q) {
    const long long o = (b * G + q) * n + r;
    const float qv = pv[o];
    const int qa = pa[o];
    if (takes(v, a, qv, qa)) {
      v = qv;
      a = qa;
    }
  }
  *v_out = v;
  *a_out = a;
}

// Copy VW floats (4, 2 or 1) from global to shared memory, or store zeros.
template <int VW>
__device__ __forceinline__ void copy_vec(float* dst, const float* src) {
  if (VW == 4) cp_async16(dst, src);
  else if (VW == 2) cp_async8(dst, src);
  else cp_async4(dst, src);
}
template <int VW>
__device__ __forceinline__ void zero_vec(float* dst) {
  if (VW == 4) *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  else if (VW == 2) *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
  else *dst = 0.f;
}

// Stage KC columns from j0 of `rows` rows of a row-major (., d) source that
// starts at src into dst at the stride KC + 4, VW floats a copy, by NT
// threads; rows from `valid` on and columns from d on are zeros.  Each thread
// keeps one column group and walks the rows, so its source pointer only
// advances.
template <int NT, int VW, int KC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows,
                                           long long valid, int d, int j0,
                                           int tid) {
  constexpr int VPR = KC / VW, RPI = NT / VPR;
  static_assert(NT % VPR == 0, "a copy's rows split the threads evenly");
  const int jv = (tid % VPR) * VW, j = j0 + jv;
  const bool in_d = j < d;
  int row = tid / VPR;
  const float* p = src + (long long)row * d + j;
  for (; row < rows; row += RPI, p += (long long)RPI * d) {
    float* q = dst + row * (KC + 4) + jv;
    if (in_d && row < valid)
      copy_vec<VW>(q, p);
    else
      zero_vec<VW>(q);
  }
}

// One CTA's tile: rows [0, BM) of Xt (the first `valid` of them real)
// against the center tiles [ct0, ct1) of Cb (k centers, row-major (k, d)).
// Calls emit(i, v, a) once for each real row i of the tile with its unclamped
// (minimum, index) over those centers.  Every thread of the CTA calls it;
// the dynamic shared memory holds tiled_floats(BM, 8 TX, KC) floats.
template <int NT, int TX, int KC, int BM, typename Emit>
__device__ __forceinline__ void tiled_assign(const float* __restrict__ Xt,
                                             const float* __restrict__ Cb,
                                             long long valid, int d, int k,
                                             int ct0, int ct1, int vec,
                                             Emit emit) {
  constexpr int BN = 8 * TX;
  constexpr int TY = NT / TX, TM = BM / TY, LD = KC + 4;
  static_assert(TM >= 1 && TM * TY == BM && BM <= NT && BN <= NT,
                "each thread keeps whole rows; one thread a row's x2 and a center's cn");
  constexpr int STAGE = (BM + BN) * LD;
  extern __shared__ float4 tiled_smem[];
  float* sm = reinterpret_cast<float*>(tiled_smem);
  float* x2s = sm + 2 * STAGE;   // [BM]
  float* cns = x2s + BM;         // [BN], +inf past k
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int nch = (d + KC - 1) / KC;
  const int nsteps = (ct1 - ct0) * nch;

  // step s: center tile ct0 + s / nch, columns from KC (s % nch)
  auto issue = [&](int s) {
    float* xs = sm + (s & 1) * STAGE;
    const int c0 = (ct0 + s / nch) * BN, j0 = (s % nch) * KC;
    const float* Ct = Cb + (long long)c0 * d;
    if (vec == 4) {
      stage_rows<NT, 4, KC>(xs, Xt, BM, valid, d, j0, tid);
      stage_rows<NT, 4, KC>(xs + BM * LD, Ct, BN, k - c0, d, j0, tid);
    } else if (vec == 2) {
      stage_rows<NT, 2, KC>(xs, Xt, BM, valid, d, j0, tid);
      stage_rows<NT, 2, KC>(xs + BM * LD, Ct, BN, k - c0, d, j0, tid);
    } else {
      stage_rows<NT, 1, KC>(xs, Xt, BM, valid, d, j0, tid);
      stage_rows<NT, 1, KC>(xs + BM * LD, Ct, BN, k - c0, d, j0, tid);
    }
    cp_async_commit();
  };

  float t[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int l = 0; l < 8; ++l) t[i][l] = 0.f;
  // the thread's running minimum of each of its rows over its centers so
  // far, in ascending center order (-1: none yet)
  float bv[TM];
  int ba[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bv[i] = __int_as_float(0x7f800000);
    ba[i] = -1;
  }
  float x2 = 0.f, cn = 0.f;   // thread tid's row and center chains

  issue(0);
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<0>();
    __syncthreads();   // step s has landed; every thread is done with s - 1
    if (s + 1 < nsteps) issue(s + 1);
    const float* xs = sm + (s & 1) * STAGE;
    const float* cs = xs + BM * LD;
    const bool first_tile = s < nch;
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      float4 xv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (ty + TY * i) * LD + 4 * q);
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + (tx + TX * l) * LD + 4 * q);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          t[i][l] = fmaf(xv[i].x, cv.x, t[i][l]);
          t[i][l] = fmaf(xv[i].y, cv.y, t[i][l]);
          t[i][l] = fmaf(xv[i].z, cv.z, t[i][l]);
          t[i][l] = fmaf(xv[i].w, cv.w, t[i][l]);
        }
      }
    }
    // the chains of ||c||^2 and (on the group's first tile) x2, outside the
    // product's loop so that it stays one block of straight-line code
    if (tid < BN) {
#pragma unroll
      for (int q = 0; q < KC / 4; ++q) {
        const float4 c = *reinterpret_cast<const float4*>(cs + tid * LD + 4 * q);
        cn = fmaf(c.x, c.x, cn);
        cn = fmaf(c.y, c.y, cn);
        cn = fmaf(c.z, c.z, cn);
        cn = fmaf(c.w, c.w, cn);
      }
    }
    if (first_tile && tid < BM) {
#pragma unroll
      for (int q = 0; q < KC / 4; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(xs + tid * LD + 4 * q);
        x2 = fmaf(x.x, x.x, x2);
        x2 = fmaf(x.y, x.y, x2);
        x2 = fmaf(x.z, x.z, x2);
        x2 = fmaf(x.w, x.w, x2);
      }
    }
    if (s % nch != nch - 1) continue;

    // the center tile is done: its distances into the thread's minima.  A
    // center past k has cn = +inf, so its distance is +inf (or NaN) and
    // never smaller; center 0 is taken whatever its value, as in the scan.
    const int c0 = (ct0 + s / nch) * BN;
    if (tid < BN) cns[tid] = c0 + tid < k ? cn : __int_as_float(0x7f800000);
    if (first_tile && tid < BM) x2s[tid] = x2;
    cn = 0.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float xr = x2s[ty + TY * i];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int c = c0 + tx + TX * l;
        // 2 t is exact, so contracting this into an fma changes no bit
        const float dl = (xr + cns[tx + TX * l]) - 2.0f * t[i][l];
        if (c == 0 || dl < bv[i]) {
          bv[i] = dl;
          ba[i] = c;
        }
        t[i][l] = 0.f;
      }
    }
  }
  // the TX threads of each row combine their minima; one emits the row's
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < TX; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, ba[i], off);
      if (takes(bv[i], ba[i], ov, oa)) {
        bv[i] = ov;
        ba[i] = oa;
      }
    }
    const int r = ty + TY * i;
    if (tx == 0 && r < valid) emit(r, bv[i], ba[i]);
  }
}

}  // namespace kmeans
