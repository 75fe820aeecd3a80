// Shared declarations for the port's CUDA kernels: a plain C interface,
// loaded with ctypes (see repro_torch/kernels/_build.py).  Every launcher
// returns the cudaError_t of its launch as an int (0 = success); it never
// synchronises and allocates nothing: the Python wrapper owns every buffer.
#pragma once

#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// Opt a kernel into `bytes` of dynamic shared memory, checked against what
// the current device allows a block (227 KB on Hopper).
template <typename Kernel>
inline cudaError_t repro_set_smem(Kernel kernel, size_t bytes) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// CTAs per batch entry of a persistent grid (ctas, B): as many CTAs of
// `kernel`, at `threads` threads and `smem` bytes of dynamic shared memory,
// as the device's SMs hold at once (the occupancy calculator's count; set
// the kernel's shared-memory attributes first), shared among the B entries,
// at least one per entry and never more than an entry's `tiles`.  Each CTA
// walks its entry's tiles with a stride of the result.
template <typename Kernel>
inline cudaError_t repro_persistent_ctas(Kernel kernel, int threads,
                                         size_t smem, long long tiles, int B,
                                         unsigned* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  long long c = (long long)sms * (per_sm > 1 ? per_sm : 1) / B;
  if (c > tiles) c = tiles;
  *ctas = (unsigned)(c > 1 ? c : 1);
  return cudaSuccess;
}

// Asynchronous copies from global to shared memory, in completion groups
// (the kernels' tile rings): 4 or 8 bytes through L1, or 16 bytes (both
// addresses 16-byte aligned) around it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Copy `total` contiguous floats src[0, total) to dst, where dst and src
// agree modulo 16 bytes: 16-byte copies between 4-byte ones at the two
// unaligned ends; thread `tid` of `nthreads` takes every nthreads-th copy.
__device__ __forceinline__ void cp_async_run(float* dst, const float* src,
                                             int total, int tid,
                                             int nthreads) {
  const int head =
      min((int)((16 - (reinterpret_cast<unsigned long long>(src) & 15)) & 15) / 4,
          total);
  const int nvec = (total - head) / 4;
  for (int i = tid; i < head; i += nthreads) cp_async4(dst + i, src + i);
  for (int i = tid; i < nvec; i += nthreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * nvec + tid; i < total; i += nthreads)
    cp_async4(dst + i, src + i);
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
