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
