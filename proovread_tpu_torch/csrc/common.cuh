// Shared definitions of the port's CUDA kernels (plain C interface, loaded
// with ctypes by proovread_tpu_torch/kernels.py). Every entry point launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

// Opt a kernel into ``bytes`` of dynamic shared memory when that and its
// static shared memory pass the default 48 KB a block (the H100 allows up
// to 227 KB a block).
template <typename K>
static inline cudaError_t pt_reserve_smem(K kernel, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  if (bytes + a.sharedSizeBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
