// The current card's SM count, shared memory an SM and the most dynamic
// shared memory a block may opt in to, read once a card: the launch plans
// of attention.cu (K1's splits) and head_sample.cu (K3 / K4's vocabulary
// slices) run on every call, and the CUDA runtime's queries cost host
// time next to kernels of some 0.02-5 ms.
#pragma once

#include <cuda_runtime.h>

inline cudaError_t card_shape(int& sms, int& smem_per_sm, int& smem_optin) {
  constexpr int CARDS = 64;
  static int cached[CARDS][3];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < CARDS && cached[dev][0] > 0) {
    sms = cached[dev][0];
    smem_per_sm = cached[dev][1];
    smem_optin = cached[dev][2];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && dev < CARDS) {
    cached[dev][1] = smem_per_sm;
    cached[dev][2] = smem_optin;
    cached[dev][0] = sms;
  }
  return e;
}
