// The current card's SM count, shared memory an SM and the most dynamic
// shared memory a block may opt in to, read once a card: the launch plans
// of attention.cu (K1's and K6's splits) and head_sample.cu (K3 / K4's
// vocabulary slices) run on every call, and the CUDA runtime's queries
// cost host time next to kernels of some 0.01-5 ms.
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

// CTAs of `kern` an SM at this block size and dynamic shared memory,
// queried once per (kernel, block size, shared memory): the occupancy
// query costs more host time than the launch plans can spare on every
// call. The plans run on one card model at a time.
template <typename Kern>
inline cudaError_t blocks_per_sm(Kern kern, int threads, size_t smem, int& n) {
  constexpr int N = 64;
  static const void* keys[N];
  static int thr[N], val[N], used = 0;
  static size_t bytes[N];
  const void* key = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key && thr[i] == threads && bytes[i] == smem) {
      n = val[i];
      return cudaSuccess;
    }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem);
  if (e == cudaSuccess && used < N) {
    keys[used] = key;
    thr[used] = threads;
    bytes[used] = smem;
    val[used++] = n;
  }
  return e;
}

// Lets `kern` take up to the card's opt-in maximum of dynamic shared
// memory, once per (kernel, card): the attribute only permits, the launch
// takes what it asks for, and the call costs host time on every launch of
// a kernel that runs 1128 times a 128f batch (K1).
template <typename Kern>
inline cudaError_t opt_in_smem(Kern kern) {
  constexpr int N = 64;
  static const void* keys[N];
  static int devs[N], used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key && devs[i] == dev) return cudaSuccess;
  int sms = 0, smem_sm = 0, optin = 0;
  e = card_shape(sms, smem_sm, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess && used < N) {
    keys[used] = key;
    devs[used++] = dev;
  }
  return e;
}
