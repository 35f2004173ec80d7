// Philox4x32-10, shared by head_sample.cu (K3, K4: Exp(1) noise at
// (token row, vocabulary column)) and attention.cu (dropout keep bits at
// (query row, key)). Key (seed, 0), counter (col, row, 0, 0), first
// output word; mebt_tpu_torch/ops/philox.py:philox_bits computes the same
// word in plain PyTorch.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t row,
                                                uint32_t col) {
  uint32_t c0 = col, c1 = row, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}
