// Philox4x32-10, shared by head_sample.cu (K3, K4, K5: Exp(1) noise at
// (token row, vocabulary column)) and attention.cu (K8: dropout keep bits
// at (query row, key)). Key (seed, 0) for both; each call gives four words
// and each stream uses all four, so one call serves four elements:
//   noise: counter (col >> 2, row, NOISE_TAG, 0): word m decides element
//          (row, col) of vocabulary column col = 4 (col >> 2) + m of
//          whole-head row row (philox_noise4 for a group's four columns,
//          philox_noise_bits for one element's word);
//   keep:  counter (key, prow >> 2, KEEP_TAG, 0): word m decides element
//          (prow, key) of whole-model query row prow = 4 (prow >> 2) + m, so
//          one call serves the four consecutive query rows of a group.
// The tag in the third counter word keeps the two streams apart.
// mebt_tpu_torch/ops/philox.py computes the same words in plain PyTorch
// (philox_bits, philox4, philox_keep_at).
#pragma once

#include <stdint.h>

constexpr uint32_t KEEP_TAG = 1u;   // the keep stream's third counter word
constexpr uint32_t NOISE_TAG = 2u;  // the noise stream's third counter word

__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                         uint32_t k0, uint32_t k1) {
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
  return make_uint4(c0, c1, c2, c3);
}

// word m (0 .. 3) of a call, by selects on registers
__device__ __forceinline__ uint32_t philox_word(const uint4& w, uint32_t m) {
  const uint32_t a = m & 1u ? w.y : w.x, b = m & 1u ? w.w : w.z;
  return m & 2u ? b : a;
}

// The noise stream's four words for vocabulary columns 4 grp .. 4 grp + 3
// of whole-head row `row`
__device__ __forceinline__ uint4 philox_noise4(uint32_t seed, uint32_t row, uint32_t grp) {
  return philox4(grp, row, NOISE_TAG, 0u, seed, 0u);
}

// The noise stream's word of one element (row, col): a call of its own
__device__ __forceinline__ uint32_t philox_noise_bits(uint32_t seed, uint32_t row, uint32_t col) {
  return philox_word(philox_noise4(seed, row, col >> 2), col & 3u);
}

// The keep stream's four words for the group of whole-model rows 4 grp ..
// 4 grp + 3 at one key
__device__ __forceinline__ uint4 philox_keep4(uint32_t seed, uint32_t grp, uint32_t key) {
  return philox4(key, grp, KEEP_TAG, 0u, seed, 0u);
}
