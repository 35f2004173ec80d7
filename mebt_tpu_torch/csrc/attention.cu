// K1, K2, K6, K7, K8: forward and backward of the two attention regimes
// of the routed MeBT blocks, with and without dropout on the
// probabilities, for sm_90a. Built by mebt_tpu_torch/ops/_build.py into a
// shared library with a plain C interface (bound with ctypes).
//
// K1 (mebt_smallq_attention) replaces the TPU kernel
//   mebt_tpu/ops/attention_pallas.py:_smallq_attention (_smallq_kernel):
//   few queries (256 latents) over many MASKED keys (latent_enc: the
//   context bucket; lt2l: [latents; target bucket]). Flash forward that
//   emits lse (B, H, NQ) fp32 for the backward; a fully masked row writes
//   0 and lse = +1e30 (the first MaskGIT step has no context at all).
//   Bound on the card: bytes (Q/out plus K/V of the LIVE keys only; 4
//   NQ Dh operations a live key are far below the tensor cores' rate).
//   bf16, smallq_fwd_wgmma_kernel (+ smallq_merge_kernel), on Hopper's
//   own instructions (csrc/hopper.cuh): a CTA a (b, h) of four consumer
//   warpgroups (its 256 queries, a 64-query tile each; two with dropout)
//   and a producer warp. The CTA lists its batch row's live keys (a scan
//   of the mask row in 16-byte chunks while TMA loads the Q tiles), and the
//   producer warp gathers their K/V rows 64 at a time with 16-byte
//   cp.async into 128-byte-swizzled tiles, the layout TMA writes and wgmma
//   reads, completing on the stages' mbarriers; every warpgroup reads each
//   stage. Dead keys cost nothing (training masks are random over
//   positions, so whole dead tiles are rare). Per stage S = Q K^T is one
//   wgmma m64n64k16 chain, the softmax is K2's (a reference m that moves
//   only past a margin of 8, two-part P from the accumulator registers),
//   and P V is wgmma with V MN-major. Too few (b, h) CTAs to fill the card
//   (128f, batch 2) split the live list over up to 8 CTAs (split-K); each
//   leaves fp32 (o, m, l) and a merge adds them in split order, so two
//   calls give the same bits. lse is summed in double. The plan and the
//   shared-memory opt-in are made once per shape and card: K1 runs 1128
//   times a 128f batch on a card that waits for the host.
//   fp32, smallq_kernel: one CTA per (b, h, 64 queries), FMA loops over
//   64-key tiles, dead tiles skipped (the parity checks only).
//
// K2 (mebt_largeq_attention) replaces
//   mebt_tpu/ops/attention_pallas.py:_largeq_attention (_largeq_kernel):
//   many queries over <= 512 UNMASKED keys (latent_self: 256 x 256;
//   latent_dec: M tokens x 256 latents). K and V of one (b, h) stay
//   resident in shared memory in the input type.
//   bf16, largeq_fwd_wgmma_kernel, on Hopper's own instructions
//   (csrc/hopper.cuh): 16f latent_dec moves 84 MB (q, k, v, out; 0.025 ms
//   of HBM) and takes 17.2 GFLOP, 25.8 with the two-part P below (0.026
//   ms of bf16 tensor-core time). A persistent grid of one CTA an SM walks
//   (b, h, 64-query tile) items in (b, h)-major order, a balanced range a
//   CTA. A producer warpgroup's first lane loads by TMA, behind mbarriers,
//   K and V of each (b, h) the range enters (all keys, 128-byte swizzled,
//   into a ring of two stages at 256 keys, so the next (b, h)'s keys load
//   while this one's run) and each item's 64-row Q tile (TMA zero-fills
//   rows past NQ and keys past NK). Three consumer warpgroups take every
//   third item. Per 64-key block, S = Q K^T is wgmma m64n64k16 (both
//   K-major in shared memory) and P V is wgmma m64n64k16 with P from
//   registers (S's accumulator registers are mma.m16n8k16's A fragments)
//   and V MN-major (the transpose bit), phased so that a block's softmax
//   runs while the block before's P V does. The softmax keeps a reference
//   m in the log2 domain that moves only where a block's maximum passes it
//   by more than 8, so O is rescaled only there, and takes 2^(s c - m) by
//   one fmaf and the SFU's ex2. The probabilities go to P V as two bf16
//   operands, hi = bf16(e) and lo = bf16(e - hi), summed in one fp32
//   accumulator: e to about 2^-18, where one bf16 rounding of e (the TPU
//   kernel's choice) would miss the plain version's fp32 result by some
//   2^-9 and break the two-ulp gate by 36x. The output is normalized and
//   rounded once. 128-key blocks (S and P twice as wide) left ptxas short
//   of registers at 384 threads: it spilled and ran the products one
//   after another, setmaxnreg or not.
//   Measured (chip_smoke.py's k2 phase, NVIDIA H100 80GB HBM3, 700 W):
//   0.072 ms on the device at 16f latent_dec, SDPA 0.054; 0.068 at 128f,
//   SDPA 0.054; by events, which hold the wrappers' host work, 0.073-0.094
//   against 0.059 and 0.071 against 0.073-0.084. It loses at 16f: without
//   any product (scripts/k2_variants.py, no_mma) the kernel still takes
//   0.04 ms, its softmax and P's split (some 10 instructions a score on
//   12 warps an SM) and its loads and stores, and the products overlap
//   that only in part.
//   fp32, largeq_kernel: each CTA takes 32 queries and does one softmax
//   pass as fp32 FMA loops from shared memory (the parity checks only).
//
// K6 (mebt_smallq_backward) replaces
//   mebt_tpu/ops/attention_pallas.py:_smallq_backward (_smallq_bwd_kernel):
//   dq, dk, dv of K1 from the saved lse and D = rowsum(g * out). The TPU
//   kernel owns a key block per grid step and carries dq in scratch
//   across a SEQUENTIAL key axis; blocks run in no order here, so the
//   work is split into two passes that each write their outputs once and
//   need no atomics (bit-repeatable). Bound: 10 * NQ * live keys * Dh
//   operations per (b, h) against the bytes of q, g, dq and the live
//   K/V/dk/dv rows: bytes at NQ = 256.
//   bf16, on Hopper's own instructions: smallq_bwd_live_kernel lists each
//   batch row's live keys once into scratch; smallq_bwd_dq_wgmma_kernel is
//   K7's second dq sweep over K1's gathered stages, a CTA a (64-query
//   tile, key split, b, h) of one consumer warpgroup and a producer warp:
//   Q and g by TMA, D from g and out, p = 2^(s c - L) with L = lse log2(e)
//   as an fp32 pair from a double product, S and dP by wgmma, ds in three
//   bf16 parts from registers, each stage's ds K summed apart and added
//   to dq in fp32; where the CTAs fill less than a few waves the live keys
//   split over CTAs and smallq_bwd_dq_merge_kernel adds the fp32 partials
//   in split order. It draws each keep bit once and leaves (L, D, the
//   keep bits) to smallq_bwd_dkdv_wgmma_kernel, K7's key-major dk/dv tile
//   with the K and V rows of 64 live keys gathered and resident (p and ds
//   in three parts, each query tile's products added in fp32), which
//   scatters its rows back to their keys and zeroes the dead keys' rows.
//   fp32: smallq_bwd_dq_kernel (one CTA per (b, h, 64 queries) over the
//   key tiles) and attn_bwd_dkdv_kernel (one CTA per (b, h, 64 keys)
//   over the query tiles), FMA loops, 7 tile products; a key tile with no
//   live key is skipped, and a fully masked row (lse = +1e30) gives p = 0
//   (the parity checks only).
//
// K7 (mebt_largeq_backward) replaces
//   mebt_tpu/ops/attention_pallas.py:_largeq_backward (_largeq_bwd_kernel):
//   dq, dk, dv of K2; nothing is saved by the forward, and the passes
//   write their outputs once (no atomics, bit-repeatable). Pass 1
//   recomputes, per query row, the softmax and D = rowsum(g * O), writes
//   dq, and leaves lse and D in a scratch buffer; pass 2 sums dk and dv
//   over the query tiles of one (b, h) per key tile.
//   bf16: bound by operations (10 NQ NK Dh per (b, h), 0.11 ms at 128f
//   latent_dec, against 0.03 ms of bytes), on Hopper's own instructions
//   (csrc/hopper.cuh): every product is wgmma m64n64k16 on operands that
//   TMA loads behind mbarriers, 56 a 64 x 64 block over both passes (0.30
//   ms at peak at 128f latent_dec). largeq_bwd_dq_wgmma_kernel has K2's
//   persistent shape: 64-query tiles over the (b, h)'s resident K and V,
//   three consumer warpgroups (two with dropout) and a producer
//   warpgroup. Sweep 1 takes S = Q K^T and dP = g V^T a 64-key block and
//   keeps, beside the online softmax's (m, l), d = sum_k e_k keep_k dp_k
//   rescaled by the same 2^(m_old - m_new): D = d / l is rowsum(g * O)
//   without forming O. Sweep 2: p = exp2(s - lse), dp = g V^T, ds = p (dp
//   keep - D) scale, dq += ds K with ds from registers in two bf16 parts
//   and K MN-major (a sum over the NK keys only).
//   largeq_bwd_dkdv_wgmma_kernel has the key axis as M: a CTA of one
//   consumer warpgroup (64 keys, K and V resident) and a producer warp
//   whose first lane streams 64-query tiles of Q and g into a ring and
//   whose other lanes copy beside them the rows' (m, log2 l), D and keep
//   words; two CTAs an SM, so that one's softmax runs while the other's
//   products do (a wider tile would spill: K2's 128-key blocks did at 384
//   threads). S^T = K Q^T and dP^T = V g^T, then dv += (P^T keep) g and
//   dk += dS^T Q with P^T and dS^T from the accumulator registers
//   (FlashAttention-3's conversion) in three bf16 parts and g, Q
//   MN-major, each query tile's products summed apart in the accumulator
//   and added to the fp32 dk, dv sums (the tensor cores' own fp32 sums
//   drop the low bits of small products, which over 8192 queries showed).
//   Its (b, h, key tile) CTAs fill 1.2 waves at 128f (320 of 264 slots),
//   so the host splits the query walk over up to 16 CTAs when that ends
//   the launch sooner (k7_dkdv_plan); each split leaves fp32 dk, dv in
//   scratch and largeq_bwd_dkdv_merge_kernel adds them in split order, so
//   two calls give the same bits. p and ds enter the dk/dv products in
//   three bf16 parts (K7_PARTS below).
//   fp32: largeq_bwd_dq_kernel (32 queries a CTA, FMA loops) and
//   attn_bwd_dkdv_kernel without a mask (the parity checks only).
//
// K8, dropout on the probabilities (the p_drop branches of the four TPU
//   kernels, attention_pallas.py:_drop_keep): element (b, h, query, key)
//   of whole-model row prow = ((b0 + b) * H_total + h0 + h) * NQ + query
//   is kept iff word prow & 3 of the Philox4x32-10 call at counter (key,
//   prow >> 2, KEEP_TAG, 0), key (seed, 0), is >= thresh = min(int(p *
//   2^32), 2^32 - 1) (csrc/philox.cuh), and a kept probability is scaled
//   by 1 / (1 - p). The softmax denominator and lse use the undropped p.
//   The index is that of the unpadded problem, so the mask depends on no
//   tiling and every pass regenerates the same one; b0, h0 and H_total
//   place a rank's rows and heads in the whole model's problem (Dropout
//   below), 0, 0 and H on one rank. One call decides four consecutive
//   query rows at one key: in the wgmma kernels the four lanes that hold
//   them share its words (keep_bits_stage), so a lane makes 8 calls for a
//   64-key stage's 32 bits, not 32. Each kernel is templated on DROP:
//   thresh == 0 runs the instantiation without a single dropout
//   instruction.
//
// All take fp32 or bf16 inputs (is_bf16), accumulate in fp32, and
// write the output in the input type. Inputs must be contiguous
// (B, H, N, Dh) tensors at 16-byte boundaries with Dh = 64, the head width of every MeBT
// config (1024 / 16); the kernels are templated on Dh so another width
// is one more instantiation. Each entry point returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "card.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// K8: keep(row, key) is 1 / (1 - p) for a kept probability and 0 for a
// dropped one. `row` = (b * H + h) * NQ + query is the row of the local
// unpadded problem, which also indexes the kernels' scratch (K6's and
// K7's keep words); the Philox draw is keyed on the row of the whole
// model's problem, prow = ((b0 + b) * H_total + h0 + h) * NQ + query, where
// the caller holds batch rows from b0 and heads from h0 of H_total (data,
// pipeline and tensor parallelism): row + base + b * extra, with b = row /
// bh_rows. At b0 = h0 = 0 and H_total = H, base = extra = 0 and the row is
// the local one, bit for bit. Where NQ % 4 == 0 (`grouped`; every MeBT
// shape), base, extra and a (b, h)'s first row are multiples of 4, so
// local rows 4i .. 4i + 3 of a (b, h) are the four rows of one Philox
// group on every rank.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float keep_scale;
  uint32_t base;     // (b0 * H_total + h0) * NQ
  uint32_t extra;    // (H_total - H) * NQ
  uint32_t bh_rows;  // H * NQ
  uint32_t grouped;  // NQ % 4 == 0
  __device__ __forceinline__ uint32_t philox_row(uint32_t row) const {
    return extra ? row + base + (row / bh_rows) * extra : row + base;
  }
  __device__ __forceinline__ float keep(uint32_t row, uint32_t key) const {
    return keep_at(philox_row(row), key);
  }
  // keep() at a row already mapped by philox_row: word prow & 3 of its
  // group's call
  __device__ __forceinline__ float keep_at(uint32_t prow, uint32_t key) const {
    const uint4 w = philox_keep4(seed, prow >> 2, key);
    const uint32_t m = prow & 3u;
    const uint32_t x = m == 0u ? w.x : m == 1u ? w.y : m == 2u ? w.z : w.w;
    return x >= thresh ? keep_scale : 0.f;
  }
};

// The Dropout of an entry point's arguments (see the extern "C" block).
inline Dropout make_dropout(unsigned seed, unsigned thresh, float keep_scale, int H, int NQ,
                            unsigned b0, unsigned h0, unsigned heads) {
  return Dropout{seed, thresh, keep_scale, (b0 * heads + h0) * (uint32_t)NQ,
                 (heads - (uint32_t)H) * (uint32_t)NQ, (uint32_t)H * (uint32_t)NQ,
                 (uint32_t)(NQ % 4 == 0)};
}

// keep_bits_stage's key_at for a stage of consecutive keys k0, k0 + 1, ..
struct DenseKeys {
  uint32_t k0;
  __device__ __forceinline__ uint32_t operator()(int c) const { return k0 + (uint32_t)c; }
};

// keep_bits_stage's path where NQ % 4 != 0 (no MeBT shape): the lane's
// own 32 calls, word prow & 3 of each (rows prow0 at bits 4 j + e, prow1
// at 4 j + 2 + e). Out of line: inline, it made K2 with dropout spill 120
// / 196 bytes (stores / loads; 20 / 20 out of line) and run up to 3.3%
// slower (scripts/k8_variants.py, lane_inline; NVIDIA H100 80GB HBM3,
// 700 W).
template <typename KeyAt>
__device__ __noinline__ uint32_t keep_bits_own(const Dropout drop, uint32_t prow0, uint32_t prow1,
                                               int tq, KeyAt key_at) {
  uint32_t kb = 0u;
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    const int col = (i >> 2) * 8 + 2 * tq + (i & 1);
    kb |= (uint32_t)(drop.keep_at((i & 2) ? prow1 : prow0, key_at(col)) != 0.f) << i;
  }
  return kb;
}

// K8's keep bits of one 64-column stage in the wgmma accumulator layout,
// for the wgmma kernels (K1, K2 forward, K6's and K7's dq passes). Lane 4 g
// + tq holds rows g (h = 0) and g + 8 (h = 1) of its warp's 16 and the
// stage's columns 8 j + 2 tq + e; bit i = 4 j + 2 h + e of the result is
// its element i's. prow[h] are the lane's two Philox rows, key_at(c) the
// key at the stage's column c. Grouped, the four lanes of equal tq whose g
// share g >> 2 (lanes xor 4 and xor 8 apart) hold the four rows of two
// Philox groups (h = 0, 1): lane m = g & 3 of them makes the 8 calls of
// columns j = 2 m, 2 m + 1 (both rows, both e), bit c = 4 (j - 2 m) + 2 h
// + e of byte m' taking word m' of call c: byte m' is lane m''s bits
// 8 m .. 8 m + 7. A 4 x 4 byte transpose over the four lanes (two
// shuffles and two byte permutations) gives lane m' byte m of each lane m.
// Otherwise (NQ % 4 != 0) each lane makes its own 32 calls and takes word
// prow & 3 (keep_bits_own). Every lane of the warp calls it (the
// shuffles). UNROLL of the 8 grouped calls are unrolled (registers against
// latency, *_DRAW_UNROLL).
template <int UNROLL, typename KeyAt>
__device__ __forceinline__ uint32_t keep_bits_stage(const Dropout& drop, const uint32_t (&prow)[2],
                                                    int lane, KeyAt key_at) {
  const int tq = lane & 3;
  if (drop.grouped) {
    const int m = (lane >> 2) & 3;
    const uint32_t grp[2] = {prow[0] >> 2, prow[1] >> 2};
    uint32_t x = 0u;
#pragma unroll (UNROLL)
    for (int c = 0; c < 8; ++c) {
      const int col = (2 * m + (c >> 2)) * 8 + 2 * tq + (c & 1);
      const uint4 w = philox_keep4(drop.seed, grp[(c >> 1) & 1], key_at(col));
      x |= (uint32_t)(w.x >= drop.thresh) << c | (uint32_t)(w.y >= drop.thresh) << (8 + c) |
           (uint32_t)(w.z >= drop.thresh) << (16 + c) | (uint32_t)(w.w >= drop.thresh) << (24 + c);
    }
    // bit m1 of m: pair the halves bound for lanes m1 (bytes 2 m1, 2 m1 + 1)
    // of lanes m and m ^ 2, in source order; bit m0: then the bytes bound
    // for m itself, source lanes 0 .. 3
    const uint32_t y = __shfl_xor_sync(FULL, x, 8);
    const uint32_t z = __byte_perm(x, y, m & 2 ? 0x3276 : 0x5410);
    const uint32_t u = __shfl_xor_sync(FULL, z, 4);
    return __byte_perm(z, u, m & 1 ? 0x3715 : 0x6240);
  }
  return keep_bits_own(drop, prow[0], prow[1], tq, key_at);
}

// How many of the grouped draw's 8 calls a kernel unrolls
// (scripts/k8_variants.py, NVIDIA H100 80GB HBM3, 700 W): whole in K1, K2
// and K6's dq pass (2-6% faster than 4 at a time), 4 at a time in K7's dq
// pass (whole ran 8% slower at 128f)
constexpr int K1_DRAW_UNROLL = 8, K2_DRAW_UNROLL = 8, K6_DRAW_UNROLL = 8, K7_DRAW_UNROLL = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// K1: masked small-Q flash forward

constexpr int K1_BQ = 64;        // query rows per CTA
constexpr int K1_BK = 64;        // keys per tile
constexpr int K1_THREADS = 256;  // 4 threads per query row

template <int DH>
constexpr size_t k1_smem_bytes() {
  return sizeof(float) * (K1_BQ * (DH + 1) + K1_BK * (DH + 1) + K1_BK * DH +
                          K1_BQ * (K1_BK + 1)) +
         sizeof(int) * K1_BK;
}

// Thread t owns query row r = t / 4 of the tile and, inside it, the
// score columns c*4 + t%4 and the output dims j*4 + t%4 (interleaved so
// that the four threads of a row hit four different banks).
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(K1_THREADS)
smallq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              T* __restrict__ out, float* __restrict__ lse, int H, int NQ,
              int NK, float scale, Dropout drop) {
  constexpr int P = DH + 1;
  constexpr int DPT = DH / 4;
  constexpr int CPT = K1_BK / 4;
  constexpr int PP = K1_BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][P]
  float* Ks = Qs + K1_BQ * P;     // [BK][P]
  float* Vs = Ks + K1_BK * P;     // [BK][DH]
  float* Ps = Vs + K1_BK * DH;    // [BQ][PP]
  int* Ms = reinterpret_cast<int*>(Ps + K1_BQ * PP);  // [BK]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * K1_BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int part = tid & 3;

  const T* qg = q + (size_t)bh * NQ * DH;
  const T* kg = k + (size_t)bh * NK * DH;
  const T* vg = v + (size_t)bh * NK * DH;
  const uint8_t* mg = mask + (size_t)b * NK;

  for (int i = tid; i < K1_BQ * DH; i += K1_THREADS) {
    const int rr = i / DH, d = i % DH;
    Qs[rr * P + d] = (q0 + rr < NQ) ? to_f(qg[(size_t)(q0 + rr) * DH + d]) : 0.f;
  }

  float m_run = NEG_BIG, l_run = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  const uint32_t row_id = (uint32_t)bh * (uint32_t)NQ + (uint32_t)(q0 + r);

  for (int k0 = 0; k0 < NK; k0 += K1_BK) {
    __syncthreads();  // the previous tile's readers are done
    int any = 0;
    for (int i = tid; i < K1_BK; i += K1_THREADS) {
      const int live = (k0 + i < NK) && mg[k0 + i] != 0;
      Ms[i] = live;
      any |= live;
    }
    if (!__syncthreads_or(any)) continue;  // no live key in this tile
    for (int i = tid; i < K1_BK * DH; i += K1_THREADS) {
      const int kk = i / DH, d = i % DH;
      const bool in = k0 + kk < NK;
      const size_t off = (size_t)(k0 + kk) * DH + d;
      Ks[kk * P + d] = in ? to_f(kg[off]) : 0.f;
      Vs[kk * DH + d] = in ? to_f(vg[off]) : 0.f;
    }
    __syncthreads();

    float s[CPT];
    float m_cur = NEG_BIG;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int kk = c * 4 + part;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) dot = fmaf(Qs[r * P + d], Ks[kk * P + d], dot);
      s[c] = dot * scale;
      if (Ms[kk]) m_cur = fmaxf(m_cur, s[c]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(FULL, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(FULL, m_cur, 2));
    const float m_new = fmaxf(m_run, m_cur);
    const float alpha = expf(m_run - m_new);

    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int kk = c * 4 + part;
      const float p = Ms[kk] ? expf(s[c] - m_new) : 0.f;
      psum += p;  // the denominator takes the undropped p
      Ps[r * PP + kk] =
          (DROP && p != 0.f) ? p * drop.keep(row_id, (uint32_t)(k0 + kk)) : p;
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // row r of Ps is written and read by one warp

#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < K1_BK; ++kk) {
      const float p = Ps[r * PP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(p, Vs[kk * DH + j * 4 + part], acc[j]);
    }
  }

  if (q0 + r < NQ) {
    const bool empty = l_run == 0.f;
    const float inv = empty ? 0.f : 1.f / l_run;
    T* og = out + ((size_t)bh * NQ + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) og[j * 4 + part] = from_f<T>(acc[j] * inv);
    if (part == 0)
      lse[(size_t)bh * NQ + q0 + r] = empty ? -NEG_BIG : m_run + logf(l_run);
  }
}

// bf16 goes to the Hopper K1 (smallq_fwd_wgmma_kernel, defined below),
// which takes `part` (the split partials) as scratch.
template <bool DROP>
cudaError_t launch_smallq_wgmma(const void* q, const void* k, const void* v, const void* mask,
                                void* out, void* lse, void* part, int B, int H, int NQ, int NK,
                                float scale, Dropout drop, cudaStream_t stream);

template <typename T, int DH, bool DROP>
cudaError_t launch_smallq(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, void* part, int B, int H,
                          int NQ, int NK, float scale, Dropout drop,
                          cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(DH == 64, "the Hopper K1 takes Dh 64");
    return launch_smallq_wgmma<DROP>(q, k, v, mask, out, lse, part, B, H, NQ, NK, scale, drop,
                                     stream);
  } else {
    const size_t smem = k1_smem_bytes<DH>();
    auto kern = smallq_kernel<T, DH, DROP>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((NQ + K1_BQ - 1) / K1_BQ, B * H);
    kern<<<grid, K1_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
        static_cast<T*>(out), static_cast<float*>(lse), H, NQ, NK, scale, drop);
    return cudaGetLastError();
  }
}

// ---------------------------------------------------------------------------
// bf16 K1, K2, K6 and K7: shared constants and helpers. Every product is
// Hopper's wgmma (csrc/hopper.cuh); a left operand from registers is an
// accumulator, whose registers are mma.m16n8k16's A fragments pair by pair.

constexpr int TC_DH = 64;       // head width of every MeBT config
constexpr int K7_MAX_SPLITS = 16;  // K7 dk/dv: most CTAs sharing one key tile's query walk
// bf16 parts of a left operand. K2's P in two, to 2^-18 of it: P >= 0,
// so P V loses nothing to cancellation (K1's likewise). K7's p and ds in
// three, to 2^-27: dv = sum_q p g and dk = sum_q ds q cancel; with
// two parts and q eight times larger, some dk and dv elements missed
// the gate by up to 30% (an emulation over seeds, and the card); K6's
// dk/dv pass takes K7's.
// K7's dq pass adds ds K over only the NK <= 512 resident keys: ds in
// two parts kept every dq element within the gate in the emulation over
// seeds (tests/test_torch_attention_split.py) and on the card.
constexpr int K2_PARTS = 2;
constexpr int K7_PARTS = 3;
constexpr int K7_DQ_PARTS = 2;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as NP bf16 pairs (x0 in the low half): part i rounds what the
// parts before it left, so x is their sum to about 2^-(9 NP) of it.
template <int NP>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[i] = bits(h);
    x0 -= __low2float(h);  // exact: h is x's nearest bf16
    x1 -= __high2float(h);
  }
}

__device__ __forceinline__ float bf_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// ---------------------------------------------------------------------------
// K2 in bf16 on Hopper: largeq_fwd_wgmma_kernel (the source note above)

constexpr int K2W_QT = 64;                 // query rows a tile: one warpgroup's m64
constexpr int K2W_KB = 64;                 // keys a block: one m64n64 S accumulator
constexpr int K2W_MAX_NK = 8 * K2W_KB;     // K/V of 512 keys fill 128 KB
constexpr int K2W_CONSUMERS = 3;           // warpgroups of products and softmax
constexpr float K2W_RESCALE = 8.f;         // log2 headroom of the softmax's reference m
constexpr int K2W_QSTAGES = 2;             // Q ring depth a warpgroup
constexpr int K2W_THREADS = (K2W_CONSUMERS + 1) * 128;  // + a producer warpgroup (one lane works)
constexpr uint32_t K2W_TILE_BYTES = K2W_QT * TC_DH * 2;   // 8 KB
constexpr uint32_t K2W_BLOCK_BYTES = K2W_KB * TC_DH * 2;  // 8 KB of K or of V

// K/V stages for nkb key blocks: two at 256 keys (the next (b, h)'s K/V
// loads while this one's run), one at 512
__host__ __device__ constexpr int k2w_kv_stages(int nkb) { return nkb <= 4 ? 2 : 1; }

__host__ __device__ constexpr size_t k2w_smem_bytes(int nkb) {
  return 1024 + (size_t)k2w_kv_stages(nkb) * 2 * nkb * K2W_BLOCK_BYTES +
         (size_t)K2W_CONSUMERS * K2W_QSTAGES * K2W_TILE_BYTES + 256;
}

// 2^x by the SFU alone (ex2.approx.ftz): exp2f's range fix-ups for results
// below 2^-126 cost four more instructions an element, and such an e adds
// nothing a row's sum (at least 1) keeps
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The (b, h, 64-query tile) items of the problem in (b, h)-major order,
// t = bh * ceil(NQ / 64) + tile; CTA c walks items [t0, t1), a balanced
// share, and consumer warpgroup w takes items t0 + w, t0 + w + C, ...
// (C = K2W_CONSUMERS). The producer warpgroup's first lane streams what
// they need: K and V of each (b, h) the range enters (into a ring of
// k2w_kv_stages, so the next (b, h)'s keys load while this one's run),
// then each item's Q tile into its warpgroup's two-stage ring. Every
// consumer warpgroup holds every (b, h) of the range in turn, and
// releases it when it is past it, whether or not it had an item in it.
//
// NKB 64-key blocks (4 up to 256 keys, 8 up to 512); a block wholly past
// NK is never loaded, and its V rows are zeroed once (its P is 0, and
// 0 x V must stay 0). A tile runs in NKB + 1 phases: phase b rescales O by
// the block before's new maximum, issues S = Q K^T of block b and P V of
// block b - 1 (P from registers, in two bf16 parts), draws block b's keep
// bits (dropout) while they run, waits for S, runs the softmax on it while
// P V runs, waits for P V, and turns S into P. The warpgroups run their
// phases unsynchronised: the tensor cores take their products as they
// come.
template <bool DROP, int NKB>
__global__ void __launch_bounds__(K2W_THREADS, 1)
largeq_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, int NQ,
                        int NK, int n_items, float scale_log2, Dropout drop) {
  constexpr int KB_ELEMS = K2W_KB * TC_DH, TILE_ELEMS = K2W_QT * TC_DH;
  constexpr int KVS = k2w_kv_stages(NKB);
  const int nkb = (NK + K2W_KB - 1) / K2W_KB;  // blocks that hold a key
  extern __shared__ unsigned char k2w_smem[];
  unsigned char* base = align1024(k2w_smem);
  bf16* kv = reinterpret_cast<bf16*>(base);  // stage s: NKB K blocks, then NKB V blocks
  bf16* qs = kv + (size_t)KVS * 2 * NKB * KB_ELEMS;  // tile (w, stage) at w * QSTAGES + stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(qs + K2W_CONSUMERS * K2W_QSTAGES * TILE_ELEMS);
  uint64_t* kv_full = bars;                          // [KVS]
  uint64_t* kv_empty = bars + 2;                     // [KVS], a warp of each warpgroup
  uint64_t* q_full = bars + 4;                       // [w * QSTAGES + stage]
  uint64_t* q_empty = q_full + K2W_CONSUMERS * K2W_QSTAGES;  // the 4 warps of w

  const int nqt = (NQ + K2W_QT - 1) / K2W_QT;
  const int t0 = (int)((long long)blockIdx.x * n_items / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * n_items / gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KVS; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 4 * K2W_CONSUMERS);
    }
    for (int i = 0; i < K2W_CONSUMERS * K2W_QSTAGES; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4);
    }
    mbar_init_fence();
  }
  if (nkb < NKB) {  // the V blocks that no load fills
    for (int s = 0; s < KVS; ++s) {
      uint4* z = reinterpret_cast<uint4*>(kv + ((size_t)s * 2 * NKB + NKB + nkb) * KB_ELEMS);
      for (int i = threadIdx.x; i < (NKB - nkb) * KB_ELEMS / 8; i += blockDim.x)
        z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
  }
  __syncthreads();

  if (warp >= 4 * K2W_CONSUMERS) {
    // the producer warpgroup: one lane issues every load
    if (warp == 4 * K2W_CONSUMERS && lane == 0) {
      int kvs = 0, qst[K2W_CONSUMERS] = {};
      uint32_t kvph = 0, qph[K2W_CONSUMERS] = {};
      int cur = -1;
      for (int t = t0; t < t1; ++t) {
        const int bh = t / nqt, qt = t - bh * nqt;
        if (bh != cur) {
          mbar_wait(&kv_empty[kvs], kvph ^ 1);
          mbar_expect_tx(&kv_full[kvs], 2 * nkb * K2W_BLOCK_BYTES);
          bf16* ks = kv + (size_t)kvs * 2 * NKB * KB_ELEMS;
          for (int b = 0; b < nkb; ++b) {
            tma_load_3d(ks + b * KB_ELEMS, &kmap, &kv_full[kvs], 0, b * K2W_KB, bh);
            tma_load_3d(ks + (NKB + b) * KB_ELEMS, &vmap, &kv_full[kvs], 0, b * K2W_KB, bh);
          }
          cur = bh;
          if (++kvs == KVS) {
            kvs = 0;
            kvph ^= 1;
          }
        }
        const int w = (t - t0) % K2W_CONSUMERS, i = w * K2W_QSTAGES + qst[w];
        mbar_wait(&q_empty[i], qph[w] ^ 1);
        mbar_expect_tx(&q_full[i], K2W_TILE_BYTES);
        tma_load_3d(qs + (size_t)i * TILE_ELEMS, &qmap, &q_full[i], 0, qt * K2W_QT, bh);
        if (++qst[w] == K2W_QSTAGES) {
          qst[w] = 0;
          qph[w] ^= 1;
        }
      }
    }
  } else {
    // a consumer warpgroup: warp wl of it holds tile rows 16 wl + g, + 8.
    // S (32 registers), P's two parts (32) and O (32) live across a phase
    // with the softmax's temporaries within the 128 a thread that 512
    // threads leave (three consumer warpgroups: 12 warps an SM to hide
    // the softmax's latencies, where two ran longer, and the kernel
    // is bound by its instructions, scripts/k2_variants.py).
    // The warpgroup index as the compiler can see it is warp-uniform.
    const int wg = __shfl_sync(FULL, warp >> 2, 0), wl = warp & 3, g = lane >> 2, tq = lane & 3;
    constexpr int C = K2W_CONSUMERS;
    // the (b, h) whose K/V stage this warpgroup holds; hold(bh) releases
    // the ones before bh and waits for bh's
    const int bh0 = t0 / nqt;
    int cur = bh0 - 1, kvs = 0;
    uint32_t kvph = 0;
    auto hold = [&](int bh) {
      while (cur < bh) {
        if (cur >= bh0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&kv_empty[kvs]);
          if (++kvs == KVS) {
            kvs = 0;
            kvph ^= 1;
          }
        }
        ++cur;
        mbar_wait(&kv_full[kvs], kvph);
      }
    };
    int qst = 0;
    uint32_t qph = 0;
    for (int t = t0 + wg; t < t1; t += C) {
      const int bh = t / nqt, qt = t - bh * nqt;
      hold(bh);
      const int qi = wg * K2W_QSTAGES + qst;
      mbar_wait(&q_full[qi], qph);
      const bf16* qtile = qs + (size_t)qi * TILE_ELEMS;
      const bf16* ks = kv + (size_t)kvs * 2 * NKB * KB_ELEMS;
      const bf16* vs = ks + NKB * KB_ELEMS;
      const int row0 = qt * K2W_QT + wl * 16 + g;  // rows row0 and row0 + 8 of (b, h)
      uint32_t prow[2] = {0u, 0u};  // their Philox rows
      if (DROP) {
        const uint32_t r = (uint32_t)bh * (uint32_t)NQ + (uint32_t)row0;
        prow[0] = drop.philox_row(r);
        prow[1] = drop.philox_row(r + 8);
      }
      // the tiles' descriptors, once a tile; a product's is its tile's plus
      // the offset of its 16-deep step (wg_desc_at)
      const uint64_t dq = wg_desc(qtile), dk = wg_desc(ks), dv = wg_desc(vs);

      float sc[K2W_KB / 2], o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float alpha[2] = {1.f, 1.f};
      uint32_t pa[K2_PARTS][K2W_KB / 16][4];
#pragma unroll
      for (int b = 0; b <= NKB; ++b) {
        if (b >= 2 && (alpha[0] != 1.f || alpha[1] != 1.f)) {
          // O through block b - 2 to block b - 1's reference m
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        wgmma_fence_regs(o);
        wgmma_fence();
        // this phase's products: S = Q K^T over block b's 64 keys, 16 deep
        // a product, then P V of block b - 1
        if (b < NKB) {
#pragma unroll
          for (int k16 = 0; k16 < TC_DH / 16; ++k16)
            wgmma_m64n64k16(sc, wg_desc_at(dq, 32 * k16),
                            wg_desc_at(dk, 2 * (b * KB_ELEMS + k16 * 16)), k16);
          wgmma_commit();
        }
        if (b > 0) {  // O += P V over block b - 1; V MN-major (transposed)
#pragma unroll
          for (int k = 0; k < K2W_KB / 16; ++k)
#pragma unroll
            for (int p = 0; p < K2_PARTS; ++p)
              wgmma_m64n64k16_rt(o, pa[p][k],
                                 wg_desc_at(dv, 2 * ((b - 1) * KB_ELEMS + k * 16 * TC_DH)),
                                 b > 1 || k > 0 || p > 0);
          wgmma_commit();
        }
        uint32_t kbits = 0;  // block b's keep bits, bit i for sc[i]
        if (DROP && b < NKB) {
          const int k0 = b * K2W_KB;
          kbits = keep_bits_stage<K2_DRAW_UNROLL>(drop, prow, lane, DenseKeys{(uint32_t)k0});
        }
        if (b < NKB) {
          if (b > 0) wgmma_wait<1>();  // S has landed; P V may still run
          else wgmma_wait<0>();
          wgmma_fence_regs(sc);
          if (b == NKB - 1) {  // the Q tile is read: its stage goes back to the producer
            __syncwarp();
            if (lane == 0) mbar_arrive(&q_empty[qi]);
            if (++qst == K2W_QSTAGES) {
              qst = 0;
              qph ^= 1;
            }
          }
          // the softmax of rows g (e < 2) and g + 8 over the block's live keys
          const int k0 = b * K2W_KB;
          if (k0 + K2W_KB > NK) {
#pragma unroll
            for (int i = 0; i < K2W_KB / 2; ++i)
              if (k0 + (i >> 2) * 8 + 2 * tq + (i & 1) >= NK) sc[i] = -INFINITY;
          }
          // the rows' maxima and sums by trees (short dependence chains)
          float mx[2][K2W_KB / 8];
#pragma unroll
          for (int j = 0; j < K2W_KB / 8; ++j) {
            mx[0][j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
            mx[1][j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
          }
#pragma unroll
          for (int w = K2W_KB / 16; w >= 1; w >>= 1)
#pragma unroll
            for (int j = 0; j < w; ++j) {
              mx[0][j] = fmaxf(mx[0][j], mx[0][j + w]);
              mx[1][j] = fmaxf(mx[1][j], mx[1][j + w]);
            }
          // the reference m moves only when the block's maximum passes it by
          // more than 8 (log2): e then stays below 2^8, exact in fp32 and
          // split alike, and O is rescaled only where m moved (rarely after
          // the first block)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = mx[h][0];
            x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
            x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
            x *= scale_log2;  // finite on the first block: key 0 is live
            alpha[h] = 1.f;
            if (x > m[h] + K2W_RESCALE) {
              alpha[h] = exp2_ftz(m[h] - x);  // 0 on the first block
              m[h] = x;
            }
          }
#pragma unroll
          for (int i = 0; i < K2W_KB / 2; ++i)
            sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
          float sm[2][K2W_KB / 8];  // the undropped e, the denominator's
#pragma unroll
          for (int j = 0; j < K2W_KB / 8; ++j) {
            sm[0][j] = sc[4 * j] + sc[4 * j + 1];
            sm[1][j] = sc[4 * j + 2] + sc[4 * j + 3];
          }
#pragma unroll
          for (int w = K2W_KB / 16; w >= 1; w >>= 1)
#pragma unroll
            for (int j = 0; j < w; ++j) {
              sm[0][j] += sm[0][j + w];
              sm[1][j] += sm[1][j + w];
            }
          l[0] = l[0] * alpha[0] + sm[0][0];
          l[1] = l[1] * alpha[1] + sm[1][0];
          if (DROP) {
#pragma unroll
            for (int i = 0; i < K2W_KB / 2; ++i)
              sc[i] *= (kbits >> i) & 1u ? drop.keep_scale : 0.f;
          }
        }
        wgmma_wait<0>();
        wgmma_fence_regs(o);
        if (b < NKB) {
          // keys 16 k .. 16 k + 15 are S's columns 8 (2 k) .. and 8 (2 k + 1)
          // .., whose accumulator registers s[8 k .. 8 k + 7] are
          // mma.m16n8k16's A fragment of them, pair by pair: P's two parts
#pragma unroll
          for (int k = 0; k < K2W_KB / 16; ++k)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              uint32_t t2[K2_PARTS];
              split_pair<K2_PARTS>(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1], t2);
#pragma unroll
              for (int p = 0; p < K2_PARTS; ++p) pa[p][k][r] = t2[p];
            }
        }
      }
      // normalize, round once, store the rows below NQ
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float inv = 1.f / quad_sum(l[h]);
        const int row = row0 + 8 * h;
        if (row >= NQ) continue;
        bf16* dst = out + ((size_t)bh * NQ + row) * TC_DH + 2 * tq;
#pragma unroll
        for (int j = 0; j < TC_DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
    }
    // on to the range's last (b, h): the producer's ring waits for the
    // releases
    hold((t1 - 1) / nqt);
  }
}

template <bool DROP>
cudaError_t launch_largeq_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                                int H, int NQ, int NK, float scale, Dropout drop,
                                cudaStream_t stream) {
  if (NQ == 0) return cudaSuccess;
  if (NK < 1 || NK > K2W_MAX_NK) return cudaErrorInvalidValue;
  const uint64_t BH = (uint64_t)B * H, row = TC_DH * sizeof(bf16);
  const uint64_t qdims[3] = {TC_DH, (uint64_t)NQ, BH}, qbytes[2] = {row, row * NQ};
  const uint64_t kdims[3] = {TC_DH, (uint64_t)NK, BH}, kbytes[2] = {row, row * NK};
  const uint32_t qbox[3] = {TC_DH, K2W_QT, 1}, kbox[3] = {TC_DH, K2W_KB, 1};
  CUtensorMap qm, km, vm;
  cudaError_t e = tma_map_bf16(qm, q, 3, qdims, qbytes, qbox);
  if (e == cudaSuccess) e = tma_map_bf16(km, k, 3, kdims, kbytes, kbox);
  if (e == cudaSuccess) e = tma_map_bf16(vm, v, 3, kdims, kbytes, kbox);
  const int nkb = NK > 4 * K2W_KB ? 8 : 4;
  auto kern = nkb == 8 ? largeq_fwd_wgmma_kernel<DROP, 8> : largeq_fwd_wgmma_kernel<DROP, 4>;
  const size_t smem = k2w_smem_bytes(nkb);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int sms = 0, smem_sm = 0, optin = 0;
  if (e == cudaSuccess) e = card_shape(sms, smem_sm, optin);
  if (e != cudaSuccess) return e;
  const int n_items = (int)BH * ((NQ + K2W_QT - 1) / K2W_QT);
  const int grid = n_items < sms ? n_items : sms;
  kern<<<grid, K2W_THREADS, smem, stream>>>(qm, km, vm, static_cast<bf16*>(out), NQ, NK, n_items,
                                            scale * LOG2E, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 in bf16 on Hopper: largeq_bwd_dq_wgmma_kernel and
// largeq_bwd_dkdv_wgmma_kernel (the source note above)

constexpr int K7W_QT = 64;                        // queries a tile: one warpgroup's m64
constexpr int K7W_KT = 64;                        // keys a block (dq) or a dk/dv CTA: m64
constexpr int K7W_THREADS = 128 + 32;             // dk/dv: a consumer warpgroup, a producer warp
constexpr int K7W_STAGES = 3;                     // the dk/dv pass's ring of query tiles
constexpr int K7W_DQ_STAGES = 2;                  // dq: Q / g ring depth a warpgroup
// dq: consumer warpgroups a CTA, 128 registers a thread at three; with
// dropout two, at 168 (its Philox draws spilled at 128)
__host__ __device__ constexpr int k7w_dq_consumers(bool drop) { return drop ? 2 : 3; }
__host__ __device__ constexpr int k7w_dq_threads(bool drop) {
  return (k7w_dq_consumers(drop) + 1) * 128;  // + a producer warpgroup
}
constexpr uint32_t K7W_TILE_BYTES = K7W_QT * TC_DH * 2;  // 8 KB of Q, g, K or V
// a dk/dv stage: Q and g tiles, then each query's (m, log2 l), D and its
// two keep words at the CTA's 64 keys; 1024-aligned for the next stage
constexpr uint32_t K7W_SIDE_BYTES =
    K7W_QT * (sizeof(float2) + sizeof(float) + 2 * sizeof(uint32_t));
constexpr uint32_t K7W_STAGE_BYTES = (2 * K7W_TILE_BYTES + K7W_SIDE_BYTES + 1023) / 1024 * 1024;

// the dk/dv pass's dk or dv sums, fp32, a float2 per (warp, row half, 8
// columns, lane): 16 KB each
constexpr uint32_t K7W_SUM_BYTES = K7W_KT * TC_DH * sizeof(float);

__host__ __device__ constexpr size_t k7w_dkdv_smem_bytes() {
  return 1024 + 2 * K7W_TILE_BYTES + (size_t)K7W_STAGES * K7W_STAGE_BYTES + 2 * K7W_SUM_BYTES +
         (1 + 2 * K7W_STAGES) * sizeof(uint64_t);
}

// the dq pass: K2's K/V ring, each consumer warpgroup's Q and g ring, the
// barriers (230,656 bytes at 256 keys and three consumers, two K/V stages;
// as many at 512 keys, one)
__host__ __device__ constexpr size_t k7w_dq_smem_bytes(int nkb, bool drop) {
  return 1024 + (size_t)k2w_kv_stages(nkb) * 2 * nkb * K7W_TILE_BYTES +
         (size_t)k7w_dq_consumers(drop) * K7W_DQ_STAGES * 2 * K7W_TILE_BYTES + 256;
}

// S (or S^T) = A B^T over the 64-deep head width: A and B 64-row tiles,
// both K-major (as stored), four m64n64k16 a product
__device__ __forceinline__ void wg_abt64(float (&d)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int k16 = 0; k16 < TC_DH / 16; ++k16)
    wgmma_m64n64k16(d, wg_desc_at(a, 32 * k16), wg_desc_at(b, 32 * k16), k16);
}

// The m64n64 accumulator c as A fragments of its four 16-column blocks in
// NP bf16 parts: columns 16 k .. 16 k + 15 are c[8 k .. 8 k + 7], pair by
// pair mma.m16n8k16's A fragment of them
template <int NP>
__device__ __forceinline__ void wg_a_parts(const float (&c)[32], uint32_t (&a)[NP][4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t t[NP];
      split_pair<NP>(c[8 * k + 2 * r], c[8 * k + 2 * r + 1], t);
#pragma unroll
      for (int p = 0; p < NP; ++p) a[p][k][r] = t[p];
    }
}

// a thread's 32 sums at `at` (float2 x / 2 at at[x / 2 * 32]) += tile, in fp32
__device__ __forceinline__ void add_sums(float2* at, const float (&tile)[32]) {
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const float2 a = at[x * 32];
    at[x * 32] = make_float2(a.x + tile[2 * x], a.y + tile[2 * x + 1]);
  }
}

// d (+)= A B over 64 deep: A from registers in NP parts (wg_a_parts), B a
// 64-row tile MN-major (its 64 columns contiguous: g, Q, K or V as
// stored), 16 rows a step; d is zeroed first where `add` is false
template <int NP>
__device__ __forceinline__ void wg_ab64(float (&d)[32], const uint32_t (&a)[NP][4][4],
                                        uint64_t b, bool add) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int p = 0; p < NP; ++p)
      wgmma_m64n64k16_rt(d, a[p][k], wg_desc_at(b, 2 * k * 16 * TC_DH), add || k > 0 || p > 0);
}

// K7 pass 1 (bf16): K2's persistent shape. One CTA an SM walks (b, h,
// 64-query tile) items in (b, h)-major order, a balanced range a CTA; the
// producer warpgroup's first lane loads by TMA K and V of each (b, h) the
// range enters (every 64-key block that holds a key, into K2's ring of
// k2w_kv_stages) and each item's Q and g tiles into its consumer
// warpgroup's two-stage ring; C consumer warpgroups (three, two with
// dropout: k7w_dq_consumers) take every C-th item, warp wl holding tile
// rows 16 wl + g, + 8. Sweep 1, per 64-key
// block: S = Q K^T and dP = g V^T (wgmma, K-major operands), the online
// softmax (m, l) and beside l the unnormalized d = sum_k e_k keep_k dp_k
// rescaled with it, so that D = d / l = rowsum(g o O) without O; each keep
// bit is drawn here once and written as (B, H, NQ, nkw) words for sweep 2
// and pass 2. Sweep 2: p = 2^(s c - m - log2 l), ds = p (dp keep - D)
// scale, dq += ds K with ds from registers in K7_DQ_PARTS bf16 parts and
// K MN-major. Then dq (bf16), each row's (m, log2 l) (lse = (m + log2 l)
// ln 2, kept apart: their fp32 sum rounds at the size of m) and D. Twelve
// consumer warps an SM: with two CTAs of one warpgroup each, the pass's
// chains of products, waits and softmax took 0.45 ms at 128f latent_dec
// on an NVIDIA H100 80GB HBM3, 0.31 with twelve.
template <bool DROP, int NKB>
__global__ void __launch_bounds__(k7w_dq_threads(DROP), 1)
largeq_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap gmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ dq,
                           float2* __restrict__ lse2, float* __restrict__ dvec,
                           uint32_t* __restrict__ keep, int NQ, int NK, int n_items,
                           float scale, float scale_log2, Dropout drop) {
  constexpr int KB_ELEMS = K7W_KT * TC_DH, TILE_ELEMS = K7W_QT * TC_DH;
  constexpr int KVS = k2w_kv_stages(NKB), C = k7w_dq_consumers(DROP), QS = K7W_DQ_STAGES;
  const int nkb = (NK + K7W_KT - 1) / K7W_KT, nkw = (NK + 31) / 32;  // blocks that hold a key
  extern __shared__ unsigned char k7w_smem[];
  unsigned char* base = align1024(k7w_smem);
  bf16* kv = reinterpret_cast<bf16*>(base);  // stage s: NKB K blocks, then NKB V blocks
  bf16* qg = kv + (size_t)KVS * 2 * NKB * KB_ELEMS;  // stage (w, s) at w QS + s: Q, then g
  uint64_t* bars = reinterpret_cast<uint64_t*>(qg + (size_t)C * QS * 2 * TILE_ELEMS);
  uint64_t* kv_full = bars;              // [KVS]
  uint64_t* kv_empty = bars + 2;         // [KVS], a warp of each consumer warpgroup
  uint64_t* q_full = bars + 4;           // [w QS + s]
  uint64_t* q_empty = q_full + C * QS;   // the 4 warps of w

  const int nqt = (NQ + K7W_QT - 1) / K7W_QT;
  const int t0 = (int)((long long)blockIdx.x * n_items / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * n_items / gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KVS; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 4 * C);
    }
    for (int i = 0; i < C * QS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C) {
    // the producer warpgroup: one lane issues every load
    if (warp == 4 * C && lane == 0) {
      int kvs = 0;
      uint32_t kvph = 0;
      int cur = -1;
      for (int t = t0; t < t1; ++t) {
        const int bh = t / nqt, qt = t - bh * nqt;
        if (bh != cur) {
          mbar_wait(&kv_empty[kvs], kvph ^ 1);
          mbar_expect_tx(&kv_full[kvs], 2 * nkb * K7W_TILE_BYTES);
          bf16* ks = kv + (size_t)kvs * 2 * NKB * KB_ELEMS;
          for (int b = 0; b < nkb; ++b) {
            tma_load_3d(ks + b * KB_ELEMS, &kmap, &kv_full[kvs], 0, b * K7W_KT, bh);
            tma_load_3d(ks + (NKB + b) * KB_ELEMS, &vmap, &kv_full[kvs], 0, b * K7W_KT, bh);
          }
          cur = bh;
          if (++kvs == KVS) {
            kvs = 0;
            kvph ^= 1;
          }
        }
        // item t is consumer w's j-th: its stage j % QS, phase (j / QS) & 1
        const int w = (t - t0) % C, j = (t - t0) / C, i = w * QS + j % QS;
        mbar_wait(&q_empty[i], ((j / QS) & 1) ^ 1);
        mbar_expect_tx(&q_full[i], 2 * K7W_TILE_BYTES);
        bf16* st = qg + (size_t)i * 2 * TILE_ELEMS;
        tma_load_3d(st, &qmap, &q_full[i], 0, qt * K7W_QT, bh);
        tma_load_3d(st + TILE_ELEMS, &gmap, &q_full[i], 0, qt * K7W_QT, bh);
      }
    }
    return;
  }

  // a consumer warpgroup (the warpgroup index as the compiler can see it
  // is warp-uniform)
  const int wg = __shfl_sync(FULL, warp >> 2, 0), wl = warp & 3, g = lane >> 2, tq = lane & 3;
  // the (b, h) whose K/V stage this warpgroup holds; hold(bh) releases the
  // ones before bh and waits for bh's (K2's)
  const int bh0 = t0 / nqt;
  int cur = bh0 - 1, kvs = 0;
  uint32_t kvph = 0;
  auto hold = [&](int bh) {
    while (cur < bh) {
      if (cur >= bh0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_empty[kvs]);
        if (++kvs == KVS) {
          kvs = 0;
          kvph ^= 1;
        }
      }
      ++cur;
      mbar_wait(&kv_full[kvs], kvph);
    }
  };
  int qst = 0;
  uint32_t qph = 0;
  for (int t = t0 + wg; t < t1; t += C) {
    const int bh = t / nqt, qt = t - bh * nqt;
    hold(bh);
    const int qi = wg * QS + qst;
    mbar_wait(&q_full[qi], qph);
    const bf16* st = qg + (size_t)qi * 2 * TILE_ELEMS;
    const uint64_t dQ = wg_desc(st), dG = wg_desc(st + TILE_ELEMS);
    const bf16* ks = kv + (size_t)kvs * 2 * NKB * KB_ELEMS;
    const uint64_t dk = wg_desc(ks), dv = wg_desc(ks + NKB * KB_ELEMS);
    const int row0 = qt * K7W_QT + wl * 16 + g;  // rows row0, row0 + 8 of (b, h)
    const uint32_t lrow = (uint32_t)bh * (uint32_t)NQ + (uint32_t)row0;  // the local row
    uint32_t prow[2] = {0u, 0u};  // their Philox rows
    if (DROP) {
      prow[0] = drop.philox_row(lrow);
      prow[1] = drop.philox_row(lrow + 8);
    }

    // sweep 1: (m, l) and D = d / l
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
    float sc[32], dp[32];
#pragma unroll
    for (int b = 0; b < NKB; ++b) {
      if (b >= nkb) continue;
      wgmma_fence();
      wg_abt64(sc, dQ, wg_desc_at(dk, 2 * b * KB_ELEMS));
      wg_abt64(dp, dG, wg_desc_at(dv, 2 * b * KB_ELEMS));  // zero rows past NK
      wgmma_commit();
      uint32_t kb = 0u;  // element i's keep bit at bit i
      if (DROP) {  // drawn while the products run
        const int k0 = b * K7W_KT;
        kb = keep_bits_stage<K7_DRAW_UNROLL>(drop, prow, lane, DenseKeys{(uint32_t)k0});
      }
      wgmma_wait<0>();
      wgmma_fence_regs(sc);
      wgmma_fence_regs(dp);
      const int k0 = b * K7W_KT;
      if (k0 + K7W_KT > NK) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + (i >> 2) * 8 + 2 * tq + (i & 1) >= NK) sc[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = mx[h];
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
        const float mn = fmaxf(m[h], x * scale_log2);  // finite: key 0 is live
        const float alpha = exp2_ftz(m[h] - mn);  // 0 on the first block
        m[h] = mn;
        l[h] *= alpha;
        d[h] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float x = exp2_ftz(fmaf(sc[i], scale_log2, -m[h]));
        l[h] += x;  // the denominator takes the undropped e
        if (DROP) x *= (kb >> i) & 1u ? drop.keep_scale : 0.f;
        d[h] = fmaf(x, dp[i], d[h]);
      }
      if (DROP) {
        // the block's two words of each row: word w holds keys k0 + 32 w ..,
        // element i at bit (i >> 2) * 8 + 2 tq + (i & 1) - 32 w
        uint32_t wd[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          wd[(i >> 1) & 1][i >> 4] |= ((kb >> i) & 1u) << (((i >> 2) & 3) * 8 + 2 * tq + (i & 1));
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            wd[h][w] |= __shfl_xor_sync(FULL, wd[h][w], 1);
            wd[h][w] |= __shfl_xor_sync(FULL, wd[h][w], 2);
          }
        const int h = tq >> 1, w = tq & 1, kw = 2 * b + w;  // lane tq stores one word
        if (row0 + 8 * h < NQ && kw < nkw)
          keep[(size_t)(lrow + 8 * h) * nkw + kw] = h ? (w ? wd[1][1] : wd[1][0])
                                                      : (w ? wd[0][1] : wd[0][0]);
      }
    }
    float D[2], lg2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      D[h] = quad_sum(d[h]) / l[h];
      lg2[h] = log2f(l[h]);
    }
    if (DROP) __syncwarp();  // the rows' keep words are written

    // sweep 2: dq += ds K
    float acc[32];
#pragma unroll
    for (int b = 0; b < NKB; ++b) {
      if (b >= nkb) continue;
      wgmma_fence();
      wg_abt64(sc, dQ, wg_desc_at(dk, 2 * b * KB_ELEMS));
      wg_abt64(dp, dG, wg_desc_at(dv, 2 * b * KB_ELEMS));
      wgmma_commit();
      // the rows' keep bits of this block, read back (bit = key % 32)
      uint32_t kw[2][2] = {{0u, 0u}, {0u, 0u}};
      if (DROP) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int w = 0; w < 2; ++w)
            if (row0 + 8 * h < NQ && 2 * b + w < nkw)
              kw[h][w] = keep[(size_t)(lrow + 8 * h) * nkw + 2 * b + w];
      }
      wgmma_wait<0>();
      wgmma_fence_regs(sc);
      wgmma_fence_regs(dp);
      const int k0 = b * K7W_KT;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * tq + (i & 1);  // the block's column
        const bool live = k0 + c < NK;
        const float p = live ? exp2_ftz(fmaf(sc[i], scale_log2, -m[h]) - lg2[h]) : 0.f;
        float x = dp[i];
        if (DROP) x = (kw[h][i >> 4] >> (c & 31)) & 1u ? x * drop.keep_scale : 0.f;
        dp[i] = p * (x - D[h]) * scale;
      }
      uint32_t da[K7_DQ_PARTS][4][4];
      wg_a_parts<K7_DQ_PARTS>(dp, da);
      wgmma_fence();
      wg_ab64<K7_DQ_PARTS>(acc, da, wg_desc_at(dk, 2 * b * KB_ELEMS), b > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
    }
    // the tile's Q and g are read: the stage goes back to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qi]);
    if (++qst == QS) {
      qst = 0;
      qph ^= 1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= NQ) continue;
      bf16* dst = dq + ((size_t)bh * NQ + row) * TC_DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < TC_DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (tq == 0) {
        lse2[(size_t)bh * NQ + row] = make_float2(m[h], lg2[h]);
        dvec[(size_t)bh * NQ + row] = D[h];
      }
    }
  }
  // on to the range's last (b, h): the producer's ring waits for the
  // releases
  hold((t1 - 1) / nqt);
}

// K7 pass 2 (bf16). Grid (64-key tiles, B * H, query splits), one CTA a
// key tile and the split's query tiles (tps from tile tps z of split z =
// blockIdx.z). The producer warp's first lane loads the tile's K and V
// rows (zeros past NK) and streams each query tile's Q and g rows by TMA
// into a ring of K7W_STAGES; its other lanes copy beside them the rows'
// (m, log2 l), D and keep words at the CTA's keys (zeros past NQ: with
// q = g = 0 a row adds nothing), and every lane arrives on the stage's
// barrier. The consumer warpgroup: S^T = K Q^T and dP^T = V g^T
// (m64n64k16, K-major operands; keys are M, warp wl holds keys 16 wl + g,
// + 8), p and ds in place, then dv += P^T g and dk += dS^T Q with the A
// operand from registers in K7_PARTS bf16 parts (FlashAttention-3's
// conversion of the accumulator) and g, Q MN-major. Each tile's products
// are summed apart in the wgmma accumulator and added to the fp32 dk, dv
// sums. One split writes dk, dv in bf16; with more, each leaves its fp32
// sums in part (dk of split z at part + z n, dv at part + (splits + z) n,
// n = B H NK Dh) for largeq_bwd_dkdv_merge_kernel.
template <bool DROP>
__global__ void __launch_bounds__(K7W_THREADS, 2)
largeq_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap gmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const float2* __restrict__ lse2, const float* __restrict__ dvec,
                             const uint32_t* __restrict__ keep, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, float* __restrict__ part, int NQ, int NK,
                             int tps, float scale, float scale_log2, Dropout drop) {
  constexpr int TILE_ELEMS = K7W_QT * TC_DH;
  extern __shared__ unsigned char k7w_smem[];
  unsigned char* base = align1024(k7w_smem);
  bf16* kt = reinterpret_cast<bf16*>(base);
  bf16* vt = kt + TILE_ELEMS;
  unsigned char* ring = base + 2 * K7W_TILE_BYTES;
  float2* sums = reinterpret_cast<float2*>(ring + (size_t)K7W_STAGES * K7W_STAGE_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sums + 2 * K7W_SUM_BYTES / sizeof(float2));
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + K7W_STAGES;
  const int bh = blockIdx.y, k0 = blockIdx.x * K7W_KT, nkw = (NK + 31) / 32;
  const int ntiles = (NQ + K7W_QT - 1) / K7W_QT;
  const int t0 = blockIdx.z * tps, t1 = min(ntiles, t0 + tps);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < K7W_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the TMA's expect_tx and 31 lanes' side rows
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * K7W_TILE_BYTES);
      tma_load_3d(kt, &kmap, kv_full, 0, k0, bh);
      tma_load_3d(vt, &vmap, kv_full, 0, k0, bh);
    }
    const int w0 = k0 / 32;
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % K7W_STAGES;
      mbar_wait(&empty[s], ((i / K7W_STAGES) & 1) ^ 1);
      unsigned char* st = ring + (size_t)s * K7W_STAGE_BYTES;
      float2* ls = reinterpret_cast<float2*>(st + 2 * K7W_TILE_BYTES);
      float* ds = reinterpret_cast<float*>(ls + K7W_QT);
      uint32_t* ms = reinterpret_cast<uint32_t*>(ds + K7W_QT);
      for (int qq = lane; qq < K7W_QT; qq += 32) {
        const int row = t * K7W_QT + qq;
        const bool in = row < NQ;
        const size_t r = (size_t)bh * NQ + (in ? row : 0);
        ls[qq] = in ? lse2[r] : make_float2(0.f, 0.f);
        ds[qq] = in ? dvec[r] : 0.f;
        if (DROP) {
#pragma unroll
          for (int w = 0; w < 2; ++w)
            ms[2 * qq + w] = in && w0 + w < nkw ? keep[r * nkw + w0 + w] : 0u;
        }
      }
      if (lane == 0) {  // arrives once with the bytes TMA will bring
        mbar_expect_tx(&full[s], 2 * K7W_TILE_BYTES);
        tma_load_3d(st, &qmap, &full[s], 0, t * K7W_QT, bh);
        tma_load_3d(st + K7W_TILE_BYTES, &gmap, &full[s], 0, t * K7W_QT, bh);
      } else {
        mbar_arrive(&full[s]);  // after this lane's side rows (release)
      }
    }
    return;
  }

  const int wl = warp, g = lane >> 2, tq = lane & 3;
  const int kw = wl >> 1, kbit = (wl & 1) * 16 + g;  // the keep word and bit of key row g
  const uint64_t dK = wg_desc(kt), dV = wg_desc(vt);
  // the dk and dv sums in shared memory (the thread's own 32 each, float2
  // x at at[x / 2 * 32]: lanes side by side), which leaves the registers
  // to the tile's products and the A parts (in registers the sums spilled)
  float2* dk_at = sums + wl * 16 * 32 + lane;
  float2* dv_at = dk_at + K7W_SUM_BYTES / sizeof(float2);
#pragma unroll
  for (int i = 0; i < 16; ++i) dk_at[i * 32] = dv_at[i * 32] = make_float2(0.f, 0.f);
  mbar_wait(kv_full, 0);
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, s = i % K7W_STAGES;
    mbar_wait(&full[s], (i / K7W_STAGES) & 1);
    const unsigned char* st = ring + (size_t)s * K7W_STAGE_BYTES;
    const float2* ls = reinterpret_cast<const float2*>(st + 2 * K7W_TILE_BYTES);
    const float* ds = reinterpret_cast<const float*>(ls + K7W_QT);
    const uint32_t* ms = reinterpret_cast<const uint32_t*>(ds + K7W_QT);
    const uint64_t dQ = wg_desc(st), dG = wg_desc(st + K7W_TILE_BYTES);
    float sc[32], dp[32];
    wgmma_fence();
    wg_abt64(sc, dK, dQ);  // S^T: keys x queries
    wg_abt64(dp, dV, dG);  // dP^T = V g^T
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(sc);
    wgmma_fence_regs(dp);
    // element 4 j + e: key row g + 8 (e >> 1), query 8 j + 2 tq + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      const float4 L = *reinterpret_cast<const float4*>(ls + c);  // (m, log2 l) of c, c + 1
      const float2 Dc = *reinterpret_cast<const float2*>(ds + c);
      uint32_t w[2] = {0u, 0u};
      if (DROP) {
        w[0] = ms[2 * c + kw];
        w[1] = ms[2 * (c + 1) + kw];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, cc = e & 1;
        const float p =
            exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -(cc ? L.z : L.x)) - (cc ? L.w : L.y));
        float kp = 1.f;
        if (DROP) kp = (w[cc] >> (kbit + 8 * h)) & 1u ? drop.keep_scale : 0.f;
        sc[4 * j + e] = p * kp;
        dp[4 * j + e] = p * (dp[4 * j + e] * kp - (cc ? Dc.y : Dc.x)) * scale;
      }
    }
    // the tile's products summed apart in the accumulator, then added in
    // fp32: the tensor cores' own sums drop the bits of a small product
    // below the accumulator's last place, which over 8192 queries cost
    // elements near zero 2-3x their bound
    float tile[32];
    uint32_t a[K7_PARTS][4][4];
    wg_a_parts<K7_PARTS>(sc, a);
    wgmma_fence();
    wg_ab64<K7_PARTS>(tile, a, dG, false);  // P^T g
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(tile);
    add_sums(dv_at, tile);
    wg_a_parts<K7_PARTS>(dp, a);
    wgmma_fence();
    wg_ab64<K7_PARTS>(tile, a, dQ, false);  // dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(tile);
    add_sums(dk_at, tile);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t n = (size_t)gridDim.y * NK * TC_DH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + wl * 16 + g + 8 * h;
    if (key >= NK) continue;
    const size_t off = ((size_t)bh * NK + key) * TC_DH + 2 * tq;
#pragma unroll
    for (int j = 0; j < TC_DH / 8; ++j) {
      const float2 k2 = dk_at[(2 * j + h) * 32], v2 = dv_at[(2 * j + h) * 32];
      if (part == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) = __floats2bfloat162_rn(k2.x, k2.y);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) = __floats2bfloat162_rn(v2.x, v2.y);
      } else {
        *reinterpret_cast<float2*>(part + blockIdx.z * n + off + j * 8) = k2;
        *reinterpret_cast<float2*>(part + (gridDim.z + blockIdx.z) * n + off + j * 8) = v2;
      }
    }
  }
}

// dk, dv (n elements each) = the sums of the splits' fp32 partials, added
// in split order (bit-repeatable), rounded to bf16 once; four a thread
__global__ void __launch_bounds__(256)
largeq_bwd_dkdv_merge_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, size_t n, int splits) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int which = i >= n;
  const size_t j = i - which * n;
  const float* src = part + (size_t)which * splits * n + j;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int z = 1; z < splits; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(src + (size_t)z * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>((which ? dv : dk) + j);
  dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
  dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

// The query splits of K7's dk/dv pass on the current card: its (64-key
// tile, b, h) CTAs fall short of a few waves (320 at 128f against 264
// slots), so each key tile's walk over the ceil(NQ / 64) query tiles is
// cut into the count whose launch ends soonest when the CTAs run in waves
// (slots = SMs x CTAs an SM), each CTA costing its tiles plus one for its
// K/V, first tile and store, and a split walk one more for the merge's
// launch; the fewer splits on a tie. tps = tiles a split; no split is
// empty.
template <bool DROP>
cudaError_t k7_dkdv_plan(int BH, int NQ, int NK, int& splits, int& tps) {
  const size_t smem = k7w_dkdv_smem_bytes();
  auto kern = largeq_bwd_dkdv_wgmma_kernel<DROP>;
  int sms = 0, smem_sm = 0, optin = 0, per_sm = 0;
  cudaError_t e = card_shape(sms, smem_sm, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = blocks_per_sm(kern, K7W_THREADS, smem, per_sm);
  if (e != cudaSuccess) return e;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long ctas = (long)((NK + K7W_KT - 1) / K7W_KT) * BH;
  const int ntiles = (NQ + K7W_QT - 1) / K7W_QT;
  splits = 1;
  long best_cost = -1;
  for (int s = 1; s <= K7_MAX_SPLITS && s <= ntiles; ++s) {
    const long cost =
        (ctas * s + slots - 1) / slots * ((ntiles + s - 1) / s + 1) + (s > 1 ? 1 : 0);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      splits = s;
    }
  }
  tps = ntiles > 0 ? (ntiles + splits - 1) / splits : 1;
  splits = ntiles > 0 ? (ntiles + tps - 1) / tps : 1;
  return cudaSuccess;
}

template <bool DROP, int NKB>
cudaError_t launch_largeq_bwd_dq(const CUtensorMap& qm, const CUtensorMap& gm,
                                 const CUtensorMap& km, const CUtensorMap& vm, void* dq,
                                 void* lse2, void* dvec, void* keep, int BH, int NQ, int NK,
                                 float scale, Dropout drop, cudaStream_t stream) {
  auto kern = largeq_bwd_dq_wgmma_kernel<DROP, NKB>;
  const size_t smem = k7w_dq_smem_bytes(NKB, DROP);
  int sms = 0, smem_sm = 0, optin = 0;
  cudaError_t e = card_shape(sms, smem_sm, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_items = BH * ((NQ + K7W_QT - 1) / K7W_QT);
  const int grid = n_items < sms ? n_items : sms;
  kern<<<grid, k7w_dq_threads(DROP), smem, stream>>>(
      qm, gm, km, vm, static_cast<bf16*>(dq), static_cast<float2*>(lse2),
      static_cast<float*>(dvec), static_cast<uint32_t*>(keep), NQ, NK, n_items, scale,
      scale * LOG2E, drop);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t launch_largeq_bwd_wgmma(const void* q, const void* k, const void* v, const void* g,
                                    void* dq, void* dk, void* dv, void* lse2, void* dvec,
                                    void* keep, void* part, int B, int H, int NQ, int NK,
                                    float scale, Dropout drop, cudaStream_t stream) {
  if (NK < 1 || NK > K2W_MAX_NK) return cudaErrorInvalidValue;
  const int BH = B * H;
  const uint64_t row = TC_DH * sizeof(bf16);
  const uint64_t qdims[3] = {TC_DH, (uint64_t)(NQ > 0 ? NQ : 1), (uint64_t)BH};
  const uint64_t qbytes[2] = {row, row * (NQ > 0 ? NQ : 1)};
  const uint64_t kdims[3] = {TC_DH, (uint64_t)NK, (uint64_t)BH}, kbytes[2] = {row, row * NK};
  const uint32_t box[3] = {TC_DH, 64, 1};
  CUtensorMap qm, gm, km, vm;
  cudaError_t e = tma_map_bf16(qm, q, 3, qdims, qbytes, box);
  if (e == cudaSuccess) e = tma_map_bf16(gm, g, 3, qdims, qbytes, box);
  if (e == cudaSuccess) e = tma_map_bf16(km, k, 3, kdims, kbytes, box);
  if (e == cudaSuccess) e = tma_map_bf16(vm, v, 3, kdims, kbytes, box);
  if (e != cudaSuccess) return e;
  if (NQ > 0) {  // with no query, dk = dv = 0 from pass 2 alone
    e = NK > 4 * K7W_KT
            ? launch_largeq_bwd_dq<DROP, 8>(qm, gm, km, vm, dq, lse2, dvec, keep, BH, NQ, NK,
                                            scale, drop, stream)
            : launch_largeq_bwd_dq<DROP, 4>(qm, gm, km, vm, dq, lse2, dvec, keep, BH, NQ, NK,
                                            scale, drop, stream);
    if (e != cudaSuccess) return e;
  }
  int splits = 1, tps = 1;
  e = k7_dkdv_plan<DROP>(BH, NQ, NK, splits, tps);
  if (e != cudaSuccess) return e;
  float* partf = splits > 1 ? static_cast<float*>(part) : nullptr;
  const dim3 grid((NK + K7W_KT - 1) / K7W_KT, BH, splits);
  largeq_bwd_dkdv_wgmma_kernel<DROP><<<grid, K7W_THREADS, k7w_dkdv_smem_bytes(), stream>>>(
      qm, gm, km, vm, static_cast<const float2*>(lse2), static_cast<const float*>(dvec),
      static_cast<const uint32_t*>(keep), static_cast<bf16*>(dk), static_cast<bf16*>(dv), partf,
      NQ, NK, tps, scale, scale * LOG2E, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t n = (size_t)BH * NK * TC_DH;
  largeq_bwd_dkdv_merge_kernel<<<(unsigned)((2 * n / 4 + 255) / 256), 256, 0, stream>>>(
      partf, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1 / K6 in bf16 on Hopper: wgmma over gathered stages of LIVE keys
//
// The live keys of a batch row are listed in key order: by each K1 CTA
// itself while its Q tile lands, and for K6 once by a pre-pass of B CTAs
// into scratch (count, then keys: smallq_bwd_live_kernel), since its dk/dv
// pass reads the list again.
// A producer warp walks them in 64-key stages, gathering each stage's K
// and V rows with 16-byte cp.async into 128-byte-swizzled tiles
// (gather_rows_b128, csrc/hopper.cuh) whose copies complete on the
// stage's mbarrier, so that consumers wait and read them by wgmma as K2
// and K7 do TMA's tiles; rows past the live count are zeros (a zero V row
// meets a zero probability). Dead keys cost nothing, a stage is partly
// empty only at the end of a list, and dropout keys stay the original key
// indices.

constexpr int SQ_KT = 64;              // live keys a gathered stage
constexpr int SQ_QT = 64;              // queries a tile: one warpgroup's m64
constexpr int SQ_THREADS = 128 + 32;   // a consumer warpgroup and a producer warp
constexpr int K6W_DQ_STAGES = 3;       // K6's dq pass: its ring of gathered K/V stages
constexpr int SQ_MAX_SPLITS = 8;       // most CTAs sharing one (b, h, query tile)'s keys
constexpr uint32_t SQ_TILE_BYTES = SQ_KT * TC_DH * 2;   // 8 KB of Q, g, K or V
constexpr uint32_t SQ_STAGE_BYTES = 2 * SQ_TILE_BYTES;  // a stage: K, then V
// K6's dq pass adds ds K over thousands of live keys: ds in three bf16
// parts (tests/test_torch_attention_split_masked.py)
constexpr int K6_PARTS = 3;
constexpr double LN2_D = 0.6931471805599453;
constexpr double LOG2E_D = 1.4426950408889634;

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// The live keys of one batch row (mask row mrow of NK bytes), in key
// order. The row is read as 16-byte chunks (from the chunk holding key 0;
// bytes outside the row count as dead), a contiguous run of chunks a
// thread: each thread counts its live keys, a scan over the CTA (warp
// shuffles, then the warps' sums in wsum, one int a warp, in shared
// memory) gives each thread its first live position and the total, and
// the key at live position p goes to Is[p - beg] for p in [beg, end),
// where range(total, beg, end) picks them from the total; a thread whose
// positions miss [beg, end) writes nothing. At most 32 warps; Is may be
// shared or global memory. Every thread of the CTA calls it; it ends on a
// barrier.
template <typename Range>
__device__ __forceinline__ void list_live(const uint8_t* mrow, int NK, int* Is, int* wsum,
                                          Range range, int& beg, int& end) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  const int off = (int)(reinterpret_cast<uintptr_t>(mrow) & 15u);
  const uint4* chunks = reinterpret_cast<const uint4*>(mrow - off);
  const int nchunks = (NK + off + 15) / 16;
  const int per = (nchunks + (int)blockDim.x - 1) / (int)blockDim.x;
  const int c0 = tid * per, c1 = min(nchunks, c0 + per);
  auto live_bits = [&](int i) {  // bit j: byte j of chunk i holds a live key
    const uint4 w = chunks[i];
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
    uint32_t m = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t x = __vcmpne4(v[q], 0u);  // 0xff in each nonzero byte
      m |= ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u)) << (4 * q);
    }
    const int k0 = 16 * i - off;  // the key of byte 0
    if (k0 < 0) m &= 0xffffu << (-k0);
    if (k0 + 16 > NK) m &= 0xffffu >> (k0 + 16 - NK);
    return m;
  };
  int cnt = 0;
  for (int i = c0; i < c1; ++i) cnt += __popc(live_bits(i));
  int x = cnt;  // inclusive prefix of the warp's counts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int pos = x - cnt, total = 0;
  for (int w = 0; w < nw; ++w) {
    const int t = wsum[w];
    pos += w < warp ? t : 0;
    total += t;
  }
  range(total, beg, end);
  if (pos < end && pos + cnt > beg) {
    for (int i = c0; i < c1; ++i) {
      uint32_t m = live_bits(i);
      const int k0 = 16 * i - off;
      while (m != 0u) {
        const int j = __ffs(m) - 1;
        m &= m - 1u;
        if (pos >= beg && pos < end) Is[pos - beg] = k0 + j;
        ++pos;
      }
    }
  }
  __syncthreads();
}

// The live positions [beg, end) of split `split` of `splits`: a run of
// whole 64-key stages, the splits in list order
__device__ __forceinline__ void split_range(int total, int split, int splits, int& beg,
                                            int& end) {
  const int chunk = round_up((total + splits - 1) / splits, SQ_KT);
  beg = min(total, split * chunk);
  end = min(total, beg + chunk);
}

// K6's pre-pass (grid B, SQ_LIVE_THREADS threads: a row of up to 16384
// keys in one 16-byte chunk a thread): the live list of batch row
// blockIdx.x, live[b (NK + 1)] its count, then its keys in key order
constexpr int SQ_LIVE_THREADS = 1024;

__global__ void __launch_bounds__(SQ_LIVE_THREADS)
smallq_bwd_live_kernel(const uint8_t* __restrict__ mask, int* __restrict__ live, int NK) {
  __shared__ int wcnt[32];
  int* row = live + (size_t)blockIdx.x * (NK + 1);
  int beg, end;
  list_live(mask + (size_t)blockIdx.x * NK, NK, row + 1, wcnt,
            [](int total, int& b0, int& e0) {
              b0 = 0;
              e0 = total;
            },
            beg, end);
  if (threadIdx.x == 0) row[0] = end;
}

// ln(sum_k e^(s_k)) of a row from its log2-domain pair (m, l), the sum
// in double: the fp32 sum of m and log2 l rounds at the size of m. A row
// without a live key (l = 0) gives +1e30.
__device__ __forceinline__ float lse_of(float m, float l) {
  return l == 0.f ? -NEG_BIG : (float)(LN2_D * ((double)m + log2((double)l)));
}

// The producer warp's stage: K and V rows keys[0 .. n) of one (b, h)
// (kg, vg: its rows) into the stage's two tiles, zeros from row n on; the
// copies land on `full` (initialised with the warp's 32 lanes)
__device__ __forceinline__ void gather_kv(unsigned char* st, const bf16* kg, const bf16* vg,
                                          const int* keys, int n, uint64_t* full, int lane) {
  gather_rows_b128(st, kg, st + SQ_TILE_BYTES, vg, keys, n, lane);
  mbar_arrive_cp_async(full);
}

// keep_bits_stage's key_at for a gathered stage: column c holds live key
// keys[c]; columns past n draw key 0, unused
struct GatheredKeys {
  const int* keys;
  int n;
  __device__ __forceinline__ uint32_t operator()(int c) const {
    return c < n ? (uint32_t)keys[c] : 0u;
  }
};

// K1's consumer warpgroups a CTA, a 64-query tile each: four (the 256
// latent queries of a (b, h)), which share every gathered stage, at the
// 96 registers a thread that ptxas allots 544 threads; with dropout two,
// at 168 (its Philox draws spilled at 128)
__host__ __device__ constexpr int k1w_consumers(bool drop) { return drop ? 2 : 4; }
__host__ __device__ constexpr int k1w_threads(bool drop) { return k1w_consumers(drop) * 128 + 32; }
constexpr int K1W_STAGES = 4;  // K1's ring of gathered K/V stages

// K1's dynamic shared memory: the Q tiles, the ring of K/V stages, the
// barriers and the list scan's warp sums, and the split's live keys
inline size_t k1w_smem_bytes(bool drop, int NK, int splits) {
  return 1024 + (size_t)k1w_consumers(drop) * SQ_TILE_BYTES + (size_t)K1W_STAGES * SQ_STAGE_BYTES +
         256 + sizeof(int) * (size_t)round_up((NK + splits - 1) / splits, SQ_KT);
}

// K1 (bf16). Grid (query blocks of C 64-query tiles, splits, B * H), C =
// k1w_consumers: C consumer warpgroups (warpgroup w holds tile C x + w, its
// warp wl the tile's rows 16 wl + g, + 8) and a producer warp. The
// producer's first lane loads the Q tiles by TMA (rows past NQ are zeros);
// the CTA lists the live keys of its split (list_live), and the producer
// warp gathers them 64 at a time into a ring of K1W_STAGES that every
// consumer warpgroup reads. Per stage a consumer takes S = Q K^T by one
// chain of wgmma m64n64k16 over the head width (both K-major: lse at
// scores eight times larger, about 35, lands within 1e-5 of float64 on an
// H100, as close as the plain fp32 lse), masks the columns past the live
// count, runs K2's online
// softmax (the reference m moves only past a margin of 8 in the log2
// domain; e = 2^(s c - m) by one fmaf and ex2; l sums the undropped e) and
// adds P V with P from registers in K2_PARTS bf16 parts and V MN-major.
// The next stage's keep bits are drawn while P V runs. One split writes
// out and lse (a row without a live key: 0 and 1e30); with more, each CTA
// leaves its rows' unnormalized o and (m, l) in fp32 for
// smallq_merge_kernel.
template <bool DROP>
__global__ void __launch_bounds__(k1w_threads(DROP), 1)
smallq_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                        bf16* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ part_o,
                        float2* __restrict__ part_ml, int H, int NQ, int NK, int splits,
                        float scale_log2, Dropout drop) {
  constexpr int C = k1w_consumers(DROP);
  extern __shared__ unsigned char sqw_smem[];
  unsigned char* base = align1024(sqw_smem);
  unsigned char* qs = base;  // tile w at qs + w SQ_TILE_BYTES
  unsigned char* ring = base + C * SQ_TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)K1W_STAGES * SQ_STAGE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;            // [K1W_STAGES]: the producer warp's copies
  uint64_t* empty = full + K1W_STAGES;  // [K1W_STAGES]: every consumer warp
  int* wsum = reinterpret_cast<int*>(bars + 16);  // the list scan's warp sums
  int* Is = wsum + 32;                            // the split's live keys

  const int qb = blockIdx.x, split = blockIdx.y, bh = blockIdx.z, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nact = min(C, (NQ + SQ_QT - 1) / SQ_QT - qb * C);  // warpgroups with a tile
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < K1W_STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * nact);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == C * 128) {  // the Q tiles land while the live keys are listed
    mbar_expect_tx(q_full, nact * SQ_TILE_BYTES);
    for (int w = 0; w < nact; ++w)
      tma_load_3d(qs + w * SQ_TILE_BYTES, &qmap, q_full, 0, (qb * C + w) * SQ_QT, bh);
  }
  int beg, end;
  list_live(mask + (size_t)b * NK, NK, Is, wsum,
            [&](int total, int& b0, int& e0) { split_range(total, split, splits, b0, e0); },
            beg, end);
  const int* keys = Is;
  const int n = end - beg, ntiles = (n + SQ_KT - 1) / SQ_KT;

  if (warp == 4 * C) {  // the producer warp
    const bf16* kg = k + (size_t)bh * NK * TC_DH;
    const bf16* vg = v + (size_t)bh * NK * TC_DH;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % K1W_STAGES;
      mbar_wait(&empty[s], ((t / K1W_STAGES) & 1) ^ 1);
      unsigned char* st = ring + (size_t)s * SQ_STAGE_BYTES;
      gather_kv(st, kg, vg, keys + t * SQ_KT, min(SQ_KT, n - t * SQ_KT), &full[s], lane);
    }
    cp_async_wait<0>();
    return;
  }

  // a consumer warpgroup (its index as the compiler can see it is
  // warp-uniform)
  const int wg = __shfl_sync(FULL, warp >> 2, 0), wl = warp & 3, g = lane >> 2, tq = lane & 3;
  if (wg >= nact) return;  // past the last query tile
  const int row0 = (qb * C + wg) * SQ_QT + wl * 16 + g;  // rows row0 and row0 + 8 of (b, h)
  uint32_t prow[2] = {0u, 0u};                          // their Philox rows
  if (DROP) {
    const uint32_t r = (uint32_t)bh * (uint32_t)NQ + (uint32_t)row0;
    prow[0] = drop.philox_row(r);
    prow[1] = drop.philox_row(r + 8);
  }
  uint32_t kbits = 0u;  // the stage's keep bits, bit i for element i
  if (DROP && ntiles > 0)
    kbits = keep_bits_stage<K1_DRAW_UNROLL>(drop, prow, lane, GatheredKeys{keys, n});
  mbar_wait(q_full, 0);
  const uint64_t dQ = wg_desc(qs + wg * SQ_TILE_BYTES);
  float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % K1W_STAGES, nt = min(SQ_KT, n - t * SQ_KT);
    mbar_wait(&full[s], (t / K1W_STAGES) & 1);
    fence_proxy_async();  // cp.async wrote the stage
    const unsigned char* st = ring + (size_t)s * SQ_STAGE_BYTES;
    const uint64_t dK = wg_desc(st), dV = wg_desc(st + SQ_TILE_BYTES);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < TC_DH / 16; ++k16)
      wgmma_m64n64k16(sc, wg_desc_at(dQ, 32 * k16), wg_desc_at(dK, 32 * k16), k16 > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(sc);
    if (nt < SQ_KT) {  // the columns past the live count
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if ((i >> 2) * 8 + 2 * tq + (i & 1) >= nt) sc[i] = -INFINITY;
    }
    // the rows' maxima and sums by trees (short dependence chains), K2's
    float mx[2][SQ_KT / 8];
#pragma unroll
    for (int j = 0; j < SQ_KT / 8; ++j) {
      mx[0][j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
      mx[1][j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
    }
#pragma unroll
    for (int w = SQ_KT / 16; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        mx[0][j] = fmaxf(mx[0][j], mx[0][j + w]);
        mx[1][j] = fmaxf(mx[1][j], mx[1][j + w]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = mx[h][0];
      x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
      x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
      x *= scale_log2;  // finite: column 0 of a stage is live
      alpha[h] = 1.f;
      if (x > m[h] + K2W_RESCALE) {
        alpha[h] = exp2_ftz(m[h] - x);  // 0 on the first stage
        m[h] = x;
      }
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
    float sm[2][SQ_KT / 8];  // the undropped e, the denominator's
#pragma unroll
    for (int j = 0; j < SQ_KT / 8; ++j) {
      sm[0][j] = sc[4 * j] + sc[4 * j + 1];
      sm[1][j] = sc[4 * j + 2] + sc[4 * j + 3];
    }
#pragma unroll
    for (int w = SQ_KT / 16; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        sm[0][j] += sm[0][j + w];
        sm[1][j] += sm[1][j + w];
      }
    l[0] = l[0] * alpha[0] + sm[0][0];
    l[1] = l[1] * alpha[1] + sm[1][0];
    if (DROP) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= (kbits >> i) & 1u ? drop.keep_scale : 0.f;
    }
    uint32_t pa[K2_PARTS][4][4];
    wg_a_parts<K2_PARTS>(sc, pa);
    wgmma_fence();
    wgmma_fence_regs(o);
    wg_ab64<K2_PARTS>(o, pa, dV, true);  // O += P V, V MN-major
    wgmma_commit();
    if (DROP && t + 1 < ntiles)  // the next stage's keep bits while P V runs
      kbits = keep_bits_stage<K1_DRAW_UNROLL>(
          drop, prow, lane, GatheredKeys{keys + (t + 1) * SQ_KT, n - (t + 1) * SQ_KT});
    wgmma_wait<0>();
    wgmma_fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= NQ) continue;
    if (splits == 1) {
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
      bf16* dst = out + ((size_t)bh * NQ + row) * TC_DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < TC_DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      if (tq == 0) lse[(size_t)bh * NQ + row] = lse_of(m[h], l[h]);
    } else {
      const size_t pr = ((size_t)bh * splits + split) * NQ + row;
      float* dst = part_o + pr * TC_DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < TC_DH / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (tq == 0) part_ml[pr] = make_float2(m[h], l[h]);
    }
  }
}

// K1's merge of the splits, a warp per query row, in split order (so two
// calls give the same bits): M = max m_s, l = sum l_s 2^(m_s - M),
// out = sum o_s 2^(m_s - M) / l, lse from (M, l).
__global__ void __launch_bounds__(256)
smallq_merge_kernel(const float* __restrict__ part_o, const float2* __restrict__ part_ml,
                    bf16* __restrict__ out, float* __restrict__ lse, int rows, int NQ,
                    int splits) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t p0 = (size_t)(row / NQ) * splits * NQ + row % NQ;  // split s at p0 + s NQ
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[p0 + (size_t)s * NQ].x);
  float l = 0.f, o0 = 0.f, o1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[p0 + (size_t)s * NQ];
    if (ml.y == 0.f) continue;  // a split without a live key
    const float w = exp2f(ml.x - mx);
    const float2 o = *reinterpret_cast<const float2*>(part_o + (p0 + (size_t)s * NQ) * TC_DH +
                                                      2 * lane);
    l = fmaf(ml.y, w, l);
    o0 = fmaf(o.x, w, o0);
    o1 = fmaf(o.y, w, o1);
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * TC_DH + 2 * lane) =
      __floats2bfloat162_rn(o0 * inv, o1 * inv);
  if (lane == 0) lse[row] = lse_of(mx, l);
}

// The splits of a K1 or K6 dq launch of `ctas` CTAs a split over `rows`
// query rows: the S (at most SQ_MAX_SPLITS) whose launch ends soonest when
// the card runs `slots` CTAs at a time, each split walking ceil(tiles / S)
// stages (tiles over all NK keys: the live count is on the device only)
// after a start (its first loads and the live list) costed as three, with
// the merge costed as two stages and one more for each 16384 rows of fp32
// partials it reads. (Without the start, K6's dq pass split 16f's keys in
// two and ran 0.061 ms where one split took 0.048, and at two it split
// 128f's six ways for nothing; without the rows, K1 split a 16f batch
// five ways and moved 84 MB through its merge: scripts/k1_k6_variants.py
// times every split count.)
inline int live_splits(int ctas, int NK, int slots, long rows) {
  const int tiles = (NK + SQ_KT - 1) / SQ_KT;
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= SQ_MAX_SPLITS && s <= tiles; ++s) {
    const long waves = ((long)ctas * s + slots - 1) / slots;
    const long cost =
        waves * ((tiles + s - 1) / s + 3) + (s > 1 ? 2 + (s * rows + 16383) / 16384 : 0);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// live_splits for `ctas` CTAs of kern (`threads`, smem bytes) over NK keys
// and `rows` query rows on the current card, with the CTAs an SM that the
// card fits. Cached per (kernel, card, ctas, NK, rows), since the plan runs
// on every call: the key holds every input of live_splits, so an evicted
// entry is planned again to the same count, and the scratch that
// mebt_smallq_scratch_bytes sized for a shape always fits its launch.
template <typename Kern>
inline cudaError_t live_plan(Kern kern, int threads, size_t smem, int ctas, int NK, long rows,
                             int& splits) {
  constexpr int N = 64;
  static const void* keys[N];
  static int devs[N], cs[N], nks[N], val[N], used = 0, next = 0;
  static long rs[N];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key && devs[i] == dev && cs[i] == ctas && nks[i] == NK && rs[i] == rows) {
      splits = val[i];
      return cudaSuccess;
    }
  int sms = 0, smem_sm = 0, optin = 0, per_sm = 0;
  e = card_shape(sms, smem_sm, optin);
  if (e == cudaSuccess) e = opt_in_smem(kern);
  if (e == cudaSuccess) e = blocks_per_sm(kern, threads, smem, per_sm);
  if (e != cudaSuccess) return e;
  splits = live_splits(ctas, NK, sms * (per_sm > 0 ? per_sm : 1), rows);
  keys[next] = key;
  devs[next] = dev;
  cs[next] = ctas;
  nks[next] = NK;
  rs[next] = rows;
  val[next] = splits;
  next = (next + 1) % N;
  if (used < N) ++used;
  return cudaSuccess;
}

// K1's splits for these shapes, planned for the instantiation's own CTA
// shape (with dropout half the query rows a CTA, one CTA an SM at 168
// registers: at 16f training it gains from two splits where the kernel
// without dropout does not, scripts/k1_k6_variants.py's sweep)
template <bool DROP>
inline cudaError_t k1_plan(int B, int H, int NQ, int NK, int& splits) {
  constexpr int qrows = k1w_consumers(DROP) * SQ_QT;  // query rows a CTA
  return live_plan(smallq_fwd_wgmma_kernel<DROP>, k1w_threads(DROP),
                   k1w_smem_bytes(DROP, NK, 1), (NQ + qrows - 1) / qrows * B * H, NK,
                   (long)B * H * NQ, splits);
}

// Bytes of K1's scratch: each split's o (fp32, TC_DH a row) and (m, l) a
// query row (none at one split)
inline size_t k1_scratch_bytes(int B, int H, int NQ, int splits) {
  return splits == 1 ? 0 : (size_t)B * H * splits * NQ * (TC_DH * sizeof(float) + sizeof(float2));
}

template <bool DROP>
cudaError_t launch_smallq_wgmma(const void* q, const void* k, const void* v, const void* mask,
                                void* out, void* lse, void* part, int B, int H, int NQ, int NK,
                                float scale, Dropout drop, cudaStream_t stream) {
  if (NQ == 0 || B * H == 0) return cudaSuccess;
  int splits = 1;
  cudaError_t e = k1_plan<DROP>(B, H, NQ, NK, splits);
  auto kern = smallq_fwd_wgmma_kernel<DROP>;
  if (e == cudaSuccess) e = opt_in_smem(kern);
  const uint64_t BH = (uint64_t)B * H, row = TC_DH * sizeof(bf16);
  const uint64_t qdims[3] = {TC_DH, (uint64_t)NQ, BH}, qbytes[2] = {row, row * NQ};
  const uint32_t qbox[3] = {TC_DH, SQ_QT, 1};
  CUtensorMap qm;
  if (e == cudaSuccess) e = tma_map_bf16(qm, q, 3, qdims, qbytes, qbox);
  if (e != cudaSuccess) return e;
  const size_t rows = (size_t)BH * NQ;
  float* part_o = splits > 1 ? static_cast<float*>(part) : nullptr;
  float2* part_ml = splits > 1 ? reinterpret_cast<float2*>(part_o + rows * splits * TC_DH) : nullptr;
  constexpr int qrows = k1w_consumers(DROP) * SQ_QT;  // query rows a CTA
  const dim3 grid((NQ + qrows - 1) / qrows, splits, (unsigned)BH);
  kern<<<grid, k1w_threads(DROP), k1w_smem_bytes(DROP, NK, splits), stream>>>(
      qm, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse),
      part_o, part_ml, H, NQ, NK, splits, scale * LOG2E, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  smallq_merge_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      part_o, part_ml, static_cast<bf16*>(out), static_cast<float*>(lse), (int)rows, NQ, splits);
  return cudaGetLastError();
}

// K6 pass 1's dynamic shared memory: the Q and g tiles, the ring of K/V
// stages, the barriers
constexpr size_t k6w_dq_smem_bytes() {
  return 1024 + 2 * SQ_TILE_BYTES + (size_t)K6W_DQ_STAGES * SQ_STAGE_BYTES + 128;
}

// K6 pass 1 (bf16): K7's dq sweep over gathered stages. Grid (query tiles
// of 64, key splits, B * H), 160 threads as K1's. The producer's first
// lane loads the Q and g tiles by TMA; the producer warp gathers the
// split's live K/V rows (the pre-pass's list) into the ring. The consumer
// warpgroup takes D = rowsum(g out) in fp32 and L = lse log2(e) as an fp32
// pair (hi, lo) from a double product, then per stage S = Q K^T and dP =
// g V^T (wgmma, K-major), p = 2^(s c - hi - lo), ds = p (dP keep - D)
// scale, and the stage's ds K (ds from registers in K6_PARTS bf16 parts,
// K MN-major) summed apart in the accumulator and added to dq in fp32 (over
// thousands of keys the tensor cores' own sums would drop small products'
// low bits). Split 0 leaves (hi, lo) and D a row for pass 2, and every
// split with dropout its stages' keep bits (a word per 32 live positions,
// each bit drawn once here, the next stage's while the products run). One
// split writes dq in bf16; with more, each leaves its fp32 sums for
// smallq_bwd_dq_merge_kernel (split z at dq_part + z B H NQ Dh).
// K6 dq pass: CTAs an SM, three at 128 registers a thread; with dropout
// two, at 168 (its Philox draws)
__host__ __device__ constexpr int k6w_dq_ctas_per_sm(bool drop) { return drop ? 2 : 3; }

template <bool DROP>
__global__ void __launch_bounds__(SQ_THREADS, k6w_dq_ctas_per_sm(DROP))
smallq_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap gmap, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ g,
                           const bf16* __restrict__ out, const float* __restrict__ lse,
                           const int* __restrict__ live, bf16* __restrict__ dq,
                           float* __restrict__ dq_part, float2* __restrict__ lse2,
                           float* __restrict__ dvec, uint32_t* __restrict__ keep, int H, int NQ,
                           int NK, int splits, float scale, float scale_log2, Dropout drop) {
  extern __shared__ unsigned char sqw_smem[];
  unsigned char* base = align1024(sqw_smem);
  unsigned char* qg = base;  // the Q tile, then the g tile
  unsigned char* ring = base + 2 * SQ_TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)K6W_DQ_STAGES * SQ_STAGE_BYTES);
  uint64_t* qg_full = bars;
  uint64_t* full = bars + 1;           // [K6W_DQ_STAGES]: the producer warp's copies
  uint64_t* empty = full + K6W_DQ_STAGES;  // [K6W_DQ_STAGES]: the 4 consumer warps

  const int qt = blockIdx.x, split = blockIdx.y, bh = blockIdx.z, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* lrow = live + (size_t)b * (NK + 1);
  int beg, end;
  split_range(lrow[0], split, splits, beg, end);
  const int* keys = lrow + 1 + beg;
  const int n = end - beg, ntiles = (n + SQ_KT - 1) / SQ_KT;
  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < K6W_DQ_STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qg_full, 2 * SQ_TILE_BYTES);
      tma_load_3d(qg, &qmap, qg_full, 0, qt * SQ_QT, bh);
      tma_load_3d(qg + SQ_TILE_BYTES, &gmap, qg_full, 0, qt * SQ_QT, bh);
    }
    const bf16* kg = k + (size_t)bh * NK * TC_DH;
    const bf16* vg = v + (size_t)bh * NK * TC_DH;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % K6W_DQ_STAGES;
      mbar_wait(&empty[s], ((t / K6W_DQ_STAGES) & 1) ^ 1);
      gather_kv(ring + (size_t)s * SQ_STAGE_BYTES, kg, vg, keys + t * SQ_KT,
                min(SQ_KT, n - t * SQ_KT), &full[s], lane);
    }
    cp_async_wait<0>();
    return;
  }

  const int wl = warp, gr = lane >> 2, tq = lane & 3;
  const int row0 = qt * SQ_QT + wl * 16 + gr;  // rows row0 and row0 + 8 of (b, h)
  const size_t rb = (size_t)bh * NQ;
  // D of the warp's 16 rows: lane 2 r + x sums row r's columns 32 x .. 32 x + 31
  float dsum = 0.f;
  {
    const int r = qt * SQ_QT + wl * 16 + (lane >> 1), c0 = (lane & 1) * 32;
    if (r < NQ) {
      const uint4* og = reinterpret_cast<const uint4*>(out + (rb + r) * TC_DH + c0);
      const uint4* gg = reinterpret_cast<const uint4*>(g + (rb + r) * TC_DH + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 a = og[i], c = gg[i];
        const uint32_t av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dsum = fmaf(bf_lo(av[j]), bf_lo(cv[j]), dsum);
          dsum = fmaf(bf_hi(av[j]), bf_hi(cv[j]), dsum);
        }
      }
    }
  }
  dsum += __shfl_xor_sync(FULL, dsum, 1);
  float lh[2], ll[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    D[h] = __shfl_sync(FULL, dsum, 2 * (gr + 8 * h));
    lh[h] = INFINITY;  // rows past NQ: p = 0
    ll[h] = 0.f;
    if (row < NQ) {
      const double L = (double)lse[rb + row] * LOG2E_D;
      lh[h] = (float)L;
      ll[h] = (float)(L - (double)lh[h]);
      if (split == 0 && tq == 0) {
        lse2[rb + row] = make_float2(lh[h], ll[h]);
        dvec[rb + row] = D[h];
      }
    }
  }
  const int nkw = (NK + 31) / 32;
  uint32_t prow[2] = {0u, 0u};  // the rows' Philox rows
  if (DROP) {
    prow[0] = drop.philox_row((uint32_t)(rb + row0));
    prow[1] = drop.philox_row((uint32_t)(rb + row0 + 8));
  }
  mbar_wait(qg_full, 0);
  const uint64_t dQ = wg_desc(qg), dG = wg_desc(qg + SQ_TILE_BYTES);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % K6W_DQ_STAGES, nt = min(SQ_KT, n - t * SQ_KT);
    mbar_wait(&full[s], (t / K6W_DQ_STAGES) & 1);
    fence_proxy_async();  // cp.async wrote the stage
    const unsigned char* st = ring + (size_t)s * SQ_STAGE_BYTES;
    const uint64_t dK = wg_desc(st), dV = wg_desc(st + SQ_TILE_BYTES);
    float sc[32], dp[32];
    wgmma_fence();
    wg_abt64(sc, dQ, dK);
    wg_abt64(dp, dG, dV);
    wgmma_commit();
    uint32_t kb = 0u;  // drawn while the products run
    if (DROP)
      kb = keep_bits_stage<K6_DRAW_UNROLL>(drop, prow, lane, GatheredKeys{keys + t * SQ_KT, nt});
    wgmma_wait<0>();
    wgmma_fence_regs(sc);
    wgmma_fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * tq + (i & 1);
      const float p = c < nt ? exp2_ftz(fmaf(sc[i], scale_log2, -lh[h]) - ll[h]) : 0.f;
      float x = dp[i];
      if (DROP) x = (kb >> i) & 1u ? x * drop.keep_scale : 0.f;
      dp[i] = p * (x - D[h]) * scale;
    }
    if (DROP) {
      // the stage's two words of each row: word w holds live positions
      // beg + 64 t + 32 w .., element i at bit (i >> 2) % 4 * 8 + 2 tq + (i & 1)
      uint32_t wd[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        wd[(i >> 1) & 1][i >> 4] |= ((kb >> i) & 1u) << (((i >> 2) & 3) * 8 + 2 * tq + (i & 1));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          wd[h][w] |= __shfl_xor_sync(FULL, wd[h][w], 1);
          wd[h][w] |= __shfl_xor_sync(FULL, wd[h][w], 2);
        }
      const int h = tq >> 1, w = tq & 1, kw = (beg + t * SQ_KT) / 32 + w;  // lane tq stores one
      if (row0 + 8 * h < NQ && kw < nkw)
        keep[(rb + row0 + 8 * h) * nkw + kw] = h ? (w ? wd[1][1] : wd[1][0])
                                                 : (w ? wd[0][1] : wd[0][0]);
    }
    uint32_t da[K6_PARTS][4][4];
    wg_a_parts<K6_PARTS>(dp, da);
    float part[32];
    wgmma_fence();
    wg_ab64<K6_PARTS>(part, da, dK, false);  // the stage's ds K, K MN-major
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= NQ) continue;
    if (splits == 1) {
      bf16* dst = dq + (rb + row) * TC_DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < TC_DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    } else {
      float* dst = dq_part + ((size_t)split * gridDim.z * NQ + rb + row) * TC_DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < TC_DH / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// dq (n elements) = the sum of the key splits' fp32 partials, added in
// split order (bit-repeatable), rounded to bf16 once; four a thread
__global__ void __launch_bounds__(256)
smallq_bwd_dq_merge_kernel(const float* __restrict__ part, bf16* __restrict__ dq, size_t n,
                           int splits) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(part + (size_t)z * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(dq + i);
  dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
  dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

// K6 pass 2 (bf16): K7's largeq_bwd_dkdv_wgmma_kernel over 64 live
// positions of a batch row. Grid (ceil(NK / 64), B * H): CTA x first zeroes
// the dk, dv rows of the dead keys among keys [64 x, 64 x + 64), so that
// every row is written once, then, if the row has live positions from
// 64 x on, its producer warp gathers their K and V rows (the pre-pass's
// list; zeros past the live count) and streams each 64-query tile's Q and
// g by TMA into K7's ring, with (hi, lo), D and the keep words at the
// CTA's positions beside them. The consumer warpgroup runs K7's tile (S^T
// = K Q^T and dP^T = V g^T, then dv += (P^T keep) g and dk += dS^T Q with
// the A operand from registers in K7_PARTS bf16 parts, each query tile's
// products summed apart and added to the fp32 sums in shared memory), and
// the rows go back to their keys. Two CTAs an SM, as K7's. (A CTA walking
// several live tiles, the next tile's K and V gathered while this one's
// run, was no faster at 128f and slower at 16f, where its fewer CTAs left
// SMs idle, and spilled.)
template <bool DROP>
__global__ void __launch_bounds__(K7W_THREADS, 2)
smallq_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap gmap,
                             const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const uint8_t* __restrict__ mask, const int* __restrict__ live,
                             const float2* __restrict__ lse2, const float* __restrict__ dvec,
                             const uint32_t* __restrict__ keep, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int H, int NQ, int NK, float scale,
                             float scale_log2, Dropout drop) {
  const int bh = blockIdx.y, b = bh / H, p0 = blockIdx.x * SQ_KT, nkw = (NK + 31) / 32;
  const size_t koff = (size_t)bh * NK * TC_DH;
  const uint8_t* mrow = mask + (size_t)b * NK;
  for (int i = threadIdx.x; i < SQ_KT * (TC_DH / 8); i += blockDim.x) {  // dead keys' rows
    const int key = p0 + i / (TC_DH / 8), c = (i % (TC_DH / 8)) * 8;
    if (key < NK && mrow[key] == 0) {
      *reinterpret_cast<uint4*>(dk + koff + (size_t)key * TC_DH + c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + koff + (size_t)key * TC_DH + c) = make_uint4(0, 0, 0, 0);
    }
  }
  const int* lrow = live + (size_t)b * (NK + 1);
  const int n = min(SQ_KT, lrow[0] - p0);
  if (n <= 0) return;
  const int* keys = lrow + 1 + p0;

  extern __shared__ unsigned char sqw_smem[];
  unsigned char* base = align1024(sqw_smem);
  unsigned char* kt = base;
  unsigned char* vt = base + K7W_TILE_BYTES;
  unsigned char* ring = base + 2 * K7W_TILE_BYTES;
  float2* sums = reinterpret_cast<float2*>(ring + (size_t)K7W_STAGES * K7W_STAGE_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sums + 2 * K7W_SUM_BYTES / sizeof(float2));
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + K7W_STAGES;
  const int ntiles = (NQ + K7W_QT - 1) / K7W_QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 32);  // the producer warp's gathers
    for (int s = 0; s < K7W_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the TMA's expect_tx and 31 lanes' side rows
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    gather_rows_b128(kt, k + koff, vt, v + koff, keys, n, lane);
    mbar_arrive_cp_async(kv_full);
    const int w0 = p0 / 32;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % K7W_STAGES;
      mbar_wait(&empty[s], ((t / K7W_STAGES) & 1) ^ 1);
      unsigned char* st = ring + (size_t)s * K7W_STAGE_BYTES;
      float2* ls = reinterpret_cast<float2*>(st + 2 * K7W_TILE_BYTES);
      float* ds = reinterpret_cast<float*>(ls + K7W_QT);
      uint32_t* ms = reinterpret_cast<uint32_t*>(ds + K7W_QT);
      for (int qq = lane; qq < K7W_QT; qq += 32) {
        const int row = t * K7W_QT + qq;
        const bool in = row < NQ;
        const size_t r = (size_t)bh * NQ + (in ? row : 0);
        ls[qq] = in ? lse2[r] : make_float2(0.f, 0.f);
        ds[qq] = in ? dvec[r] : 0.f;
        if (DROP) {
#pragma unroll
          for (int w = 0; w < 2; ++w)
            ms[2 * qq + w] = in && w0 + w < nkw ? keep[r * nkw + w0 + w] : 0u;
        }
      }
      if (lane == 0) {  // arrives once with the bytes TMA will bring
        mbar_expect_tx(&full[s], 2 * K7W_TILE_BYTES);
        tma_load_3d(st, &qmap, &full[s], 0, t * K7W_QT, bh);
        tma_load_3d(st + K7W_TILE_BYTES, &gmap, &full[s], 0, t * K7W_QT, bh);
      } else {
        mbar_arrive(&full[s]);  // after this lane's side rows (release)
      }
    }
    cp_async_wait<0>();
    return;
  }

  const int wl = warp, g = lane >> 2, tq = lane & 3;
  const int kw = wl >> 1, kbit = (wl & 1) * 16 + g;  // the keep word and bit of key row g
  const uint64_t dK = wg_desc(kt), dV = wg_desc(vt);
  // the dk and dv sums in shared memory (K7's: the thread's own 32 each)
  float2* dk_at = sums + wl * 16 * 32 + lane;
  float2* dv_at = dk_at + K7W_SUM_BYTES / sizeof(float2);
#pragma unroll
  for (int i = 0; i < 16; ++i) dk_at[i * 32] = dv_at[i * 32] = make_float2(0.f, 0.f);
  mbar_wait(kv_full, 0);
  fence_proxy_async();  // cp.async wrote K and V
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % K7W_STAGES;
    mbar_wait(&full[s], (t / K7W_STAGES) & 1);
    const unsigned char* st = ring + (size_t)s * K7W_STAGE_BYTES;
    const float2* ls = reinterpret_cast<const float2*>(st + 2 * K7W_TILE_BYTES);
    const float* ds = reinterpret_cast<const float*>(ls + K7W_QT);
    const uint32_t* ms = reinterpret_cast<const uint32_t*>(ds + K7W_QT);
    const uint64_t dQ = wg_desc(st), dG = wg_desc(st + K7W_TILE_BYTES);
    float sc[32], dp[32];
    wgmma_fence();
    wg_abt64(sc, dK, dQ);  // S^T: live keys x queries
    wg_abt64(dp, dV, dG);  // dP^T = V g^T over the live keys
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(sc);
    wgmma_fence_regs(dp);
    // element 4 j + e: key row g + 8 (e >> 1), query 8 j + 2 tq + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      const float4 L = *reinterpret_cast<const float4*>(ls + c);  // (hi, lo) of c, c + 1
      const float2 Dc = *reinterpret_cast<const float2*>(ds + c);
      uint32_t w[2] = {0u, 0u};
      if (DROP) {
        w[0] = ms[2 * c + kw];
        w[1] = ms[2 * (c + 1) + kw];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, cc = e & 1;
        const float p =
            exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -(cc ? L.z : L.x)) - (cc ? L.w : L.y));
        float kp = 1.f;
        if (DROP) kp = (w[cc] >> (kbit + 8 * h)) & 1u ? drop.keep_scale : 0.f;
        sc[4 * j + e] = p * kp;
        dp[4 * j + e] = p * (dp[4 * j + e] * kp - (cc ? Dc.y : Dc.x)) * scale;
      }
    }
    float tile[32];
    uint32_t a[K7_PARTS][4][4];
    wg_a_parts<K7_PARTS>(sc, a);
    wgmma_fence();
    wg_ab64<K7_PARTS>(tile, a, dG, false);  // P^T g: the live keys' dv
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(tile);
    add_sums(dv_at, tile);
    wg_a_parts<K7_PARTS>(dp, a);
    wgmma_fence();
    wg_ab64<K7_PARTS>(tile, a, dQ, false);  // dS^T Q: their dk
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(tile);
    add_sums(dk_at, tile);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  // the rows back to their keys; rows past n (zero K and V) are dropped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wl * 16 + g + 8 * h;
    if (r >= n) continue;
    const size_t off = koff + (size_t)keys[r] * TC_DH + 2 * tq;
#pragma unroll
    for (int j = 0; j < TC_DH / 8; ++j) {
      const float2 k2 = dk_at[(2 * j + h) * 32], v2 = dv_at[(2 * j + h) * 32];
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) = __floats2bfloat162_rn(k2.x, k2.y);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) = __floats2bfloat162_rn(v2.x, v2.y);
    }
  }
}

// K6's dq-pass splits for these shapes, planned for the instantiation's
// own occupancy (with dropout two CTAs an SM, not three)
template <bool DROP>
inline cudaError_t k6_plan(int B, int H, int NQ, int NK, int& splits) {
  return live_plan(smallq_bwd_dq_wgmma_kernel<DROP>, SQ_THREADS, k6w_dq_smem_bytes(),
                   (NQ + SQ_QT - 1) / SQ_QT * B * H, NK, (long)B * H * NQ, splits);
}

// K6's bf16 scratch, in this order: each row's (hi, lo) and D, each batch
// row's live list (NK + 1 words), with dropout the keep words, with more
// than one key split the dq partials (at a 16-byte boundary)
inline size_t k6_scratch_bytes(int B, int H, int NQ, int NK, bool dropout, int splits,
                               size_t* part_at = nullptr) {
  const size_t rows = (size_t)B * H * NQ;
  const size_t lists = rows * (sizeof(float2) + sizeof(float)) + (size_t)B * (NK + 1) * sizeof(int) +
                       (dropout ? rows * ((NK + 31) / 32) * sizeof(uint32_t) : 0);
  const size_t at = (lists + 15) / 16 * 16;
  if (part_at != nullptr) *part_at = at;
  return splits > 1 ? at + (size_t)splits * rows * TC_DH * sizeof(float) : lists;
}

template <bool DROP>
cudaError_t launch_smallq_bwd_wgmma(const void* q, const void* k, const void* v,
                                    const void* mask, const void* lse, const void* out,
                                    const void* g, void* dq, void* dk, void* dv, void* scratch,
                                    int B, int H, int NQ, int NK, float scale, Dropout drop,
                                    cudaStream_t stream) {
  if (B * H == 0) return cudaSuccess;
  const size_t kv_bytes = (size_t)B * H * NK * TC_DH * sizeof(bf16);
  if (NQ == 0) {  // no query: every gradient of K and V is 0
    cudaError_t e = cudaMemsetAsync(dk, 0, kv_bytes, stream);
    return e == cudaSuccess ? cudaMemsetAsync(dv, 0, kv_bytes, stream) : e;
  }
  const int BH = B * H;
  int splits = 1;
  cudaError_t e = k6_plan<DROP>(B, H, NQ, NK, splits);
  auto kdq = smallq_bwd_dq_wgmma_kernel<DROP>;
  auto kdkdv = smallq_bwd_dkdv_wgmma_kernel<DROP>;
  if (e == cudaSuccess) e = opt_in_smem(kdq);
  if (e == cudaSuccess) e = opt_in_smem(kdkdv);
  const uint64_t row = TC_DH * sizeof(bf16);
  const uint64_t qdims[3] = {TC_DH, (uint64_t)NQ, (uint64_t)BH}, qbytes[2] = {row, row * NQ};
  const uint32_t box[3] = {TC_DH, SQ_QT, 1};
  CUtensorMap qm, gm;
  if (e == cudaSuccess) e = tma_map_bf16(qm, q, 3, qdims, qbytes, box);
  if (e == cudaSuccess) e = tma_map_bf16(gm, g, 3, qdims, qbytes, box);
  if (e != cudaSuccess) return e;
  const size_t rows = (size_t)BH * NQ;
  size_t part_at = 0;
  k6_scratch_bytes(B, H, NQ, NK, DROP, splits, &part_at);
  unsigned char* sp = static_cast<unsigned char*>(scratch);
  float2* lse2 = reinterpret_cast<float2*>(sp);
  float* dvec = reinterpret_cast<float*>(lse2 + rows);
  int* live = reinterpret_cast<int*>(dvec + rows);
  uint32_t* keep = DROP ? reinterpret_cast<uint32_t*>(live + (size_t)B * (NK + 1)) : nullptr;
  float* dq_part = splits > 1 ? reinterpret_cast<float*>(sp + part_at) : nullptr;
  const uint8_t* m8 = static_cast<const uint8_t*>(mask);
  smallq_bwd_live_kernel<<<B, SQ_LIVE_THREADS, 0, stream>>>(m8, live, NK);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nqt = (NQ + SQ_QT - 1) / SQ_QT;
  kdq<<<dim3(nqt, splits, BH), SQ_THREADS, k6w_dq_smem_bytes(), stream>>>(
      qm, gm, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const bf16*>(out), static_cast<const float*>(lse),
      live, static_cast<bf16*>(dq), dq_part, lse2, dvec, keep, H, NQ, NK, splits, scale,
      scale * LOG2E, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (splits > 1) {
    const size_t n = rows * TC_DH;
    smallq_bwd_dq_merge_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
        dq_part, static_cast<bf16*>(dq), n, splits);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  kdkdv<<<dim3((NK + SQ_KT - 1) / SQ_KT, BH), K7W_THREADS, k7w_dkdv_smem_bytes(), stream>>>(
      qm, gm, static_cast<const bf16*>(k), static_cast<const bf16*>(v), m8, live, lse2, dvec,
      keep, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, NQ, NK, scale, scale * LOG2E,
      drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: unmasked large-Q, K/V resident (fp32: FMA loops)

constexpr int K2_BQ = 32;        // query rows per CTA
constexpr int K2_THREADS = 256;  // 8 threads per query row

// Pitch of a resident K row in elements of T: one extra 32-bit word so
// that the eight threads of a row, reading eight different keys, hit
// eight different banks.
template <typename T, int DH>
__host__ __device__ constexpr int k2_kpitch() { return DH + (int)(4 / sizeof(T)); }

template <typename T, int DH>
size_t k2_smem_bytes(int NK) {
  return sizeof(T) * (size_t)NK * (k2_kpitch<T, DH>() + DH) +
         sizeof(float) * (size_t)K2_BQ * (DH + 1) +
         sizeof(float) * (size_t)K2_BQ * (NK + 1);
}

// Thread t owns query row r = t / 8, the score columns part + 8*i and
// the output dims j*8 + part, part = t % 8.
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(K2_THREADS)
largeq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int NQ, int NK,
              float scale, Dropout drop) {
  constexpr int KP = k2_kpitch<T, DH>();
  constexpr int P = DH + 1;
  constexpr int DPT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);            // [NK][KP]
  T* Vs = Ks + (size_t)NK * KP;                      // [NK][DH]
  float* Qs = reinterpret_cast<float*>(Vs + (size_t)NK * DH);  // [BQ][P]
  float* Ss = Qs + K2_BQ * P;                        // [BQ][NK + 1]
  const int SP = NK + 1;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * K2_BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int part = tid & 7;

  const T* qg = q + (size_t)bh * NQ * DH;
  const T* kg = k + (size_t)bh * NK * DH;
  const T* vg = v + (size_t)bh * NK * DH;

  for (int i = tid; i < NK * DH; i += K2_THREADS) {
    const int kk = i / DH, d = i % DH;
    Ks[kk * KP + d] = kg[i];
    Vs[i] = vg[i];
  }
  for (int i = tid; i < K2_BQ * DH; i += K2_THREADS) {
    const int rr = i / DH, d = i % DH;
    Qs[rr * P + d] = (q0 + rr < NQ) ? to_f(qg[(size_t)(q0 + rr) * DH + d]) : 0.f;
  }
  __syncthreads();

  float m = NEG_BIG;
  for (int j = part; j < NK; j += 8) {
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) dot = fmaf(Qs[r * P + d], to_f(Ks[j * KP + d]), dot);
    dot *= scale;
    Ss[r * SP + j] = dot;
    m = fmaxf(m, dot);
  }
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 4));
  float sum = 0.f;
  const uint32_t row_id = (uint32_t)bh * (uint32_t)NQ + (uint32_t)(q0 + r);
  for (int j = part; j < NK; j += 8) {
    const float e = expf(Ss[r * SP + j] - m);
    Ss[r * SP + j] = DROP ? e * drop.keep(row_id, (uint32_t)j) : e;
    sum += e;  // the denominator takes the undropped e
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sum += __shfl_xor_sync(FULL, sum, 2);
  sum += __shfl_xor_sync(FULL, sum, 4);
  __syncwarp();  // row r of Ss is written and read by one warp

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  for (int kk = 0; kk < NK; ++kk) {
    const float p = Ss[r * SP + kk];
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      acc[j] = fmaf(p, to_f(Vs[(size_t)kk * DH + j * 8 + part]), acc[j]);
  }
  if (q0 + r < NQ) {
    const float inv = 1.f / sum;
    T* og = out + ((size_t)bh * NQ + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) og[j * 8 + part] = from_f<T>(acc[j] * inv);
  }
}

template <typename T, int DH, bool DROP>
cudaError_t launch_largeq(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int NQ, int NK, float scale,
                          Dropout drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(DH == TC_DH, "the wgmma K2 takes Dh 64");
    return launch_largeq_wgmma<DROP>(q, k, v, out, B, H, NQ, NK, scale, drop, stream);
  } else {
    const size_t smem = k2_smem_bytes<T, DH>(NK);
    auto kern = largeq_kernel<T, DH, DROP>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((NQ + K2_BQ - 1) / K2_BQ, B * H);
    kern<<<grid, K2_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), NQ, NK, scale, drop);
    return cudaGetLastError();
  }
}


// ---------------------------------------------------------------------------
// K6 / K7, pass "dk, dv": one CTA per (b, h, 64-key tile), all queries

constexpr int BW_T = 64;         // rows and columns of a backward tile
constexpr int BW_THREADS = 256;  // 4 threads per tile row

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * BW_T * (DH + 1) + 2 * BW_T * (BW_T + 1) + 2 * BW_T) +
         sizeof(int) * BW_T;
}

// mask may be null (K7: every key is live). lse and dvec are (B, H, NQ)
// fp32: the row's logsumexp and D = rowsum(g * out). Phase 1 has thread t
// on query row t / 4 and the key columns c*4 + t%4 (as K1): it fills the
// tile of dropped probabilities Ps and of ds. Phase 2 has thread t on
// key row t / 4 and the dims j*4 + t%4: dv += Ps^T g, dk += ds^T q.
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(BW_THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int NQ, int NK, float scale,
                     Dropout drop) {
  constexpr int P = DH + 1;
  constexpr int DPT = DH / 4;
  constexpr int CPT = BW_T / 4;
  constexpr int PP = BW_T + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [T][P]
  float* Vs = Ks + BW_T * P;     // [T][P]
  float* Qs = Vs + BW_T * P;     // [T][P]
  float* Gs = Qs + BW_T * P;     // [T][P]
  float* Ps = Gs + BW_T * P;     // [T][PP] query x key
  float* Ss = Ps + BW_T * PP;    // [T][PP] ds, query x key
  float* Ls = Ss + BW_T * PP;    // [T] lse of the query rows
  float* Dv = Ls + BW_T;         // [T] D of the query rows
  int* Ms = reinterpret_cast<int*>(Dv + BW_T);  // [T] live keys

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * BW_T;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int part = tid & 3;

  const T* qg = q + (size_t)bh * NQ * DH;
  const T* gg = g + (size_t)bh * NQ * DH;
  const T* kg = k + (size_t)bh * NK * DH;
  const T* vg = v + (size_t)bh * NK * DH;
  const float* lg = lse + (size_t)bh * NQ;
  const float* dg = dvec + (size_t)bh * NQ;

  int any = 0;
  for (int i = tid; i < BW_T; i += BW_THREADS) {
    const int live =
        (k0 + i < NK) && (mask == nullptr || mask[(size_t)b * NK + k0 + i] != 0);
    Ms[i] = live;
    any |= live;
  }
  float acc_dk[DPT], acc_dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc_dk[j] = acc_dv[j] = 0.f;

  if (__syncthreads_or(any)) {  // else: no live key, dk = dv = 0
    for (int i = tid; i < BW_T * DH; i += BW_THREADS) {
      const int kk = i / DH, d = i % DH;
      const bool in = k0 + kk < NK;
      const size_t off = (size_t)(k0 + kk) * DH + d;
      Ks[kk * P + d] = in ? to_f(kg[off]) : 0.f;
      Vs[kk * P + d] = in ? to_f(vg[off]) : 0.f;
    }
    for (int q0 = 0; q0 < NQ; q0 += BW_T) {
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < BW_T * DH; i += BW_THREADS) {
        const int rr = i / DH, d = i % DH;
        const bool in = q0 + rr < NQ;
        const size_t off = (size_t)(q0 + rr) * DH + d;
        Qs[rr * P + d] = in ? to_f(qg[off]) : 0.f;
        Gs[rr * P + d] = in ? to_f(gg[off]) : 0.f;
      }
      for (int i = tid; i < BW_T; i += BW_THREADS) {
        const bool in = q0 + i < NQ;
        Ls[i] = in ? lg[q0 + i] : -NEG_BIG;  // a padded row has p = 0
        Dv[i] = in ? dg[q0 + i] : 0.f;
      }
      __syncthreads();

      const float lse_r = Ls[r], d_r = Dv[r];
      const uint32_t row_id = (uint32_t)bh * (uint32_t)NQ + (uint32_t)(q0 + r);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kk = c * 4 + part;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) {
          s = fmaf(Qs[r * P + d], Ks[kk * P + d], s);
          dp = fmaf(Gs[r * P + d], Vs[kk * P + d], dp);
        }
        const float p = Ms[kk] ? expf(s * scale - lse_r) : 0.f;
        float keep = 1.f;
        if (DROP && p != 0.f) keep = drop.keep(row_id, (uint32_t)(k0 + kk));
        Ps[r * PP + kk] = p * keep;
        Ss[r * PP + kk] = p * (dp * keep - d_r) * scale;
      }
      __syncthreads();

      for (int qq = 0; qq < BW_T; ++qq) {
        const float pv = Ps[qq * PP + r];
        const float ds = Ss[qq * PP + r];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          acc_dv[j] = fmaf(pv, Gs[qq * P + j * 4 + part], acc_dv[j]);
          acc_dk[j] = fmaf(ds, Qs[qq * P + j * 4 + part], acc_dk[j]);
        }
      }
    }
  }

  if (k0 + r < NK) {
    T* dkg = dk + ((size_t)bh * NK + k0 + r) * DH;
    T* dvg = dv + ((size_t)bh * NK + k0 + r) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dkg[j * 4 + part] = from_f<T>(acc_dk[j]);
      dvg[j * 4 + part] = from_f<T>(acc_dv[j]);
    }
  }
}

template <typename T, int DH, bool DROP>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* g, const void* mask, const void* lse,
                        const void* dvec, void* dk, void* dv, int B, int H,
                        int NQ, int NK, float scale, Dropout drop,
                        cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes<DH>();
  auto kern = attn_bwd_dkdv_kernel<T, DH, DROP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((NK + BW_T - 1) / BW_T, B * H);
  kern<<<grid, BW_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dk), static_cast<T*>(dv),
      H, NQ, NK, scale, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6, pass "dq": one CTA per (b, h, 64-query tile), key tiles as in K1

template <int DH>
constexpr size_t k6_dq_smem_bytes() {
  return sizeof(float) * (4 * BW_T * (DH + 1) + BW_T * (BW_T + 1)) +
         sizeof(int) * BW_T;
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(BW_THREADS)
smallq_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dq, int H,
                     int NQ, int NK, float scale, Dropout drop) {
  constexpr int P = DH + 1;
  constexpr int DPT = DH / 4;
  constexpr int CPT = BW_T / 4;
  constexpr int PP = BW_T + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [T][P]
  float* Gs = Qs + BW_T * P;     // [T][P]
  float* Ks = Gs + BW_T * P;     // [T][P]
  float* Vs = Ks + BW_T * P;     // [T][P]
  float* Ss = Vs + BW_T * P;     // [T][PP] ds, query x key
  int* Ms = reinterpret_cast<int*>(Ss + BW_T * PP);  // [T]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BW_T;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int part = tid & 3;

  const T* qg = q + (size_t)bh * NQ * DH;
  const T* gg = g + (size_t)bh * NQ * DH;
  const T* kg = k + (size_t)bh * NK * DH;
  const T* vg = v + (size_t)bh * NK * DH;
  const uint8_t* mg = mask + (size_t)b * NK;

  for (int i = tid; i < BW_T * DH; i += BW_THREADS) {
    const int rr = i / DH, d = i % DH;
    const bool in = q0 + rr < NQ;
    const size_t off = (size_t)(q0 + rr) * DH + d;
    Qs[rr * P + d] = in ? to_f(qg[off]) : 0.f;
    Gs[rr * P + d] = in ? to_f(gg[off]) : 0.f;
  }
  const bool row_in = q0 + r < NQ;
  const float lse_r = row_in ? lse[(size_t)bh * NQ + q0 + r] : -NEG_BIG;
  const float d_r = row_in ? dvec[(size_t)bh * NQ + q0 + r] : 0.f;
  const uint32_t row_id = (uint32_t)bh * (uint32_t)NQ + (uint32_t)(q0 + r);

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < NK; k0 += BW_T) {
    __syncthreads();  // the previous tile's readers are done
    int any = 0;
    for (int i = tid; i < BW_T; i += BW_THREADS) {
      const int live = (k0 + i < NK) && mg[k0 + i] != 0;
      Ms[i] = live;
      any |= live;
    }
    if (!__syncthreads_or(any)) continue;  // no live key in this tile
    for (int i = tid; i < BW_T * DH; i += BW_THREADS) {
      const int kk = i / DH, d = i % DH;
      const bool in = k0 + kk < NK;
      const size_t off = (size_t)(k0 + kk) * DH + d;
      Ks[kk * P + d] = in ? to_f(kg[off]) : 0.f;
      Vs[kk * P + d] = in ? to_f(vg[off]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int kk = c * 4 + part;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        s = fmaf(Qs[r * P + d], Ks[kk * P + d], s);
        dp = fmaf(Gs[r * P + d], Vs[kk * P + d], dp);
      }
      const float p = Ms[kk] ? expf(s * scale - lse_r) : 0.f;
      if (DROP && p != 0.f) dp *= drop.keep(row_id, (uint32_t)(k0 + kk));
      Ss[r * PP + kk] = p * (dp - d_r) * scale;
    }
    __syncwarp();  // row r of Ss is written and read by one warp

    for (int kk = 0; kk < BW_T; ++kk) {
      const float ds = Ss[r * PP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        acc[j] = fmaf(ds, Ks[kk * P + j * 4 + part], acc[j]);
    }
  }

  if (row_in) {
    T* dqg = dq + ((size_t)bh * NQ + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dqg[j * 4 + part] = from_f<T>(acc[j]);
  }
}

template <typename T, int DH, bool DROP>
cudaError_t launch_smallq_bwd(const void* q, const void* k, const void* v,
                              const void* mask, const void* lse, const void* out,
                              const void* dvec, const void* g, void* dq,
                              void* dk, void* dv, void* scratch, int B, int H,
                              int NQ, int NK, float scale, Dropout drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(DH == TC_DH, "the Hopper K6 takes Dh 64");
    return launch_smallq_bwd_wgmma<DROP>(q, k, v, mask, lse, out, g, dq, dk, dv, scratch, B, H,
                                         NQ, NK, scale, drop, stream);
  } else {
    const size_t smem = k6_dq_smem_bytes<DH>();
    auto kern = smallq_bwd_dq_kernel<T, DH, DROP>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((NQ + BW_T - 1) / BW_T, B * H);
    kern<<<grid, BW_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
        static_cast<const float*>(dvec), static_cast<T*>(dq), H, NQ, NK, scale,
        drop);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return launch_dkdv<T, DH, DROP>(q, k, v, g, mask, lse, dvec, dk, dv, B, H, NQ,
                                    NK, scale, drop, stream);
  }
}

// ---------------------------------------------------------------------------
// K7, pass "dq": K/V resident, softmax, O and D recomputed per 32 queries

// K and V both carry the padded pitch here: every thread of a query row
// reads its own key row of V for dp = g v^T.
template <typename T, int DH>
size_t k7_smem_bytes(int NK) {
  return sizeof(T) * (size_t)NK * 2 * k2_kpitch<T, DH>() +
         sizeof(float) * (size_t)K2_BQ * 2 * (DH + 1) +
         sizeof(float) * (size_t)K2_BQ * (NK + 1);
}

// Thread t owns query row r = t / 8, the key columns part + 8*i and the
// dims j*8 + part, part = t % 8 (as K2). Ss holds, in turn, the scores,
// the normalized probabilities with the sign bit set where dropout
// dropped the element, and ds.
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(K2_THREADS)
largeq_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     T* __restrict__ dq, float* __restrict__ lse,
                     float* __restrict__ dvec, int NQ, int NK, float scale,
                     Dropout drop) {
  constexpr int KP = k2_kpitch<T, DH>();
  constexpr int P = DH + 1;
  constexpr int DPT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);            // [NK][KP]
  T* Vs = Ks + (size_t)NK * KP;                      // [NK][KP]
  float* Qs = reinterpret_cast<float*>(Vs + (size_t)NK * KP);  // [BQ][P]
  float* Gs = Qs + K2_BQ * P;                        // [BQ][P]
  float* Ss = Gs + K2_BQ * P;                        // [BQ][NK + 1]
  const int SP = NK + 1;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * K2_BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int part = tid & 7;

  const T* qg = q + (size_t)bh * NQ * DH;
  const T* gg = g + (size_t)bh * NQ * DH;
  const T* kg = k + (size_t)bh * NK * DH;
  const T* vg = v + (size_t)bh * NK * DH;

  for (int i = tid; i < NK * DH; i += K2_THREADS) {
    const int kk = i / DH, d = i % DH;
    Ks[kk * KP + d] = kg[i];
    Vs[kk * KP + d] = vg[i];
  }
  for (int i = tid; i < K2_BQ * DH; i += K2_THREADS) {
    const int rr = i / DH, d = i % DH;
    const bool in = q0 + rr < NQ;
    const size_t off = (size_t)(q0 + rr) * DH + d;
    Qs[rr * P + d] = in ? to_f(qg[off]) : 0.f;
    Gs[rr * P + d] = in ? to_f(gg[off]) : 0.f;
  }
  __syncthreads();

  float m = NEG_BIG;
  for (int j = part; j < NK; j += 8) {
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) dot = fmaf(Qs[r * P + d], to_f(Ks[j * KP + d]), dot);
    dot *= scale;
    Ss[r * SP + j] = dot;
    m = fmaxf(m, dot);
  }
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 4));
  float sum = 0.f;
  for (int j = part; j < NK; j += 8) {
    const float e = expf(Ss[r * SP + j] - m);
    Ss[r * SP + j] = e;
    sum += e;
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sum += __shfl_xor_sync(FULL, sum, 2);
  sum += __shfl_xor_sync(FULL, sum, 4);
  const float inv = 1.f / sum;
  const uint32_t row_id = (uint32_t)bh * (uint32_t)NQ + (uint32_t)(q0 + r);
  for (int j = part; j < NK; j += 8) {
    float p = Ss[r * SP + j] * inv;
    if (DROP && drop.keep(row_id, (uint32_t)j) == 0.f) p = -p;  // -0.f too
    Ss[r * SP + j] = p;
  }
  __syncwarp();  // row r of Ss is written and read by one warp

  // O = (p o keep) V and D = rowsum(g o O)
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  for (int kk = 0; kk < NK; ++kk) {
    const float x = Ss[r * SP + kk];
    const float pv = DROP ? ((__float_as_uint(x) >> 31) ? 0.f : x * drop.keep_scale) : x;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      acc[j] = fmaf(pv, to_f(Vs[(size_t)kk * KP + j * 8 + part]), acc[j]);
  }
  float d_r = 0.f;
#pragma unroll
  for (int j = 0; j < DPT; ++j) d_r = fmaf(Gs[r * P + j * 8 + part], acc[j], d_r);
  d_r += __shfl_xor_sync(FULL, d_r, 1);
  d_r += __shfl_xor_sync(FULL, d_r, 2);
  d_r += __shfl_xor_sync(FULL, d_r, 4);
  __syncwarp();  // every reader of the probabilities is done

  // ds = p (dp o keep - D) scale, in place
  for (int j = part; j < NK; j += 8) {
    const float x = Ss[r * SP + j];
    float dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) dp = fmaf(Gs[r * P + d], to_f(Vs[j * KP + d]), dp);
    if (DROP) dp = (__float_as_uint(x) >> 31) ? 0.f : dp * drop.keep_scale;
    Ss[r * SP + j] = fabsf(x) * (dp - d_r) * scale;
  }
  __syncwarp();

#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  for (int kk = 0; kk < NK; ++kk) {
    const float ds = Ss[r * SP + kk];
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      acc[j] = fmaf(ds, to_f(Ks[(size_t)kk * KP + j * 8 + part]), acc[j]);
  }
  if (q0 + r < NQ) {
    T* dqg = dq + ((size_t)bh * NQ + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dqg[j * 8 + part] = from_f<T>(acc[j]);
    if (part == 0) {
      lse[(size_t)bh * NQ + q0 + r] = m + logf(sum);
      dvec[(size_t)bh * NQ + q0 + r] = d_r;
    }
  }
}

template <typename T, int DH, bool DROP>
cudaError_t launch_largeq_bwd(const void* q, const void* k, const void* v,
                              const void* g, void* dq, void* dk, void* dv,
                              void* lse, void* dvec, void* keep, void* part, int B,
                              int H, int NQ, int NK, float scale, Dropout drop,
                              cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(DH == TC_DH, "the tensor-core K7 takes Dh 64");
    return launch_largeq_bwd_wgmma<DROP>(q, k, v, g, dq, dk, dv, lse, dvec, keep, part, B, H,
                                       NQ, NK, scale, drop, stream);
  } else {
    const size_t smem = k7_smem_bytes<T, DH>(NK);
    auto kern = largeq_bwd_dq_kernel<T, DH, DROP>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((NQ + K2_BQ - 1) / K2_BQ, B * H);
    kern<<<grid, K2_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(dq),
        static_cast<float*>(lse), static_cast<float*>(dvec), NQ, NK, scale, drop);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return launch_dkdv<T, DH, DROP>(q, k, v, g, nullptr, lse, dvec, dk, dv, B, H,
                                    NQ, NK, scale, drop, stream);
  }
}

// Pick the instantiation: input type, and dropout on iff thresh > 0.
#define MEBT_DISPATCH(fn, is_bf16, drop, ...)                              \
  ((is_bf16) ? ((drop).thresh ? (int)fn<__nv_bfloat16, 64, true>(__VA_ARGS__) \
                              : (int)fn<__nv_bfloat16, 64, false>(__VA_ARGS__)) \
             : ((drop).thresh ? (int)fn<float, 64, true>(__VA_ARGS__)      \
                              : (int)fn<float, 64, false>(__VA_ARGS__)))

}  // namespace

extern "C" {

// Every entry point takes the dropout arguments (seed, thresh, keep_scale,
// b0, h0, heads): thresh = min(int(p * 2^32), 2^32 - 1), keep_scale =
// 1 / (1 - p), thresh 0 means no dropout; the Philox rows are those of
// batch rows from b0 and heads from h0 of a problem of `heads` heads
// (0, 0, H: the local problem).

// Bytes of the scratch K1 needs for these shapes, with or without
// dropout, on the current card (the bf16 kernel's split partials, none at
// one split; 0 in fp32), or 0 with *status set on an error.
size_t mebt_smallq_scratch_bytes(int B, int H, int NQ, int NK, int is_bf16, int dropout,
                                 int* status) {
  *status = 0;
  if (!is_bf16 || NQ == 0 || B * H == 0) return 0;
  int splits = 1;
  const cudaError_t e = dropout ? k1_plan<true>(B, H, NQ, NK, splits)
                                : k1_plan<false>(B, H, NQ, NK, splits);
  *status = (int)e;
  return e == cudaSuccess ? k1_scratch_bytes(B, H, NQ, splits) : 0;
}

// q (B,H,NQ,Dh), k/v (B,H,NK,Dh), mask (B,NK) uint8 -> out (B,H,NQ,Dh)
// in the input type, lse (B,H,NQ) fp32. part: mebt_smallq_scratch_bytes
// of scratch (unused where that is 0).
int mebt_smallq_attention(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, void* part, int B, int H,
                          int NQ, int NK, int Dh, float scale, int is_bf16,
                          unsigned seed, unsigned thresh, float keep_scale,
                          unsigned b0, unsigned h0, unsigned heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, thresh, keep_scale, H, NQ, b0, h0, heads);
  return MEBT_DISPATCH(launch_smallq, is_bf16, drop, q, k, v, mask, out, lse, part, B,
                       H, NQ, NK, scale, drop, s);
}

// The split counts of K1 and of K6's dq pass for these shapes, with or
// without dropout, on the current card (bf16; 1 in fp32), or -1 with
// *status set.
int mebt_smallq_splits(int B, int H, int NQ, int NK, int is_bf16, int dropout, int backward,
                       int* status) {
  *status = 0;
  if (!is_bf16 || NQ == 0 || B * H == 0) return 1;
  int splits = 1;
  const cudaError_t e =
      backward ? (dropout ? k6_plan<true>(B, H, NQ, NK, splits) : k6_plan<false>(B, H, NQ, NK, splits))
               : (dropout ? k1_plan<true>(B, H, NQ, NK, splits) : k1_plan<false>(B, H, NQ, NK, splits));
  *status = (int)e;
  return e == cudaSuccess ? splits : -1;
}

// Dynamic shared memory K2 needs for NK keys, in bytes. The caller
// refuses shapes above the card's per-block limit.
size_t mebt_largeq_smem_bytes(int NK, int is_bf16) {
  if (!is_bf16) return k2_smem_bytes<float, 64>(NK);
  // past 512 keys the kernel takes no launch: more than any card has
  return NK > K2W_MAX_NK ? ((size_t)1 << 30) : k2w_smem_bytes(NK > 4 * K2W_KB ? 8 : 4);
}

// q (B,H,NQ,Dh), k/v (B,H,NK,Dh) -> out (B,H,NQ,Dh) in the input type.
int mebt_largeq_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int NQ, int NK, int Dh,
                          float scale, int is_bf16, unsigned seed,
                          unsigned thresh, float keep_scale, unsigned b0, unsigned h0,
                          unsigned heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, thresh, keep_scale, H, NQ, b0, h0, heads);
  return MEBT_DISPATCH(launch_largeq, is_bf16, drop, q, k, v, out, B, H, NQ, NK,
                       scale, drop, s);
}

// K6. out (the forward's) and g (B,H,NQ,Dh) in the input type, lse
// (B,H,NQ) fp32 -> dq (B,H,NQ,Dh), dk/dv (B,H,NK,Dh) in the input type.
// fp32 takes dvec = rowsum(g * out) (B,H,NQ) fp32 from the caller; bf16
// computes it (dvec unused). scratch: mebt_smallq_bwd_scratch_bytes of
// it, which the bf16 passes fill (unused in fp32): each batch row's live
// keys, each row's lse log2(e) as an fp32 pair (hi, lo) and D and, with
// dropout, the keep bits by (row, live position), for the dk/dv pass; the
// dq pass's key-split partials.
int mebt_smallq_backward(const void* q, const void* k, const void* v,
                         const void* mask, const void* lse, const void* out, const void* dvec,
                         const void* g, void* dq, void* dk, void* dv, void* scratch,
                         int B, int H, int NQ, int NK, int Dh, float scale,
                         int is_bf16, unsigned seed, unsigned thresh,
                         float keep_scale, unsigned b0, unsigned h0, unsigned heads,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, thresh, keep_scale, H, NQ, b0, h0, heads);
  return MEBT_DISPATCH(launch_smallq_bwd, is_bf16, drop, q, k, v, mask, lse, out,
                       dvec, g, dq, dk, dv, scratch, B, H, NQ, NK, scale, drop, s);
}

// Bytes of the scratch K6 needs for these shapes on the current card (0
// in fp32, and on an error, which the launch then reports).
size_t mebt_smallq_bwd_scratch_bytes(int B, int H, int NQ, int NK, int is_bf16, int dropout) {
  if (!is_bf16) return 0;
  int splits = 1;
  if (B * H > 0 && NQ > 0 &&
      (dropout ? k6_plan<true>(B, H, NQ, NK, splits) : k6_plan<false>(B, H, NQ, NK, splits)) !=
          cudaSuccess)
    return 0;
  return k6_scratch_bytes(B, H, NQ, NK, dropout != 0, splits);
}

// Dynamic shared memory of K7's passes for NK keys (the larger), in bytes.
size_t mebt_largeq_bwd_smem_bytes(int NK, int is_bf16) {
  if (!is_bf16) return k7_smem_bytes<float, 64>(NK);
  // past 512 keys the kernel takes no launch: more than any card has
  if (NK > K2W_MAX_NK) return (size_t)1 << 30;
  const size_t dq = k7w_dq_smem_bytes(NK > 4 * K7W_KT ? 8 : 4, false),
               dkdv = k7w_dkdv_smem_bytes();
  return dq > dkdv ? dq : dkdv;
}

// The query splits of the bf16 K7's dk/dv pass for these shapes on the
// current card (1 in fp32), or -1 with *status set. With more than one,
// the pass needs 2 * splits * B * H * NK * Dh fp32 of scratch (part).
int mebt_largeq_bwd_splits(int B, int H, int NQ, int NK, int is_bf16, int dropout,
                           int* status) {
  *status = 0;
  if (!is_bf16) return 1;
  int splits = 1, tps = 1;
  const cudaError_t e = dropout ? k7_dkdv_plan<true>(B * H, NQ, NK, splits, tps)
                                : k7_dkdv_plan<false>(B * H, NQ, NK, splits, tps);
  *status = (int)e;
  return e == cudaSuccess ? splits : -1;
}

// K7. lse, dvec and keep are scratch that the dq pass fills for the
// dk/dv pass: dvec (B,H,NQ) fp32; lse (B,H,NQ) fp32 in fp32, (B,H,NQ,2)
// pairs (m, log2 l) in bf16; keep, bf16 with dropout only (else unused),
// (B,H,NQ,ceil(NK/32)) 32-bit words of keep bits; part, the dk/dv
// pass's split sums (see mebt_largeq_bwd_splits; unused at one split) ->
// dq (B,H,NQ,Dh), dk/dv (B,H,NK,Dh) in the input type.
int mebt_largeq_backward(const void* q, const void* k, const void* v,
                         const void* g, void* dq, void* dk, void* dv, void* lse,
                         void* dvec, void* keep, void* part, int B, int H, int NQ, int NK,
                         int Dh, float scale, int is_bf16, unsigned seed,
                         unsigned thresh, float keep_scale, unsigned b0, unsigned h0,
                         unsigned heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, thresh, keep_scale, H, NQ, b0, h0, heads);
  return MEBT_DISPATCH(launch_largeq_bwd, is_bf16, drop, q, k, v, g, dq, dk, dv,
                       lse, dvec, keep, part, B, H, NQ, NK, scale, drop, s);
}

}  // extern "C"
