// K1, K2, K6, K7, K8: forward and backward of the two attention regimes
// of the routed MeBT blocks, with and without dropout on the
// probabilities, for sm_90a. Built by mebt_tpu_torch/ops/_build.py into a
// shared library with a plain C interface (bound with ctypes).
//
// K1 (mebt_smallq_attention) replaces the TPU kernel
//   mebt_tpu/ops/attention_pallas.py:_smallq_attention (_smallq_kernel):
//   few queries (256 latents) over many MASKED keys (latent_enc: the
//   context bucket; lt2l: [latents; target bucket]). Flash forward: one
//   CTA per (b, h, 64-query tile); a loop over 64-key tiles inside the
//   CTA takes the place of the TPU's sequential grid axis and carries the
//   running (max, denominator, accumulator) in fp32 registers. A key tile
//   with no live key is skipped as a whole. A fully masked row writes 0
//   and lse = +1e30 (the first MaskGIT step has no context at all).
//   Emits lse (B, H, NQ) fp32 for the later backward.
//   Bound on the card: at the 16f shapes the work is O(NQ*NK*Dh) with
//   NQ = 256, so bytes set the floor: Q/out plus K/V of the LIVE keys
//   only (~64 MB in lt2l at M = 1024 with half the targets live, where
//   all of K/V would be ~100 MB); this first version runs both products
//   as fp32 FMA loops from
//   shared memory, so it is bounded by FMA throughput, not by
//   memory. Tensor-core tiles (mma.sync / wgmma) are later work.
//
// K2 (mebt_largeq_attention) replaces
//   mebt_tpu/ops/attention_pallas.py:_largeq_attention (_largeq_kernel):
//   many queries over <= 512 UNMASKED keys (latent_self: 256 x 256;
//   latent_dec: M tokens x 256 latents). K and V of one (b, h) stay
//   resident in shared memory in the input type; each CTA takes 32
//   queries and does one softmax pass (scores for all keys, row max,
//   exp, sum, then P @ V). Bound: bytes at these shapes (~84 MB in
//   latent_dec at M = 1024); the design reads K/V once per CTA from L2.
//
// K6 (mebt_smallq_backward) replaces
//   mebt_tpu/ops/attention_pallas.py:_smallq_backward (_smallq_bwd_kernel):
//   dq, dk, dv of K1 from the saved lse and D = rowsum(g * out). The TPU
//   kernel owns a key block per grid step and carries dq in scratch
//   across a SEQUENTIAL key axis; blocks run in no order here, so the
//   work is split into two passes that each write their outputs once and
//   need no atomics: smallq_bwd_dq_kernel, one CTA per (b, h, 64-query
//   tile) walking the key tiles like K1 (dq), and attn_bwd_dkdv_kernel,
//   one CTA per (b, h, 64-key tile) walking the query tiles (dk, dv).
//   Both recompute p = exp(s * scale - lse) and dp = g v^T, 7 tile
//   products in all against the 5 of one fused pass; in exchange the
//   result does not depend on the order blocks run in. A key tile with
//   no live key is skipped (its dk, dv are zero); a fully masked row has
//   lse = +1e30, so p and every gradient are exactly zero.
//   Bound: 10 * NQ * live keys * Dh operations per (b, h) against the
//   bytes of q, g, dq and the live K/V/dk/dv rows: bytes at NQ = 256.
//   Both passes are fp32 FMA loops from shared memory, far above it.
//
// K7 (mebt_largeq_backward) replaces
//   mebt_tpu/ops/attention_pallas.py:_largeq_backward (_largeq_bwd_kernel):
//   dq, dk, dv of K2; nothing is saved by the forward. Pass 1,
//   largeq_bwd_dq_kernel: K and V of one (b, h) resident in shared memory
//   as in K2, one CTA per 32 queries recomputes the softmax, O and
//   D = rowsum(g * O), writes dq, and leaves lse and D in a scratch
//   buffer. Pass 2 is attn_bwd_dkdv_kernel again, without a mask: dk and
//   dv are sums over ALL query tiles of one (b, h) (4 at NQ 1024, 128 at
//   NQ 8192), taken inside one CTA per key tile, so no reduction across
//   CTAs is needed.
//
// K8, dropout on the probabilities (the p_drop branches of the four TPU
//   kernels, attention_pallas.py:_drop_keep): element (b, h, query, key)
//   is kept iff the Philox word keyed on (seed, (b * H + h) * NQ + query,
//   key) is >= thresh = min(int(p * 2^32), 2^32 - 1), and a kept
//   probability is scaled by 1 / (1 - p). The softmax denominator and lse
//   use the undropped p. The index is that of the unpadded problem, so
//   the mask depends on no tiling and every pass regenerates the same
//   one. Each kernel is templated on DROP: thresh == 0 runs the
//   instantiation without a single dropout instruction.
//
// All take fp32 or bf16 inputs (is_bf16), accumulate in fp32, and
// write the output in the input type. Inputs must be contiguous
// (B, H, N, Dh) tensors with Dh = 64, the head width of every MeBT
// config (1024 / 16); the kernels are templated on Dh so another width
// is one more instantiation. Each entry point returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// K8: keep(row, key) is 1 / (1 - p) for a kept probability and 0 for a
// dropped one; row = (b * H + h) * NQ + query of the unpadded problem.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float keep_scale;
  __device__ __forceinline__ float keep(uint32_t row, uint32_t key) const {
    return philox_bits(seed, row, key) >= thresh ? keep_scale : 0.f;
  }
};

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

template <typename T, int DH, bool DROP>
cudaError_t launch_smallq(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, int B, int H,
                          int NQ, int NK, float scale, Dropout drop,
                          cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// K2: unmasked large-Q, K/V resident

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
                              const void* mask, const void* lse,
                              const void* dvec, const void* g, void* dq,
                              void* dk, void* dv, int B, int H, int NQ, int NK,
                              float scale, Dropout drop, cudaStream_t stream) {
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
                              void* lse, void* dvec, int B, int H, int NQ,
                              int NK, float scale, Dropout drop,
                              cudaStream_t stream) {
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

// Pick the instantiation: input type, and dropout on iff thresh > 0.
#define MEBT_DISPATCH(fn, is_bf16, drop, ...)                              \
  ((is_bf16) ? ((drop).thresh ? (int)fn<__nv_bfloat16, 64, true>(__VA_ARGS__) \
                              : (int)fn<__nv_bfloat16, 64, false>(__VA_ARGS__)) \
             : ((drop).thresh ? (int)fn<float, 64, true>(__VA_ARGS__)      \
                              : (int)fn<float, 64, false>(__VA_ARGS__)))

}  // namespace

extern "C" {

// Every entry point takes the dropout triple (seed, thresh, keep_scale):
// thresh = min(int(p * 2^32), 2^32 - 1), keep_scale = 1 / (1 - p);
// thresh 0 means no dropout.

// q (B,H,NQ,Dh), k/v (B,H,NK,Dh), mask (B,NK) uint8 -> out (B,H,NQ,Dh)
// in the input type, lse (B,H,NQ) fp32.
int mebt_smallq_attention(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, int B, int H,
                          int NQ, int NK, int Dh, float scale, int is_bf16,
                          unsigned seed, unsigned thresh, float keep_scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, keep_scale};
  return MEBT_DISPATCH(launch_smallq, is_bf16, drop, q, k, v, mask, out, lse, B,
                       H, NQ, NK, scale, drop, s);
}

// Dynamic shared memory K2 needs for NK keys, in bytes. The caller
// refuses shapes above the card's per-block limit.
size_t mebt_largeq_smem_bytes(int NK, int is_bf16) {
  return is_bf16 ? k2_smem_bytes<__nv_bfloat16, 64>(NK) : k2_smem_bytes<float, 64>(NK);
}

// q (B,H,NQ,Dh), k/v (B,H,NK,Dh) -> out (B,H,NQ,Dh) in the input type.
int mebt_largeq_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int NQ, int NK, int Dh,
                          float scale, int is_bf16, unsigned seed,
                          unsigned thresh, float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, keep_scale};
  return MEBT_DISPATCH(launch_largeq, is_bf16, drop, q, k, v, out, B, H, NQ, NK,
                       scale, drop, s);
}

// K6. g (B,H,NQ,Dh) in the input type; lse and dvec = rowsum(g * out)
// (B,H,NQ) fp32 -> dq (B,H,NQ,Dh), dk/dv (B,H,NK,Dh) in the input type.
int mebt_smallq_backward(const void* q, const void* k, const void* v,
                         const void* mask, const void* lse, const void* dvec,
                         const void* g, void* dq, void* dk, void* dv, int B,
                         int H, int NQ, int NK, int Dh, float scale,
                         int is_bf16, unsigned seed, unsigned thresh,
                         float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, keep_scale};
  return MEBT_DISPATCH(launch_smallq_bwd, is_bf16, drop, q, k, v, mask, lse,
                       dvec, g, dq, dk, dv, B, H, NQ, NK, scale, drop, s);
}

// Dynamic shared memory of K7's dq pass for NK keys, in bytes.
size_t mebt_largeq_bwd_smem_bytes(int NK, int is_bf16) {
  return is_bf16 ? k7_smem_bytes<__nv_bfloat16, 64>(NK) : k7_smem_bytes<float, 64>(NK);
}

// K7. lse and dvec are (B,H,NQ) fp32 scratch that the dq pass fills for
// the dk/dv pass -> dq (B,H,NQ,Dh), dk/dv (B,H,NK,Dh) in the input type.
int mebt_largeq_backward(const void* q, const void* k, const void* v,
                         const void* g, void* dq, void* dk, void* dv, void* lse,
                         void* dvec, int B, int H, int NQ, int NK, int Dh,
                         float scale, int is_bf16, unsigned seed,
                         unsigned thresh, float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, keep_scale};
  return MEBT_DISPATCH(launch_largeq_bwd, is_bf16, drop, q, k, v, g, dq, dk, dv,
                       lse, dvec, B, H, NQ, NK, scale, drop, s);
}

}  // extern "C"
