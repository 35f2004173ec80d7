// K1 and K2: the two attention regimes of the routed MeBT blocks, for
// sm_90a. Built by mebt_tpu_torch/ops/_build.py into a shared library
// with a plain C interface (bound with ctypes).
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
// Both take fp32 or bf16 inputs (is_bf16), accumulate in fp32, and
// write the output in the input type. Inputs must be contiguous
// (B, H, N, Dh) tensors with Dh = 64, the head width of every MeBT
// config (1024 / 16); the kernels are templated on Dh so another width
// is one more instantiation. Each entry point returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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
template <typename T, int DH>
__global__ void __launch_bounds__(K1_THREADS)
smallq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              T* __restrict__ out, float* __restrict__ lse, int H, int NQ,
              int NK, float scale) {
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
      psum += p;
      Ps[r * PP + kk] = p;
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

template <typename T, int DH>
cudaError_t launch_smallq(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, int B, int H,
                          int NQ, int NK, float scale, cudaStream_t stream) {
  const size_t smem = k1_smem_bytes<DH>();
  auto kern = smallq_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((NQ + K1_BQ - 1) / K1_BQ, B * H);
  kern<<<grid, K1_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, NQ, NK, scale);
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
template <typename T, int DH>
__global__ void __launch_bounds__(K2_THREADS)
largeq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int NQ, int NK,
              float scale) {
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
  for (int j = part; j < NK; j += 8) {
    const float e = expf(Ss[r * SP + j] - m);
    Ss[r * SP + j] = e;
    sum += e;
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

template <typename T, int DH>
cudaError_t launch_largeq(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int NQ, int NK, float scale,
                          cudaStream_t stream) {
  const size_t smem = k2_smem_bytes<T, DH>(NK);
  auto kern = largeq_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((NQ + K2_BQ - 1) / K2_BQ, B * H);
  kern<<<grid, K2_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), NQ, NK, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,NQ,Dh), k/v (B,H,NK,Dh), mask (B,NK) uint8 -> out (B,H,NQ,Dh)
// in the input type, lse (B,H,NQ) fp32.
int mebt_smallq_attention(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, int B, int H,
                          int NQ, int NK, int Dh, float scale, int is_bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)launch_smallq<__nv_bfloat16, 64>(q, k, v, mask, out, lse,
                                                         B, H, NQ, NK, scale, s)
                 : (int)launch_smallq<float, 64>(q, k, v, mask, out, lse, B, H,
                                                 NQ, NK, scale, s);
}

// Dynamic shared memory K2 needs for NK keys, in bytes. The caller
// refuses shapes above the card's per-block limit.
size_t mebt_largeq_smem_bytes(int NK, int is_bf16) {
  return is_bf16 ? k2_smem_bytes<__nv_bfloat16, 64>(NK) : k2_smem_bytes<float, 64>(NK);
}

// q (B,H,NQ,Dh), k/v (B,H,NK,Dh) -> out (B,H,NQ,Dh) in the input type.
int mebt_largeq_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int NQ, int NK, int Dh,
                          float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)launch_largeq<__nv_bfloat16, 64>(q, k, v, out, B, H, NQ,
                                                         NK, scale, s)
                 : (int)launch_largeq<float, 64>(q, k, v, out, B, H, NQ, NK,
                                                 scale, s);
}

}  // extern "C"
