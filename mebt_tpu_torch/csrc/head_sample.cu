// K3: vocab head + Gumbel-max sample in one pass, for sm_90a.
//
// Replaces the TPU kernel
//   mebt_tpu/ops/head_sample_pallas.py:fused_head_sample
//   (_head_sample_kernel).
// For each row of x (R, D) it computes the logits l = (x @ W^T) / T over
// the vocabulary in 64-wide chunks and keeps, per row, a running max and
// sum of exponentials (the logsumexp) and a running argmax of the
// perturbed logit l - log(q), q ~ Exp(1) (Gumbel-max). It returns the
// sampled id and its probability under softmax(l); the (R, V) logits
// never reach device memory.
//
// Layout: W is the head's nn.Linear weight (V, D), row-major, so x and W
// are both read along D. One CTA takes 64 rows and loops over all vocab
// chunks; a chunk's 64x64 logits tile is a register-tiled fp32 FMA
// product (each thread 4x4) staged through shared memory, then the four
// threads that own a row fold the tile into that row's running state.
// Within a chunk the first maximum wins; across chunks the merge uses a
// strict '>', so over the whole vocabulary the lowest index wins a tie.
//
// Noise: Philox4x32-10 keyed on (seed, 0) with counter (column, row, 0,
// 0), so a draw depends on (seed, row, column) only, never on the
// tiling. u = mantissa(bits >> 9) - 1 + 2^-25, q = -log(u), the same
// conversion as the TPU kernel. The caller passes a fresh 32-bit seed
// per step, drawn from a host generator (no device sync).
//
// Bound on the card: 2*R*D*V operations (5.5e11 at R = 16384, D = 1024,
// V = 16384), i.e. operations, not bytes. This first version runs the
// product on the FP32 pipes, not the tensor cores, so it sits far above
// that bound; wgmma tiles are later work. Below 132 row tiles
// (R < 8448) the grid under-fills the 132 SMs: at 16f, batch 16, the
// last two segments (buckets 512 and 256: R = 8192 and 4096) run 128
// and 64 CTAs. Not fixed here.
//
// Takes fp32 or bf16 x and W (is_bf16); temperature 0 is passed as
// inv_temp = 1/(0 + 1e-8) and gives the greedy argmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TR = 64;        // rows per CTA
constexpr int VC = 64;        // vocab columns per chunk
constexpr int KT = 32;        // depth per shared-memory stage
constexpr int THREADS = 256;  // GEMM: 16x16 threads of 4x4; epilogue: 4 per row
constexpr int AP = TR + 4;    // pitches keep float4 alignment
constexpr int LP = VC + 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

__device__ __forceinline__ float exp_noise(uint32_t seed, uint32_t row,
                                           uint32_t col) {
  const uint32_t bits = (philox_bits(seed, row, col) >> 9) | 0x3F800000u;
  const float u = (__uint_as_float(bits) - 1.0f) + 2.9802322e-8f;  // 2^-25
  return -logf(u);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_sample_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   int* __restrict__ ids, float* __restrict__ probs, int R,
                   int D, int V, float inv_temp, uint32_t seed) {
  __shared__ __align__(16) float As[KT][AP];  // x tile, As[k][row]
  __shared__ __align__(16) float Bs[KT][AP];  // W tile, Bs[k][col]
  __shared__ float Ls[TR][LP];                // scaled logits tile

  const int r0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // GEMM: rows ty*4.., cols tx*4..
  const int er = tid >> 2, ep = tid & 3;   // epilogue: row er, cols c*4+ep
  const int row = r0 + er;

  float m_run = -1e30f, s_run = 0.f;
  float best = -CUDART_INF_F, best_l = 0.f;
  int best_i = 0;

  for (int v0 = 0; v0 < V; v0 += VC) {
    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KT) {
      for (int i = tid; i < TR * KT; i += THREADS) {
        const int rr = i / KT, kk = i % KT;
        const int gr = r0 + rr, gk = k0 + kk;
        As[kk][rr] = (gr < R && gk < D) ? to_f(x[(size_t)gr * D + gk]) : 0.f;
      }
      for (int i = tid; i < VC * KT; i += THREADS) {
        const int cc = i / KT, kk = i % KT;
        const int gc = v0 + cc, gk = k0 + kk;
        Bs[kk][cc] = (gc < V && gk < D) ? to_f(w[(size_t)gc * D + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ls[ty * 4 + i][tx * 4 + j] = c[i][j] * inv_temp;
    __syncthreads();

    // fold the chunk into row er's running state
    float cm = -1e30f, cb = -CUDART_INF_F, cl = 0.f;
    int ci = 0x7fffffff;
#pragma unroll 4
    for (int cc = 0; cc < VC / 4; ++cc) {
      const int gcol = v0 + cc * 4 + ep;
      if (gcol < V) {
        const float l = Ls[er][cc * 4 + ep];
        const float pert = l - logf(exp_noise(seed, (uint32_t)row, (uint32_t)gcol));
        if (pert > cb) {
          cb = pert;
          ci = gcol;
          cl = l;
        }
        cm = fmaxf(cm, l);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(FULL, cb, off);
      const int oi = __shfl_xor_sync(FULL, ci, off);
      const float ol = __shfl_xor_sync(FULL, cl, off);
      if (ob > cb || (ob == cb && oi < ci)) {
        cb = ob;
        ci = oi;
        cl = ol;
      }
      cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, off));
    }
    const float m_new = fmaxf(m_run, cm);
    float cs = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < VC / 4; ++cc) {
      const int gcol = v0 + cc * 4 + ep;
      if (gcol < V) cs += expf(Ls[er][cc * 4 + ep] - m_new);
    }
    cs += __shfl_xor_sync(FULL, cs, 1);
    cs += __shfl_xor_sync(FULL, cs, 2);
    s_run = s_run * expf(m_run - m_new) + cs;
    m_run = m_new;
    if (cb > best) {
      best = cb;
      best_i = ci;
      best_l = cl;
    }
    __syncthreads();  // Ls is rewritten by the next chunk
  }

  if (ep == 0 && row < R) {
    const float lse = m_run + logf(s_run);
    ids[row] = best_i;
    probs[row] = expf(best_l - lse);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* ids, void* probs, int R,
                   int D, int V, float inv_temp, uint32_t seed,
                   cudaStream_t stream) {
  const dim3 grid((R + TR - 1) / TR);
  head_sample_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<int*>(ids), static_cast<float*>(probs), R, D, V, inv_temp,
      seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (R,D), w (V,D) -> ids (R,) int32, probs (R,) fp32.
int mebt_head_sample(const void* x, const void* w, void* ids, void* probs,
                     int R, int D, int V, float inv_temp, unsigned int seed,
                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)launch<__nv_bfloat16>(x, w, ids, probs, R, D, V,
                                              inv_temp, seed, s)
                 : (int)launch<float>(x, w, ids, probs, R, D, V, inv_temp,
                                      seed, s);
}

}  // extern "C"
