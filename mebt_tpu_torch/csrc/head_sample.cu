// K3 and K4: vocab head + Gumbel-max sample in one pass, for sm_90a.
//
// K3 (mebt_head_sample) replaces the TPU kernel
//   mebt_tpu/ops/head_sample_pallas.py:fused_head_sample
//   (_head_sample_kernel).
// For each row of x (R, D) it computes the logits l = (x @ W^T) / T over
// the vocabulary in 64-wide chunks and keeps, per row, a running max and
// sum of exponentials (the logsumexp) and a running argmax of the
// perturbed logit l - log(q), q ~ Exp(1) (Gumbel-max). It returns the
// sampled id and its probability under softmax(l); the (R, V) logits
// never reach device memory.
//
// K4 (mebt_head_topk_sample) replaces
//   mebt_tpu/ops/head_sample_pallas.py:fused_head_topk_sample_v2
//   (_head_topk_sample_v2_kernel).
// Same product and tiling; per row it keeps the k largest logits seen so
// far as a sorted buffer of (value, column) pairs in shared memory. A
// logit is compared with the row's current k-th pair and inserted only
// when it comes before it. The order is total: value descending, column
// ascending, so of two equal logits the lower column ranks first and the
// buffer's content does not depend on the order in which columns arrive.
// Every logit of the row is held against the buffer, and an insertion
// pushes out exactly the last pair, so after the last chunk the buffer
// IS the row's top k: there is no per-chunk candidate limit that could
// overflow, hence no overflow flag and no fallback (the TPU kernel's
// top-m extraction per slice and its flag work around a compiler that
// cannot pipeline a data-dependent loop; a GPU thread can just branch).
// After warm-up insertions are rare: about k ln(V/k) per row, some 200
// of 16384 logits at k = 32. Noise is then drawn for the k survivors
// only; the winner is argmax(l - log q), the lowest buffer slot on a
// tie, and its probability is taken under the softmax of the k values.
//
// Layout: W is the head's nn.Linear weight (V, D), row-major, so x and W
// are both read along D. One CTA takes 64 rows and loops over all vocab
// chunks; a chunk's 64x64 logits tile is a register-tiled fp32 FMA
// product (each thread 4x4) staged through shared memory, then the four
// threads that own a row fold the tile into that row's running state.
// K3: within a chunk the first maximum wins; across chunks the merge
// uses a strict '>', so over the whole vocabulary the lowest index wins
// a tie. K4: the four threads of a row sit in one warp; each first holds
// its 16 logits of the chunk against the k-th pair, and only when one of
// them has a candidate do the four take turns at the row's buffer, with
// __syncwarp() between turns. Taking turns at every chunk, candidate or
// not, cost 20 ms of 50 at R = V = 16384 (NVIDIA H100 80GB HBM3, 700 W).
//
// Noise: Philox4x32-10 keyed on (seed, 0) with counter (column, row, 0,
// 0), so a draw depends on (seed, row, vocabulary column) only, never on
// the tiling or on a survivor's buffer slot. u = mantissa(bits >> 9) - 1
// + 2^-25, q = -log(u), the same conversion as the TPU kernel. The
// caller passes a fresh 32-bit seed per step, drawn from a host
// generator (no device sync).
//
// Bound on the card: 2*R*D*V operations (5.5e11 at R = 16384, D = 1024,
// V = 16384), i.e. operations, not bytes. This first version runs the
// product on the FP32 pipes, not the tensor cores, so it sits far above
// that bound; wgmma tiles are later work. Below 132 row tiles
// (R < 8448) the grid under-fills the 132 SMs: at 16f, batch 16, the
// last two segments (buckets 512 and 256: R = 8192 and 4096) run 128
// and 64 CTAs. Not fixed here.
//
// Both take fp32 or bf16 x and W (is_bf16); temperature 0 is passed as
// inv_temp = 1/(0 + 1e-8) and gives the greedy argmax. Rows beyond R and
// columns beyond V are computed on zeros and never sampled, stored or
// summed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

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

__device__ __forceinline__ float exp_noise(uint32_t seed, uint32_t row,
                                           uint32_t col) {
  const uint32_t bits = (philox_bits(seed, row, col) >> 9) | 0x3F800000u;
  const float u = (__uint_as_float(bits) - 1.0f) + 2.9802322e-8f;  // 2^-25
  return -logf(u);
}

// One 64x64 tile of scaled logits, rows r0.., columns v0.., into Ls.
// Ends with a barrier: every thread may read Ls on return. The caller
// puts a barrier before the next call, which rewrites Ls.
template <typename T>
__device__ __forceinline__ void logits_tile(
    const T* __restrict__ x, const T* __restrict__ w, int R, int D, int V,
    int r0, int v0, float inv_temp, float (*As)[AP], float (*Bs)[AP],
    float (*Ls)[LP]) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty*4.., cols tx*4..
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
  const int er = tid >> 2, ep = tid & 3;  // epilogue: row er, cols c*4+ep
  const int row = r0 + er;

  float m_run = -1e30f, s_run = 0.f;
  float best = -CUDART_INF_F, best_l = 0.f;
  int best_i = 0;

  for (int v0 = 0; v0 < V; v0 += VC) {
    logits_tile(x, w, R, D, V, r0, v0, inv_temp, As, Bs, Ls);

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

// (value, column) a comes before b: value descending, column ascending.
__device__ __forceinline__ bool ahead(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Dynamic shared memory of K4: per row k values and k columns, pitch k+1
// so that the eight row owners of a warp hit different banks.
inline size_t topk_smem_bytes(int k) {
  return (size_t)TR * (k + 1) * (sizeof(float) + sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_topk_sample_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        int* __restrict__ ids, float* __restrict__ probs,
                        int R, int D, int V, int k, float inv_temp,
                        uint32_t seed) {
  __shared__ __align__(16) float As[KT][AP];
  __shared__ __align__(16) float Bs[KT][AP];
  __shared__ float Ls[TR][LP];
  extern __shared__ float topk_smem[];

  const int r0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const int er = tid >> 2, ep = tid & 3;  // row er, cols c*4+ep, slots s*4+ep
  const int row = r0 + er;
  const unsigned row_lanes = 0xFu << (tid & 28);  // the row's threads in the warp
  const int BP = k + 1;
  float* bv = topk_smem + er * BP;  // row er's values, sorted by `ahead`
  int* bi = reinterpret_cast<int*>(topk_smem + TR * BP) + er * BP;  // columns

  // empty slots rank behind every real logit; k <= V fills them all
  for (int s = ep; s < k; s += 4) {
    bv[s] = -CUDART_INF_F;
    bi[s] = 0x7fffffff;
  }
  __syncwarp();  // a row's four threads are neighbours in one warp

  for (int v0 = 0; v0 < V; v0 += VC) {
    logits_tile(x, w, R, D, V, r0, v0, inv_temp, As, Bs, Ls);
    // Pre-filter: hold the thread's 16 logits against the row's k-th pair
    // as it stood when the chunk began. The k-th pair only ever moves
    // ahead, so this keeps every logit that can still enter; most chunks
    // keep none and the row's threads skip the turns below.
    const float kth_v = bv[k - 1];
    const int kth_i = bi[k - 1];
    unsigned cand = 0;
#pragma unroll
    for (int cc = 0; cc < VC / 4; ++cc) {
      const int col = cc * 4 + ep, gcol = v0 + col;
      if (gcol < V && ahead(Ls[er][col], gcol, kth_v, kth_i)) cand |= 1u << cc;
    }
    unsigned any = cand;
    any |= __shfl_xor_sync(row_lanes, any, 1);
    any |= __shfl_xor_sync(row_lanes, any, 2);
    if (any) {  // the same for the row's four threads
      for (int turn = 0; turn < 4; ++turn) {
        if (ep == turn) {
          while (cand) {
            const int col = (__ffs(cand) - 1) * 4 + ep, gcol = v0 + col;
            cand &= cand - 1;
            const float l = Ls[er][col];
            if (!ahead(l, gcol, bv[k - 1], bi[k - 1])) continue;
            int j = k - 1;  // shift the pairs it comes before; the last falls out
            while (j > 0 && ahead(l, gcol, bv[j - 1], bi[j - 1])) {
              bv[j] = bv[j - 1];
              bi[j] = bi[j - 1];
              --j;
            }
            bv[j] = l;
            bi[j] = gcol;
          }
        }
        __syncwarp(row_lanes);
      }
    }
    __syncthreads();  // Ls is rewritten by the next chunk
  }

  // Gumbel-max among the k survivors, softmax over their values
  const float m = bv[0];
  float best = -CUDART_INF_F, sum = 0.f;
  int slot = 0x7fffffff;
  for (int s = ep; s < k; s += 4) {
    const float l = bv[s];
    sum += expf(l - m);
    const float pert = l - logf(exp_noise(seed, (uint32_t)row, (uint32_t)bi[s]));
    if (pert > best) {
      best = pert;
      slot = s;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int os = __shfl_xor_sync(FULL, slot, off);
    if (ob > best || (ob == best && os < slot)) {
      best = ob;
      slot = os;
    }
    sum += __shfl_xor_sync(FULL, sum, off);
  }
  if (ep == 0 && row < R) {
    ids[row] = bi[slot];
    probs[row] = expf(bv[slot] - (m + logf(sum)));
  }
}

template <typename T>
cudaError_t launch_topk(const void* x, const void* w, void* ids, void* probs,
                        int R, int D, int V, int k, float inv_temp,
                        uint32_t seed, cudaStream_t stream) {
  const size_t smem = topk_smem_bytes(k);
  auto kern = head_topk_sample_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((R + TR - 1) / TR);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<int*>(ids), static_cast<float*>(probs), R, D, V, k,
      inv_temp, seed);
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

// As above with an exact top-k, 1 <= k <= min(V, 256), before the sample.
int mebt_head_topk_sample(const void* x, const void* w, void* ids, void* probs,
                          int R, int D, int V, int k, float inv_temp,
                          unsigned int seed, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > V || k > 256) return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)launch_topk<__nv_bfloat16>(x, w, ids, probs, R, D, V, k,
                                                   inv_temp, seed, s)
                 : (int)launch_topk<float>(x, w, ids, probs, R, D, V, k,
                                           inv_temp, seed, s);
}

}  // extern "C"
