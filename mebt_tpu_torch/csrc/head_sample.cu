// K3, K4 and K5: vocab head + Gumbel-max sample in one pass, for sm_90a.
//
// K3 (mebt_head_sample) replaces the TPU kernel
//   mebt_tpu/ops/head_sample_pallas.py:fused_head_sample
//   (_head_sample_kernel).
// For each row of x (R, D) it computes the logits l = (x @ W^T) / T over
// the vocabulary and keeps, per row, a running max and sum of
// exponentials (the logsumexp) and a running argmax of the perturbed
// logit l - log(q), q ~ Exp(1) (Gumbel-max). It returns the sampled id
// and its probability under softmax(l); the (R, V) logits never reach
// device memory.
//
// K4 (mebt_head_topk_sample) replaces
//   mebt_tpu/ops/head_sample_pallas.py:fused_head_topk_sample_v2
//   (_head_topk_sample_v2_kernel).
// Same product; per row it keeps the k largest logits seen so far as a
// buffer of (value, column) pairs in shared memory. A logit is compared
// with the row's current k-th pair and enters only when it comes before
// it. The order is total: value descending, column ascending, so of two
// equal logits the lower column ranks first and the buffer's content
// does not depend on the order in which columns arrive. Every logit of
// the row is held against the buffer, and an entry pushes out exactly the
// k-th pair, so after the last column the buffer IS the row's top k
// (fp32: kept sorted by insertion; bf16: unsorted, the k-th pair tracked,
// sorted once at the end): there is no per-chunk candidate limit that could
// overflow, hence no overflow flag and no fallback (the TPU kernel's
// top-m extraction per slice and its flag work around a compiler that
// cannot pipeline a data-dependent loop; a GPU thread can just branch).
// After warm-up insertions are rare: about k ln(V/k) per row, some 200
// of 16384 logits at k = 32. Noise is then drawn for the k survivors
// only; the winner is argmax(l - log q), the lowest slot on a tie, and
// its probability is taken under the softmax of the k values.
//
// Bound on the card, K3, K4 and K5: 2 R D V operations, 5.5e11 at R =
// 16384, D = 1024, V = 16384 (0.556 ms at 989 TFLOP/s bf16), against 64 MB
// of x and W: operations. K3 also draws a noise word and takes two logf
// per logit (268 M of each at R = 16384; one 10-round Philox call gives
// the words of four columns, 67 M calls), so its floor on the card lies
// above the bound. K4 and K5 draw only for their k survivors.
//
// bf16 K3, K4 and K5 (head_sample_wgmma_kernel, head_topk_wgmma_kernel,
// head_topk_v1_wgmma_kernel: one tile, head_slice<Epi>, three epilogues)
// on Hopper's own instructions (csrc/hopper.cuh): a CTA takes 64 rows a
// consumer warpgroup (K3, K4, K5: two, 128 rows; K4 and K5 one where k
// passes about 80 and the row buffers fill shared memory) and walks
// 128-column chunks of its slice. One lane streams each 64-deep stage, the
// CTA's x rows and the chunk's 128 W rows, by TMA into a ring of up to 4
// stages in 128-byte-swizzled shared memory, behind mbarriers (full: the
// bytes have landed; empty: every consumer warp has read the stage). Each
// consumer warpgroup multiplies its 64 rows by the chunk with wgmma
// m64n128k16 (4 a stage, B = W K-major as stored), keeps one stage's
// products in flight while it waits for the next, and at the chunk's end
// runs its epilogue on the accumulator: a thread holds 2 rows of its warp
// (g, g + 8) and 32 columns of each in the m16n8 C layout, the four
// threads of a quad sharing a row. The stages are shared, so the
// warpgroups keep within the ring's 3 stages of each other and their
// epilogues overlap each other's products little. K3's noise (a quarter
// of a 10-round Philox call and two logf a logit) is therefore drawn
// apart: a noise warpgroup writes each chunk's -log(q) into one of two
// buffers in shared memory while the product warpgroups multiply, and a
// chunk's epilogue adds it. With the noise in the epilogue the products
// and the noise ran one after the other (1.0 and 1.5 ms at R 16384 on an
// NVIDIA H100 80GB HBM3, a call a logit then); three warpgroups of that
// design took 3.1 ms, this one 3.0. A call now serves the four columns
// of a thread pair of a quad (SampleEpi::help), so a noise thread makes
// 32 calls a chunk, not 128. K3's CTA has no producer warp
// (its first product thread issues the loads as it releases a stage): at
// 13 warps ptxas's budget was 128 registers a thread and the product
// warpgroups spilled; at 12 it is 168.
// Measured (chip_smoke.py's k4 and k5 phases, NVIDIA H100 80GB HBM3,
// 700 W): K4 2.11 / 1.23 / 0.62 ms at R 16384 / 6400 / 3328 against the
// library's 4.57 / 1.94 / 1.11 (torch.matmul and the plain top-k sampler)
// and the bound's 0.56 / 0.22 / 0.11; K5 the same within 3%.
// K3's epilogue: per thread and row an online max and sum of exp and a
// running Gumbel argmax over its own columns, which it visits in column
// order (strict '>': the lowest column wins a tie), with the noise
// warpgroup's -log(q) for them; the quad's four states are merged once
// per slice by shuffles (a tie to the lower column). K4's epilogue
// (TopkEpi): per thread and row the pre-filter against the row's k-th
// pair as it stood when the chunk began (the k-th pair only moves ahead,
// so nothing that can still enter is dropped); where a quad of the warp
// holds a candidate, the eight quads walk their rows' candidates best
// first (each thread's best by a comparison tree over its registers, the
// quad's by two shuffles): one that still comes before the k-th fills an
// empty slot or replaces the k-th, and the quad finds the new k-th pair
// (k / 4 slots a thread, two shuffles); the walk stops at the first that
// would not enter. At the slice's end each pair's rank gives its place.
// The grid is (row blocks) x (S vocabulary slices of whole chunks); the
// host picks S from the card's SM count (read once) so that the CTAs
// fill the card at every R the decode runs (R from 3328 to 16384). Each
// slice leaves its state in a scratch buffer the wrapper allocates, and a
// merge kernel folds the slices IN SLICE ORDER, so two calls give the
// same bits: K3 (head_sample_merge_kernel) from (m, s, best perturbed
// logit, its logit, its column) takes m = max m_i, s = sum s_i e^(m_i - m)
// and the best by a strict '>', so the lowest column wins a tie over the
// whole vocabulary; K4 (head_topk_merge_kernel, a warp per row) takes the
// top k of the S k pairs under the same total order, so the merged set is
// the one-CTA set, then draws the noise at the survivors' columns. S = 1
// launches the merge as well, a trivial one (one slice's state passes
// through the same formulas).
//
// fp32 (head_sample_kernel<float>, head_topk_sample_kernel<float>: the
// parity checks only): one CTA takes 64 rows and loops over all vocab
// chunks; a chunk's 64x64 logits tile is a register-tiled fp32 FMA
// product (each thread 4x4) staged through shared memory, then the four
// threads that own a row fold the tile into that row's running state.
// K3: within a chunk the first maximum wins; across chunks the merge
// uses a strict '>'. K4: the four threads of a row first hold their 16
// logits of the chunk against the k-th pair, and only when one of them
// has a candidate do the four take turns at the row's buffer.
//
// Noise: Philox4x32-10 keyed on (seed, 0); element (row, column) is word
// column & 3 of the call at counter (column >> 2, row, NOISE_TAG, 0)
// (philox.cuh), so a draw depends on (seed, row, vocabulary column) only,
// never on the tiling, the slices or a survivor's buffer slot, and one
// call serves four neighbouring columns of a row. u = mantissa(bits >> 9)
// - 1 + 2^-25, q = -log(u), the same conversion as the TPU kernel (one
// 32-bit word a draw: the resolution of its 32-bit hardware draw).
// The caller passes a fresh 32-bit seed per step, drawn from a host
// generator (no device sync).
//
// K5 (mebt_head_topk_sample_v1) replaces
//   mebt_tpu/ops/head_sample_pallas.py:fused_head_topk_sample (v1,
//   _head_topk_sample_kernel).
// K4's function by the TPU kernel's other selection design: per chunk a
// data-dependent extraction loop. While the chunk's largest remaining
// logit (value descending, column ascending) comes before the row's k-th
// pair, it is sort-inserted into the row's buffer, which stays sorted
// (the pairs behind it move down a slot and the last falls out), and
// masked out of the chunk. So the loop runs once per logit that enters
// the buffer (k in a slice's first chunk, about k / c in its c-th), plus
// once to stop in each chunk where one entered. No decode path runs K5,
// as none in the JAX package runs v1.
//
// bf16 (head_topk_v1_wgmma_kernel + head_topk_merge_kernel): K4's tile,
// slices, plan, scratch and merge, with SortedEpi for TopkEpi. The loop
// reads the accumulator fragments: the quad that owns a row extracts for
// it (each thread's best remaining candidate, the quad's best by two
// shuffles), so a warp's eight quads run eight rows' loops side by side
// (K4's walk does the same into its unsorted buffer). The insertion compares
// each slot with the new pair and with the slot before it, 8 slots a
// thread in blocks of 32 from the end, no count of the pairs ahead
// first. A slice leaves its k pairs already sorted, which is exactly K4's
// state, so K4's merge and draw follow: K5's ids and probabilities equal
// K4's bit for bit (the same tile sums, the same exact top-k set).
// Only the k survivors draw Philox noise, at their columns.
//
// fp32 (head_topk_sample_v1_kernel<float>, the parity checks only): the
// FMA tile; one warp takes one row of the chunk's 64-column logits tile
// at a time, each lane two logits, a warp max per turn and a shift of
// k / 32 slots a lane, then K4's draw a warp per row.
//
// All take fp32 or bf16 x and W (is_bf16); temperature 0 is passed as
// inv_temp = 1/(0 + 1e-8) and gives the greedy argmax. Rows beyond R and
// columns beyond V are computed on zeros and never sampled, stored or
// summed. The bf16 kernels need D % 8 == 0 and x, W at 16-byte
// boundaries (the wrapper pads and copies where they are not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "card.cuh"
#include "hopper.cuh"
#include "mma.cuh"
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

// Exp(1) draw q = -log(u) of one noise word: u = mantissa(bits >> 9) - 1
// + 2^-25, in [2^-25, 1)
__device__ __forceinline__ float exp_of(uint32_t bits) {
  const float u = (__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f) + 2.9802322e-8f;
  return -logf(u);
}

// Word i (0 .. 7) of two consecutive calls' eight, by selects on
// registers (an indexed pick put the words in local memory)
__device__ __forceinline__ uint32_t word_of_two(const uint4& lo, const uint4& hi, uint32_t i) {
  const uint32_t a = i & 1u ? lo.y : lo.x, b = i & 1u ? lo.w : lo.z;
  const uint32_t c = i & 1u ? hi.y : hi.x, d = i & 1u ? hi.w : hi.z;
  const uint32_t e = i & 2u ? b : a, f = i & 2u ? d : c;
  return i & 4u ? f : e;
}

// Exp(1) noise at one element (whole-head row, vocabulary column): its
// word of its group's call, a call of its own (philox.cuh)
__device__ __forceinline__ float exp_noise(uint32_t seed, uint32_t row, uint32_t col) {
  return exp_of(philox_noise_bits(seed, row, col));
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

// fp32 only: bf16 goes to the tensor-core K3 below
cudaError_t launch_fma(const void* x, const void* w, void* ids, void* probs, int R,
                       int D, int V, float inv_temp, uint32_t seed,
                       cudaStream_t stream) {
  using T = float;
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

// fp32 only: bf16 goes to the tensor-core K4 below
cudaError_t launch_topk_fma(const void* x, const void* w, void* ids, void* probs,
                            int R, int D, int V, int k, float inv_temp,
                            uint32_t seed, cudaStream_t stream) {
  using T = float;
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

constexpr int WARPS = THREADS / 32;
constexpr int V1_MAX_K = 256;  // fp32 K5's shift keeps k / 32 pairs a lane in registers

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_topk_sample_v1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           int* __restrict__ ids, float* __restrict__ probs,
                           int R, int D, int V, int k, float inv_temp,
                           uint32_t seed) {
  __shared__ __align__(16) float As[KT][AP];
  __shared__ __align__(16) float Bs[KT][AP];
  __shared__ float Ls[TR][LP];
  extern __shared__ float topk_smem[];

  const int r0 = blockIdx.x * TR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf_v = topk_smem;                                 // (TR, k) values
  int* buf_i = reinterpret_cast<int*>(topk_smem + TR * k);  // (TR, k) columns

  for (int i = threadIdx.x; i < TR * k; i += THREADS) {  // empty slots rank last
    buf_v[i] = -CUDART_INF_F;
    buf_i[i] = 0x7fffffff;
  }
  // the first logits_tile's barriers order these stores before any read

  for (int v0 = 0; v0 < V; v0 += VC) {
    logits_tile(x, w, R, D, V, r0, v0, inv_temp, As, Bs, Ls);
    for (int er = warp; er < TR && r0 + er < R; er += WARPS) {
      float* bv = buf_v + er * k;
      int* bi = buf_i + er * k;
      // the lane's two logits of the chunk; a column past V is never live
      float lv[2];
      int lc[2];
      bool live[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        lc[t] = v0 + lane + 32 * t;
        live[t] = lc[t] < V;
        lv[t] = Ls[er][lane + 32 * t];
      }
      float kth_v = bv[k - 1];
      int kth_i = bi[k - 1];
      while (true) {
        // the chunk's largest live logit, (value desc, column asc)
        float mv = -CUDART_INF_F;
        int mc = 0x7fffffff;
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (live[t] && ahead(lv[t], lc[t], mv, mc)) {
            mv = lv[t];
            mc = lc[t];
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(FULL, mv, off);
          const int oc = __shfl_xor_sync(FULL, mc, off);
          if (ahead(ov, oc, mv, mc)) {
            mv = ov;
            mc = oc;
          }
        }
        if (mc == 0x7fffffff || !ahead(mv, mc, kth_v, kth_i)) break;  // warp-uniform
        // its slot: the number of buffered pairs that come before it
        int pos = 0;
        for (int s = lane; s < k; s += 32) pos += ahead(bv[s], bi[s], mv, mc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) pos += __shfl_xor_sync(FULL, pos, off);
        // shift slots pos..k-2 down by one: all reads, then all writes
        float sv[V1_MAX_K / 32];
        int si[V1_MAX_K / 32];
#pragma unroll
        for (int t = 0; t < V1_MAX_K / 32; ++t) {
          const int s = lane + 32 * t;
          if (s < k && s > pos) {
            sv[t] = bv[s - 1];
            si[t] = bi[s - 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < V1_MAX_K / 32; ++t) {
          const int s = lane + 32 * t;
          if (s < k && s > pos) {
            bv[s] = sv[t];
            bi[s] = si[t];
          }
        }
        if (lane == 0) {
          bv[pos] = mv;
          bi[pos] = mc;
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (lc[t] == mc) live[t] = false;
        kth_v = bv[k - 1];
        kth_i = bi[k - 1];
      }
    }
    __syncthreads();  // Ls is rewritten by the next chunk
  }

  // Gumbel-max among the k survivors, softmax over their values (K4's)
  for (int er = warp; er < TR && r0 + er < R; er += WARPS) {
    const int row = r0 + er;
    const float* bv = buf_v + er * k;
    const int* bi = buf_i + er * k;
    const float m = bv[0];
    float best = -CUDART_INF_F, sum = 0.f;
    int slot = 0x7fffffff;
    for (int s = lane; s < k; s += 32) {
      const float l = bv[s];
      sum += expf(l - m);
      const float pert = l - logf(exp_noise(seed, (uint32_t)row, (uint32_t)bi[s]));
      if (pert > best) {
        best = pert;
        slot = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int os = __shfl_xor_sync(FULL, slot, off);
      if (ob > best || (ob == best && os < slot)) {
        best = ob;
        slot = os;
      }
      sum += __shfl_xor_sync(FULL, sum, off);
    }
    if (lane == 0) {
      ids[row] = bi[slot];
      probs[row] = expf(bv[slot] - (m + logf(sum)));
    }
  }
}

// fp32 only: bf16 goes to the tensor-core K5 below
cudaError_t launch_topk_v1_fma(const void* x, const void* w, void* ids, void* probs,
                               int R, int D, int V, int k, float inv_temp,
                               uint32_t seed, cudaStream_t stream) {
  using T = float;
  const size_t smem = (size_t)TR * k * (sizeof(float) + sizeof(int));
  auto kern = head_topk_sample_v1_kernel<T>;
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

// ---------------------------------------------------------------------------
// bf16 K3, K4 and K5 on Hopper: the wgmma tile over a slice of the
// vocabulary (the source note above), K3's merge and K4's

using bf16 = __nv_bfloat16;

constexpr int HT_MAX_SPLITS = 32;  // K4's merge holds one slice a lane
constexpr int TOPK_WARMUP = 3;     // chunks a K4 / K5 slice's start costs (head_plan)
constexpr int K3_START = 1;        // chunks a K3 slice's start (the ring's fill) costs
constexpr int MERGE_WARPS = 8;

// A K3 scratch part of S slices: the float4 states, then the columns.
__device__ __forceinline__ const float4* k3_states(const unsigned char* parts,
                                                   size_t part_bytes, int p) {
  return reinterpret_cast<const float4*>(parts + (size_t)p * part_bytes);
}
__device__ __forceinline__ const int* k3_cols(const unsigned char* parts, size_t part_bytes,
                                              int p, int S, int R) {
  return reinterpret_cast<const int*>(k3_states(parts, part_bytes, p) + (size_t)S * R);
}

// K3's merge, a thread per row, over the slices in order: m = max m_i,
// s = sum s_i e^(m_i - m), the best perturbed logit by a strict '>' (the
// slices ascend in column, so the lowest column wins a tie). The slices
// are those of n_parts scratch parts of S slices each, part_bytes apart:
// one launch's (n_parts 1), or the parts of the ranks that split the
// vocabulary in rank order, gathered, which then fold as the slices of
// one launch.
__global__ void __launch_bounds__(256)
head_sample_merge_kernel(const unsigned char* __restrict__ parts, size_t part_bytes,
                         int n_parts, int* __restrict__ ids, float* __restrict__ probs, int R,
                         int S) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float m = -1e30f;
  for (int p = 0; p < n_parts; ++p)
    for (int s = 0; s < S; ++s) m = fmaxf(m, k3_states(parts, part_bytes, p)[(size_t)s * R + row].x);
  float sum = 0.f, best = -CUDART_INF_F, bl = 0.f;
  int bi = 0;
  for (int p = 0; p < n_parts; ++p)
    for (int s = 0; s < S; ++s) {
      const float4 q = k3_states(parts, part_bytes, p)[(size_t)s * R + row];
      sum += q.y * expf(q.x - m);
      if (q.z > best) {
        best = q.z;
        bl = q.w;
        bi = k3_cols(parts, part_bytes, p, S, R)[(size_t)s * R + row];
      }
    }
  ids[row] = bi;
  probs[row] = expf(bl - (m + logf(sum)));
}

// ---------------------------------------------------------------------------
// bf16 K4 and K5 on Hopper: the wgmma tile (the source note above)

constexpr int HW_BN = 128;    // vocabulary columns a chunk: m64n128k16
constexpr int HW_BK = 64;     // depth a stage: one 128-byte swizzled row
constexpr int HW_ROWS = 64;   // rows a consumer warpgroup: m64
constexpr int HW_MAX_WG = 2;  // consumer warpgroups a K4 / K5 CTA at most (their buffers)
constexpr int K3_WG = 2;      // K3's product warpgroups a CTA (128 rows)
// K3's noise warps, -log(q) for the product warpgroups: a warpgroup, and
// no producer warp (the first product thread issues the loads), so that
// the CTA has 384 threads and 168 registers a thread (at 416 ptxas's
// budget is 128, where the product warpgroups spilled)
constexpr int K3_NOISE_WARPS = 4;
// noise-stream calls a noise thread makes side by side (one warp a
// scheduler: its own independent calls hide the chains' latencies); 4 ran
// 0.6-1.5% faster than 8 (scripts/head_sample_variants.py, NVIDIA H100
// 80GB HBM3, 700 W)
constexpr int K3_NOISE_UNROLL = 4;
constexpr int HW_MAX_STAGES = 4;
constexpr uint32_t HW_X_BYTES = HW_ROWS * HW_BK * 2;  // a warpgroup's x rows a stage: 8 KB
constexpr uint32_t HW_W_BYTES = HW_BN * HW_BK * 2;    // a chunk's W rows a stage: 16 KB

// A thread's accumulator of a chunk: row slot j (row g + 8 j of its warp's
// 16), column 8 nt + 2 t + e at [4 nt + 2 j + e]
using WAcc = float[HW_BN / 2];

__host__ __device__ inline size_t hw_stage_bytes(int nwg) {
  return (size_t)nwg * HW_X_BYTES + HW_W_BYTES;
}

// Dynamic shared memory of the bf16 K3, K4 or K5: the ring (1024-aligned),
// its barriers, and K4's and K5's buffers of k (value, column) pairs a row,
// pitch k + 1 so that the eight rows a warp's quads own fall in different
// banks, or K3's (k = 0) two chunks of noise (64 values a product thread)
// and their four barriers.
inline size_t hw_smem_bytes(int nwg, int stages, int k) {
  const size_t bufs =
      k ? (size_t)nwg * HW_ROWS * (k + 1) * (sizeof(float) + sizeof(int))
        : 4 * sizeof(uint64_t) + 2 * (size_t)nwg * 128 * (HW_BN / 2) * sizeof(float);
  return 1024 + (size_t)stages * (hw_stage_bytes(nwg) + 2 * sizeof(uint64_t)) + bufs;
}

// What K4's and K5's epilogues share: the CTA's rows' buffers of k
// (value, column) pairs, pitch k + 1 so that the eight rows a warp's quads
// own fall in different banks; the thread's CTA row rl0 (row0 of x) and
// quad place t: its row slot j is CTA row rl0 + 8 j, its columns of a
// chunk 8 nt + 2 t + e.
struct SliceRows {
  int k, rl0, row0, t, R, V, col_off;
  float inv_temp;
};

struct TopkRows : SliceRows {
  static constexpr int HELPER_WARPS = 0;  // no warps beside the products and the producer
  __device__ __forceinline__ void init(unsigned char*) const {}
  __device__ __forceinline__ void help(unsigned char*, int, int, int) const {}

  float* bv;  // the CTA's rows' values, pitch k + 1
  int* bi;    // their columns, of the whole vocabulary (W's first is col_off)
  float* part_v;  // the slices' sorted pairs (the scratch)
  int* part_i;

  // the buffers at `bufs`; this warp's 16 rows' slots emptied: empty
  // slots rank behind every logit
  __device__ __forceinline__ void bind(unsigned char* bufs) {
    const int BP = k + 1, nwg = blockDim.x >> 7, lane = threadIdx.x & 31;
    bv = reinterpret_cast<float*>(bufs);
    bi = reinterpret_cast<int*>(bv + nwg * HW_ROWS * BP);
    const int r = rl0 - (lane >> 2);  // the warp's first row
    for (int i = lane; i < 16 * BP; i += 32) {
      bv[r * BP + i] = -CUDART_INF_F;
      bi[r * BP + i] = 0x7fffffff;
    }
    __syncwarp();
  }

  // the thread's columns of the chunk at c0 that lie before V, as bits
  __device__ __forceinline__ unsigned live_cols(int c0) const {
    if (c0 + HW_BN <= V) return FULL;
    unsigned live = 0;
#pragma unroll
    for (int c = 0; c < HW_BN / 4; ++c)
      if (c0 + (c >> 1) * 8 + 2 * t + (c & 1) < V) live |= 1u << c;
    return live;
  }

  // the thread's 32 logits of row slot J, scaled
  template <int J>
  __device__ __forceinline__ void scaled(const WAcc& acc, float (&l)[HW_BN / 4]) const {
#pragma unroll
    for (int c = 0; c < HW_BN / 4; ++c) l[c] = acc[4 * (c >> 1) + 2 * J + (c & 1)] * inv_temp;
  }

  // The best of the logits `left` of l: value, column and bit; (-inf, no
  // column) when none is left. A tree of 31 comparisons, five deep, over
  // the registers; the left operand keeps a tie, so the lower bit, which
  // is the lower column, wins.
  __device__ __forceinline__ void best(const float (&l)[HW_BN / 4], unsigned left, int c0,
                                       float& mv, int& mc, int& mbit) const {
    float v[HW_BN / 4];
    int b[HW_BN / 4];
#pragma unroll
    for (int c = 0; c < HW_BN / 4; ++c) {
      v[c] = (left >> c) & 1u ? l[c] : -CUDART_INF_F;
      b[c] = c;
    }
#pragma unroll
    for (int w = 1; w < HW_BN / 4; w <<= 1)
#pragma unroll
      for (int c = 0; c < HW_BN / 4; c += 2 * w)
        if (v[c + w] > v[c]) {
          v[c] = v[c + w];
          b[c] = b[c + w];
        }
    mv = v[0];
    mbit = b[0];
    mc = left ? col_off + c0 + (mbit >> 1) * 8 + 2 * t + (mbit & 1) : 0x7fffffff;
  }
};

// K3's epilogue: per thread and row slot an online max m and sum s of
// e^(l - m), and the best perturbed logit l - log(q), q ~ Exp(1), of its
// own columns (visited in column order, strict '>': the lowest column wins
// a tie) with its logit and column. A thread holds rows g, g + 8 of its
// warp's 16 and 32 columns of each (8 nt + 2 t + e): the quad shares a
// row. The noise does not depend on the logits: warps of their own (help)
// draw -log(q) for each chunk of the slice into one of two buffers in
// shared memory, value v = 32 J + c of product thread p at [v NTHR + p],
// while the product warpgroups multiply; a chunk's epilogue adds it
// (noise_full: drawn; noise_empty: read). ALIGNED: the slice's first
// column col_off is a multiple of 4, so each noise-stream group of four
// columns lies in one thread pair's registers (the host's choice; the
// other instantiation serves a rank's W that starts inside a group).
template <bool ALIGNED>
struct SampleEpi : SliceRows {
  static constexpr int HELPER_WARPS = K3_NOISE_WARPS;
  float m[2], s[2], best[2], bl[2];
  int bi[2];
  uint32_t seed, row_off;
  float4* part;  // the slices' states (the scratch), then their columns
  int* part_col;
  static constexpr int NTHR = K3_WG * 128;  // product threads
  int turn;  // chunks done

  __device__ __forceinline__ static uint64_t* bars(unsigned char* bufs) {
    return reinterpret_cast<uint64_t*>(bufs);  // full[2], empty[2]
  }
  __device__ __forceinline__ static float* noise(unsigned char* bufs) {
    return reinterpret_cast<float*>(bars(bufs) + 4);
  }

  __device__ __forceinline__ void init(unsigned char* bufs) const {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&bars(bufs)[b], 32 * HELPER_WARPS);
      mbar_init(&bars(bufs)[2 + b], NTHR);
    }
  }

  // The noise warps: the slice's chunks [chunk0, chunk1) of the CTA's rows
  // r0... Product threads p and p + 1 (p even: quad places t = 2h, 2h + 1)
  // hold columns 8 nt + 4 h .. 8 nt + 4 h + 3 of a chunk in rows g + 8 J:
  // one group of the noise stream, one Philox call (philox_noise4) whose
  // words 0 .. 3 are values 32 J + 2 nt + e of p (columns + e) and of p + 1
  // (columns + 2 + e), stored as two float2, the pair side by side, so a
  // warp's 32 pairs fill 256 bytes without a bank conflict. Noise thread n
  // takes the chunk's groups q = n, n + nn, ... of NTHR / 2 x 32 (pair q %
  // (NTHR / 2), J and nt from the quotient), K3_NOISE_UNROLL calls side by
  // side. Where col_off % 4 != 0 (!ALIGNED) the four columns start at word
  // col_off & 3 of one group and end in the next: two calls a group. The
  // two logs are logf, as the plain version's torch.log: they now cost more
  // than the call (__logf for both ran K3 12% faster at R 16384).
  __device__ __forceinline__ void help(unsigned char* bufs, int chunk0, int chunk1, int r0) {
    constexpr int nn = 32 * HELPER_WARPS, npair = NTHR / 2, groups = npair * (HW_BN / 4);
    const int n = threadIdx.x - NTHR;
    const uint32_t lead = (uint32_t)col_off & 3u;  // the first column's word (0 where ALIGNED)
    uint64_t* bar = bars(bufs);
    for (int c = chunk0, i = 0; c < chunk1; ++c, ++i) {
      const int b = i & 1;
      mbar_wait(&bar[2 + b], ((i >> 1) & 1) ^ 1);  // the buffer's last chunk is read
      float* buf = noise(bufs) + (size_t)b * NTHR * (HW_BN / 2);
#pragma unroll (K3_NOISE_UNROLL)
      for (int q = n; q < groups; q += nn) {
        const int p = 2 * (q % npair), v = q / npair, nt = v & 15, J = v >> 4, lane = p & 31;
        // the pair's row g + 8 J and its first column of the group
        const uint32_t r = row_off + (uint32_t)(r0 + (p >> 7) * HW_ROWS + ((p >> 5) & 3) * 16 +
                                                (lane >> 2) + 8 * J);
        const uint32_t col = (uint32_t)(col_off + c * HW_BN + nt * 8 + 2 * (lane & 3));
        uint4 w = philox_noise4(seed, r, col >> 2);
        if (!ALIGNED) {
          const uint4 lo = w, hi = philox_noise4(seed, r, (col >> 2) + 1u);
          w = make_uint4(word_of_two(lo, hi, lead), word_of_two(lo, hi, lead + 1u),
                         word_of_two(lo, hi, lead + 2u), word_of_two(lo, hi, lead + 3u));
        }
        float* at = buf + (32 * J + 2 * nt) * NTHR + p;
        *reinterpret_cast<float2*>(at) = make_float2(-logf(exp_of(w.x)), -logf(exp_of(w.z)));
        *reinterpret_cast<float2*>(at + NTHR) =
            make_float2(-logf(exp_of(w.y)), -logf(exp_of(w.w)));
      }
      mbar_arrive(&bar[b]);  // after this thread's stores (release)
    }
  }

  unsigned char* bufs;

  __device__ __forceinline__ void start(unsigned char* b) {
    bufs = b;
    turn = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[j] = -1e30f;
      s[j] = 0.f;
      best[j] = -CUDART_INF_F;
      bl[j] = 0.f;
      bi[j] = 0x7fffffff;
    }
  }

  // the thread's logit c of row slot J, scaled; -inf past V (taken from
  // the accumulator at each use: 32 more registers held them spilled)
  template <int J>
  __device__ __forceinline__ float logit(const WAcc& acc, int c0, int c) const {
    const int col = c0 + (c >> 1) * 8 + 2 * t + (c & 1);
    return col < V ? acc[4 * (c >> 1) + 2 * J + (c & 1)] * inv_temp : -CUDART_INF_F;
  }

  template <int J>
  __device__ __forceinline__ void row(const WAcc& acc, int c0, const float* nz) {
    const int r = row0 + 8 * J;
    float cm = -1e30f;
#pragma unroll
    for (int c = 0; c < HW_BN / 4; ++c) cm = fmaxf(cm, logit<J>(acc, c0, c));
    const float mj = m[J], mn = fmaxf(mj, cm);
    float cs = 0.f;
#pragma unroll
    for (int c = 0; c < HW_BN / 4; ++c) cs += __expf(logit<J>(acc, c0, c) - mn);
    s[J] = s[J] * __expf(mj - mn) + cs;
    m[J] = mn;
    if (r >= R) return;
    float b = best[J], bv = bl[J];
    int bc = bi[J];
#pragma unroll
    for (int c = 0; c < HW_BN / 4; ++c) {
      const int col = c0 + (c >> 1) * 8 + 2 * t + (c & 1);
      const float l = logit<J>(acc, c0, c);
      // l - log(q) as l + (-log(q)): the same bits
      const float pert = l + nz[(32 * J + c) * NTHR];
      if (col < V && pert > b) {
        b = pert;
        bc = col_off + col;  // the column of the whole vocabulary
        bv = l;
      }
    }
    best[J] = b;
    bl[J] = bv;
    bi[J] = bc;
  }

  __device__ __forceinline__ void chunk(const WAcc& acc, int c0) {
    const int b = turn & 1;
    mbar_wait(&bars(bufs)[b], (turn >> 1) & 1);
    const float* nz = noise(bufs) + (size_t)b * NTHR * (HW_BN / 2) + threadIdx.x;
    row<0>(acc, c0, nz);
    row<1>(acc, c0, nz);
    mbar_arrive(&bars(bufs)[2 + b]);  // this thread has read the chunk's noise
    ++turn;
  }

  // the quad's four states folded by shuffles, once a slice (a tie of the
  // perturbed logits to the lower column); thread t = 0 stores the row's
  // slice state
  __device__ __forceinline__ void finish(int slice) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mj = m[j], sj = s[j], bj = best[j], lj = bl[j];
      int ij = bi[j];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float om = __shfl_xor_sync(FULL, mj, off), os = __shfl_xor_sync(FULL, sj, off);
        const float ob = __shfl_xor_sync(FULL, bj, off), ol = __shfl_xor_sync(FULL, lj, off);
        const int oi = __shfl_xor_sync(FULL, ij, off);
        const float mn = fmaxf(mj, om);
        sj = sj * expf(mj - mn) + os * expf(om - mn);
        mj = mn;
        if (ob > bj || (ob == bj && oi < ij)) {
          bj = ob;
          ij = oi;
          lj = ol;
        }
      }
      const int r = row0 + 8 * j;
      if (t == 0 && r < R) {
        part[(size_t)slice * R + r] = make_float4(mj, sj, bj, lj);
        part_col[(size_t)slice * R + r] = ij;
      }
    }
  }
};

// K4's epilogue. A row's buffer holds its k best (value, column) pairs of
// the slice so far, unsorted; its four quad threads keep, in registers,
// the count of filled slots and the worst pair (the k-th, and its slot).
// Per chunk and row slot a thread takes its 32 logits of the row into
// registers and marks those that come before the row's k-th pair as it
// stood when the chunk began (it only moves ahead, so nothing that can
// still enter is dropped). Where some quad of the warp holds one (a
// ballot), the warp's eight quads walk their rows' candidates side by
// side, best first: each thread offers its best remaining one (a
// comparison tree over its registers), the quad takes the best of the
// four (two shuffles), and while that comes before the k-th pair it fills
// the next empty slot or replaces the k-th; a full buffer's new k-th is
// then its worst pair (k / 4 slots a thread, two shuffles). Best first, a
// chunk inserts only the logits that stay in the row's top k of the
// slice so far, and the walk stops at the first that would not (the
// column-order walk of PR 8 inserted and evicted, with a rescan each).
// Every warp-wide step runs converged; a quad whose walk has ended idles
// until the warp's last. After the slice each row's k pairs are ranked
// under the total order and stored sorted for the merge.
struct TopkEpi : TopkRows {
  float kv[2];  // per row slot: the k-th pair, its slot, the filled slots
  int ki[2], ks[2], cnt[2];

  __device__ __forceinline__ void start(unsigned char* bufs) {
    bind(bufs);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kv[j] = -CUDART_INF_F;
      ki[j] = 0x7fffffff;
      ks[j] = 0;
      cnt[j] = 0;
    }
  }

  __device__ __forceinline__ void chunk(const WAcc& acc, int c0) {
    const unsigned live = live_cols(c0);
#pragma unroll 1
    for (int j = 0; j < 2; ++j) {
      const int dr = 8 * j;
      float* rv = bv + (rl0 + dr) * (k + 1);
      int* ri = bi + (rl0 + dr) * (k + 1);
      float kth_v = kv[j];
      int kth_i = ki[j];
      float l[HW_BN / 4];
      if (j == 0) scaled<0>(acc, l);  // static fragment indices in a rolled loop
      else scaled<1>(acc, l);
      unsigned left = 0;
      if (row0 + dr < R) {
#pragma unroll
        for (int c = 0; c < HW_BN / 4; ++c)
          left |= (ahead(l[c], col_off + c0 + (c >> 1) * 8 + 2 * t + (c & 1), kth_v, kth_i)
                       ? 1u : 0u) << c;
      }
      left &= live;
      if (!__any_sync(FULL, left != 0)) continue;  // the ballot
      int kth_s = ks[j], n = cnt[j];
      float mv;
      int mc, mbit;
      best(l, left, c0, mv, mc, mbit);
#pragma unroll 1
      while (true) {
        float qv = mv;
        int qc = mc;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(FULL, qv, off);
          const int oc = __shfl_xor_sync(FULL, qc, off);
          if (ahead(ov, oc, qv, qc)) {
            qv = ov;
            qc = oc;
          }
        }
        const bool ins = ahead(qv, qc, kth_v, kth_i);  // quad-uniform
        if (!__any_sync(FULL, ins)) break;              // warp-uniform
        if (ins) {
          const int slot = n < k ? n++ : kth_s;
          if (t == 0) {
            rv[slot] = qv;
            ri[slot] = qc;
          }
          if (mc == qc) {  // the thread offered it: its next
            left &= ~(1u << mbit);
            best(l, left, c0, mv, mc, mbit);
          }
        }
        // a full buffer's new k-th pair: its worst, k / 4 slots a thread,
        // the whole warp in step (no quad waits on another's branch)
        const bool rescan = ins && n == k;
        if (!__any_sync(FULL, rescan)) continue;
        __syncwarp();
        float wv = CUDART_INF_F;  // ahead of every pair
        int wi = -1, ws = -1;
#pragma unroll 4
        for (int s = t; s < k; s += 4) {
          const float sv = rv[s];
          const int si = ri[s];
          if (ahead(wv, wi, sv, si)) {
            wv = sv;
            wi = si;
            ws = s;
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(FULL, wv, off);
          const int oi = __shfl_xor_sync(FULL, wi, off);
          const int os = __shfl_xor_sync(FULL, ws, off);
          if (ahead(wv, wi, ov, oi)) {
            wv = ov;
            wi = oi;
            ws = os;
          }
        }
        if (rescan) {
          kth_v = wv;
          kth_i = wi;
          kth_s = ws;
        }
      }
      kv[j] = kth_v;
      ki[j] = kth_i;
      ks[j] = kth_s;
      cnt[j] = n;
    }
  }

  // each row's k pairs stored in order: a pair's place is the number of
  // pairs ahead of it (equal pairs, the empty slots, by slot)
  __device__ __forceinline__ void finish(int slice) {
    __syncwarp();
#pragma unroll 1
    for (int j = 0; j < 2; ++j) {
      const int dr = 8 * j;
      const int row = row0 + dr;
      if (row >= R) continue;
      const float* rv = bv + (rl0 + dr) * (k + 1);
      const int* ri = bi + (rl0 + dr) * (k + 1);
      const size_t o = ((size_t)slice * R + row) * k;
      for (int s = t; s < k; s += 4) {
        const float v = rv[s];
        const int c = ri[s];
        int rank = 0;
        for (int q = 0; q < k; ++q)
          rank += ahead(rv[q], ri[q], v, c) || (q < s && rv[q] == v && ri[q] == c);
        part_v[o + rank] = v;
        part_i[o + rank] = c;
      }
    }
  }
};

// K5's epilogue: v1's extraction loop, read from the accumulator
// fragments. A row's buffer stays sorted under `ahead`, so its k-th pair
// is slot k - 1. Per chunk and row slot a thread takes its 32 logits of
// the row from the fragments into registers (static indices: a switch
// over the rolled slot loop) and marks those not below the row's k-th
// VALUE as the chunk began (a superset of the logits that can still
// enter: one equal to it with a higher column stops the loop at its
// turn). Where some quad of the warp holds one (a ballot), the warp's
// eight quads run v1's loop for their eight rows side by side: each
// thread offers its best remaining logit, the quad takes the best of the
// four (two shuffles), and while that comes before the row's k-th pair
// it is inserted, sorted, and the thread that offered it finds its next
// (a comparison tree over its registers). Every warp-wide step is taken
// converged; a quad whose loop has ended idles until the warp's last.
struct SortedEpi : TopkRows {
  __device__ __forceinline__ void start(unsigned char* bufs) { bind(bufs); }

  __device__ __forceinline__ void chunk(const WAcc& acc, int c0) {
    const int BP = k + 1;
    const unsigned live = live_cols(c0);  // the thread's columns before V
#pragma unroll 1
    for (int j = 0; j < 2; ++j) {
      const int dr = 8 * j;
      float* rv = bv + (rl0 + dr) * BP;
      int* ri = bi + (rl0 + dr) * BP;
      float kth_v = rv[k - 1];
      int kth_i = ri[k - 1];
      const float kv = row0 + dr < R ? kth_v : CUDART_INF_F;  // a row past R takes none
      float l[HW_BN / 4];
      if (j == 0) scaled<0>(acc, l);  // static fragment indices in a rolled loop
      else scaled<1>(acc, l);
      unsigned left = 0;
#pragma unroll
      for (int c = 0; c < HW_BN / 4; ++c) left |= (l[c] >= kv ? 1u : 0u) << c;
      left &= live;
      if (!__any_sync(FULL, left != 0)) continue;  // the ballot
      float mv;
      int mc, mbit;
      best(l, left, c0, mv, mc, mbit);
#pragma unroll 1
      while (true) {
        float qv = mv;
        int qc = mc;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(FULL, qv, off);
          const int oc = __shfl_xor_sync(FULL, qc, off);
          if (ahead(ov, oc, qv, qc)) {
            qv = ov;
            qc = oc;
          }
        }
        const bool ins = ahead(qv, qc, kth_v, kth_i);  // quad-uniform
        if (!__any_sync(FULL, ins)) break;              // warp-uniform
        insert(rv, ri, qv, qc, ins);
        if (ins) {
          kth_v = rv[k - 1];
          kth_i = ri[k - 1];
          if (mc == qc) {  // the thread offered it: its next
            left &= ~(1u << mbit);
            best(l, left, c0, mv, mc, mbit);
          }
        }
      }
    }
  }

  // (v, c) into the row's sorted buffer where `ins` (quad-uniform): slot s
  // keeps its pair if that comes before (v, c), else takes the pair of
  // slot s - 1, or (v, c) where the pair of s - 1 comes before it (the
  // last pair falls out). No count of the pairs ahead first: each slot
  // compares for itself. In blocks of 32 slots from the end while some
  // quad's pairs still move (one block at k <= 32); thread t of a quad
  // holds 8 neighbouring slots, so the warp's 8 rows x 4 threads fall in
  // 32 distinct banks (pitch k + 1; slots 4 q + t took 4 ways), and the
  // pair before its first slot is its left neighbour's last (a shuffle),
  // or for the block's first slot a read. A block reads all it needs
  // before it writes, and the block below writes none of what it reads.
  __device__ __forceinline__ void insert(float* rv, int* ri, float v, int c, bool ins) const {
#pragma unroll 1
    for (int hi = k;; hi -= 32) {
      const int lo = max(hi - 32, 0), s0 = lo + 8 * t;
      float a[8];
      int ai[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const bool in = ins && s0 + q < hi;
        a[q] = in ? rv[s0 + q] : CUDART_INF_F;
        ai[q] = in ? ri[s0 + q] : -1;
      }
      float pv = __shfl_up_sync(FULL, a[7], 1);
      int pi = __shfl_up_sync(FULL, ai[7], 1);
      if (t == 0) {
        const bool in = ins && lo > 0;
        pv = in ? rv[lo - 1] : CUDART_INF_F;
        pi = in ? ri[lo - 1] : -1;
      }
      const bool more = t == 0 && ins && lo > 0 && !ahead(pv, pi, v, c);
      unsigned wr = 0;
#pragma unroll
      for (int q = 7; q >= 0; --q) {  // in place: a[q - 1] is still the old pair
        const float p = q ? a[q - 1] : pv;
        const int pc = q ? ai[q - 1] : pi;
        if (ins && s0 + q < hi && !ahead(a[q], ai[q], v, c)) {
          const bool prev = !ahead(p, pc, v, c);
          a[q] = prev ? p : v;
          ai[q] = prev ? pc : c;
          wr |= 1u << q;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if ((wr >> q) & 1u) {
          rv[s0 + q] = a[q];
          ri[s0 + q] = ai[q];
        }
      __syncwarp();
      if (!__any_sync(FULL, more)) break;
    }
  }

  // each row's k pairs, already in order, to the slice's scratch
  __device__ __forceinline__ void finish(int slice) {
    __syncwarp();
#pragma unroll 1
    for (int j = 0; j < 2; ++j) {
      const int dr = 8 * j;
      const int row = row0 + dr;
      if (row >= R) continue;
      const float* rv = bv + (rl0 + dr) * (k + 1);
      const int* ri = bi + (rl0 + dr) * (k + 1);
      const size_t o = ((size_t)slice * R + row) * k;
      for (int s = t; s < k; s += 4) {
        part_v[o + s] = rv[s];
        part_i[o + s] = ri[s];
      }
    }
  }
};

// One CTA of the bf16 K3, K4 or K5: rows r0.. (64 a consumer warpgroup)
// over the chunks of slice blockIdx.y; the epilogue Epi reads each
// finished chunk from the accumulator and leaves each row's state of the
// slice for the merge (epi.finish). One lane streams each 64-deep stage of
// the CTA's x rows and the chunk's 128 W rows by TMA into a ring of
// `stages`: the last warp's (K4, K5), or the first product thread's as it
// releases a stage (K3, whose noise warps run Epi::help). Each consumer
// warpgroup multiplies its 64 rows by the chunk (4 m64n128k16 a stage, one
// product in flight while the next stage's run), and when the chunk's
// last product has ended runs the epilogue on the accumulator while the
// ring fills ahead and the other warpgroups' products run.
// The caller sets the epilogue's own fields; head_slice the rows'.
template <typename Epi>
__device__ __forceinline__ void head_slice(unsigned char* smem, const CUtensorMap& xmap,
                                           const CUtensorMap& wmap, int R, int D, int V, int k,
                                           int cps, float inv_temp, int col_off, int stages,
                                           Epi& epi) {
  // with helper warps (K3) the loads are issued by the first product
  // thread, which keeps the CTA at 12 warps; else by a producer warp
  constexpr bool own_producer = Epi::HELPER_WARPS == 0;
  const int nwg = (blockDim.x - 32 * Epi::HELPER_WARPS - (own_producer ? 32 : 0)) >> 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * nwg * HW_ROWS, slice = blockIdx.y;
  const int chunk0 = slice * cps;
  const int chunk1 = min((V + HW_BN - 1) / HW_BN, chunk0 + cps);
  const int ksteps = (D + HW_BK - 1) / HW_BK;
  const size_t stage_bytes = hw_stage_bytes(nwg);
  unsigned char* ring = align1024(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * stage_bytes);
  uint64_t* empty = full + stages;  // a warp of each consumer warpgroup
  unsigned char* bufs = reinterpret_cast<unsigned char*>(empty + stages);
  epi.k = k;
  epi.R = R;
  epi.V = V;
  epi.col_off = col_off;
  epi.inv_temp = inv_temp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nwg);
    }
    epi.init(bufs);
    mbar_init_fence();
  }
  __syncthreads();

  const int n_iter = (chunk1 - chunk0) * ksteps;
  // stage `it`: the CTA's x rows and the chunk's W rows, once every
  // consumer warp has read the stage before it in the same slot
  auto load = [&](int it) {
    const int s = it % stages;
    mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
    mbar_expect_tx(&full[s], (uint32_t)stage_bytes);
    unsigned char* st = ring + (size_t)s * stage_bytes;
    const int c0 = (chunk0 + it / ksteps) * HW_BN, k0 = (it % ksteps) * HW_BK;
    tma_load_2d(st, &xmap, &full[s], k0, r0);
    tma_load_2d(st + nwg * HW_X_BYTES, &wmap, &full[s], k0, c0);
  };
  if (warp >= 4 * nwg && warp < 4 * nwg + Epi::HELPER_WARPS) {  // the epilogue's helpers
    epi.help(bufs, chunk0, chunk1, r0);
    return;
  }
  if (own_producer && warp == 4 * nwg) {
    if (lane == 0)
      for (int it = 0; it < n_iter; ++it) load(it);
    return;
  }

  const int wg = warp >> 2, wl = warp & 3;
  epi.rl0 = wg * HW_ROWS + wl * 16 + (lane >> 2);
  epi.row0 = r0 + epi.rl0;
  epi.t = lane & 3;
  epi.start(bufs);

  // releases stage `it`; without a producer warp the first thread then
  // loads the stage that goes into its slot
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % stages]);
    if (!own_producer && threadIdx.x == 0 && it + stages < n_iter) load(it + stages);
  };
  if (!own_producer && threadIdx.x == 0)
    for (int it = 0; it < stages && it < n_iter; ++it) load(it);
  WAcc acc;
  int it = 0;
  for (int c = chunk0; c < chunk1; ++c) {
    for (int kk = 0; kk < ksteps; ++kk, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* st = ring + (size_t)s * stage_bytes;
      const bf16* xa = reinterpret_cast<const bf16*>(st + wg * HW_X_BYTES);
      const bf16* wb = reinterpret_cast<const bf16*>(st + nwg * HW_X_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < HW_BK / 16; ++k16)
        wgmma_m64n128k16(acc, wg_desc(xa + k16 * 16), wg_desc(wb + k16 * 16), kk > 0 || k16 > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is read
      if (kk > 0) release(it - 1);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    release(it - 1);
    epi.chunk(acc, c * HW_BN);
  }
  epi.finish(slice);
}

// K3 (bf16). Grid (row blocks of 128 rows, slices of cps chunks), K3_WG
// product warpgroups and K3_NOISE_WARPS noise warps (384 threads, no
// producer warp). W holds the vocabulary's columns [col_off, col_off +
// V) and x the batch's rows [row_off, row_off + R): the noise and the
// stored columns are the whole head's. ALIGNED: col_off % 4 == 0.
constexpr int K3_THREADS = K3_WG * 128 + 32 * K3_NOISE_WARPS;
template <bool ALIGNED>
__global__ void __launch_bounds__(K3_THREADS, 1)
head_sample_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, float4* __restrict__ part,
                         int* __restrict__ part_col, int R, int D, int V, int cps,
                         float inv_temp, uint32_t seed, uint32_t row_off, int col_off,
                         int stages) {
  extern __shared__ unsigned char hw_smem[];
  SampleEpi<ALIGNED> epi;
  epi.part = part;
  epi.part_col = part_col;
  epi.seed = seed;
  epi.row_off = row_off;
  head_slice(hw_smem, xmap, wmap, R, D, V, 0, cps, inv_temp, col_off, stages, epi);
}

// K4 (bf16). Grid (row blocks of 64 nwg rows, slices of cps chunks), 128
// nwg + 32 threads. W holds the vocabulary's columns [col_off, col_off +
// V): the pairs hold the whole head's columns.
__global__ void __launch_bounds__(HW_MAX_WG * 128 + 32, 1)
head_topk_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, float* __restrict__ part_v,
                       int* __restrict__ part_i, int R, int D, int V, int k, int cps,
                       float inv_temp, int col_off, int stages) {
  extern __shared__ unsigned char hw_smem[];
  TopkEpi epi;
  epi.part_v = part_v;
  epi.part_i = part_i;
  head_slice(hw_smem, xmap, wmap, R, D, V, k, cps, inv_temp, col_off, stages, epi);
}

// K5 (bf16): K4's grid, plan, tile and scratch, v1's sorted extraction.
__global__ void __launch_bounds__(HW_MAX_WG * 128 + 32, 1)
head_topk_v1_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, float* __restrict__ part_v,
                          int* __restrict__ part_i, int R, int D, int V, int k, int cps,
                          float inv_temp, int col_off, int stages) {
  extern __shared__ unsigned char hw_smem[];
  SortedEpi epi;
  epi.part_v = part_v;
  epi.part_i = part_i;
  head_slice(hw_smem, xmap, wmap, R, D, V, k, cps, inv_temp, col_off, stages, epi);
}

// K4's merge, a warp per row: lane s holds the head of slice s's sorted
// list; k times the warp takes the head that comes first (value
// descending, column ascending) and that lane moves on. Then K4's draw:
// Philox noise at the k survivors' columns (row row_off + row of the
// batch), Gumbel-max with the lowest slot winning a tie, and the
// probability under the softmax of the k. The slices are those of n_parts
// scratch parts of S each, part_bytes apart (one launch's, or the gathered
// parts of the ranks that split the vocabulary), n_parts S <= 32.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
head_topk_merge_kernel(const unsigned char* __restrict__ parts, size_t part_bytes,
                       int n_parts, int* __restrict__ ids, float* __restrict__ probs, int R,
                       int k, int S, uint32_t seed, uint32_t row_off) {
  extern __shared__ float merge_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * MERGE_WARPS + warp;
  if (row >= R) return;  // the whole warp
  float* mv = merge_smem + warp * 2 * k;
  int* mi = reinterpret_cast<int*>(mv + k);
  // lane = p S + s: slice s of part p
  const float* part_v =
      reinterpret_cast<const float*>(parts + (size_t)(lane / S) * part_bytes);
  const int* part_i = reinterpret_cast<const int*>(part_v + (size_t)S * R * k);
  const size_t base = ((size_t)(lane % S) * R + row) * k;
  int h = 0;
  float hv = -CUDART_INF_F;
  int hc = 0x7fffffff;
  if (lane < n_parts * S) {
    hv = part_v[base];
    hc = part_i[base];
  }
  for (int j = 0; j < k; ++j) {
    float bv = hv;
    int bc = hc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oc = __shfl_xor_sync(FULL, bc, off);
      if (ahead(ov, oc, bv, bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if (lane == 0) {
      mv[j] = bv;
      mi[j] = bc;
    }
    if (lane < n_parts * S && hc == bc && hv == bv) {  // columns are unique across slices
      ++h;
      hv = h < k ? part_v[base + h] : -CUDART_INF_F;
      hc = h < k ? part_i[base + h] : 0x7fffffff;
    }
  }
  __syncwarp();
  const float m = mv[0];
  float best = -CUDART_INF_F, sum = 0.f;
  int slot = 0x7fffffff;
  for (int s = lane; s < k; s += 32) {
    const float l = mv[s];
    sum += expf(l - m);
    const float pert = l - logf(exp_noise(seed, row_off + (uint32_t)row, (uint32_t)mi[s]));
    if (pert > best) {
      best = pert;
      slot = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int os = __shfl_xor_sync(FULL, slot, off);
    if (ob > best || (ob == best && os < slot)) {
      best = ob;
      slot = os;
    }
    sum += __shfl_xor_sync(FULL, sum, off);
  }
  if (lane == 0) {
    ids[row] = mi[slot];
    probs[row] = expf(mv[slot] - (m + logf(sum)));
  }
}

struct HeadPlan {
  int blocks = 0, splits = 1, cps = 1;
  int nwg = HW_MAX_WG, stages = HW_MAX_STAGES;  // consumer warpgroups a CTA, ring depth
  size_t smem = 0;
};

// The S slices of `blocks` row blocks over `chunks` chunks whose launch ends
// soonest when the card runs its CTAs in waves of `slots`, each slice
// walking ceil(chunks / S) chunks plus its start: for K4 and K5 a warm-up
// costed as TOPK_WARMUP chunks (their buffers start empty in every slice,
// so the first chunks insert most of the pairs), for K3 K3_START (the
// ring's fill, the merge's read); the fewer slices on a tie. S is
// then cut so that no slice is empty. A launch that is one of n_parts
// parts of a vocabulary split over ranks takes at most HT_MAX_SPLITS /
// n_parts slices, so that K4's merge holds every part's slices one a lane.
inline void plan_slices(int chunks, long slots, int k, int n_parts, HeadPlan& p) {
  long best_cost = -1;
  for (int s = 1; s <= HT_MAX_SPLITS / n_parts && s <= chunks; ++s) {
    const long waves = ((long)p.blocks * s + slots - 1) / slots;
    const long cost = waves * ((chunks + s - 1) / s + (k ? TOPK_WARMUP : K3_START));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      p.splits = s;
    }
  }
  p.cps = (chunks + p.splits - 1) / p.splits;
  p.splits = (chunks + p.cps - 1) / p.cps;
}

// The grid of the bf16 K3 (k = 0), K4 or K5 on the current card, one CTA
// an SM: K3_WG product warpgroups (K3), or two (128 rows) where K4's and
// K5's buffers fit, else one (k above about 80); the deepest ring up to
// 4 stages that fits beside them (K3: 3, beside its noise buffers). Then
// the slices (plan_slices): at R 8192, K3's 64 blocks of 128 rows in 2
// slices fill 128 of 132 SMs; at R 3328, K4's 26 blocks in 5 slices 130.
inline cudaError_t head_plan(int R, int V, int k, int n_parts, HeadPlan& p) {
  if (n_parts < 1 || n_parts > HT_MAX_SPLITS) return cudaErrorInvalidValue;
  int sms = 0, smem_sm = 0, optin = 0;
  const cudaError_t e = card_shape(sms, smem_sm, optin);
  if (e != cudaSuccess) return e;
  for (p.nwg = k == 0 ? K3_WG : HW_MAX_WG; p.nwg >= (k == 0 ? K3_WG : 1); --p.nwg) {
    for (p.stages = HW_MAX_STAGES; p.stages >= 2; --p.stages)
      if (hw_smem_bytes(p.nwg, p.stages, k) <= (size_t)optin) break;
    if (p.stages >= 2) break;
  }
  if (p.nwg < 1 || p.stages < 2) return cudaErrorInvalidValue;
  p.smem = hw_smem_bytes(p.nwg, p.stages, k);
  p.blocks = (R + p.nwg * HW_ROWS - 1) / (p.nwg * HW_ROWS);
  plan_slices((V + HW_BN - 1) / HW_BN, sms, k, n_parts, p);
  return cudaSuccess;
}

// Bytes of the slices' states: K3 (m, s, best, its logit) and the
// column per slice and row; K4 and K5 k (value, column) pairs per slice
// and row.
inline size_t head_scratch_bytes(int R, int k, const HeadPlan& p) {
  if (k == 0) return (size_t)p.splits * R * (sizeof(float4) + sizeof(int));
  return (size_t)p.splits * R * k * (sizeof(float) + sizeof(int));
}

// The TMA maps of x (R, D) and W (V, D) for the plan's tile: boxes of
// 64 deep by the CTA's rows and by a chunk's 128 columns
inline cudaError_t head_maps(const void* x, const void* w, int R, int D, int V,
                             const HeadPlan& p, CUtensorMap& xm, CUtensorMap& wm) {
  const uint64_t row = (uint64_t)D * sizeof(bf16);
  const uint64_t xd[2] = {(uint64_t)D, (uint64_t)R}, wd[2] = {(uint64_t)D, (uint64_t)V};
  const uint32_t xbox[2] = {HW_BK, (uint32_t)(p.nwg * HW_ROWS)}, wbox[2] = {HW_BK, HW_BN};
  const cudaError_t e = tma_map_bf16(xm, x, 2, xd, &row, xbox);
  return e == cudaSuccess ? tma_map_bf16(wm, w, 2, wd, &row, wbox) : e;
}

// K3's slices (bf16) into `scratch`: rows row_off.. of the batch against
// the vocabulary's columns col_off.., by the instantiation whose noise
// groups fit col_off
cudaError_t launch_sample_part(const void* x, const void* w, void* scratch, int R, int D,
                               int V, float inv_temp, uint32_t seed, uint32_t row_off,
                               int col_off, const HeadPlan& p, cudaStream_t stream) {
  if (col_off < 0) return cudaErrorInvalidValue;
  const auto kern =
      col_off % 4 == 0 ? head_sample_wgmma_kernel<true> : head_sample_wgmma_kernel<false>;
  CUtensorMap xm, wm;
  cudaError_t e = head_maps(x, w, R, D, V, p, xm, wm);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return e;
  float4* part = static_cast<float4*>(scratch);
  int* part_col = reinterpret_cast<int*>(part + (size_t)p.splits * R);
  kern<<<dim3(p.blocks, p.splits), K3_THREADS, p.smem, stream>>>(
      xm, wm, part, part_col, R, D, V, p.cps, inv_temp, seed, row_off, col_off, p.stages);
  return cudaGetLastError();
}

cudaError_t launch_sample_merge(const void* parts, size_t part_bytes, int n_parts, void* ids,
                                void* probs, int R, int S, cudaStream_t stream) {
  head_sample_merge_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
      static_cast<const unsigned char*>(parts), part_bytes, n_parts, static_cast<int*>(ids),
      static_cast<float*>(probs), R, S);
  return cudaGetLastError();
}

cudaError_t launch_sample_mma(const void* x, const void* w, void* ids, void* probs,
                              void* scratch, int R, int D, int V, float inv_temp, uint32_t seed,
                              cudaStream_t stream) {
  if (D % 8 != 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  HeadPlan p;
  cudaError_t e = head_plan(R, V, 0, 1, p);
  if (e != cudaSuccess) return e;
  e = launch_sample_part(x, w, scratch, R, D, V, inv_temp, seed, 0, 0, p, stream);
  if (e != cudaSuccess) return e;
  return launch_sample_merge(scratch, head_scratch_bytes(R, 0, p), 1, ids, probs, R, p.splits,
                             stream);
}

using TopkKernel = void (*)(CUtensorMap, CUtensorMap, float*, int*, int, int, int, int, int,
                            float, int, int);

// K4's or K5's slices (bf16, the slices' kernel `kern`) into `scratch`,
// against the vocabulary's columns col_off..
cudaError_t launch_topk_part(TopkKernel kern, const void* x, const void* w, void* scratch,
                             int R, int D, int V, int k, float inv_temp, int col_off,
                             const HeadPlan& p, cudaStream_t stream) {
  CUtensorMap xm, wm;
  cudaError_t e = head_maps(x, w, R, D, V, p, xm, wm);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return e;
  float* part_v = static_cast<float*>(scratch);
  int* part_i = reinterpret_cast<int*>(part_v + (size_t)p.splits * R * k);
  kern<<<dim3(p.blocks, p.splits), p.nwg * 128 + 32, p.smem, stream>>>(
      xm, wm, part_v, part_i, R, D, V, k, p.cps, inv_temp, col_off, p.stages);
  return cudaGetLastError();
}

cudaError_t launch_topk_merge(const void* parts, size_t part_bytes, int n_parts, void* ids,
                              void* probs, int R, int k, int S, uint32_t seed, uint32_t row_off,
                              cudaStream_t stream) {
  if (n_parts * S > HT_MAX_SPLITS) return cudaErrorInvalidValue;
  head_topk_merge_kernel<<<(R + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32,
                           MERGE_WARPS * 2 * k * sizeof(float), stream>>>(
      static_cast<const unsigned char*>(parts), part_bytes, n_parts, static_cast<int*>(ids),
      static_cast<float*>(probs), R, k, S, seed, row_off);
  return cudaGetLastError();
}

// K4 or K5 (bf16): the slices' kernel `kern`, then the merge and draw
cudaError_t launch_topk_wgmma(TopkKernel kern, const void* x, const void* w, void* ids,
                            void* probs, void* scratch, int R, int D, int V, int k,
                            float inv_temp, uint32_t seed, cudaStream_t stream) {
  if (D % 8 != 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  HeadPlan p;
  cudaError_t e = head_plan(R, V, k, 1, p);
  if (e != cudaSuccess) return e;
  e = launch_topk_part(kern, x, w, scratch, R, D, V, k, inv_temp, 0, p, stream);
  if (e != cudaSuccess) return e;
  return launch_topk_merge(scratch, head_scratch_bytes(R, k, p), 1, ids, probs, R, k, p.splits,
                           seed, 0, stream);
}

}  // namespace

extern "C" {

// Bytes of scratch the bf16 K3 (k = 0), K4 or K5 takes for R rows of a V
// vocabulary on the current card: the slices' states; 0 in fp32. *err
// gets the CUDA status of the plan.
size_t mebt_head_scratch_bytes(int R, int V, int k, int is_bf16, int* err) {
  *err = 0;
  if (!is_bf16 || R == 0) return 0;
  HeadPlan p;
  const cudaError_t e = head_plan(R, V, k, 1, p);
  if (e != cudaSuccess) {
    *err = (int)e;
    return 0;
  }
  return head_scratch_bytes(R, k, p);
}

// x (R,D), w (V,D) -> ids (R,) int32, probs (R,) fp32; scratch of
// mebt_head_scratch_bytes(R, V, 0, is_bf16) bytes.
int mebt_head_sample(const void* x, const void* w, void* ids, void* probs,
                     void* scratch, int R, int D, int V, float inv_temp,
                     unsigned int seed, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)launch_sample_mma(x, w, ids, probs, scratch, R, D, V,
                                          inv_temp, seed, s)
                 : (int)launch_fma(x, w, ids, probs, R, D, V, inv_temp, seed, s);
}

// As above with an exact top-k, 1 <= k <= min(V, 256), before the sample;
// scratch of mebt_head_scratch_bytes(R, V, k, is_bf16) bytes.
int mebt_head_topk_sample(const void* x, const void* w, void* ids, void* probs,
                          void* scratch, int R, int D, int V, int k,
                          float inv_temp, unsigned int seed, int is_bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > V || k > 256) return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)launch_topk_wgmma(head_topk_wgmma_kernel, x, w, ids, probs, scratch, R,
                                        D, V, k, inv_temp, seed, s)
                 : (int)launch_topk_fma(x, w, ids, probs, R, D, V, k, inv_temp,
                                        seed, s);
}

// K5: K4's function by v1's extraction loop, 1 <= k <= min(V, 256);
// scratch of mebt_head_scratch_bytes(R, V, k, is_bf16) bytes, as K4's.
int mebt_head_topk_sample_v1(const void* x, const void* w, void* ids, void* probs,
                             void* scratch, int R, int D, int V, int k, float inv_temp,
                             unsigned int seed, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > V || k > V1_MAX_K) return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)launch_topk_wgmma(head_topk_v1_wgmma_kernel, x, w, ids, probs, scratch,
                                        R, D, V, k, inv_temp, seed, s)
                 : (int)launch_topk_v1_fma(x, w, ids, probs, R, D, V, k, inv_temp, seed, s);
}

// The sharded head (bf16): the vocabulary split over n_parts ranks in
// rank order, this rank's W holding columns [col_off, col_off + V), x rows
// [row_off, row_off + R) of the batch. mebt_head_part_plan gives the bytes
// of this rank's part and its slices (*splits); mebt_head_*_part fills the
// part, the caller gathers the n_parts parts (rank order, part_bytes
// apart) and mebt_head_*_merge folds them as the slices of one launch:
// the whole head's ids, noise drawn at the whole head's (row, column).
size_t mebt_head_part_plan(int R, int V, int k, int n_parts, int* splits, int* err) {
  *err = 0;
  *splits = 0;
  if (R == 0) return 0;
  HeadPlan p;
  const cudaError_t e = head_plan(R, V, k, n_parts, p);
  if (e != cudaSuccess) {
    *err = (int)e;
    return 0;
  }
  *splits = p.splits;
  return head_scratch_bytes(R, k, p);
}

int mebt_head_sample_part(const void* x, const void* w, void* part, int R, int D, int V,
                          float inv_temp, unsigned int seed, unsigned int row_off, int col_off,
                          int n_parts, void* stream) {
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  HeadPlan p;
  const cudaError_t e = head_plan(R, V, 0, n_parts, p);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_sample_part(x, w, part, R, D, V, inv_temp, seed, row_off, col_off, p,
                                 static_cast<cudaStream_t>(stream));
}

int mebt_head_sample_merge(const void* parts, size_t part_bytes, int n_parts, void* ids,
                           void* probs, int R, int S, void* stream) {
  if (R == 0) return 0;
  return (int)launch_sample_merge(parts, part_bytes, n_parts, ids, probs, R, S,
                                  static_cast<cudaStream_t>(stream));
}

int mebt_head_topk_part(const void* x, const void* w, void* part, int R, int D, int V, int k,
                        float inv_temp, int col_off, int n_parts, void* stream) {
  if (D % 8 != 0 || k < 1 || k > 256) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  HeadPlan p;
  const cudaError_t e = head_plan(R, V, k, n_parts, p);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_topk_part(head_topk_wgmma_kernel, x, w, part, R, D, V, k, inv_temp, col_off,
                               p, static_cast<cudaStream_t>(stream));
}

int mebt_head_topk_merge(const void* parts, size_t part_bytes, int n_parts, void* ids,
                         void* probs, int R, int k, int S, unsigned int seed,
                         unsigned int row_off, void* stream) {
  if (R == 0) return 0;
  return (int)launch_topk_merge(parts, part_bytes, n_parts, ids, probs, R, k, S, seed, row_off,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
