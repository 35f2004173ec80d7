// K9: nearest codebook entry, for sm_90a.
//
// Replaces the TPU kernel mebt_tpu/ops/vq_pallas.py:nearest_code_pallas
// (_nn_kernel). For each row x_m of x (M, D) it returns
//   argmin_k  -2 x_m . e_k + |e_k|^2
// over the codebook E (K, D), in fp32; |x_m|^2 is constant per row and
// dropped, as the TPU kernel drops it. The lowest index wins an exact
// tie. |e_k|^2 comes from the caller (computed once per call in
// PyTorch, as the JAX wrapper computes it outside its pallas_call).
// The (M, K) score matrix never reaches device memory.
//
// Bound on the card: 2 M K D operations (3.4e11 at M = 40960, K = 16384,
// D = 256, STL-128f batch 5) against some 23-170 MB of x, E and the
// output: operations. At the fp32 FMA rate (67 TFLOP/s) that is 5.13 ms;
// done as 3xTF32 on the tensor cores (three products at 495 TFLOP/s) it
// is 2.08 ms.
//
// Products on the tensor cores in 3xTF32 (nearest_code_tf32_kernel):
// each fp32 operand v is split as it leaves shared memory into hi =
// tf32(v) and lo = tf32(v - hi) (cvt.rna's rounding to nearest, by
// integer operations), and
//   x . e = hi_x hi_e + (hi_x lo_e + lo_x hi_e)
// by mma.sync m16n8k8 tf32 with fp32 sums (lo_x lo_e, some 2^-22 of a
// term, is dropped). The two small products go to an accumulator of
// their own, added to the large one once per chunk: the tensor cores'
// fp32 sums truncate, and a small product added to the large sum would
// lose its low bits. A term is then off by about 3 2^-22 |x_d e_d|, far
// inside the rule ops/vq.py:code_mismatches holds every answer to,
// (D + 2) 2^-24 (|e|^2 + 2 sum |x e|); one TF32 product alone would miss
// it by some 2^5. Integer data stays exact (lo = 0, small sums), so exact
// ties stay ties.
//
// Tiling: a CTA of 8 warps takes 128 rows of x and walks 128-code chunks
// of ITS SLICE of the codebook; warp (wm, wn) owns rows 32 wm.. and codes
// 64 wn.. of a chunk, 2 x 8 m16n8 fragments a thread in each of the two
// accumulators. x and E stream row-major, 64 deep at a time, with 16-byte
// cp.async into a three-stage ring (rows padded to 68 floats, so the
// eight rows an ldmatrix phase reads fall in distinct banks); ldmatrix
// of 8 x 8 b16 tiles delivers 8 x 4 fp32 tiles in the tf32 fragment
// layout, so there is no transpose. After a chunk's full depth the
// epilogue reads the fragments: s = |e_k|^2 - 2 (big + small) into a
// running (min, argmin)
// per thread and row over the codes in ascending order with a strict
// '<'; at the slice's end the quad folds by shuffles and the two code
// warps through shared memory, the lower index winning equal scores.
// Rows past M and codes past K are computed on zeros and never stored or
// considered.
//
// The grid is (row blocks) x (S codebook slices of whole chunks); the
// host picks S from the SM count (nc_plan) so that the CTAs fill the
// card at both training shapes (M 6144 gives 48 row blocks for 132
// SMs). Each CTA leaves (min score, argmin) per row in scratch that the
// wrapper allocates, and nearest_code_merge_kernel folds the slices IN
// SLICE ORDER with a strict '<': the lowest index wins equal scores over
// the whole codebook and two calls give the same bits. S = 1 launches
// the merge too, a trivial one.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/
// k9_k7_variants.py): 154 TFLOP/s of TF32 products at M 40960, a third
// of the tensor cores' rate. The issue slots bound it: a warp splits 24
// operand values (five operations each) for every 48 mma.sync, with 200
// registers a thread and one CTA an SM; the cvt.rna instruction in
// place of the integer rounding costs some 10%, 32-deep stages 5%.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "card.cuh"
#include "mma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BM = 128;          // rows of x per CTA
constexpr int BN = 128;          // codes per chunk
constexpr int KS = 64;           // depth per stage
constexpr int STAGES = 3;
constexpr int PITCH = KS + 4;    // floats per shared row
constexpr int WARPS = 8;         // 4 along the rows x 2 along the codes
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SPLITS = 64;
constexpr int MAX_D = 512;       // the widths the checks cover
constexpr size_t SMEM = sizeof(float) * STAGES * (BM + BN) * PITCH;

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10
// mantissa bits) by two integer operations on the bits: every operand
// element is split as it leaves shared memory, and the cvt.rna
// instruction in their place measured some 10% slower
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v as hi + lo, both tf32 (their bit patterns)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// four 8 x 4 fp32 tiles from shared memory (ldmatrix's 8 x 8 b16 tiles):
// lanes 8 i .. 8 i + 7 give the rows of tile i, and lane 4 g + t gets
// element (g, t) of each tile, the tf32 fragment layout of mma.m16n8k8
__device__ __forceinline__ void ldsm_x4_f32(float (&r)[4], const float* p) {
  uint32_t u[4];
  ldsm_x4(u, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(u[i]);
}

// c += a b, 16 x 8 x 8, tf32 operands, fp32 sums
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (s, i) before (t, j): the lower score, then the lower index
__device__ __forceinline__ bool before(float s, int i, float t, int j) {
  return s < t || (s == t && i < j);
}

// Dp is D rounded up to a multiple of 4 (the wrapper pads x and E with
// zeros); cps chunks a slice.
__global__ void __launch_bounds__(THREADS, 1)
nearest_code_tf32_kernel(const float* __restrict__ x, const float* __restrict__ e,
                         const float* __restrict__ e2, float* __restrict__ part_s,
                         int* __restrict__ part_i, int M, int K, int Dp, int cps) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int nchunks = (K + BN - 1) / BN;
  const int c_begin = blockIdx.y * cps;
  const int c_end = min(nchunks, c_begin + cps);
  const int nst = (Dp + KS - 1) / KS;
  const int nsteps = (c_end - c_begin) * nst;

  // stage i of step (chunk c, depth d0): x rows m0.., E rows c BN.., depth d0..
  auto load = [&](int step) {
    float* xs = smem + (step % STAGES) * (BM + BN) * PITCH;
    float* es = xs + BM * PITCH;
    const int c = c_begin + step / nst, d0 = (step % nst) * KS;
    for (int i = threadIdx.x; i < (BM + BN) * (KS / 4); i += THREADS) {
      const int r = i / (KS / 4), col = (i % (KS / 4)) * 4;
      const bool is_x = r < BM;
      const int gr = is_x ? m0 + r : c * BN + (r - BM);
      const bool in = (is_x ? gr < M : gr < K) && d0 + col < Dp;
      const float* src = (is_x ? x : e) + (in ? (size_t)gr * Dp + d0 + col : 0);
      cp_async16((is_x ? xs + r * PITCH : es + (r - BM) * PITCH) + col, src, in);
    }
  };

  float big[2][8][4], small[2][8][4];
  float best[4];
  int best_i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    best[r] = CUDART_INF_F;
    best_i[r] = 0;
  }
  auto clear = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) big[mt][nt][q] = small[mt][nt][q] = 0.f;
  };
  clear();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this step's stage is in; every warp is done with the one refilled next
    if (step + STAGES - 1 < nsteps) load(step + STAGES - 1);
    cp_async_commit();

    const float* xs = smem + (step % STAGES) * (BM + BN) * PITCH;
    const float* es = xs + BM * PITCH;
    const int d0 = (step % nst) * KS;
    const int kdepth = min(KS, Dp - d0);  // a multiple of 4; zeros past D
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      if (kk >= kdepth) break;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {  // tiles: rows 0-7 / 8-15 x depths 0-3 / 4-7
        float a[4];
        ldsm_x4_f32(a, xs + (wm * 32 + mt * 16 + (lane & 15)) * PITCH + kk + (lane >> 4) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[mt][i], al[mt][i]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // tiles: codes of nt = 2 np, 2 np + 1 x depths 0-3 / 4-7
        float b[4];
        ldsm_x4_f32(b, es + (wn * 64 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * PITCH + kk +
                           ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = 2 * np + h;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b[2 * h], bh0, bl0);
          split_tf32(b[2 * h + 1], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma1688(small[mt][nt], ah[mt], bl0, bl1);
            mma1688(small[mt][nt], al[mt], bh0, bh1);
            mma1688(big[mt][nt], ah[mt], bh0, bh1);
          }
        }
      }
    }

    if (step % nst == nst - 1) {  // the chunk's full depth: fold its scores
      const int c0 = (c_begin + step / nst) * BN + wn * 64;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = c0 + nt * 8 + 2 * t + j;
          if (k >= K) continue;
          const float ek = __ldg(e2 + k);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float s = fmaf(-2.f, big[mt][nt][2 * h + j] + small[mt][nt][2 * h + j], ek);
              if (s < best[2 * mt + h]) {  // ascending codes: the first keeps a tie
                best[2 * mt + h] = s;
                best_i[2 * mt + h] = k;
              }
            }
        }
      clear();
    }
  }
  cp_async_wait<0>();

  // the quad, then the two code warps of a row block
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os = __shfl_xor_sync(FULL, best[r], off);
      const int oi = __shfl_xor_sync(FULL, best_i[r], off);
      if (before(os, oi, best[r], best_i[r])) {
        best[r] = os;
        best_i[r] = oi;
      }
    }
  __syncthreads();  // the ring is free
  float* fold_s = smem;                               // [BM] from the wn = 1 warps
  int* fold_i = reinterpret_cast<int*>(smem + BM);    // [BM]
  if (wn == 1 && t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wm * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
      fold_s[row] = best[r];
      fold_i[row] = best_i[r];
    }
  }
  __syncthreads();
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wm * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
      float s = best[r];
      int i = best_i[r];
      if (before(fold_s[row], fold_i[row], s, i)) {
        s = fold_s[row];
        i = fold_i[row];
      }
      if (m0 + row < M) {
        part_s[(size_t)blockIdx.y * M + m0 + row] = s;
        part_i[(size_t)blockIdx.y * M + m0 + row] = i;
      }
    }
  }
}

// out[m] = the index of the best of the S slices' (score, index), taken
// in slice order with a strict '<' (slice s holds lower codes than s + 1)
__global__ void __launch_bounds__(256)
nearest_code_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                          long long* __restrict__ out, int M, int S) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float best = part_s[m];
  int idx = part_i[m];
  for (int s = 1; s < S; ++s) {
    const float v = part_s[(size_t)s * M + m];
    if (v < best) {
      best = v;
      idx = part_i[(size_t)s * M + m];
    }
  }
  out[m] = idx;
}

// The codebook slices S on the current card: the count whose launch ends
// soonest when the CTAs run in waves (slots = SMs x CTAs an SM), each CTA
// costing its chunks plus one for the ring's fill and its fold; the fewer
// slices on a tie. `force` > 0 takes that count instead (tests). S is cut
// so that no slice is empty.
inline cudaError_t nc_plan(int M, int K, int force, int& splits, int& cps) {
  int sms = 0, smem_sm = 0, optin = 0;
  cudaError_t e = card_shape(sms, smem_sm, optin);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaFuncSetAttribute(nearest_code_tf32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e == cudaSuccess) e = blocks_per_sm(nearest_code_tf32_kernel, THREADS, SMEM, per_sm);
  if (e != cudaSuccess) return e;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long blocks = (M + BM - 1) / BM;
  const int chunks = (K + BN - 1) / BN;
  splits = 1;
  if (force > 0) {
    splits = force;
  } else {
    long best_cost = -1;
    for (int s = 1; s <= MAX_SPLITS && s <= chunks; ++s) {
      const long waves = (blocks * s + slots - 1) / slots;
      const long cost = waves * ((chunks + s - 1) / s + 1);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        splits = s;
      }
    }
  }
  splits = min(splits, chunks);
  cps = (chunks + splits - 1) / splits;
  splits = (chunks + cps - 1) / cps;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The slices S the search takes for (M, K) on the current card (`force`
// > 0: that many, cut to the chunk count), or -1 with *status set.
// Scratch: S * M * 8 bytes.
int mebt_nearest_code_splits(int M, int K, int force, int* status) {
  int splits = 1, cps = 1;
  const cudaError_t e = nc_plan(M, K, force, splits, cps);
  *status = (int)e;
  return e == cudaSuccess ? splits : -1;
}

// x (M, Dp), e (K, Dp) fp32 with Dp % 4 == 0 (zero-padded past D), at
// 16-byte boundaries; e2 (K,) fp32 -> out (M,) int64. scratch: S * M
// * 8 bytes for the S of mebt_nearest_code_splits(M, K, force).
int mebt_nearest_code(const void* x, const void* e, const void* e2, void* out, void* scratch,
                      int M, int K, int Dp, int force, void* stream) {
  if (M < 1 || K < 1 || Dp < 4 || Dp % 4 != 0 || Dp > MAX_D) return (int)cudaErrorInvalidValue;
  int splits = 1, cps = 1;
  cudaError_t err = nc_plan(M, K, force, splits, cps);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_s = static_cast<float*>(scratch);
  int* part_i = reinterpret_cast<int*>(part_s + (size_t)splits * M);
  nearest_code_tf32_kernel<<<dim3((M + BM - 1) / BM, splits), THREADS, SMEM, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(e2), part_s, part_i, M, K, Dp, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nearest_code_merge_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      part_s, part_i, static_cast<long long*>(out), M, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
