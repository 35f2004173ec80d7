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
// Layout and tiling: one CTA owns 64 rows of x and keeps them resident
// in shared memory, transposed (Xs[d][row], D rounded up to 32, zeros
// beyond D), for the whole walk over the codebook. The codebook streams
// through in chunks of 64 codes x 32 depths (Es[d][code]). Each of the
// 256 threads owns a 4x4 register tile (rows ty*4.., codes tx*4..) of
// fp32 FMA products: two 16-byte shared loads feed 16 FMAs. After a
// chunk's full depth, each thread folds its 4x4 scores into a running
// (min, argmin) per row; codes arrive in ascending order and the fold
// uses a strict '<', so a thread keeps the lowest index among equal
// scores. At the end the 16 threads that share a row (one half-warp)
// merge with shuffles, the lower index winning equal scores. Codes past
// K are computed on zeros and never considered (the TPU kernel pads
// them with +inf instead).
//
// Bound on the card: 2*M*K*D operations (3.4e11 at M = 40960, K = 16384,
// D = 256, STL-128f batch 5), against some 23-170 MB of x, E and the
// output: operations, at the fp32 rate, 67 TFLOP/s. This first version
// stays in fp32 on the FMA pipes, as the argmin must match an fp32
// reference; a 3xTF32 split on the tensor cores is later work. At
// STL-16f batch 6 (M = 6144) the grid is 96 CTAs for 132 SMs; splitting
// the codebook across CTAs with a merge pass is later work too.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TM = 64;        // rows of x per CTA
constexpr int TK = 64;        // codes per chunk
constexpr int DT = 32;        // depth per codebook stage
constexpr int THREADS = 256;  // 16x16 threads of 4x4
constexpr int P = TM + 4;     // pitch keeps float4 alignment
constexpr int MAX_D = 512;    // resident x tile: 512 x 68 x 4 B = 136 KB

__host__ __device__ inline int padded_depth(int D) { return (D + DT - 1) / DT * DT; }

__global__ void __launch_bounds__(THREADS)
nearest_code_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    const float* __restrict__ e2, long long* __restrict__ out,
                    int M, int K, int D) {
  extern __shared__ __align__(16) float Xs[];  // [Dp][P]
  __shared__ __align__(16) float Es[DT][P];

  const int Dp = padded_depth(D);
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < TM * Dp; i += THREADS) {
    const int r = i / Dp, d = i % Dp;
    const int gr = m0 + r;
    Xs[d * P + r] = (gr < M && d < D) ? x[(size_t)gr * D + d] : 0.f;
  }

  float best[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += TK) {
    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;

    for (int d0 = 0; d0 < Dp; d0 += DT) {
      __syncthreads();  // Es is rewritten; the first pass also waits for Xs
      for (int i = tid; i < TK * DT; i += THREADS) {
        const int cc = i / DT, dd = i % DT;
        const int gc = k0 + cc, gd = d0 + dd;
        Es[dd][cc] = (gc < K && gd < D) ? e[(size_t)gc * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DT; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(&Xs[(d0 + dd) * P + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Es[dd][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < K) {
        const float ek = e2[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = fmaf(-2.f, c[i][j], ek);
          if (s < best[i]) {
            best[i] = s;
            best_i[i] = k;
          }
        }
      }
    }
  }

  // the 16 threads of a row group are one half-warp: lanes differ in tx only
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, best[i], off);
      const int oi = __shfl_xor_sync(FULL, best_i[i], off);
      if (ov < best[i] || (ov == best[i] && oi < best_i[i])) {
        best[i] = ov;
        best_i[i] = oi;
      }
    }
    const int row = m0 + ty * 4 + i;
    if (tx == 0 && row < M) out[row] = best_i[i];
  }
}

}  // namespace

extern "C" {

// x (M, D), e (K, D), e2 (K,) fp32 -> out (M,) int64. 1 <= D <= 512.
int mebt_nearest_code(const void* x, const void* e, const void* e2, void* out,
                      int M, int K, int D, void* stream) {
  if (M < 1 || K < 1 || D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)padded_depth(D) * P * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + TM - 1) / TM);
  nearest_code_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(e2), static_cast<long long*>(out), M, K, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
