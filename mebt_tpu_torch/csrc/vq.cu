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
// 3xTF32: each fp32 operand v is split into hi = tf32(v) and lo = tf32(v
// - hi) (cvt.rna's rounding to nearest, ties away from zero, by integer
// operations; both parts have their low 13 bits zero, so the tensor cores
// read them exactly), and
//   x . e = hi_x hi_e + (hi_x lo_e + lo_x hi_e)
// with fp32 sums (lo_x lo_e, some 2^-22 of a term, is dropped). The two
// small products go to an accumulator of their own, added to the large
// one once per chunk: the tensor cores' fp32 sums truncate, and a small
// product added to the large sum would lose its low bits. A term is then
// off by about 3 2^-22 |x_d e_d|, far inside the rule ops/vq.py:
// code_mismatches holds every answer to, (D + 2) 2^-24 (|e|^2 + 2 sum
// |x e|); one TF32 product alone would miss it by some 2^5. Integer data
// stays exact (lo = 0, small sums), so exact ties stay ties.
//
// Three kernels a call, in order on the stream:
// - nearest_code_split_kernel splits E once into hi and lo planes (K, Dp)
//   in scratch the wrapper allocates (32 MB at K 16384, D 256: 0.016 ms
//   on the H100), so that no warp splits a codebook value;
// - nearest_code_wgmma_kernel: a CTA keeps its 128 rows of x (64 where
//   D > 256) in shared memory, fp32 as TMA writes them (128-byte-swizzled
//   tiles 32 deep, loaded once), and walks 128-code chunks of ITS SLICE
//   of the codebook. Each chunk's hi and lo planes stream 32 deep by TMA
//   (one 3-D box of both) into a ring of stages behind mbarriers. Each
//   consumer warpgroup of 64 rows reads its x fragments of a stage's
//   four 8-deep steps by ldmatrix (the tf32 A layout), splits them in
//   registers, and issues three wgmma m64n128k8 tf32 products a step
//   with A from registers: big += hi_x hi_e, small += hi_x lo_e, small
//   += lo_x hi_e (one group of twelve a stage). After a chunk's full
//   depth the epilogue folds s = fmaf(-2, big + small, |e_k|^2) into a
//   running (min, argmin) per thread and row over ascending codes with a
//   strict '<'; while one warpgroup splits or folds, the other's
//   products run. At the slice's end the quad folds by shuffles, the
//   lower index winning equal scores;
// - nearest_code_merge_kernel folds the slices IN SLICE ORDER with a
//   strict '<': the lowest index wins equal scores over the whole
//   codebook and two calls give the same bits. S = 1 launches it too.
// Rows past M, codes past K and depths past D are loaded as zeros by TMA
// and never stored or considered.
//
// Why x is split in registers and E by a pass: x's two planes for a
// 128-row block at D 256 would take 256 KB of shared memory, so x stays
// resident in fp32 and each consumer splits the 16 values of a stage it
// needs (some 80 instructions per 12 products of 64 x 128 x 8).
//
// What holds it back (scripts/k9_variants.py, NVIDIA H100 80GB HBM3 at
// 700 W): 3.75 ms at 128f, 56% of the three products' 2.08 ms. Without
// any product it still takes 2.23 ms: a stage's codebook tile lands and
// its x is split, then its products run, and with two stages a ring
// (a third measured slower) the two barely overlap. Half the codebook's
// L2 traffic takes about as long (3.67 ms), so L2 bytes do not bound it.
//
// The grid is (row blocks) x (S codebook slices of whole chunks); the
// host picks S from the SM count (nc_plan) so that the CTAs fill the card
// (M 6144 gives 48 row blocks for 132 SMs).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "card.cuh"
#include "hopper.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 64;                   // rows of x a consumer warpgroup
constexpr int BN = 128;                    // codes per chunk
constexpr int BK = 32;                     // depth per stage: one 128-byte row of fp32
constexpr int MAX_WG = 2;                  // consumer warpgroups a CTA
constexpr int THREADS = MAX_WG * 128;      // no producer warp: see the kernel
constexpr int STAGES = 2;                  // the ring: a third stage measured slower
constexpr int E_TILE = BN * BK * 4;        // one plane of a stage, 16 KB
constexpr int STAGE_BYTES = 2 * E_TILE;    // hi, then lo
constexpr int MAX_SPLITS = 64;
constexpr int MAX_D = 512;                 // the widths the checks cover

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10
// mantissa bits) by two integer operations on the bits
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v as hi + lo, both tf32 (their bit patterns)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d (64 x 128, fp32) += A B: A (64 x 8) tf32 from registers (mma.m16n8k8's
// tf32 A fragment a warp: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)),
// B (128 x 8) tf32 K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// (s, i) before (t, j): the lower score, then the lower index
__device__ __forceinline__ bool before(float s, int i, float t, int j) {
  return s < t || (s == t && i < j);
}

// hi and lo planes of n fp32 values (v = hi + lo, both tf32), four a
// thread, by 16-byte loads and stores where n % 4 == 0
__global__ void __launch_bounds__(256)
nearest_code_split_kernel(const float* __restrict__ v, float* __restrict__ hi,
                          float* __restrict__ lo, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  const bool vec = n % 4 == 0;  // lo = hi + n is then at a 16-byte boundary too
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < n; i += stride) {
    if (vec) {
      const float4 x = *reinterpret_cast<const float4*>(v + i);
      uint32_t h[4], l[4];
      split_tf32(x.x, h[0], l[0]);
      split_tf32(x.y, h[1], l[1]);
      split_tf32(x.z, h[2], l[2]);
      split_tf32(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(hi + i) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
    } else {
      for (long long j = i; j < n; ++j) {
        uint32_t h, l;
        split_tf32(v[j], h, l);
        hi[j] = __uint_as_float(h);
        lo[j] = __uint_as_float(l);
      }
    }
  }
}

// Shared memory of a CTA of nwg consumer warpgroups at width Dp: x's
// depth tiles (64 nwg rows of 128 bytes each), the ring, its barriers and
// release tickets.
constexpr size_t nc_smem_bytes(int nwg, int Dp) {
  return 1024 + (size_t)((Dp + BK - 1) / BK) * nwg * ROWS * 128 + (size_t)STAGES * STAGE_BYTES +
         sizeof(uint64_t) * (STAGES + 1) + sizeof(int) * STAGES;
}

// One CTA: rows m0.. (64 a consumer warpgroup) over the chunks of slice
// blockIdx.y. xmap: x (M, Dp) fp32, boxes of 32 x 64 nwg; emap: the hi and
// lo planes (2, K, Dp), boxes of 32 x 128 x 2. Dp % 4 == 0.
//
// No producer warp: ptxas gives a CTA of more than 256 threads 168
// registers a thread whatever its bounds say, and the two accumulators
// and a stage's x parts need more (at 168 it spilled and serialized every
// wgmma). Thread 0 issues x's load and the ring's first stages; after
// that the second warpgroup to be done with a stage (a ticket a stage in
// shared memory, no waiting) refills it.
__global__ void __launch_bounds__(THREADS, 1)
nearest_code_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap emap, const float* __restrict__ e2,
                          float* __restrict__ part_s, int* __restrict__ part_i, int M, int K,
                          int Dp, int cps) {
  extern __shared__ unsigned char nc_smem[];
  const int nwg = blockDim.x >> 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bm = nwg * ROWS;
  const int m0 = blockIdx.x * bm;
  const int nchunks = (K + BN - 1) / BN;
  const int c_begin = blockIdx.y * cps;
  const int c_end = min(nchunks, c_begin + cps);
  const int nt = (Dp + BK - 1) / BK;  // stages a chunk
  const int n_iter = (c_end - c_begin) * nt;
  unsigned char* xs = align1024(nc_smem);
  unsigned char* ring = xs + (size_t)nt * bm * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)STAGES * STAGE_BYTES);
  uint64_t* xbar = full + STAGES;
  int* tickets = reinterpret_cast<int*>(xbar + 1);
  // stage `it`: the chunk's hi and lo planes, 32 deep, into its slot
  auto load = [&](int it) {
    const int s = it % STAGES;
    mbar_expect_tx(&full[s], (uint32_t)STAGE_BYTES);
    tma_load_3d(ring + (size_t)s * STAGE_BYTES, &emap, &full[s], (it % nt) * BK,
                (c_begin + it / nt) * BN, 0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      tickets[s] = 0;
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(xbar, (uint32_t)(nt * bm * 128));
    for (int t = 0; t < nt; ++t) tma_load_2d(xs + (size_t)t * bm * 128, &xmap, xbar, t * BK, m0);
    for (int it = 0; it < STAGES && it < n_iter; ++it) load(it);
  }

  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: lane L gives row (L & 7) + 8 ((L >> 3) & 1) of the warp's 16
  // and 16-byte granule (L >> 4) of the step's two; the swizzle puts
  // granule c of row r at c ^ (r & 7)
  const int lrow = wg * ROWS + wl * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const unsigned char* xrow = xs + lrow * 128;
  const int lsw = lane & 7, lgr = lane >> 4;

  float big[64], small[64];
  float best[2] = {CUDART_INF_F, CUDART_INF_F};
  int best_i[2] = {0, 0};

  // the warpgroup is done with stage `it` (its four warps past their
  // waits); the second warpgroup done with it loads stage it + STAGES
  auto release = [&](int it) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (wl == 0 && lane == 0 && atomicAdd(&tickets[it % STAGES], 1) % nwg == nwg - 1 &&
        it + STAGES < n_iter)
      load(it + STAGES);
  };
  mbar_wait(xbar, 0);
  int it = 0;
  for (int c = c_begin; c < c_end; ++c) {
    for (int kt = 0; kt < nt; ++kt, ++it) {
      const int s = it % STAGES;
      const unsigned char* eh = ring + (size_t)s * STAGE_BYTES;
      const uint64_t dh = wg_desc(eh), dl = wg_desc(eh + E_TILE);
      const unsigned char* xt = xrow + (size_t)kt * bm * 128;
      // the stage's x parts, four 8-deep steps (past Dp the stage holds
      // zeros), split while its codebook stage may still be landing
      uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, xt + (((2 * kk + lgr) ^ lsw) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[kk][i], al[kk][i]);
      }
      mbar_wait(&full[s], (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int acc = kt > 0 || kk > 0;
        wgmma_m64n128k8_tf32_rs(big, ah[kk], wg_desc_at(dh, 32 * kk), acc);
        wgmma_m64n128k8_tf32_rs(small, ah[kk], wg_desc_at(dl, 32 * kk), acc);
        wgmma_m64n128k8_tf32_rs(small, al[kk], wg_desc_at(dh, 32 * kk), 1);
      }
      wgmma_commit();
      // the stage's products end before its parts' registers are reused;
      // the other warpgroup's products keep the tensor cores busy
      wgmma_wait<0>();
      release(it);
    }
    wgmma_fence_regs(big);
    wgmma_fence_regs(small);

    // the chunk's scores: d[4 j + e] is row g + 8 (e >> 1), code 8 j + 2 t +
    // (e & 1); each thread's codes ascend, so '<' keeps the first of a tie
    const int c0 = c * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        const int k = c0 + 8 * j + 2 * t + cb;
        if (k >= K) continue;
        const float ek = __ldg(e2 + k);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + cb;
          const float sc = fmaf(-2.f, big[i] + small[i], ek);
          if (sc < best[h]) {
            best[h] = sc;
            best_i[h] = k;
          }
        }
      }
  }

  // the quad's four code columns
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os = __shfl_xor_sync(FULL, best[h], off);
      const int oi = __shfl_xor_sync(FULL, best_i[h], off);
      if (before(os, oi, best[h], best_i[h])) {
        best[h] = os;
        best_i[h] = oi;
      }
    }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * ROWS + wl * 16 + g + 8 * h;
      if (row < M) {
        part_s[(size_t)blockIdx.y * M + row] = best[h];
        part_i[(size_t)blockIdx.y * M + row] = best_i[h];
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

struct NcPlan {
  int nwg, splits, cps;
  size_t smem;
};

// The launch on the current card: two consumer warpgroups (128 rows)
// where their x and the ring fit in shared memory, else one. The codebook
// slices S: the count
// whose launch ends soonest when the CTAs run in waves (slots = SMs x
// CTAs an SM), each CTA costing its chunks plus one for loading x and
// the ring's fill; the fewer slices on a tie. `force` > 0 takes that
// count instead (tests). S is cut so that no slice is empty.
inline cudaError_t nc_plan(int M, int K, int Dp, int force, NcPlan& p) {
  int sms = 0, smem_sm = 0, optin = 0;
  cudaError_t e = card_shape(sms, smem_sm, optin);
  if (e != cudaSuccess) return e;
  p.nwg = nc_smem_bytes(MAX_WG, Dp) <= (size_t)optin ? MAX_WG : 1;
  p.smem = nc_smem_bytes(p.nwg, Dp);
  if (p.smem > (size_t)optin) return cudaErrorInvalidValue;
  e = opt_in_smem(nearest_code_wgmma_kernel);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = blocks_per_sm(nearest_code_wgmma_kernel, p.nwg * 128, p.smem, per_sm);
  if (e != cudaSuccess) return e;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long blocks = (M + p.nwg * ROWS - 1) / (p.nwg * ROWS);
  const int chunks = (K + BN - 1) / BN;
  int splits = 1;
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
  p.cps = (chunks + splits - 1) / splits;
  p.splits = (chunks + p.cps - 1) / p.cps;
  return cudaSuccess;
}

inline int split_blocks(long long n) {
  int sms = 0, smem_sm = 0, optin = 0;
  if (card_shape(sms, smem_sm, optin) != cudaSuccess || sms < 1) sms = 132;
  const long long want = (n + 4 * 256 - 1) / (4 * 256);
  return (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
}

}  // namespace

extern "C" {

// The slices S the search takes for (M, K) at width Dp on the current
// card (`force` > 0: that many, cut to the chunk count), or -1 with
// *status set. Scratch: 8 K Dp + 8 S M bytes.
int mebt_nearest_code_splits(int M, int K, int Dp, int force, int* status) {
  NcPlan p;
  const cudaError_t e = nc_plan(M, K, Dp, force, p);
  *status = (int)e;
  return e == cudaSuccess ? p.splits : -1;
}

// hi and lo planes (out, then out + n) of n fp32 values at v: the split
// pass alone. v and out at 16-byte boundaries.
int mebt_tf32_split(const void* v, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  float* hi = static_cast<float*>(out);
  nearest_code_split_kernel<<<split_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), hi, hi + n, n);
  return (int)cudaGetLastError();
}

// x (M, Dp), e (K, Dp) fp32 with Dp % 4 == 0 (zero-padded past D), at
// 16-byte boundaries; e2 (K,) fp32 -> out (M,) int64. scratch, at a
// 16-byte boundary: the hi and lo planes of e (8 K Dp bytes), then the
// slices' (score, index) pairs (8 S M bytes for the S of
// mebt_nearest_code_splits(M, K, Dp, force)).
int mebt_nearest_code(const void* x, const void* e, const void* e2, void* out, void* scratch,
                      int M, int K, int Dp, int force, void* stream) {
  if (M < 1 || K < 1 || Dp < 4 || Dp % 4 != 0 || Dp > MAX_D) return (int)cudaErrorInvalidValue;
  NcPlan p;
  cudaError_t err = nc_plan(M, K, Dp, force, p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)K * Dp;
  float* hi = static_cast<float*>(scratch);
  float* part_s = hi + 2 * n;
  int* part_i = reinterpret_cast<int*>(part_s + (size_t)p.splits * M);
  nearest_code_split_kernel<<<split_blocks(n), 256, 0, s>>>(static_cast<const float*>(e), hi,
                                                           hi + n, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, emap;
  const uint64_t xd[2] = {(uint64_t)Dp, (uint64_t)M}, xb[1] = {(uint64_t)Dp * 4};
  const uint32_t xbox[2] = {BK, (uint32_t)(p.nwg * ROWS)};
  const uint64_t ed[3] = {(uint64_t)Dp, (uint64_t)K, 2};
  const uint64_t eb[2] = {(uint64_t)Dp * 4, (uint64_t)n * 4};
  const uint32_t ebox[3] = {BK, BN, 2};
  err = tma_map_f32(xmap, x, 2, xd, xb, xbox);
  if (err == cudaSuccess) err = tma_map_f32(emap, hi, 3, ed, eb, ebox);
  if (err != cudaSuccess) return (int)err;
  nearest_code_wgmma_kernel<<<dim3((M + p.nwg * ROWS - 1) / (p.nwg * ROWS), p.splits),
                              p.nwg * 128, p.smem, s>>>(
      xmap, emap, static_cast<const float*>(e2), part_s, part_i, M, K, Dp, p.cps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nearest_code_merge_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      part_s, part_i, static_cast<long long*>(out), M, p.splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
