// Hopper building blocks shared by attention.cu (K1, K2, K6, K7),
// head_sample.cu (K3, K4, K5) and vq.cu (K9), for sm_90a: TMA tensor maps
// and loads, mbarriers, rows gathered by cp.async into the layout TMA
// writes, and wgmma (warpgroup matrix multiply) with bf16 operands and
// fp32 sums (vq.cu adds its tf32 product).
//
// Every tile these kernels load is a run of rows of 64 bf16 or 32 fp32
// (128 bytes), which TMA writes into shared memory with the 128-byte
// swizzle: 16-byte granule c of row r lands at granule c ^ (r % 8) of the
// row. A tile's base sits at a 1024-byte boundary, so the swizzle pattern
// that TMA writes is the one wgmma reads through a descriptor of layout
// B128, whose 8-row groups lie 1024 bytes apart (the stride byte offset).
// K-major operands (the reduction dimension contiguous: Q, K, x, W, E)
// advance 16 bf16 (8 tf32) deep by adding 32 bytes to the descriptor's
// start address;
// an MN-major operand (V, its 64 columns contiguous) advances 16 deep by
// 16 rows, 2048 bytes. K1 and K6 take rows that TMA's tiled mode cannot
// fetch (the live keys of a batch row): gather_rows_b128 copies each with
// 16-byte cp.async to the place TMA would have put it, and the copies
// complete on an mbarrier as TMA's do (cp.async.mbarrier.arrive.noinc).
//
// The tensor maps are encoded on the host by the driver's
// cuTensorMapEncodeTiled, found in the loaded libcuda with dlsym (the
// libraries link no driver library), and kept in a small cache keyed by
// every argument: an encoding is a pure function of them, so a cached map
// is never stale. A kernel takes its maps as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "mma.cuh"

// ---------------------------------------------------------------------------
// host: tensor maps

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A tensor of `type` and `rank` <= 3 dimensions, innermost first, strides
// in bytes of dims 1.. (bytes[0] is that of dim 1), box[] elements a load,
// whose innermost box dimension is one swizzled 128-byte row. Elements
// outside the tensor load as zeros. Returns cudaErrorInvalidValue where
// the driver refuses it.
inline cudaError_t tma_map(CUtensorMap& map, CUtensorMapDataType type, const void* base,
                           int rank, const uint64_t* dims, const uint64_t* bytes,
                           const uint32_t* box) {
  struct Key {
    const void* base;
    int type;
    int rank;
    uint64_t dims[3], bytes[2];
    uint32_t box[3];
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  constexpr int N = 32;
  static Entry cache[N];
  static int used = 0, next = 0;
  static std::mutex mu;
  Key key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.type = (int)type;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.bytes[i] = bytes[i];
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (memcmp(&cache[i].key, &key, sizeof(Key)) == 0) {
      map = cache[i].map;
      return cudaSuccess;
    }
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorSharedObjectInitFailed;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], one[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = bytes[i];
  }
  const CUresult r = encode(&map, type, (cuuint32_t)rank,
                            const_cast<void*>(base), d, s, b, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  cache[next].key = key;
  cache[next].map = map;
  next = (next + 1) % N;
  if (used < N) ++used;
  return cudaSuccess;
}

// bf16: box[0] = 64 columns (attention.cu, head_sample.cu)
inline cudaError_t tma_map_bf16(CUtensorMap& map, const void* base, int rank,
                                const uint64_t* dims, const uint64_t* bytes,
                                const uint32_t* box) {
  return tma_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, bytes, box);
}

// fp32: box[0] = 32 columns (vq.cu: x and the codebook's TF32 planes)
inline cudaError_t tma_map_f32(CUtensorMap& map, const void* base, int rank,
                               const uint64_t* dims, const uint64_t* bytes,
                               const uint32_t* box) {
  return tma_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank, dims, bytes, box);
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA

// the first 1024-byte boundary at or after p (the swizzle's period)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrives once and adds `bytes` to the transaction count the phase awaits
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed. A wait past 2^34 SM
// cycles (some 10 s; a kernel here takes milliseconds) traps: a fault in
// the pipeline's bookkeeping ends the launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// The arrive-on of `bar` once every cp.async this thread issued before it
// has landed. noinc: the barrier's expected count already holds this
// arrival (init it with the number of threads that call this).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Orders what this thread sees of shared memory written through the
// generic proxy (plain stores, cp.async) before its own accesses through
// the async proxy (wgmma's operand reads, TMA): a consumer calls it after
// the mbarrier wait that made gathered rows visible, before its wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows of two tensors into two 1024-byte-aligned tiles of 64 rows of 64
// bf16 (128 bytes) as TMA would write a box of them with the 128-byte
// swizzle (granule c of row r at granule c ^ (r % 8)): row r < n of each
// tile is row rows[r] of its tensor (sa, sb), rows from n on are zeros.
// The 32 lanes of a warp share the 2 x 512 16-byte cp.async copies, eight
// lanes a row, so each row is read as one 128-byte run; a lane reads each
// row index once for both tensors. rows may point to shared or global
// memory.
__device__ __forceinline__ void gather_rows_b128(void* ta, const void* sa, void* tb,
                                                 const void* sb, const int* rows, int n,
                                                 int lane) {
  unsigned char* da = static_cast<unsigned char*>(ta);
  unsigned char* db = static_cast<unsigned char*>(tb);
  const unsigned char* pa = static_cast<const unsigned char*>(sa);
  const unsigned char* pb = static_cast<const unsigned char*>(sb);
  const int c = lane & 7;
#pragma unroll 4
  for (int r = lane >> 3; r < 64; r += 4) {
    const bool in = r < n;
    const size_t src = (size_t)(in ? rows[r] : 0) * 128 + c * 16;
    const int dst = r * 128 + ((c ^ (r & 7)) << 4);
    cp_async16(da + dst, pa + src, in);
    cp_async16(db + dst, pb + src, in);
  }
}

// a box of a 2D / 3D tensor map at element coordinates (c0 innermost)
// into shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma

// Descriptor of a B128-swizzled operand at p (a 1024-byte-aligned tile, or
// one advanced from it as the header says): start address >> 4, leading
// byte offset 1 (unused by swizzled layouts of one 64-column atom), stride
// byte offset 1024 >> 4, layout B128.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The descriptor d advanced by `bytes` (a multiple of 16) in shared memory:
// the start address field (14 bits, address >> 4) has room for any
// address of the 228 KB.
__device__ __forceinline__ uint64_t wg_desc_at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// orders earlier register and shared-memory accesses before the next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the accumulator registers after a wait (or before a product), so
// that no read or write of them moves across the asynchronous products
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The m64nNk16 accumulator: warp w of the warpgroup holds rows 16 w ..
// 16 w + 15; lane 4 g + t holds d[4 j + e] at row g + 8 (e >> 1), column
// 8 j + 2 t + (e & 1): mma.m16n8k16's C fragment for each 8 columns.

// d (64 x 64, fp32) += A B: A (64 x 16) and B (64 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += A B: A (64 x 16) and B (128 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A B: A (64 x 16) bf16 from registers (mma.m16n8k16's A
// fragment a warp), B (16 x 64) MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_m64n64k16_rt(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
