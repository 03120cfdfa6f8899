// Hopper (sm_90a) building blocks of the port's warp-specialised kernels:
// TMA tensor maps (encoded on the host) and loads, mbarrier rings, named
// barriers, register reallocation (setmaxnreg), wgmma shared-memory
// descriptors, the wgmma products the flash kernels use, and the fences
// around them.  Used by flash_fwd_hopper.cu (K1) and flash_bwd_hopper.cu
// (K2 / K3); paged_tile.cuh (K4 / K5) uses the tensor maps (16-bit, and
// one-byte ones for quantized pools), TMA loads, mbarriers and the cp.async
// copies of the page scales; paged_prefill_tile.cuh (K6) also the wgmma
// products in bf16 and fp16, the proxy fence, and the cluster barrier and
// loads that fold its segments.
//
// Shared-memory tiles are [rows][64] bf16 sub-tiles: 128 bytes a row, laid
// down by a TMA load with CU_TENSOR_MAP_SWIZZLE_128B (each 16-byte chunk of
// row r moves to chunk index ^ (r % 8)), every sub-tile 1024-byte aligned.
// A head_dim of 128 is two sub-tiles side by side in memory ([2][rows][64]).
// wgmma reads them through 128B-swizzle descriptors:
//
// * K-major operand (Q and K in S = Q K^T: the reduced dimension d is
//   contiguous): 8-row groups 1024 bytes apart (SBO); a k16 step moves the
//   start address 32 bytes inside the 128-byte row, and the fifth step
//   starts on the next sub-tile.
// * MN-major operand (V in O += P V, K in dQ += dS K, dO and Q in the
//   backward's dV / dK products: the output dimension d is contiguous,
//   read with wgmma's transpose bit): 8-row groups of the reduced
//   dimension 1024 bytes apart (SBO), the next 64 output columns one
//   sub-tile further (LBO: the sub-tile's rows x 128 bytes); a k16 step
//   moves 16 rows, 2048 bytes.
//
// The wgmma accumulator of m64nN puts, in each warp w of the warpgroup,
// rows 16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0, 1} in
// registers [j][0..3] (the mma.sync C fragment, N / 8 times); the A operand
// of the register form takes the mma.sync m16n8k16 A fragment.  So a score
// accumulator turns into the next product's A operand with
// flash_common.cuh's to_a_frags.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Host: TMA tensor maps.  cuTensorMapEncodeTiled lives in libcuda, which
// the library does not link, so it is looked up through the runtime.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) ptr = nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A 4-D map of 16-bit elements (bf16, or fp16 for `type`) over a
// [b, s, heads, d] tensor: `geo` holds the global dims innermost first (d,
// heads, s, b) and the byte strides of heads, s and b (7 values).  A box is
// `rows` rows of one head by 64 columns, 128B-swizzled; rows past s read as
// zeros and still count in the box's transaction bytes.  With `type`
// UINT8: one-byte elements (quantized KV pages, fp8 moved as bytes), boxes
// of `rows` rows x `cols` bytes, 128B- or 64B-swizzled (`swizzle`: 16-byte
// chunk c of row r lands at chunk c ^ (r % 8), or c ^ ((r / 2) % 4)).  TMA
// takes byte strides that are multiples of 16.
inline cudaError_t encode_rows_bf16(
    CUtensorMap* map, const void* base, const long long* geo, uint32_t rows,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B, uint32_t cols = 64) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)geo[0], (cuuint64_t)geo[1], (cuuint64_t)geo[2],
                              (cuuint64_t)geo[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)geo[4], (cuuint64_t)geo[5], (cuuint64_t)geo[6]};
  const cuuint32_t box[4] = {cols, 1, rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr,
            "cuTensorMapEncodeTiled failed (CUresult %d): dims %lld %lld %lld %lld, byte "
            "strides %lld %lld %lld, box rows %u\n",
            (int)r, geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6], rows);
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Device: shared-memory addresses, mbarriers, TMA, named barriers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier has completed the phase of parity `parity` (its
// current phase differs from it).  Acquire: the waiter sees what the
// arrivals released and the bytes the TMA wrote.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D map (coordinates innermost first) into shared memory;
// completion counts on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 4 bytes from global `src` into shared `dst` by cp.async; `src_bytes` 0
// writes zeros and reads nothing.  Then an arrival on `bar` once every
// cp.async this thread started so far has landed (.noinc: the barrier's
// init count includes it).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Order this thread's generic-proxy writes to shared memory before the
// async proxy's reads that follow a barrier (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (0 is __syncthreads') over `threads` threads: sync
// waits, arrive only counts.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Thread block clusters: a barrier over every block of the cluster (its
// arrival releases this thread's writes, its wait acquires the others'),
// and loads from another block's shared memory (distributed shared memory):
// `addr` is this block's shared address of the same variable, `rank` the
// other block's rank in the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Hand registers between warpgroups; every warp of the warpgroup runs it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma: descriptors, ordering, products.
// ---------------------------------------------------------------------------

// A 128B-swizzle shared-memory matrix descriptor; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Order this thread's register and shared-memory accesses before the
// wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wait that completes it (the products write it asynchronously).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// The wgmma products, in bf16 (the default) or fp16 (T = __half): the
// accumulator's registers as asm operands, the instruction with its
// operand types spliced in.
#define HOPPER_ACC4(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define HOPPER_ACC32(d)                                                                   \
  HOPPER_ACC4(d, 0), HOPPER_ACC4(d, 1), HOPPER_ACC4(d, 2), HOPPER_ACC4(d, 3),             \
      HOPPER_ACC4(d, 4), HOPPER_ACC4(d, 5), HOPPER_ACC4(d, 6), HOPPER_ACC4(d, 7)
#define HOPPER_ACC64(d)                                                                   \
  HOPPER_ACC32(d), HOPPER_ACC4(d, 8), HOPPER_ACC4(d, 9), HOPPER_ACC4(d, 10),              \
      HOPPER_ACC4(d, 11), HOPPER_ACC4(d, 12), HOPPER_ACC4(d, 13), HOPPER_ACC4(d, 14),     \
      HOPPER_ACC4(d, 15)
#define HOPPER_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
// A and B from shared memory, both K-major; the predicate is scale_d.
#define HOPPER_SS_ASM(N, TY, REGS, A, B, P)                                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"                                         \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " REGS ", %" A ", %" B     \
  ", p, 1, 1, 0, 0;\n}\n"
// A in registers, B from shared memory MN-major (the transpose bit);
// scale_d is 1 (accumulate).
#define HOPPER_RS_ASM(N, TY, REGS, A0, B, P)                                             \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"                                         \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " REGS ", {%" A0           \
  "}, %" B ", p, 1, 1, 1;\n}\n"

// d (+)= A B: m64n128k16, A and B from shared memory, both K-major;
// scale_d 0 starts the sum from zero.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[16][4], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(HOPPER_SS_ASM("128", "f16", HOPPER_REGS64, "64", "65", "66")
                 : HOPPER_ACC64(d) : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  else
    asm volatile(HOPPER_SS_ASM("128", "bf16", HOPPER_REGS64, "64", "65", "66")
                 : HOPPER_ACC64(d) : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The same at n64 (a 64-row B tile).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[8][4], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(HOPPER_SS_ASM("64", "f16", HOPPER_REGS32, "32", "33", "34")
                 : HOPPER_ACC32(d) : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  else
    asm volatile(HOPPER_SS_ASM("64", "bf16", HOPPER_REGS32, "32", "33", "34")
                 : HOPPER_ACC32(d) : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A B: A (m64 x k16) in registers as mma.sync A fragments, B from
// shared memory MN-major (the transpose bit), n128 and n64.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[16][4],
                                                   const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(HOPPER_RS_ASM("128", "f16", HOPPER_REGS64, "64, %65, %66, %67", "68", "69")
                 : HOPPER_ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  else
    asm volatile(HOPPER_RS_ASM("128", "bf16", HOPPER_REGS64, "64, %65, %66, %67", "68", "69")
                 : HOPPER_ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[8][4],
                                                   const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(HOPPER_RS_ASM("64", "f16", HOPPER_REGS32, "32, %33, %34, %35", "36", "37")
                 : HOPPER_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  else
    asm volatile(HOPPER_RS_ASM("64", "bf16", HOPPER_REGS32, "32, %33, %34, %35", "36", "37")
                 : HOPPER_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace hopper
