// Shared device code of the flash-attention kernels (flash_fwd.cu and
// flash_fwd_hopper.cu: K1, flash_bwd.cu and flash_bwd_hopper.cu: K2 and K3).
//
// Two paths.  bf16 at head_dim 64 / 128 (the training shapes) takes the
// Hopper kernels of flash_fwd_hopper.cu and flash_bwd_hopper.cu (TMA,
// wgmma, warp-specialised warpgroups; they use Params, the tile tests, the
// quad reductions, to_a_frags and store_frags from here).  fp32, and bf16
// at head_dim 256, take the shared-memory path: every kernel works on
// tiles staged in shared memory: q / k / v / do tiles of B rows x D dims in
// the input type T, a B x B fp32 score tile, a B x B probability (or dS)
// tile in T that feeds the next product, and B x D fp32 accumulators.  The
// tiled products are `gemm` below: `mma.sync` m16n8k16 with bf16 inputs
// and fp32 sums (operands fetched with `ldmatrix`) for bf16, and an fp32
// FMA loop for fp32 inputs (the tensor cores' TF32 keeps about three
// digits, too few for the fp32 contract).  The softmax and the masks run
// between the products, one warp per row.  Tile rows are B = 32, which
// keeps every kernel's shared memory under the 227 KB a block may use at
// head_dim 256.
//
// Masks are built from global positions exactly as the Pallas kernels
// build them (megatron_llm_tpu/ops/pallas/flash_attention.py: _mask,
// _run_block): causal (q >= kv), sliding window (q - kv < window) and
// segment ids (same document), plus the ragged edges (q < sq, kv < skv).
// Whole tiles in which no pair can be allowed are skipped.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

// The Pallas kernels' sentinel for a masked score; p = 0 where s <= NEG_INF / 2
// (the guard for rows that are fully masked so far).
constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

template <typename T, int D>
struct Shape {
  static constexpr int B = 32;  // tile rows
  static constexpr int PAD = 16 / (int)sizeof(T);  // 16 bytes of row padding
  static constexpr int LDT = D + PAD;  // pitch of a [B][D] tile of T
  static constexpr int LDP = B + PAD;  // pitch of a [B][B] tile of T
  static constexpr int LDS = B + 4;    // pitch of a [B][B] fp32 tile
  static constexpr int LDA = D + 4;    // pitch of a [B][D] fp32 accumulator
  static constexpr int TILE_T = B * LDT * (int)sizeof(T);
  static constexpr int TILE_P = B * LDP * (int)sizeof(T);
  static constexpr int TILE_S = B * LDS * 4;
  static constexpr int TILE_A = B * LDA * 4;
  static constexpr int VEC_F = B * 4;  // one float or int per tile row
};

// Everything a launch needs.  Strides are in elements of [b, s, heads, d]
// tensors whose last dimension is contiguous; lse / delta are
// [b, n, sq] fp32; out / dq are [b, sq, n, d] and dk / dv [b, skv, nkv, d],
// contiguous, in T or (out_f32) fp32.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* seg_q;
  const int* seg_kv;
  void* out;
  float* lse_out;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int b, sq, skv, n, nkv;
  float scale;
  int causal, window, out_f32;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void store_out(void* out, long long i, float x, int out_f32) {
  if (out_f32) static_cast<float*>(out)[i] = x;
  else static_cast<T*>(out)[i] = from_f<T>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Whether a [q0, q0 + bq) x [kv0, kv0 + bkv) tile can hold an allowed pair
// (the Pallas kernels' _run_block).
__device__ __forceinline__ bool run_tile(int q0, int kv0, int bq, int bkv,
                                         const Params& p) {
  if (p.causal && q0 + bq - 1 < kv0) return false;
  if (p.window > 0 && kv0 + bkv - 1 <= q0 - p.window) return false;
  return true;
}

// Whether query position qi may attend kv position kj (the Pallas _mask).
__device__ __forceinline__ bool allowed(int qi, int kj, int seg_qi, int seg_kj,
                                        const Params& p) {
  if (qi >= p.sq || kj >= p.skv) return false;
  if (p.causal && qi < kj) return false;
  if (p.window > 0 && qi - kj >= p.window) return false;
  if (p.seg_q != nullptr && seg_qi != seg_kj) return false;
  return true;
}

// Rows [row0, row0 + R) of one head of a [b, s, heads, D] tensor (`g` points
// at the head's first element of row 0, rows `ss` elements apart) into
// sm[R][LD]; rows at or past `s` are zeros.  16-byte loads.
template <typename T, int R, int D, int LD>
__device__ __forceinline__ void load_tile(T* sm, const T* g, long long ss, int row0,
                                          int s) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = D / VEC;
  for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = val;
  }
}

// v[i] = g[row0 + i] for the R rows of a tile, `fill` past `s` (g may be null).
template <typename V, int R>
__device__ __forceinline__ void load_vec(V* sm, const V* g, int row0, int s, V fill) {
  for (int i = threadIdx.x; i < R; i += THREADS)
    sm[i] = (g != nullptr && row0 + i < s) ? g[row0 + i] : fill;
}

template <int R, int C, int LD>
__device__ __forceinline__ void zero_acc(float* sm) {
  for (int i = threadIdx.x; i < R * C; i += THREADS) sm[(i / C) * LD + i % C] = 0.f;
}

// ---------------------------------------------------------------------------
// Tiled products: C[M][N] (fp32, pitch ldc) = (ACC ? C : 0) + A * op(B), A a
// row-major [M][K] tile; B_NT: B is stored [N][K] and op(B) = B^T, else B is
// stored [K][N].  Called by all THREADS threads; each owns fixed elements of
// C, so ACC reads and writes need no barrier.
// ---------------------------------------------------------------------------

template <int M, int N, int K, bool B_NT, bool ACC>
__device__ __forceinline__ void gemm_fma(const float* A, int lda, const float* B,
                                         int ldb, float* C, int ldc) {
  constexpr int TM = M / 16, TN = N / 16;  // a 16 x 16 thread grid
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      acc[i][j] = ACC ? C[(ty + 16 * i) * ldc + tx + 16 * j] : 0.f;
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = B_NT ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) C[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp w owns the 16 rows m0 = (w / WN) * 16 and N / WN columns from
// n0 = (w % WN) * N / WN, as NT tiles of 8; per 16-deep step it fetches its A
// fragment with one ldmatrix.x4 and each B fragment with one ldmatrix.x2
// (transposed when B is stored [K][N]).
template <int M, int N, int K, bool B_NT, bool ACC>
__device__ __forceinline__ void gemm_mma(const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb, float* C,
                                         int ldc) {
  constexpr int WM = M / 16;
  constexpr int WN = NWARPS / WM;
  constexpr int NT = N / WN / 8;
  static_assert(WM * WN == NWARPS && NT >= 1 && N % (WN * 8) == 0 && K % 16 == 0,
                "unsupported tile");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp / WN) * 16;
  const int n0 = (warp % WN) * (N / WN);
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + 8 * j + gc;
    if (ACC) {
      acc[j][0] = C[(m0 + gr) * ldc + col];
      acc[j][1] = C[(m0 + gr) * ldc + col + 1];
      acc[j][2] = C[(m0 + gr + 8) * ldc + col];
      acc[j][3] = C[(m0 + gr + 8) * ldc + col + 1];
    } else {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
  }
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, A + (m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nb = n0 + 8 * j;
      uint32_t b[2];
      if constexpr (B_NT)
        ldmatrix_x2(b, B + (nb + (lane & 7)) * ldb + k0 + ((lane >> 3) & 1) * 8);
      else
        ldmatrix_x2_trans(b, B + (k0 + (lane & 15)) * ldb + nb);
      mma_bf16(acc[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + 8 * j + gc;
    C[(m0 + gr) * ldc + col] = acc[j][0];
    C[(m0 + gr) * ldc + col + 1] = acc[j][1];
    C[(m0 + gr + 8) * ldc + col] = acc[j][2];
    C[(m0 + gr + 8) * ldc + col + 1] = acc[j][3];
  }
}

template <typename T, int M, int N, int K, bool B_NT, bool ACC>
__device__ __forceinline__ void gemm(const T* A, int lda, const T* B, int ldb, float* C,
                                     int ldc) {
  if constexpr (std::is_same<T, float>::value)
    gemm_fma<M, N, K, B_NT, ACC>(A, lda, B, ldb, C, ldc);
  else
    gemm_mma<M, N, K, B_NT, ACC>(A, lda, B, ldb, C, ldc);
}

// Set a kernel's dynamic shared memory limit, then launch it.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t st, const Params& p) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Pieces of the Hopper kernels (bf16, head_dim 64 / 128).  A wgmma
// accumulator holds, in each warp, 16 rows of the tile in the mma.sync C
// fragment layout (hopper.cuh), so the helpers below work per warp on
// [16][8 N] fragments.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// Work tiles walk groups of heads whose K / V (K2: also Q / dO) fit in L2
// together: a third of the H100's 50 MB.
constexpr long long L2_GROUP_BYTES = 16ll << 20;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether no pair of the tile is masked (the per-element checks can go).
__device__ __forceinline__ bool tile_full(int q0, int kv0, int bq, int bkv,
                                          const Params& p) {
  if (q0 + bq > p.sq || kv0 + bkv > p.skv || p.seg_q != nullptr) return false;
  if (p.causal && kv0 + bkv - 1 > q0) return false;
  if (p.window > 0 && q0 + bq - 1 - kv0 >= p.window) return false;
  return true;
}

// Score fragments (C layout: rows g / g + 8, columns 2c, 2c + 1 of each
// 8-wide tile) -> A fragments of the next product over those columns.
template <int NJ>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[NJ / 2][4], const float (&s)[NJ][4]) {
#pragma unroll
  for (int t = 0; t < NJ / 2; ++t) {
    pa[t][0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
    pa[t][1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
    pa[t][2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
    pa[t][3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a warp's [16][8 ND] fp32 fragments, scaled per row by inv[0] /
// inv[1], as rows `rows[0] / rows[1]` (skipped at or past `n_rows`) of a
// [b, s, heads, D] output whose row r starts at out + r * rs.
template <int ND>
__device__ __forceinline__ void store_frags(void* out, long long base, long long rs,
                                            const float (&acc)[ND][4], const int (&rows)[2],
                                            int n_rows, const float (&inv)[2], int out_f32) {
  const int gc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= n_rows) continue;
    const long long o = base + rows[i] * rs + gc;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float x = acc[nd][2 * i] * inv[i], y = acc[nd][2 * i + 1] * inv[i];
      if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o + 8 * nd) = make_float2(x, y);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + o + 8 * nd) = pack_bf16(x, y);
      }
    }
  }
}

}  // namespace flash

// Instantiate `FN<T, D>(params, stream)` for the runtime (dtype, d); `err`
// is cudaErrorInvalidValue for an unsupported combination.
#define FLASH_DISPATCH(FN, dtype, d, p, st, err)                          \
  switch ((dtype) * 1000 + (d)) {                                         \
    case 64: err = FN<float, 64>(p, st); break;                           \
    case 128: err = FN<float, 128>(p, st); break;                         \
    case 256: err = FN<float, 256>(p, st); break;                         \
    case 1064: err = FN<__nv_bfloat16, 64>(p, st); break;                 \
    case 1128: err = FN<__nv_bfloat16, 128>(p, st); break;                \
    case 1256: err = FN<__nv_bfloat16, 256>(p, st); break;                \
    default: err = cudaErrorInvalidValue;                                 \
  }
