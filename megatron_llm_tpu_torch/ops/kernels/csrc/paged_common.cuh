// Shared device code of the three paged-attention kernels
// (paged_ragged.cu, paged_decode.cu, paged_prefill.cu): one query token's
// GQA group of heads attends through one block table, for one kv head.
// This is their "rows" routine, for fp32 q and head_dim 256; bf16 / fp16 q
// at head_dim 64 / 128 take the tile routines (paged_tile.cuh,
// paged_prefill_tile.cuh), over plain and quantized pools alike.
//
// What bounds these kernels on an H100 is the bytes of K/V pages read from
// device memory (3.35 TB/s): about 4 flops per byte read, far below the
// tensor cores' ridge.  The design keeps many loads in flight and every
// intermediate out of device memory:
//
// * each of the block's warps walks its own 8-token chunks of the context
//   (chunk c, c + NW, c + 2 NW, ...; a page holds a whole number of
//   chunks, which is why page_size % 8 == 0); a chunk's 8 K rows and 8 V
//   rows are loaded together, each lane loading its D/32 contiguous dims;
// * the queries (pre-scaled), the running max, the normalizer and the fp32
//   accumulator live in registers; there is no block barrier inside the
//   walk;
// * after the walk the warps' partial softmax states merge once through
//   shared memory and the block writes its [heads, D] output.
//
// The Pallas kernel's sequential page axis becomes each warp's loop;
// nothing carries between blocks.
//
// Quantized pools (--kv_dtype int8 / fp8: ops/kv_quant.py) store K/V as
// one byte an element (int8, or fp8 e4m3) with one fp32 scale per (page,
// kv head).  The storage type S is a template parameter beside q's type T
// (S == T: a plain pool).  A lane loads its D/32 storage bytes of a chunk
// row, converts them to fp32 exactly (int8 by a cast, e4m3 by cuda_fp8.h's
// conversion) and multiplies by the page's scale, which the warp loads once
// per chunk (a chunk lies in one page); the fp32 online softmax after that
// is the plain pool's.  Device memory traffic stays at the quantized bytes
// plus 4 bytes of scale per (page, kv head): the Pallas kernels' fused
// dequantize after the page DMA (_decode_kernel, _prefill_kernel,
// _ragged_kernel in megatron_llm_tpu/ops/pallas/paged_attention.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

// Masked scores carry this value; p = 0 where s <= NEG_INF / 2 (the Pallas
// kernels' constant and "fully masked so far" guard).
constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNK = 8;  // kv tokens a warp takes per step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N contiguous elements of T (N * sizeof(T) in {2, 4, 8, 16, 32} bytes,
// aligned to min(16, that)) as raw 32-bit words.  Two bytes a lane is a
// one-byte pool at head_dim 64.
template <typename T, int N>
struct Raw {
  static constexpr int BYTES = N * (int)sizeof(T);
  static constexpr int WORDS = (BYTES + 3) / 4;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + k);
        w[4 * k] = r.x; w[4 * k + 1] = r.y; w[4 * k + 2] = r.z; w[4 * k + 3] = r.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = r.x; w[1] = r.y;
    } else if constexpr (BYTES == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      static_assert(BYTES == 2, "a lane loads 2, 4, 8 or a multiple of 16 bytes");
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  __device__ __forceinline__ float at(int u) const {
    return to_f(reinterpret_cast<const T*>(w)[u]);
  }
};

// Attend `ng` (<= GP) query heads of one token through `table`, kv head h.
// q_row / out_row point at the group's first head ([ng][D], contiguous);
// the token sits at position `pos` and attends to kv positions <= pos inside
// the sliding window (window <= 0: none), on the pages that start below
// `hor` (a dead row, horizon 0, touches no page and writes zeros).  The
// pools hold S: T for a plain pool, int8_t or __nv_fp8_e4m3 for a quantized
// one, whose values are scaled by k_scale / v_scale [pages][nkv] (unread
// for a plain pool).
// Shared memory: s_m / s_l [NWARPS][GP], s_acc [NWARPS][GP][D].
template <typename T, typename S, int D, int GP>
__device__ void attend_row(const T* __restrict__ q_row, T* __restrict__ out_row,
                           int ng, const S* __restrict__ k_pool,
                           const S* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ table, int W, int page,
                           int nkv, int h, int pos, int hor, float scale,
                           int window, float* s_m, float* s_l, float* s_acc) {
  constexpr bool QUANT = !std::is_same<S, T>::value;
  constexpr int DPL = D / 32;  // dims per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // tokens [lo, hi): the pages the Pallas walk visits
  int lo = 0;
  if (window > 0 && pos - window + 1 > 0) lo = ((pos - window + 1) / page) * page;
  const int64_t hor_tok = (((int64_t)hor + page - 1) / page) * page;
  const int hi = (int)min((int64_t)min(pos + 1, W * page), hor_tok);

  float qr[GP][DPL], acc[GP][DPL], m[GP], l[GP];
#pragma unroll
  for (int gi = 0; gi < GP; ++gi) {
    Raw<T, DPL> r;
    if (gi < ng) {
      r.load(q_row + (int64_t)gi * D + lane * DPL);
#pragma unroll
      for (int u = 0; u < DPL; ++u) qr[gi][u] = r.at(u) * scale;
    } else {
#pragma unroll
      for (int u = 0; u < DPL; ++u) qr[gi][u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[gi][u] = 0.f;
    m[gi] = NEG_INF;
    l[gi] = 0.f;
  }

  const int64_t tok_stride = (int64_t)nkv * D;
  for (int c0 = lo + warp * CHUNK; c0 < hi; c0 += NWARPS * CHUNK) {
    const int j = c0 / page;
    const int64_t pid = table[j];
    const int64_t base = ((pid * page + (c0 - j * page)) * nkv + h) * D + lane * DPL;
    Raw<S, DPL> kr[CHUNK], vr[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) kr[t].load(k_pool + base + t * tok_stride);
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) vr[t].load(v_pool + base + t * tok_stride);
    // the chunk's page scales (a quantized pool): x = q * scale in fp32
    float ks = 1.f, vs = 1.f;
    if constexpr (QUANT) {
      ks = __ldg(k_scale + pid * nkv + h);
      vs = __ldg(v_scale + pid * nkv + h);
    }
    // element u of chunk row t in fp32 (a plain pool: its value as it is)
    auto kf = [&](int t, int u) -> float {
      if constexpr (QUANT) return kr[t].at(u) * ks;
      else return kr[t].at(u);
    };
    auto vf = [&](int t, int u) -> float {
      if constexpr (QUANT) return vr[t].at(u) * vs;
      else return vr[t].at(u);
    };

#pragma unroll
    for (int gi = 0; gi < GP; ++gi) {
      float s[CHUNK];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < DPL; ++u) dot += qr[gi][u] * kf(t, u);
        s[t] = warp_sum(dot);
        const int kv = c0 + t;
        const bool ok = kv <= pos && (window <= 0 || pos - kv < window);
        s[t] = ok ? s[t] : NEG_INF;
      }
      float mx = m[gi];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) mx = fmaxf(mx, s[t]);
      const float alpha = expf(m[gi] - mx);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        s[t] = s[t] <= NEG_INF * 0.5f ? 0.f : expf(s[t] - mx);
        psum += s[t];
      }
      l[gi] = alpha * l[gi] + psum;
      m[gi] = mx;
#pragma unroll
      for (int u = 0; u < DPL; ++u) {
        float a = acc[gi][u] * alpha;
#pragma unroll
        for (int t = 0; t < CHUNK; ++t) a += s[t] * vf(t, u);
        acc[gi][u] = a;
      }
    }
  }

  // merge the warps' partial states
#pragma unroll
  for (int gi = 0; gi < GP; ++gi) {
    if (lane == 0) {
      s_m[warp * GP + gi] = m[gi];
      s_l[warp * GP + gi] = l[gi];
    }
#pragma unroll
    for (int u = 0; u < DPL; ++u)
      s_acc[(warp * GP + gi) * D + lane * DPL + u] = acc[gi][u];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ng * D; e += blockDim.x) {
    const int gi = e / D;
    const int c = e - gi * D;
    float mx = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, s_m[w * GP + gi]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(s_m[w * GP + gi] - mx);
      lsum += f * s_l[w * GP + gi];
      a += f * s_acc[(w * GP + gi) * D + c];
    }
    // no page attended: l == 0 and the accumulator is 0 -> exact zeros
    out_row[e] = from_f<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
  __syncthreads();
}

// Heads per pass for a GQA group of g heads: registers hold GP query rows.
inline int heads_per_pass(int g, int d) {
  const int cap = d >= 256 ? 4 : 8;
  int gp = 1;
  while (gp < g && gp < cap) gp *= 2;
  return gp;
}

// The pools' storage type S of the kernels for q's type T and a storage
// code KV: 0 = a plain pool in T, 1 = int8, 2 = fp8 e4m3.  Each paged source
// compiles once a code (build.py: -DPAGED_KV=0, 1, 2), so an object holds
// one storage type's instantiations and the three build in parallel.
template <typename T, int KV> struct Storage { using type = T; };
template <typename T> struct Storage<T, 1> { using type = int8_t; };
template <typename T> struct Storage<T, 2> { using type = __nv_fp8_e4m3; };

}  // namespace paged

#ifndef PAGED_KV
#define PAGED_KV 0  // the storage code this object instantiates
#endif
#define PAGED_CAT_(a, b) a##_##b
#define PAGED_CAT(a, b) PAGED_CAT_(a, b)
// `name_<PAGED_KV>`: the object's own routine (rows or tile)
#define PAGED_ROWS(name) PAGED_CAT(name, PAGED_KV)

// Instantiate `KERNEL<T, PAGED_KV, D, GP>` for the runtime (dtype, d, gp) and
// launch it with `ARGS`; sets `err` (cudaErrorInvalidValue for an
// unsupported combo).  dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q's
// type T).
#define PAGED_DISPATCH_GP(KERNEL, T, D, gp, grid, stream, err, ...)               \
  switch (gp) {                                                                  \
    case 1: KERNEL<T, PAGED_KV, D, 1><<<grid, paged::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    case 2: KERNEL<T, PAGED_KV, D, 2><<<grid, paged::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    case 4: KERNEL<T, PAGED_KV, D, 4><<<grid, paged::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    case 8: KERNEL<T, PAGED_KV, D, 8><<<grid, paged::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    default: err = cudaErrorInvalidValue;                                        \
  }

#define PAGED_DISPATCH_D(KERNEL, T, d, gp, grid, stream, err, ...)                \
  switch (d) {                                                                   \
    case 64: PAGED_DISPATCH_GP(KERNEL, T, 64, gp, grid, stream, err, __VA_ARGS__) break;   \
    case 128: PAGED_DISPATCH_GP(KERNEL, T, 128, gp, grid, stream, err, __VA_ARGS__) break; \
    case 256: PAGED_DISPATCH_GP(KERNEL, T, 256, gp, grid, stream, err, __VA_ARGS__) break; \
    default: err = cudaErrorInvalidValue;                                        \
  }

#define PAGED_DISPATCH(KERNEL, dtype, d, gp, grid, stream, err, ...)                   \
  switch (dtype) {                                                                     \
    case 0: PAGED_DISPATCH_D(KERNEL, float, d, gp, grid, stream, err, __VA_ARGS__) break; \
    case 1: PAGED_DISPATCH_D(KERNEL, __nv_bfloat16, d, gp, grid, stream, err, __VA_ARGS__) break; \
    case 2: PAGED_DISPATCH_D(KERNEL, __half, d, gp, grid, stream, err, __VA_ARGS__) break; \
    default: err = cudaErrorInvalidValue;                                              \
  }
