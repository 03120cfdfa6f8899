// Fused RMSNorm over the last axis: forward (K7) and backward (K8).
//
// Replaces the Pallas TPU kernels megatron_llm_tpu/ops/pallas/rmsnorm.py
// (_fwd_kernel and _bwd_kernel, launched by fused_rms_norm and its vjp).
// For rows x [rows, h] with weight w [h]:
//
//   r  = rsqrt(mean(x^2) + eps)          (fp32)
//   y  = x * r * w                       (rounded once to x's type)
//   dx = r * (g*w) - x * r^3 * mean(x * g*w)
//   dw = sum over rows of g * x * r      (fp32, rounded once to w's type)
//
// Bound on the H100: bytes (3.35 TB/s).  K7 reads x and writes y, K8 reads
// x and g and writes dx: about 4 and 10 flops an element, far below the
// card's ridge.  Design:
//
// * One block per row (K7) or per chunk of consecutive rows (K8).  A
//   thread holds its slots of the row in registers: NV vectors of 16 bytes
//   (slot k of thread t is vector t + k * blockDim), so x and g are read
//   from device memory once; the row's sums (sum x^2, and for K8 also
//   sum x*g*w) are fp32, taken with warp shuffles and one exchange through
//   shared memory, in a fixed order.
// * When h is not a multiple of a vector (16 bytes of x), rows do not
//   start on a 16-byte boundary, so the kernels take a scalar path: the
//   same layout with one element a slot.
// * dw: the Pallas kernel carries an fp32 accumulator across its
//   sequential row grid.  CUDA blocks run in no order, so each K8 block
//   keeps its columns' partial sums over its chunk of rows in registers and
//   writes them to a workspace [chunks, h]; a second kernel sums the chunks
//   in a fixed order and rounds once to w's type.  No atomics: dw is
//   bitwise the same from run to run.
#include "device_guard.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmsnorm {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_H = 16384;   // the widest row the register layout holds
// A row of up to 1024 slots takes one slot a thread; a wider one takes
// BIG_ELEMS elements a thread, in blocks of at most 512 threads (registers:
// K8 holds x, g and the dw partials, 3 * 32 floats a thread).
constexpr int BIG_ELEMS = 32;
constexpr int BIG_THREADS = 512;

// Threads a block of slots NV may have: the register budget of each.
template <int NV>
constexpr int max_threads() { return NV == 1 ? MAX_THREADS : BIG_THREADS; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// N elements of T at p as fp32, read with 16-byte accesses (N * sizeof(T) a
// multiple of 16) or as one element (N == 1); store_vec writes them back.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  if constexpr (N == 1) {
    out[0] = to_f(p[0]);
  } else {
    constexpr int Q = N * (int)sizeof(T) / 16;
    static_assert(Q * 16 == N * (int)sizeof(T), "16-byte accesses");
    uint4 raw[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) raw[q] = reinterpret_cast<const uint4*>(p)[q];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int u = 0; u < N; ++u) out[u] = to_f(e[u]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* in) {
  if constexpr (N == 1) {
    p[0] = from_f<T>(in[0]);
  } else {
    constexpr int Q = N * (int)sizeof(T) / 16;
    static_assert(Q * 16 == N * (int)sizeof(T), "16-byte accesses");
    uint4 raw[Q];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int u = 0; u < N; ++u) e[u] = from_f<T>(in[u]);
#pragma unroll
    for (int q = 0; q < Q; ++q) reinterpret_cast<uint4*>(p)[q] = raw[q];
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's sums of a and b, in every thread.  red: shared [32].
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // the previous row's readers of red are done
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const float2 s = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float2(0.f, 0.f);
  return make_float2(warp_sum(s.x), warp_sum(s.y));
}

// Load NV slots of VEC elements of row p (thread t: vectors t + k * blockDim)
// as fp32; slots past nvec read nothing.
template <typename T, int VEC, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int nvec,
                                         float (&out)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    if (v < nvec) load_vec<T, VEC>(p + (int64_t)v * VEC, out[k]);
  }
}

template <typename T, int VEC, int NV>
__device__ __forceinline__ void store_row(T* __restrict__ p, int nvec,
                                          const float (&in)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    if (v < nvec) store_vec<T, VEC>(p + (int64_t)v * VEC, in[k]);
  }
}

// K7: one block per row.
template <typename T, typename W, int VEC, int NV>
__global__ void __launch_bounds__(max_threads<NV>())
fwd_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
           int h, float eps) {
  __shared__ float2 red[32];
  const int nvec = h / VEC;
  const int64_t off = (int64_t)blockIdx.x * h;
  float xv[NV][VEC], wv[NV][VEC];
  load_row<T, VEC, NV>(x + off, nvec, xv);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if ((int)threadIdx.x + k * (int)blockDim.x < nvec) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) ss += xv[k][u] * xv[k][u];
    }
  }
  const float r = rsqrtf(block_sum2(ss, 0.f, red).x / (float)h + eps);
  load_row<W, VEC, NV>(w, nvec, wv);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int u = 0; u < VEC; ++u) xv[k][u] = xv[k][u] * r * wv[k][u];
  }
  store_row<T, VEC, NV>(y + off, nvec, xv);
}

// K8, first pass: dx of rows [chunk * rows_per_chunk, +rows_per_chunk) and
// the chunk's fp32 partial dw, written to part[chunk, :].  w is re-read
// each row, a slot at a time, from L1 / L2.
template <typename T, typename W, int VEC, int NV>
__global__ void __launch_bounds__(max_threads<NV>())
bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
           const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
           int rows, int h, int rows_per_chunk, float eps) {
  __shared__ float2 red[32];
  const int nvec = h / VEC;
  float acc[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[k][u] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  for (int row = r0; row < r1; ++row) {
    const int64_t off = (int64_t)row * h;
    float xv[NV][VEC], gv[NV][VEC];
    load_row<T, VEC, NV>(x + off, nvec, xv);
    load_row<T, VEC, NV>(g + off, nvec, gv);
    float ss = 0.f, sxgw = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = threadIdx.x + k * blockDim.x;
      if (v < nvec) {
        float wv[VEC];
        load_vec<W, VEC>(w + (int64_t)v * VEC, wv);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          ss += xv[k][u] * xv[k][u];
          sxgw += xv[k][u] * (gv[k][u] * wv[u]);
        }
      }
    }
    const float2 s = block_sum2(ss, sxgw, red);
    const float r = rsqrtf(s.x / (float)h + eps);
    const float mean_xgw = s.y / (float)h;
    const float r3 = r * r * r;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = threadIdx.x + k * blockDim.x;
      if (v < nvec) {
        float wv[VEC];
        load_vec<W, VEC>(w + (int64_t)v * VEC, wv);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const float xe = xv[k][u], ge = gv[k][u];
          acc[k][u] += ge * xe * r;
          xv[k][u] = r * (ge * wv[u]) - xe * r3 * mean_xgw;
        }
      }
    }
    store_row<T, VEC, NV>(dx + off, nvec, xv);
  }
  store_row<float, VEC, NV>(part + (int64_t)blockIdx.x * h, nvec, acc);
}

// K8, second pass: dw[j] = the chunks' partial sums of column j, in a fixed
// order (chunks c = ty, ty + 8, ... per thread row ty, then the 8 rows),
// rounded once to W.  Block (32, 8): 32 columns.
template <typename W>
__global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ part, W* __restrict__ dw, int chunks,
                 int h) {
  __shared__ float s[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f;
  if (j < h) {
#pragma unroll 8
    for (int c = threadIdx.y; c < chunks; c += 8) a += part[(int64_t)c * h + j];
  }
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && j < h) {
    float t = s[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < 8; ++k) t += s[k][threadIdx.x];
    dw[j] = from_f<W>(t);
  }
}

// A row's layout: 16-byte vectors when h allows them, else one element a
// slot; nv slots a thread (1 when the row fits one slot a thread, else
// BIG_ELEMS elements: at most BIG_THREADS threads at MAX_H); the threads, a
// multiple of 32.
struct Plan {
  bool vec;
  int nv;
  int threads;
};

template <typename T>
Plan plan(int h) {
  constexpr int V = 16 / sizeof(T);
  Plan p;
  p.vec = h % V == 0;
  const int nvec = p.vec ? h / V : h;
  p.nv = nvec <= MAX_THREADS ? 1 : BIG_ELEMS / (p.vec ? V : 1);
  p.threads = ((nvec + p.nv - 1) / p.nv + 31) / 32 * 32;
  return p;
}

template <typename T, typename W, int VEC, int NV>
void fwd_launch(const Plan& p, const void* x, const void* w, void* y, int rows,
                int h, float eps, cudaStream_t st) {
  fwd_kernel<T, W, VEC, NV><<<rows, p.threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), h,
      eps);
}

template <typename T, typename W>
cudaError_t fwd_typed(const void* x, const void* w, void* y, int rows, int h,
                      float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const Plan p = plan<T>(h);
  if (p.vec && p.nv == 1) fwd_launch<T, W, V, 1>(p, x, w, y, rows, h, eps, st);
  else if (p.vec) fwd_launch<T, W, V, BIG_ELEMS / V>(p, x, w, y, rows, h, eps, st);
  else if (p.nv == 1) fwd_launch<T, W, 1, 1>(p, x, w, y, rows, h, eps, st);
  else fwd_launch<T, W, 1, BIG_ELEMS>(p, x, w, y, rows, h, eps, st);
  return cudaGetLastError();
}

template <typename T, typename W, int VEC, int NV>
void bwd_launch(const Plan& p, const void* x, const void* w, const void* g,
                void* dx, float* part, int rows, int h, int rows_per_chunk,
                int chunks, float eps, cudaStream_t st) {
  bwd_kernel<T, W, VEC, NV><<<chunks, p.threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), part, rows, h,
      rows_per_chunk, eps);
}

template <typename T, typename W>
cudaError_t bwd_typed(const void* x, const void* w, const void* g, void* dx,
                      void* dw, void* part, int rows, int h, int rows_per_chunk,
                      float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const Plan p = plan<T>(h);
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  float* pp = static_cast<float*>(part);
  if (p.vec && p.nv == 1)
    bwd_launch<T, W, V, 1>(p, x, w, g, dx, pp, rows, h, rows_per_chunk, chunks, eps, st);
  else if (p.vec)
    bwd_launch<T, W, V, BIG_ELEMS / V>(p, x, w, g, dx, pp, rows, h, rows_per_chunk, chunks, eps, st);
  else if (p.nv == 1)
    bwd_launch<T, W, 1, 1>(p, x, w, g, dx, pp, rows, h, rows_per_chunk, chunks, eps, st);
  else
    bwd_launch<T, W, 1, BIG_ELEMS>(p, x, w, g, dx, pp, rows, h, rows_per_chunk, chunks, eps, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_reduce_kernel<W><<<(h + 31) / 32, dim3(32, 8), 0, st>>>(
      pp, static_cast<W*>(dw), chunks, h);
  return cudaGetLastError();
}

bool valid(int rows, int h, int x_dtype, int w_dtype) {
  return rows > 0 && h > 0 && h <= MAX_H && x_dtype >= 0 && x_dtype <= 2 &&
         (w_dtype == 0 || w_dtype == x_dtype);
}

}  // namespace rmsnorm

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; w is float32 or x's type;
// device: the tensors' device.
// Every pointer 16-byte aligned, every tensor contiguous.  Returns a
// cudaError_t.
extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* y,
                                   int rows, int h, float eps, int x_dtype,
                                   int w_dtype, int device, void* stream) {
  using namespace rmsnorm;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (!valid(rows, h, x_dtype, w_dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wf = w_dtype == 0;
  if (x_dtype == 0) return (int)fwd_typed<float, float>(x, w, y, rows, h, eps, st);
  if (x_dtype == 1)
    return (int)(wf ? fwd_typed<__nv_bfloat16, float>(x, w, y, rows, h, eps, st)
                    : fwd_typed<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, h, eps, st));
  return (int)(wf ? fwd_typed<__half, float>(x, w, y, rows, h, eps, st)
                  : fwd_typed<__half, __half>(x, w, y, rows, h, eps, st));
}

// part: an fp32 workspace of [ceil(rows / rows_per_chunk), h].
extern "C" int rms_norm_bwd_launch(const void* x, const void* w, const void* g,
                                   void* dx, void* dw, void* part, int rows,
                                   int h, int rows_per_chunk, float eps,
                                   int x_dtype, int w_dtype, int device,
                                   void* stream) {
  using namespace rmsnorm;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (!valid(rows, h, x_dtype, w_dtype) || rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wf = w_dtype == 0;
  if (x_dtype == 0)
    return (int)bwd_typed<float, float>(x, w, g, dx, dw, part, rows, h,
                                        rows_per_chunk, eps, st);
  if (x_dtype == 1)
    return (int)(wf ? bwd_typed<__nv_bfloat16, float>(x, w, g, dx, dw, part, rows, h,
                                                      rows_per_chunk, eps, st)
                    : bwd_typed<__nv_bfloat16, __nv_bfloat16>(
                          x, w, g, dx, dw, part, rows, h, rows_per_chunk, eps, st));
  return (int)(wf ? bwd_typed<__half, float>(x, w, g, dx, dw, part, rows, h,
                                             rows_per_chunk, eps, st)
                  : bwd_typed<__half, __half>(x, w, g, dx, dw, part, rows, h,
                                              rows_per_chunk, eps, st));
}
