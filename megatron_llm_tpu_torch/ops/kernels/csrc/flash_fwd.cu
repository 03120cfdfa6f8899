// Flash-attention forward (K1): out = softmax(q k^T * scale + mask) v and
// the row log-sum-exp, for q [b, sq, n, d] against k / v [b, skv, nkv, d]
// (grouped-query: head h reads kv head h / (n / nkv)).
//
// Replaces the Pallas TPU kernel megatron_llm_tpu/ops/pallas/flash_attention.py
// (_fwd_kernel, launched by _fwd).  What it computes is the same: fp32
// scores scaled after the product, an online softmax over kv tiles with the
// -1e30 sentinel and the guard for rows fully masked so far, 0 output for
// fully masked rows (l == 0 -> 1), lse = m + log(l) laid out [b, n, sq].
//
// Bound on the H100: at training shapes (seq 4096, d 128) the two products
// (4 * sq * skv * d flops per head, halved by the causal mask) put it far
// above the ridge, so it is bound by the tensor cores (989 TFLOP/s bf16).
// Design: one block per (q tile, head, batch); the TPU's sequential kv grid
// axis is the block's loop.  Tiles the causal mask or the window rule out
// entirely are skipped; the heaviest causal q tiles start first.  bf16 at
// head_dim 64 / 128 takes the Hopper kernel (flash_fwd_hopper.cu: TMA,
// wgmma, warp-specialised warpgroups).  fp32 and head_dim 256 take the
// shared-memory kernel here (fwd_kernel): the q tile stays in shared
// memory; per kv tile the block stages K and V, forms S = Q K^T, runs the
// online softmax one warp per row (rescaling the fp32 accumulator in
// shared memory), and accumulates P V.
#include "device_guard.cuh"
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fwd_kernel(const Params p) {
  using S = Shape<T, D>;
  constexpr int B = S::B;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + S::TILE_T);
  T* v_s = reinterpret_cast<T*>(smem + 2 * S::TILE_T);
  float* s_s = reinterpret_cast<float*>(smem + 3 * S::TILE_T);
  T* p_s = reinterpret_cast<T*>(smem + 3 * S::TILE_T + S::TILE_S);
  float* o_s = reinterpret_cast<float*>(smem + 3 * S::TILE_T + S::TILE_S + S::TILE_P);
  float* m_s = o_s + B * S::LDA;
  float* l_s = m_s + B;
  int* segq_s = reinterpret_cast<int*>(l_s + B);
  int* segk_s = segq_s + B;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (p.n / p.nkv);
  const int q0 = qt * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  const int* seg_q = p.seg_q ? p.seg_q + (long long)bi * p.sq : nullptr;
  const int* seg_kv = p.seg_kv ? p.seg_kv + (long long)bi * p.skv : nullptr;

  load_tile<T, B, D, S::LDT>(q_s, q, p.q_ss, q0, p.sq);
  load_vec<int, B>(segq_s, seg_q, q0, p.sq, 0);
  zero_acc<B, D, S::LDA>(o_s);
  for (int i = threadIdx.x; i < B; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const int n_kv_tiles = (p.skv + B - 1) / B;
  for (int kt = 0; kt < n_kv_tiles; ++kt) {
    const int kv0 = kt * B;
    if (!run_tile(q0, kv0, B, B, p)) continue;
    __syncthreads();  // the previous P V product is done with v_s / p_s
    load_tile<T, B, D, S::LDT>(k_s, k, p.k_ss, kv0, p.skv);
    load_tile<T, B, D, S::LDT>(v_s, v, p.v_ss, kv0, p.skv);
    load_vec<int, B>(segk_s, seg_kv, kv0, p.skv, 0);
    __syncthreads();
    gemm<T, B, B, D, true, false>(q_s, S::LDT, k_s, S::LDT, s_s, S::LDS);
    __syncthreads();
    for (int r = warp; r < B; r += NWARPS) {
      const int qi = q0 + r;
      float sc[B / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < B / 32; ++j) {
        const int c = lane + 32 * j;
        const float x = s_s[r * S::LDS + c] * p.scale;
        sc[j] = allowed(qi, kv0 + c, segq_s[r], segk_s[c], p) ? x : NEG_INF;
        mx = fmaxf(mx, sc[j]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < B / 32; ++j) {
        const float pr = sc[j] <= NEG_INF * 0.5f ? 0.f : expf(sc[j] - m_cur);
        p_s[r * S::LDP + lane + 32 * j] = from_f<T>(pr);
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = m_cur;
        l_s[r] = alpha * l_s[r] + sum;
      }
      for (int c = lane; c < D; c += 32) o_s[r * S::LDA + c] *= alpha;
    }
    __syncthreads();
    gemm<T, B, D, B, false, true>(p_s, S::LDP, v_s, S::LDT, o_s, S::LDA);
  }
  __syncthreads();

  for (int r = warp; r < B; r += NWARPS) {
    const int qi = q0 + r;
    if (qi >= p.sq) break;
    const float l = l_s[r];
    const float l_safe = l == 0.f ? 1.f : l;  // fully masked rows -> 0 output
    const long long row = (((long long)bi * p.sq + qi) * p.n + h) * D;
    for (int c = lane; c < D; c += 32)
      store_out<T>(p.out, row + c, o_s[r * S::LDA + c] / l_safe, p.out_f32);
    if (lane == 0)
      p.lse_out[((long long)bi * p.n + h) * p.sq + qi] = m_s[r] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t st) {
  using S = Shape<T, D>;
  constexpr int smem = 3 * S::TILE_T + S::TILE_S + S::TILE_P + S::TILE_A + 4 * S::VEC_F;
  static_assert(smem <= 232448, "shared memory");
  const dim3 grid((p.sq + S::B - 1) / S::B, p.n, p.b);
  return launch(fwd_kernel<T, D>, grid, THREADS, smem, st, p);
}

// flash_fwd_hopper.cu: bf16 at head_dim 64 / 128
cudaError_t launch_fwd_hopper(const Params& p, const long long* geo, int* tile_counter, int d,
                              cudaStream_t st);

}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16.  strides: q, k, v as (batch, seq, head)
// element strides, 9 values.  path: 0 = the shared-memory kernel (strides),
// 1 = the Hopper kernel (bf16, head_dim 64 / 128; `geo` holds q's, k's and
// v's TMA geometry, 21 values, and `tile_counter` points at one int of
// device memory), as ops/kernels/__init__.py's flash_path chose it.
// Returns a cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* seg_q, const void* seg_kv, void* out,
                                void* lse, const long long* strides,
                                const long long* geo, void* tile_counter, int b, int sq,
                                int skv, int n, int nkv, int d, float scale, int causal,
                                int window, int dtype, int out_f32, int path,
                                int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  flash::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.b = b; p.sq = sq; p.skv = skv; p.n = n; p.nkv = nkv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.out_f32 = out_f32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return dtype == 1 ? (int)flash::launch_fwd_hopper(p, geo, static_cast<int*>(tile_counter),
                                                      d, st)
                      : (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  FLASH_DISPATCH(flash::launch_fwd, dtype, d, p, st, err)
  return (int)err;
}
