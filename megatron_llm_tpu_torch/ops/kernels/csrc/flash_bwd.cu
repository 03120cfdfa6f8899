// Flash-attention backward: dq (K2) and dk / dv (K3), recomputing the
// probabilities from the forward's log-sum-exp: p = exp(s * scale - lse),
// ds = p * (dp - delta) * scale with dp = do v^T and delta = rowsum(do * o)
// (computed in fp32 by the caller).
//
// Replaces the Pallas TPU kernels megatron_llm_tpu/ops/pallas/flash_attention.py
// (_bwd_dq_kernel and _bwd_dkv_kernel, launched by _bwd), with the same
// arithmetic in fp32 and the same masks from global positions.
//
// Bound on the H100: tensor-core operations (K2: 3 products of
// 2 * sq * skv * d flops per head, K3: 4, halved by the causal mask) at
// training shapes.  Design: the TPU's sequential grid axes become loops in
// the block, and nothing crosses blocks, so there are no atomics and the
// gradients are deterministic:
//
// * K2: one block per (q tile, head, batch); q, do, lse and delta stay in
//   shared memory while the block walks the kv tiles: S = Q K^T and
//   dP = dO V^T, dS elementwise, dQ += dS K.
// * K3: one block per (kv tile, kv head, batch); k and v stay in shared
//   memory while the block walks the g query heads of its group and their
//   q tiles, in transposed form so every product is A B or A B^T:
//   S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
//
// These are the shared-memory kernels, for fp32 and head_dim 256 (score
// tiles in shared memory, one warp per row).  bf16 at head_dim 64 / 128
// takes the Hopper kernels of flash_bwd_hopper.cu, as the entry points'
// `path` says (ops/kernels/__init__.py: flash_path).
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(const Params p) {
  using S = Shape<T, D>;
  constexpr int B = S::B;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + S::TILE_T);
  T* k_s = reinterpret_cast<T*>(smem + 2 * S::TILE_T);
  T* v_s = reinterpret_cast<T*>(smem + 3 * S::TILE_T);
  float* s_s = reinterpret_cast<float*>(smem + 4 * S::TILE_T);
  float* dp_s = s_s + B * S::LDS;
  T* ds_s = reinterpret_cast<T*>(dp_s + B * S::LDS);
  float* dq_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ds_s) +
                                         S::TILE_P);
  float* lse_s = dq_s + B * S::LDA;
  float* delta_s = lse_s + B;
  int* segq_s = reinterpret_cast<int*>(delta_s + B);
  int* segk_s = segq_s + B;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (p.n / p.nkv);
  const int q0 = qt * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + bi * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  const long long vec0 = ((long long)bi * p.n + h) * p.sq;
  const int* seg_q = p.seg_q ? p.seg_q + (long long)bi * p.sq : nullptr;
  const int* seg_kv = p.seg_kv ? p.seg_kv + (long long)bi * p.skv : nullptr;

  load_tile<T, B, D, S::LDT>(q_s, q, p.q_ss, q0, p.sq);
  load_tile<T, B, D, S::LDT>(do_s, dout, p.do_ss, q0, p.sq);
  load_vec<float, B>(lse_s, p.lse + vec0, q0, p.sq, 0.f);
  load_vec<float, B>(delta_s, p.delta + vec0, q0, p.sq, 0.f);
  load_vec<int, B>(segq_s, seg_q, q0, p.sq, 0);
  zero_acc<B, D, S::LDA>(dq_s);

  const int n_kv_tiles = (p.skv + B - 1) / B;
  for (int kt = 0; kt < n_kv_tiles; ++kt) {
    const int kv0 = kt * B;
    if (!run_tile(q0, kv0, B, B, p)) continue;
    __syncthreads();  // the previous dS K product is done with k_s / ds_s
    load_tile<T, B, D, S::LDT>(k_s, k, p.k_ss, kv0, p.skv);
    load_tile<T, B, D, S::LDT>(v_s, v, p.v_ss, kv0, p.skv);
    load_vec<int, B>(segk_s, seg_kv, kv0, p.skv, 0);
    __syncthreads();
    gemm<T, B, B, D, true, false>(q_s, S::LDT, k_s, S::LDT, s_s, S::LDS);
    gemm<T, B, B, D, true, false>(do_s, S::LDT, v_s, S::LDT, dp_s, S::LDS);
    __syncthreads();
    for (int r = warp; r < B; r += NWARPS) {
      const int qi = q0 + r;
      const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < B / 32; ++j) {
        const int c = lane + 32 * j;
        const float pr = allowed(qi, kv0 + c, segq_s[r], segk_s[c], p)
                             ? expf(s_s[r * S::LDS + c] * p.scale - lse)
                             : 0.f;
        ds_s[r * S::LDP + c] =
            from_f<T>(pr * (dp_s[r * S::LDS + c] - delta) * p.scale);
      }
    }
    __syncthreads();
    gemm<T, B, D, B, false, true>(ds_s, S::LDP, k_s, S::LDT, dq_s, S::LDA);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < B * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int qi = q0 + r;
    if (qi < p.sq)
      store_out<T>(p.out, (((long long)bi * p.sq + qi) * p.n + h) * D + c,
                   dq_s[r * S::LDA + c], p.out_f32);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(const Params p) {
  using S = Shape<T, D>;
  constexpr int B = S::B;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + S::TILE_T);
  T* q_s = reinterpret_cast<T*>(smem + 2 * S::TILE_T);
  T* do_s = reinterpret_cast<T*>(smem + 3 * S::TILE_T);
  float* st_s = reinterpret_cast<float*>(smem + 4 * S::TILE_T);
  float* dpt_s = st_s + B * S::LDS;
  T* pt_s = reinterpret_cast<T*>(dpt_s + B * S::LDS);
  T* dst_s = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(pt_s) + S::TILE_P);
  float* dk_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(dst_s) +
                                         S::TILE_P);
  float* dv_s = dk_s + B * S::LDA;
  float* lse_s = dv_s + B * S::LDA;
  float* delta_s = lse_s + B;
  int* segq_s = reinterpret_cast<int*>(delta_s + B);
  int* segk_s = segq_s + B;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int g = p.n / p.nkv;
  const int kv0 = kt * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  const int* seg_q = p.seg_q ? p.seg_q + (long long)bi * p.sq : nullptr;
  const int* seg_kv = p.seg_kv ? p.seg_kv + (long long)bi * p.skv : nullptr;

  load_tile<T, B, D, S::LDT>(k_s, k, p.k_ss, kv0, p.skv);
  load_tile<T, B, D, S::LDT>(v_s, v, p.v_ss, kv0, p.skv);
  load_vec<int, B>(segk_s, seg_kv, kv0, p.skv, 0);
  zero_acc<B, D, S::LDA>(dk_s);
  zero_acc<B, D, S::LDA>(dv_s);

  const int n_q_tiles = (p.sq + B - 1) / B;
  for (int gi = 0; gi < g; ++gi) {  // the GQA sum: every query head of the group
    const int h = kvh * g + gi;
    const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + bi * p.do_sb + h * p.do_sh;
    const long long vec0 = ((long long)bi * p.n + h) * p.sq;
    for (int qt = 0; qt < n_q_tiles; ++qt) {
      const int q0 = qt * B;
      if (!run_tile(q0, kv0, B, B, p)) continue;
      __syncthreads();  // the previous dV / dK products are done with q_s, do_s
      load_tile<T, B, D, S::LDT>(q_s, q, p.q_ss, q0, p.sq);
      load_tile<T, B, D, S::LDT>(do_s, dout, p.do_ss, q0, p.sq);
      load_vec<float, B>(lse_s, p.lse + vec0, q0, p.sq, 0.f);
      load_vec<float, B>(delta_s, p.delta + vec0, q0, p.sq, 0.f);
      load_vec<int, B>(segq_s, seg_q, q0, p.sq, 0);
      __syncthreads();
      gemm<T, B, B, D, true, false>(k_s, S::LDT, q_s, S::LDT, st_s, S::LDS);
      gemm<T, B, B, D, true, false>(v_s, S::LDT, do_s, S::LDT, dpt_s, S::LDS);
      __syncthreads();
      for (int r = warp; r < B; r += NWARPS) {  // r: kv row, c: q column
        const int kj = kv0 + r;
#pragma unroll
        for (int j = 0; j < B / 32; ++j) {
          const int c = lane + 32 * j;
          const float pr = allowed(q0 + c, kj, segq_s[c], segk_s[r], p)
                               ? expf(st_s[r * S::LDS + c] * p.scale - lse_s[c])
                               : 0.f;
          pt_s[r * S::LDP + c] = from_f<T>(pr);
          dst_s[r * S::LDP + c] =
              from_f<T>(pr * (dpt_s[r * S::LDS + c] - delta_s[c]) * p.scale);
        }
      }
      __syncthreads();
      gemm<T, B, D, B, false, true>(pt_s, S::LDP, do_s, S::LDT, dv_s, S::LDA);
      gemm<T, B, D, B, false, true>(dst_s, S::LDP, q_s, S::LDT, dk_s, S::LDA);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < B * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int kj = kv0 + r;
    if (kj < p.skv) {
      const long long o = (((long long)bi * p.skv + kj) * p.nkv + kvh) * D + c;
      store_out<T>(p.dk, o, dk_s[r * S::LDA + c], p.out_f32);
      store_out<T>(p.dv, o, dv_s[r * S::LDA + c], p.out_f32);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t st) {
  using S = Shape<T, D>;
  constexpr int smem = 4 * S::TILE_T + 2 * S::TILE_S + S::TILE_P + S::TILE_A +
                       4 * S::VEC_F;
  static_assert(smem <= 232448, "shared memory");
  const dim3 grid((p.sq + S::B - 1) / S::B, p.n, p.b);
  return launch(bwd_dq_kernel<T, D>, grid, THREADS, smem, st, p);
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t st) {
  using S = Shape<T, D>;
  constexpr int smem = 4 * S::TILE_T + 2 * S::TILE_S + 2 * S::TILE_P +
                       2 * S::TILE_A + 4 * S::VEC_F;
  static_assert(smem <= 232448, "shared memory");
  const dim3 grid((p.skv + S::B - 1) / S::B, p.nkv, p.b);
  return launch(bwd_dkv_kernel<T, D>, grid, THREADS, smem, st, p);
}

// flash_bwd_hopper.cu: bf16 at head_dim 64 / 128
cudaError_t launch_bwd_hopper(const Params& p, const long long* geo, int* tile_counter, int d,
                              bool dkv, cudaStream_t st);

static flash::Params bwd_params(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg_q,
                                const void* seg_kv, const long long* strides,
                                int b, int sq, int skv, int n, int nkv,
                                float scale, int causal, int window,
                                int out_f32) {
  flash::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.b = b; p.sq = sq; p.skv = skv; p.n = n; p.nkv = nkv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.out_f32 = out_f32;
  return p;
}

}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16.  strides: q, k, v, do as (batch, seq,
// head) element strides, 12 values; lse / delta [b, n, sq] fp32.  path: 0 =
// the shared-memory kernels (strides), 1 = the Hopper kernels (bf16,
// head_dim 64 / 128; `geo` holds q's, k's, v's and do's TMA geometry, 28
// values, and `tile_counter` points at one int of device memory), as
// ops/kernels/__init__.py's flash_path chose it.  Returns a cudaError_t.
static int bwd_launch(flash::Params& p, const long long* geo, void* tile_counter, int d,
                      int dtype, int path, bool dkv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return dtype == 1 ? (int)flash::launch_bwd_hopper(p, geo, static_cast<int*>(tile_counter),
                                                      d, dkv, st)
                      : (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (dkv) {
    FLASH_DISPATCH(flash::launch_dkv, dtype, d, p, st, err)
  } else {
    FLASH_DISPATCH(flash::launch_dq, dtype, d, p, st, err)
  }
  return (int)err;
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* seg_q,
                                   const void* seg_kv, void* dq,
                                   const long long* strides, const long long* geo,
                                   void* tile_counter, int b, int sq,
                                   int skv, int n, int nkv, int d, float scale,
                                   int causal, int window, int dtype,
                                   int out_f32, int path, void* stream) {
  flash::Params p = flash::bwd_params(q, k, v, dout, lse, delta, seg_q, seg_kv,
                                      strides, b, sq, skv, n, nkv, scale, causal,
                                      window, out_f32);
  p.out = dq;
  return bwd_launch(p, geo, tile_counter, d, dtype, path, false, stream);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, const void* seg_q,
                                    const void* seg_kv, void* dk, void* dv,
                                    const long long* strides, const long long* geo,
                                    void* tile_counter, int b, int sq,
                                    int skv, int n, int nkv, int d, float scale,
                                    int causal, int window, int dtype,
                                    int out_f32, int path, void* stream) {
  flash::Params p = flash::bwd_params(q, k, v, dout, lse, delta, seg_q, seg_kv,
                                      strides, b, sq, skv, n, nkv, scale, causal,
                                      window, out_f32);
  p.dk = dk;
  p.dv = dv;
  return bwd_launch(p, geo, tile_counter, d, dtype, path, true, stream);
}
