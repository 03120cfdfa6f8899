// Paged decode attention: one decode step for b rows, each through its own
// block table up to its own position.
//
// Replaces the Pallas TPU kernel megatron_llm_tpu/ops/pallas/paged_attention.py
// (_decode_kernel, launched by paged_decode_kernel).  Row i's query token
// sits at positions[i] and attends to the kv positions <= it (inside the
// sliding window) of block_tables[i]; its own K/V were written before the
// launch.  Every row is live: the speculative draft scan routes rows past
// their depth to the null table, whose garbage they attend and discard.
//
// Bound on the H100: the bytes of K/V pages read (3.35 TB/s), as for the
// ragged kernel.  Design: grid (b, n_kv_heads), one block per (row, kv
// head) owning the row's g = n/nkv query heads (native GQA, no K/V
// expansion), walking the row's pages with the ragged kernel's device
// routine for the same `path` (paged_tile.cuh, each row a tile of one,
// launched through paged_tile.cuh's tile_launch; paged_common.cuh:
// attend_row) and a horizon that never binds (W * page).  The same routine
// over the same [lo, hi) walk makes a row's output bitwise the ragged
// kernel's for that row, which is the JAX package's contract between the
// two kernels.
#include "device_guard.cuh"
#include "paged_common.cuh"
#if PAGED_KV == 0
#include "paged_tile.cuh"   // tile::Args, tile_launch
#endif

namespace paged {

// A decode launch's arguments for the rows routine.
struct DecodeRows {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // [pages][nkv] (quantized pools)
  const float* v_scale;
  const int* block_tables;
  const int* positions;
  void* out;
  int n, nkv, W, page;
  float scale;
  int window;
};

template <typename T, int KV, int D, int GP>
__global__ void __launch_bounds__(THREADS) decode_kernel(const DecodeRows a) {
  if constexpr (D == 256 && GP == 8) {
    return;  // never launched: heads_per_pass caps GP at 4 for D = 256
  } else {
    using S = typename Storage<T, KV>::type;
    __shared__ float s_m[NWARPS * GP], s_l[NWARPS * GP];
    __shared__ float s_acc[NWARPS * GP * D];
    const int row = blockIdx.x;
    const int h = blockIdx.y;
    const int g = a.n / a.nkv;
    const int* table = a.block_tables + (int64_t)row * a.W;
    const int64_t head0 = ((int64_t)row * a.n + (int64_t)h * g) * D;
    for (int g0 = 0; g0 < g; g0 += GP) {
      attend_row<T, S, D, GP>(
          static_cast<const T*>(a.q) + head0 + (int64_t)g0 * D,
          static_cast<T*>(a.out) + head0 + (int64_t)g0 * D, min(GP, g - g0),
          static_cast<const S*>(a.k_pool), static_cast<const S*>(a.v_pool),
          a.k_scale, a.v_scale, table, a.W, a.page, a.nkv, h,
          a.positions[row], a.W * a.page, a.scale, a.window, s_m, s_l, s_acc);
    }
  }
}

// The rows routine over pools of storage code 0, 1 or 2 (one per object).
cudaError_t decode_rows_0(const DecodeRows&, int b, int d, int dtype,
                          cudaStream_t);
cudaError_t decode_rows_1(const DecodeRows&, int b, int d, int dtype,
                          cudaStream_t);
cudaError_t decode_rows_2(const DecodeRows&, int b, int d, int dtype,
                          cudaStream_t);

cudaError_t PAGED_ROWS(decode_rows)(const DecodeRows& a, int b, int d,
                                    int dtype, cudaStream_t st) {
  const dim3 grid(b, a.nkv);
  const int gp = heads_per_pass(a.n / a.nkv, d);
  cudaError_t err = cudaSuccess;
  PAGED_DISPATCH(decode_kernel, dtype, d, gp, grid, st, err, a)
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace paged

#if PAGED_KV == 0
// dtype: 0 = float32, 1 = bfloat16, 2 = float16; kv: the pools' storage, 0 =
// q's type, 1 = int8, 2 = fp8 e4m3 (k_scale / v_scale [pages][nkv] fp32);
// path: 0 = rows, 1 = tile (bf16 / fp16 q at d 64 / 128 only); pages: the
// pools' page count; seg_stages, segs, slots, the
// plan and the workspace: the tile path's (paged_tile.cuh: Args); device:
// the tensors' device.  Returns a cudaError_t.
extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_tables,
                                   const void* positions, void* out, int b,
                                   int n, int nkv, int d, int W, int page,
                                   int pages, float scale, int window,
                                   int seg_stages, int segs, int slots,
                                   void* plan, void* ws_ml, void* ws_o,
                                   int dtype, int kv, int path, int device,
                                   void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    paged::tile::Args a{};
    a.k_scale = static_cast<const float*>(k_scale);
    a.v_scale = static_cast<const float*>(v_scale);
    a.q = q;
    a.out = out;
    a.tables = static_cast<const int*>(block_tables);
    a.table_index = nullptr;
    a.positions = static_cast<const int*>(positions);
    a.horizons = nullptr;
    a.plan = static_cast<int*>(plan);
    a.ws_ml = static_cast<float*>(ws_ml);
    a.ws_o = static_cast<float*>(ws_o);
    a.rows = b, a.n = n, a.nkv = nkv, a.W = W, a.page = page, a.pages = pages;
    a.window = window, a.seg_stages = seg_stages, a.segs = segs, a.slots = slots;
    a.scale = scale;
    return (int)paged::tile_launch(a, k_pool, v_pool, d, dtype, kv, st);
  }
  const paged::DecodeRows a{
      q, k_pool, v_pool, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(positions), out, n, nkv, W, page, scale, window};
  switch (kv) {
    case 0: return (int)paged::decode_rows_0(a, b, d, dtype, st);
    case 1: return (int)paged::decode_rows_1(a, b, d, dtype, st);
    case 2: return (int)paged::decode_rows_2(a, b, d, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // PAGED_KV == 0
