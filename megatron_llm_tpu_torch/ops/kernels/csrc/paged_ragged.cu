// Ragged paged attention: one launch per engine tick.
//
// Replaces the Pallas TPU kernel megatron_llm_tpu/ops/pallas/paged_attention.py
// (_ragged_kernel, launched by paged_ragged_kernel).  R single-token rows;
// row i attends through table tables[table_index[i]] to kv positions
// <= positions[i] (inside the sliding window), on the pages that start
// below its horizon horizons[i]; a dead row (horizon 0) touches no page and
// returns exact zeros.
//
// Bound on the H100: the bytes of K/V pages read (3.35 TB/s); about 4
// flops per byte, far below the tensor cores' ridge.  Two device routines,
// picked by type and head_dim in Python (ops/kernels/__init__.py:
// paged_path) and passed as `path`:
//
// * path 1, "tile" (bf16 / fp16 q at head_dim 64 and 128, over plain
//   pools and over int8 / fp8 e4m3 pages with per-(page, kv head) scales):
//   adjacent rows on one table share a block and its page loads, and the
//   products run on the tensor cores (paged_tile.cuh: the design, the
//   quantized stage and the per-row contract);
// * path 0, "rows" (fp32 q and head_dim 256, over every pool): grid (R,
//   n_kv_heads), one block
//   per (row, kv head) owning the row's g = n/nkv query heads, so each page
//   of the row's context is read once for the whole GQA group; the block's
//   warps split the row's context into 8-token chunks and keep the online
//   softmax in registers (paged_common.cuh: attend_row).
//
// Each object holds one pool storage type's routines (PAGED_KV, build.py),
// and the tile routine of K5 too (paged_tile.cuh: tile_launch).
#include "device_guard.cuh"
#include "paged_common.cuh"
#include "paged_tile.cuh"

namespace paged {

// A ragged launch's arguments for the rows routine.
struct RaggedRows {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // [pages][nkv] (quantized pools)
  const float* v_scale;
  const int* tables;
  const int* table_index;
  const int* positions;
  const int* horizons;
  void* out;
  int n, nkv, W, page;
  float scale;
  int window;
};

template <typename T, int KV, int D, int GP>
__global__ void __launch_bounds__(THREADS) ragged_kernel(const RaggedRows a) {
  if constexpr (D == 256 && GP == 8) {
    return;  // never launched: heads_per_pass caps GP at 4 for D = 256
  } else {
    using S = typename Storage<T, KV>::type;
    __shared__ float s_m[NWARPS * GP], s_l[NWARPS * GP];
    __shared__ float s_acc[NWARPS * GP * D];
    const int row = blockIdx.x;
    const int h = blockIdx.y;
    const int g = a.n / a.nkv;
    const int* table = a.tables + (int64_t)a.table_index[row] * a.W;
    const int64_t head0 = ((int64_t)row * a.n + (int64_t)h * g) * D;
    for (int g0 = 0; g0 < g; g0 += GP) {
      attend_row<T, S, D, GP>(
          static_cast<const T*>(a.q) + head0 + (int64_t)g0 * D,
          static_cast<T*>(a.out) + head0 + (int64_t)g0 * D, min(GP, g - g0),
          static_cast<const S*>(a.k_pool), static_cast<const S*>(a.v_pool),
          a.k_scale, a.v_scale, table, a.W, a.page, a.nkv, h,
          a.positions[row], a.horizons[row], a.scale, a.window, s_m, s_l,
          s_acc);
    }
  }
}

// The rows routine over pools of storage code 0, 1 or 2 (one per object).
cudaError_t ragged_rows_0(const RaggedRows&, int R, int d, int dtype,
                          cudaStream_t);
cudaError_t ragged_rows_1(const RaggedRows&, int R, int d, int dtype,
                          cudaStream_t);
cudaError_t ragged_rows_2(const RaggedRows&, int R, int d, int dtype,
                          cudaStream_t);

cudaError_t PAGED_ROWS(ragged_rows)(const RaggedRows& a, int R, int d,
                                    int dtype, cudaStream_t st) {
  const dim3 grid(R, a.nkv);
  const int gp = heads_per_pass(a.n / a.nkv, d);
  cudaError_t err = cudaSuccess;
  PAGED_DISPATCH(ragged_kernel, dtype, d, gp, grid, st, err, a)
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tile routine (K4 and K5) over this object's storage type
// (paged_tile.cuh: tile_launch picks the object).
cudaError_t PAGED_ROWS(tile_launch)(tile::Args& a, const void* k_pool, const void* v_pool,
                                    int d, int dtype, cudaStream_t st) {
  return tile::launch<PAGED_KV>(a, k_pool, v_pool, d, dtype, st);
}

}  // namespace paged

#if PAGED_KV == 0
// dtype: 0 = float32, 1 = bfloat16, 2 = float16; kv: the pools' storage, 0 =
// q's type, 1 = int8, 2 = fp8 e4m3 (k_scale / v_scale [pages][nkv] fp32);
// path: 0 = rows, 1 = tile (bf16 / fp16 q at d 64 / 128 only); pages: the
// pools' page count; seg_stages, segs, slots, the
// plan and the workspace: the tile path's (paged_tile.cuh: Args); device:
// the tensors' device.  Returns a cudaError_t.
extern "C" int paged_ragged_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* table_index,
                                   const void* positions,
                                   const void* horizons, void* out, int R,
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
    a.tables = static_cast<const int*>(tables);
    a.table_index = static_cast<const int*>(table_index);
    a.positions = static_cast<const int*>(positions);
    a.horizons = static_cast<const int*>(horizons);
    a.plan = static_cast<int*>(plan);
    a.ws_ml = static_cast<float*>(ws_ml);
    a.ws_o = static_cast<float*>(ws_o);
    a.rows = R, a.n = n, a.nkv = nkv, a.W = W, a.page = page, a.pages = pages;
    a.window = window, a.seg_stages = seg_stages, a.segs = segs, a.slots = slots;
    a.scale = scale;
    return (int)paged::tile_launch(a, k_pool, v_pool, d, dtype, kv, st);
  }
  const paged::RaggedRows a{
      q, k_pool, v_pool, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(table_index), static_cast<const int*>(positions),
      static_cast<const int*>(horizons), out, n, nkv, W, page, scale, window};
  switch (kv) {
    case 0: return (int)paged::ragged_rows_0(a, R, d, dtype, st);
    case 1: return (int)paged::ragged_rows_1(a, R, d, dtype, st);
    case 2: return (int)paged::ragged_rows_2(a, R, d, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif  // PAGED_KV == 0
