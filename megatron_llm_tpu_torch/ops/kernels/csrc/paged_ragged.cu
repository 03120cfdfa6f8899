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
// * path 1, "tile" (bf16 / fp16 at head_dim 64 and 128): adjacent rows on
//   one table share a block and its page loads, and the products run on
//   the tensor cores (paged_tile.cuh: the design and the per-row contract);
// * path 0, "rows" (fp32, head_dim 256): grid (R, n_kv_heads), one block
//   per (row, kv head) owning the row's g = n/nkv query heads, so each page
//   of the row's context is read once for the whole GQA group; the block's
//   warps split the row's context into 8-token chunks and keep the online
//   softmax in registers (paged_common.cuh: attend_row).
#include "device_guard.cuh"
#include "paged_common.cuh"
#include "paged_tile.cuh"

namespace paged {

template <typename T, int D, int GP>
__global__ void __launch_bounds__(THREADS)
ragged_kernel(const void* q, const void* k_pool, const void* v_pool,
              const int* __restrict__ tables,
              const int* __restrict__ table_index,
              const int* __restrict__ positions,
              const int* __restrict__ horizons, void* out, int n, int nkv,
              int W, int page, float scale, int window) {
  if constexpr (D == 256 && GP == 8) {
    return;  // never launched: heads_per_pass caps GP at 4 for D = 256
  } else {
    __shared__ float s_m[NWARPS * GP], s_l[NWARPS * GP];
    __shared__ float s_acc[NWARPS * GP * D];
    const int row = blockIdx.x;
    const int h = blockIdx.y;
    const int g = n / nkv;
    const int* table = tables + (int64_t)table_index[row] * W;
    const int64_t head0 = ((int64_t)row * n + (int64_t)h * g) * D;
    for (int g0 = 0; g0 < g; g0 += GP) {
      attend_row<T, D, GP>(
          static_cast<const T*>(q) + head0 + (int64_t)g0 * D,
          static_cast<T*>(out) + head0 + (int64_t)g0 * D, min(GP, g - g0),
          static_cast<const T*>(k_pool), static_cast<const T*>(v_pool), table,
          W, page, nkv, h, positions[row], horizons[row], scale, window, s_m,
          s_l, s_acc);
    }
  }
}

}  // namespace paged

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; path: 0 = rows, 1 = tile
// (bf16 / fp16 at d 64 / 128 only); pages: the pools' page count;
// seg_stages, segs, slots, the plan and the workspace: the tile path's
// (paged_tile.cuh: Args); device: the tensors' device.  Returns a
// cudaError_t.
extern "C" int paged_ragged_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* table_index,
                                   const void* positions,
                                   const void* horizons, void* out, int R,
                                   int n, int nkv, int d, int W, int page,
                                   int pages, float scale, int window,
                                   int seg_stages, int segs, int slots,
                                   void* plan, void* ws_ml, void* ws_o,
                                   int dtype, int path, int device,
                                   void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    paged::tile::Args a{};
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
    return (int)paged::tile::launch(a, k_pool, v_pool, d, dtype, st);
  }
  const dim3 grid(R, nkv);
  const int gp = paged::heads_per_pass(n / nkv, d);
  cudaError_t err = cudaSuccess;
  PAGED_DISPATCH(paged::ragged_kernel, dtype, d, gp, grid, st, err, q, k_pool,
                 v_pool, static_cast<const int*>(tables),
                 static_cast<const int*>(table_index),
                 static_cast<const int*>(positions),
                 static_cast<const int*>(horizons), out, n, nkv, W, page,
                 scale, window)
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
