// Chunked-prefill paged attention: one s-token chunk per sequence against
// its block table.
//
// Replaces the Pallas TPU kernel megatron_llm_tpu/ops/pallas/paged_attention.py
// (_prefill_kernel, launched by paged_prefill_kernel).  Query row j of
// sequence b sits at position start[b] + j and attends to the kv positions
// <= it (inside the sliding window) of its block table, whose pages the
// chunk's own K/V were written into before the launch.
//
// Bound on the H100: the bytes of K/V pages read, each page of a
// sequence's context once (3.35 TB/s), plus the chunk's queries and
// outputs; about 4 flops a byte, far below the tensor cores' ridge.  Two
// device routines, picked by type and head_dim in Python
// (ops/kernels/__init__.py: paged_path) and passed as `path`:
//
// * path 1, "tile" (bf16 / fp16 q at head_dim 64 and 128, over plain pools
//   and over int8 / fp8 e4m3 pages with per-(page, kv head) scales): 64
//   (row, head) pairs of one kv head share each page load (TMA) and the
//   products run on wgmma, the context cut into segments over blocks
//   (paged_prefill_tile.cuh: the design and the quantized stage);
// * path 0, "rows" (fp32 q and head_dim 256, over every pool): the Pallas
//   kernel's kv-head-major
//   query rows [b, nkv, s * g, d] become the grid (b, n_kv_heads, s): a
//   block owns the g rows of one token and one kv head, reads them straight
//   from q's [b, s, n, d] layout, and walks the pages up to its own position
//   with the ragged kernel's register-resident online softmax
//   (paged_common.cuh: attend_row); each row reads its context again, from
//   L2 after the first.
#include "device_guard.cuh"
#include "paged_common.cuh"
#include "paged_prefill_tile.cuh"

namespace paged {

// A prefill launch's arguments for the rows routine.
struct PrefillRows {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // [pages][nkv] (quantized pools)
  const float* v_scale;
  const int* block_tables;
  const int* start;
  void* out;
  int s_len, n, nkv, kv_pages, page;
  float scale;
  int window;
};

template <typename T, int KV, int D, int GP>
__global__ void __launch_bounds__(THREADS) prefill_kernel(const PrefillRows a) {
  if constexpr (D == 256 && GP == 8) {
    return;  // never launched: heads_per_pass caps GP at 4 for D = 256
  } else {
    using S = typename Storage<T, KV>::type;
    __shared__ float s_m[NWARPS * GP], s_l[NWARPS * GP];
    __shared__ float s_acc[NWARPS * GP * D];
    const int b = blockIdx.x;
    const int h = blockIdx.y;
    const int tok = blockIdx.z;
    const int g = a.n / a.nkv;
    const int64_t head0 =
        (((int64_t)b * a.s_len + tok) * a.n + (int64_t)h * g) * D;
    for (int g0 = 0; g0 < g; g0 += GP) {
      attend_row<T, S, D, GP>(
          static_cast<const T*>(a.q) + head0 + (int64_t)g0 * D,
          static_cast<T*>(a.out) + head0 + (int64_t)g0 * D, min(GP, g - g0),
          static_cast<const S*>(a.k_pool), static_cast<const S*>(a.v_pool),
          a.k_scale, a.v_scale, a.block_tables + (int64_t)b * a.kv_pages,
          a.kv_pages, a.page, a.nkv, h, a.start[b] + tok, 0x7fffffff, a.scale,
          a.window, s_m, s_l, s_acc);
    }
  }
}

// The rows routine over pools of storage code 0, 1 or 2 (one per object).
cudaError_t prefill_rows_0(const PrefillRows&, int b, int d, int dtype,
                           cudaStream_t);
cudaError_t prefill_rows_1(const PrefillRows&, int b, int d, int dtype,
                           cudaStream_t);
cudaError_t prefill_rows_2(const PrefillRows&, int b, int d, int dtype,
                           cudaStream_t);

cudaError_t PAGED_ROWS(prefill_rows)(const PrefillRows& a, int b, int d,
                                     int dtype, cudaStream_t st) {
  const dim3 grid(b, a.nkv, a.s_len);
  const int gp = heads_per_pass(a.n / a.nkv, d);
  cudaError_t err = cudaSuccess;
  PAGED_DISPATCH(prefill_kernel, dtype, d, gp, grid, st, err, a)
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tile routine over pools of storage code 0, 1 or 2 (one per object).
cudaError_t prefill_tile_0(prefill_tile::Args&, const void*, const void*, int d, int dtype,
                           cudaStream_t);
cudaError_t prefill_tile_1(prefill_tile::Args&, const void*, const void*, int d, int dtype,
                           cudaStream_t);
cudaError_t prefill_tile_2(prefill_tile::Args&, const void*, const void*, int d, int dtype,
                           cudaStream_t);

cudaError_t PAGED_ROWS(prefill_tile)(prefill_tile::Args& a, const void* k_pool,
                                     const void* v_pool, int d, int dtype, cudaStream_t st) {
  return prefill_tile::launch<PAGED_KV>(a, k_pool, v_pool, d, dtype, st);
}

}  // namespace paged

#if PAGED_KV == 0
// dtype: 0 = float32, 1 = bfloat16, 2 = float16; kv: the pools' storage, 0 =
// q's type, 1 = int8, 2 = fp8 e4m3 (k_scale / v_scale [pages][nkv] fp32);
// path: 0 = rows, 1 = tile (bf16 / fp16 q at d 64 / 128 only); pages: the
// pools' page count; seg_stages and segs: the tile
// path's segments (paged_prefill_tile.cuh: Args); device: the tensors'
// device.  Returns a cudaError_t.
extern "C" int paged_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scale,
                                    const void* v_scale,
                                    const void* block_tables,
                                    const void* start, void* out, int b,
                                    int s_len, int n, int nkv, int d,
                                    int kv_pages, int page, int pages,
                                    float scale, int window, int seg_stages,
                                    int segs, int dtype, int kv, int path,
                                    int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    paged::prefill_tile::Args a{};
    a.k_scale = static_cast<const float*>(k_scale);
    a.v_scale = static_cast<const float*>(v_scale);
    a.q = q;
    a.out = out;
    a.tables = static_cast<const int*>(block_tables);
    a.start = static_cast<const int*>(start);
    a.b = b, a.s = s_len, a.n = n, a.nkv = nkv, a.W = kv_pages, a.page = page;
    a.pages = pages, a.window = window, a.seg_stages = seg_stages, a.segs = segs;
    a.scale = scale;
    switch (kv) {
      case 0: return (int)paged::prefill_tile_0(a, k_pool, v_pool, d, dtype, st);
      case 1: return (int)paged::prefill_tile_1(a, k_pool, v_pool, d, dtype, st);
      case 2: return (int)paged::prefill_tile_2(a, k_pool, v_pool, d, dtype, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const paged::PrefillRows a{
      q, k_pool, v_pool, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(start), out, s_len, n, nkv, kv_pages, page,
      scale, window};
  switch (kv) {
    case 0: return (int)paged::prefill_rows_0(a, b, d, dtype, st);
    case 1: return (int)paged::prefill_rows_1(a, b, d, dtype, st);
    case 2: return (int)paged::prefill_rows_2(a, b, d, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // PAGED_KV == 0
