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
// * path 1, "tile" (bf16 / fp16 at head_dim 64 and 128): 64 (row, head)
//   pairs of one kv head share each page load (TMA) and the products run
//   on wgmma, the context cut into segments over blocks
//   (paged_prefill_tile.cuh: the design);
// * path 0, "rows" (fp32, head_dim 256): the Pallas kernel's kv-head-major
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

template <typename T, int D, int GP>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const void* q, const void* k_pool, const void* v_pool,
               const int* __restrict__ block_tables,
               const int* __restrict__ start, void* out, int s_len, int n,
               int nkv, int kv_pages, int page, float scale, int window) {
  if constexpr (D == 256 && GP == 8) {
    return;  // never launched: heads_per_pass caps GP at 4 for D = 256
  } else {
    __shared__ float s_m[NWARPS * GP], s_l[NWARPS * GP];
    __shared__ float s_acc[NWARPS * GP * D];
    const int b = blockIdx.x;
    const int h = blockIdx.y;
    const int tok = blockIdx.z;
    const int g = n / nkv;
    const int64_t head0 = (((int64_t)b * s_len + tok) * n + (int64_t)h * g) * D;
    for (int g0 = 0; g0 < g; g0 += GP) {
      attend_row<T, D, GP>(
          static_cast<const T*>(q) + head0 + (int64_t)g0 * D,
          static_cast<T*>(out) + head0 + (int64_t)g0 * D, min(GP, g - g0),
          static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
          block_tables + (int64_t)b * kv_pages, kv_pages, page, nkv, h,
          start[b] + tok, 0x7fffffff, scale, window, s_m, s_l, s_acc);
    }
  }
}

}  // namespace paged

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; path: 0 = rows, 1 = tile
// (bf16 / fp16 at d 64 / 128 only); pages: the pools' page count;
// seg_stages and segs: the tile path's segments (paged_prefill_tile.cuh:
// Args); device: the tensors' device.  Returns a cudaError_t.
extern "C" int paged_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool,
                                    const void* block_tables,
                                    const void* start, void* out, int b,
                                    int s_len, int n, int nkv, int d,
                                    int kv_pages, int page, int pages,
                                    float scale, int window, int seg_stages,
                                    int segs, int dtype, int path,
                                    int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    paged::prefill_tile::Args a{};
    a.q = q;
    a.out = out;
    a.tables = static_cast<const int*>(block_tables);
    a.start = static_cast<const int*>(start);
    a.b = b, a.s = s_len, a.n = n, a.nkv = nkv, a.W = kv_pages, a.page = page;
    a.pages = pages, a.window = window, a.seg_stages = seg_stages, a.segs = segs;
    a.scale = scale;
    return (int)paged::prefill_tile::launch(a, k_pool, v_pool, d, dtype, st);
  }
  const dim3 grid(b, nkv, s_len);
  const int gp = paged::heads_per_pass(n / nkv, d);
  cudaError_t err = cudaSuccess;
  PAGED_DISPATCH(paged::prefill_kernel, dtype, d, gp, grid, st, err, q,
                 k_pool, v_pool, static_cast<const int*>(block_tables),
                 static_cast<const int*>(start), out, s_len, n, nkv, kv_pages,
                 page, scale, window)
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
