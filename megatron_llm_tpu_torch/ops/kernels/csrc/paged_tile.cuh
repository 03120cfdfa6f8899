// Paged attention on the tensor cores: the bf16 / fp16 path of the ragged
// kernel (K4, paged_ragged.cu) and of the decode kernel (K5,
// paged_decode.cu) at head_dim 64 and 128 (ops/kernels/__init__.py:
// paged_path).  fp32 pools and head_dim 256 keep attend_row
// (paged_common.cuh).
//
// What holds attend_row back on a ragged tick: it is one block per (row,
// kv head) with fp32 dots on CUDA cores, so the 64 rows of a prefill chunk,
// which share one block table, each read the chunk's whole context (64x
// the pages, mostly from L2), a speculative verify tick reads each slot's
// context K + 1 times, and the longest row's blocks walk its context while
// the rest of the card idles: one SM streams scattered 256-byte K / V rows
// at some 20 GB/s (measured on an H100, with cp.async and with TMA alike),
// so a 2048-token row takes one block some 50 us.  Here:
//
// * Tiles.  Adjacent rows with the same table_index form a group; a group
//   is cut into tiles every rows_per_tile(g) = 16 / g rows from its first
//   (for g > 16: one row, and the heads in passes of 16), so a tile holds
//   at most 16 (row, head) pairs: one m16 block of the products.  A decode
//   row is a tile of one.
// * Segments.  A tile's tokens are cut at multiples of seg_stages stages
//   of SPAN (512 tokens; more for tables longer than 4096 tokens).  Each
//   segment's state is merged over the block's warps and folded, in
//   segment order, into the tile's output.
// * Work.  A planner (plan_kernel, one block) finds the tiles and their
//   token ranges on the device (no host pass, no sync) and lists the work
//   longest first: a tile whose walk is longer than a block's share of the
//   launch's work (and spans several segments, while workspace slots last)
//   becomes one item a segment, any other tile one item.  Persistent
//   blocks, two an SM, take (item, kv head x head pass) pairs in list
//   order from one counter; they start while the planner runs
//   (programmatic dependent launch) and wait for its list.  A block walks
//   its items' stages as one stream, so an item's first loads overlap the
//   item before.  A segment item writes its (m, l, O) to the workspace;
//   the last of the tile's segments to arrive (an atomic count) folds them
//   all.  Folding in the block or through the workspace is the same
//   arithmetic.
// * Loads.  A block walks an item's tokens in stages of SPAN = 64 tokens
//   anchored at multiples of 64.  A stage's K and V rows of the kv head
//   arrive by TMA (hopper.cuh): boxes of 8 tokens x 64 dims of a 4-D map
//   over the pool, one lane of warp 0 a box (8 tokens never straddle a
//   page, since page % 8 == 0), 128B-swizzled, into a ring of STAGES = 3
//   buffers, each with its mbarrier.  A box wholly outside the walk reads
//   page `pages` of the map, past its end, which TMA fills with zeros.  A
//   stage's page ids are read from the table one stage before its boxes go
//   out, and a buffer is refilled right after the block's barrier that
//   ends its stage, so STAGES stages are in flight during compute.
// * Tensor cores.  Warp w takes tokens [16 w, 16 w + 16) of every stage:
//   S = Q K^T (mma.sync m16n8k16, Q's fragments held in registers, K's from
//   ldmatrix), the online softmax in fp32 on the accumulator fragments
//   (base-2, scale folded in), then O += P V with P split into a high part
//   and the rest, both in the pool's type (two products: P keeps about 16
//   bits), V's fragments from ldmatrix.trans.
// * A row's result does not depend on who shares its block, nor on how the
//   planner cuts the work.  Its arithmetic depends only on its own q,
//   table, position, horizon and window: the chunks it sees are anchored
//   at absolute token positions, each goes to the same warp in the same
//   order, the merges and the fold are the same, and a chunk or a segment
//   wholly outside the row's own [lo, hi) leaves its state bit for bit as
//   it was (all its scores are masked, so m and l keep their values, every
//   factor is exactly 1 or 0 and P is 0).  So a row's output is bitwise
//   the same alone as in a 16-row tile, which is what K5 == K4 per row and
//   the spec == non-spec and chunked == monolithic invariants rest on.
//   Dead rows (horizon 0) attend nothing and write exact zeros.
//
// Bound on the H100: the bytes of K / V pages (3.35 TB/s), each page of a
// tile's union counted once.  The products are far from the tensor cores'
// rate (a decode row fills 1 of the m16 block's 16 rows at g = 1).
#pragma once

#include <limits.h>

#include <algorithm>
#include <type_traits>

#include "flash_common.cuh"   // ldmatrix_x4, pack_bf16, ex2, quad_max / quad_sum, LOG2E
#include "hopper.cuh"         // tensor maps, TMA loads, mbarriers
#include "paged_common.cuh"   // NEG_INF

namespace paged {
namespace tile {

constexpr int WARPS = 4;              // the split of a stage's tokens among warps
constexpr int THREADS = 32 * WARPS;
constexpr int CH = 16;                // tokens a warp takes from a stage
constexpr int SPAN = WARPS * CH;      // tokens a stage holds
constexpr int STAGES = 3;
constexpr int M = 16;                 // (row, head) pairs a tile holds
constexpr int BOX = 8;                // tokens a TMA box holds
constexpr uint32_t BOX_BYTES = BOX * 64 * 2;
constexpr int PLAN_THREADS = 512;
constexpr int KEYS = 64;              // the planner's buckets of item length, in stages (2 a lane)

// Rows a tile holds and heads a pass takes, for a GQA group of g heads.
__host__ __device__ inline int rows_per_tile(int g) { return g <= M ? M / g : 1; }
__host__ __device__ inline int pass_heads(int g) { return g <= M ? g : M; }
__host__ __device__ inline int head_passes(int g) { return (g + pass_heads(g) - 1) / pass_heads(g); }

// Shared memory (bytes from a 1024-byte-aligned base): the K ring
// [STAGES][D / 64][SPAN][64], the V ring, the queries [D / 64][M][64] (every
// [rows][64] sub-tile 128B-swizzled as TMA lays it down), then the tile's
// running fp32 output [M][D] across segments.
template <int D>
struct Smem {
  static constexpr int RING = STAGES * SPAN * D;   // elements of K (and of V)
  static constexpr int BYTES = (2 * RING + M * D) * 2 + M * D * 4 + 1024;   // + alignment
  // a segment's merge: warps 0-1 write their state into the free stage's K
  // buffer, warps 2-3 into its V buffer
  static_assert(2 * M * D * 4 == SPAN * D * 2, "two warp states a stage buffer");
  static_assert(2 * (D / 64) * (SPAN / BOX) <= 32, "one lane of warp 0 a box");
};

// Element offset of 16-byte piece c (of D / 8) of row r in a [D / 64][ROWS][64]
// tile whose 128-byte rows are 128B-swizzled: piece c % 8 of a row moves to
// (c % 8) ^ (r % 8).
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(flash::smem_addr(p)));
}

template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return flash::pack_bf16(lo, hi);
  }
}

// x rounded to T's precision, as an fp32 value.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// The factor that carries a state of maximum `m` to the maximum `mn`:
// exactly 1 when they are equal (so an empty state, or one whose maximum
// holds, passes through bit for bit).
__device__ __forceinline__ float carry(float m, float mn) {
  return m == mn ? 1.f : flash::ex2(m - mn);
}

// What a launch hands the planner and every block (a __grid_constant__
// parameter, which the TMA reads the maps from).  `table_index == nullptr`:
// the decode kernel, every row its own tile on table row r.
// `horizons == nullptr`: a horizon that never binds (W * page).
//
// The plan (ints, written by plan_kernel): [0] the number of items, [1] the
// blocks' next (item, head pass) pair (X = kv heads x head passes an
// item), then [slots][X] arrival counters, then the items [rows * segs][8]
// (first row, segment or -1 for all, workspace slot or -1, length in
// stages, rows, the tile's lo and hi, table row) in list order.  The
// workspace (floats): for slot z, head pass x, segment s and pair mr, O at
// ws_o[(((z * X + x) * segs + s) * M + mr) * D] and (m, l) at
// ws_ml[(...) * 2].
struct Args {
  CUtensorMap tm_k, tm_v;   // the pools [pages, page, nkv, D]: boxes of BOX tokens x 64 dims
  const void* q;            // [rows, 1, n, D]
  void* out;                // [rows, 1, n, D]
  const int* tables;        // [T, W]
  const int* table_index;   // [rows]
  const int* positions;
  const int* horizons;
  int* plan;
  float* ws_o;
  float* ws_ml;
  int rows, n, nkv, W, page, pages, window, seg_stages, segs, slots, blocks;
  float scale;
};

// The tokens [lo, hi) a row walks: attend_row's page walk.
__device__ __forceinline__ void row_range(const Args& a, int row, int& lo, int& hi) {
  const int pos = a.positions[row];
  lo = 0;
  if (a.window > 0 && pos - a.window + 1 > 0) lo = ((pos - a.window + 1) / a.page) * a.page;
  const long long cap = (long long)a.W * a.page;
  const long long hor =
      a.horizons ? (((long long)a.horizons[row] + a.page - 1) / a.page) * a.page : cap;
  hi = (int)min(min((long long)pos + 1, cap), hor);
}

// A tile: its rows, its table and its token range [lo, hi) (0, 0: no row
// attends).
struct TileInfo {
  int nrows;
  const int* table;
  int lo, hi;
};

// Stages a walk of [lo, hi) takes.
__device__ __forceinline__ int stages_of(int lo, int hi) {
  return hi > lo ? (hi + SPAN - 1) / SPAN - lo / SPAN : 0;
}

// The plan's parts (see Args).
constexpr int ITEM_INTS = 8;   // row, segment, slot, length, rows, lo, hi, table row
__device__ __forceinline__ int* plan_arrive(const Args& a) { return a.plan + 2; }
__device__ __forceinline__ int* plan_items(const Args& a, int X) {
  return a.plan + 2 + X * a.slots;
}

// The last row at or before r whose bit is set in `bits` (row 0's always is).
__device__ __forceinline__ int last_set(const unsigned* bits, int r) {
  int w = r / 32;
  unsigned b = bits[w] & (0xffffffffu >> (31 - r % 32));
  while (b == 0) b = bits[--w];
  return w * 32 + 31 - __clz(b);
}

// The planner: one block finds the tiles (every row its own on the decode
// kernel; else a group of adjacent rows on one table is cut every
// rows_per_tile rows from its first), their rows and token ranges, and
// lists the launch's items longest first (see the header); it zeroes the
// counters.  Its order and slot numbers vary from run to run (atomics); no
// result depends on them.
constexpr int PLAN_MAX_ROWS = 8192;   // its shared memory: 25 bytes a row
static __global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const __grid_constant__ Args a) {
  extern __shared__ int plan_smem[];
  __shared__ int total, n_items, n_slots, hist[KEYS], at[KEYS];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");   // the blocks may start
  const int X = a.nkv * head_passes(a.n / a.nkv);
  const int R = a.rows;
  int* items = plan_items(a, X);
  int* r_ti = plan_smem;   // [R] each row's table row, token range, and (at a
  int* r_lo = r_ti + R;    // tile's first row) the tile's union and rows
  int* r_hi = r_lo + R;
  int* t_lo = r_hi + R;
  int* t_hi = t_lo + R;
  int* t_n = t_hi + R;
  unsigned* starts = reinterpret_cast<unsigned*>(t_n + R);   // a bit a row: it starts a tile
  unsigned* groups = starts + (R + 31) / 32;                  // a bit a row: it starts a group
  const int tid = threadIdx.x;
  const int seg_tok = a.seg_stages * SPAN;
  const int per_tile = rows_per_tile(a.n / a.nkv);
  if (tid < KEYS) hist[tid] = 0;
  if (tid == 0) total = n_items = n_slots = 0;
  for (int i = tid; i < 1 + X * a.slots; i += PLAN_THREADS) a.plan[1 + i] = 0;
  for (int i = tid; i < 2 * ((R + 31) / 32); i += PLAN_THREADS) starts[i] = 0;
  for (int r = tid; r < R; r += PLAN_THREADS) {
    r_ti[r] = a.table_index == nullptr ? r : a.table_index[r];
    row_range(a, r, r_lo[r], r_hi[r]);
    t_lo[r] = INT_MAX;
    t_hi[r] = 0;
    t_n[r] = 0;
  }
  __syncthreads();
  for (int r = tid; r < R; r += PLAN_THREADS)
    if (a.table_index == nullptr || r == 0 || r_ti[r - 1] != r_ti[r])
      atomicOr(&groups[r / 32], 1u << (r % 32));
  __syncthreads();
  // a tile starts every rows_per_tile rows from its group's first row
  for (int r = tid; r < R; r += PLAN_THREADS)
    if ((r - last_set(groups, r)) % per_tile == 0) atomicOr(&starts[r / 32], 1u << (r % 32));
  __syncthreads();
  for (int r = tid; r < R; r += PLAN_THREADS) {   // into the tile's union
    const int first = last_set(starts, r);
    if (r_lo[r] < r_hi[r]) {
      atomicMin(&t_lo[first], r_lo[r]);
      atomicMax(&t_hi[first], r_hi[r]);
    }
    atomicAdd(&t_n[first], 1);
  }
  __syncthreads();
  for (int r = tid; r < R; r += PLAN_THREADS)
    if (starts[r / 32] >> (r % 32) & 1u) {
      if (t_hi[r] == 0) t_lo[r] = 0;
      atomicAdd(&total, stages_of(t_lo[r], t_hi[r]));
    }
  __syncthreads();
  const int share = (total * X + a.blocks - 1) / a.blocks;   // a block's share of the walk
  // each tile's items: split into its segments (a workspace slot) when its
  // walk is longer than a block's share and spans several segments; count
  // them by length (r_lo holds a tile's slot from here)
  auto segs_of = [&](int r, int& first, int& last) {
    first = t_lo[r] / seg_tok;
    last = t_hi[r] > 0 ? (t_hi[r] - 1) / seg_tok : 0;
  };
  auto len_of = [&](int r, int z) {
    return z < 0 ? stages_of(t_lo[r], t_hi[r])
                 : stages_of(max(t_lo[r], z * seg_tok), min(t_hi[r], (z + 1) * seg_tok));
  };
  for (int r = tid; r < R; r += PLAN_THREADS) {
    if (!(starts[r / 32] >> (r % 32) & 1u)) continue;
    int first, last;
    segs_of(r, first, last);
    int slot = -1;
    if (last > first && len_of(r, -1) > share) {
      slot = atomicAdd(&n_slots, 1);
      if (slot >= a.slots) slot = -1;
    }
    r_lo[r] = slot;
    for (int z = first; z <= (slot >= 0 ? last : first); ++z) {
      atomicAdd(&hist[min(len_of(r, slot >= 0 ? z : -1), KEYS - 1)], 1);
      atomicAdd(&n_items, 1);
    }
  }
  __syncthreads();
  if (tid < 32) {   // each length's first place, longest first: a scan over the warp
    const int k1 = KEYS - 1 - 2 * tid, k2 = k1 - 1;   // lane t: lengths 63 - 2t, 62 - 2t
    const int pair = hist[k1] + hist[k2];
    int inc = pair;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (tid >= d) inc += v;
    }
    at[k1] = inc - pair;
    at[k2] = inc - pair + hist[k1];
    if (tid == 31) a.plan[0] = n_items;
  }
  __syncthreads();
  for (int r = tid; r < R; r += PLAN_THREADS) {   // the items, in their places
    if (!(starts[r / 32] >> (r % 32) & 1u)) continue;
    int first, last;
    segs_of(r, first, last);
    const int slot = r_lo[r];
    for (int z = first; z <= (slot >= 0 ? last : first); ++z) {
      const int len = len_of(r, slot >= 0 ? z : -1);
      int* it = items + ITEM_INTS * atomicAdd(&at[min(len, KEYS - 1)], 1);
      it[0] = r;
      it[1] = slot >= 0 ? z : -1;
      it[2] = slot;
      it[3] = len;
      it[4] = t_n[r];
      it[5] = t_lo[r];
      it[6] = t_hi[r];
      it[7] = r_ti[r];
    }
  }
}

// An item as a block walks it (`r < 0`: the list is done).
struct Item {
  int r, seg, slot;
  int x, h, hp0, gp;   // the head pass: kv head h, heads hp0 .. hp0 + gp - 1 of its group
  TileInfo t;
  int wlo, whi, k0, nst;   // the walk [wlo, hi): its first stage and stage count
};
constexpr int RING_ITEMS = 8;   // items a block's loads may run ahead by

// Persistent blocks, two an SM: each takes (item, head pass) pairs in list
// order from one counter and walks their stages as one stream: warp 0
// keeps STAGES stages in flight across items, so an item's first loads
// overlap the one before.  For tile t of an item (rows r .. r + t.nrows -
// 1), kv head h and the heads hp0 .. hp0 + gp - 1 of its group: all its
// segments (seg < 0), or segment `seg` (workspace slot `slot`).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
tile_kernel(const __grid_constant__ Args a) {
  constexpr int PPR = D / 8;   // 16-byte pieces a row of D
  constexpr int H = D / 64;    // 64-dim sub-tiles a row of D
  constexpr int GROUPS = SPAN / BOX;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float s_m[WARPS][M], s_l[WARPS][M], s_f[M][WARPS + 2], tot_m[M], tot_l[M];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ Item ring[RING_ITEMS];
  __shared__ int s_fetched, s_flag;
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  T* const sk = reinterpret_cast<T*>(smem);
  T* const sv = sk + Smem<D>::RING;
  T* const sq = sv + Smem<D>::RING;
  float* const tot_o = reinterpret_cast<float*>(sq + M * D);   // [M][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = a.n / a.nkv;
  const int passes = head_passes(g), X = a.nkv * passes;
  const int seg_tok = a.seg_stages * SPAN;
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < STAGES; ++b) hopper::mbar_init(&full[b], 1);
    hopper::mbar_init_fence();
    s_fetched = 0;
  }
  // the plan is the planner's: what is above overlaps it (programmatic
  // dependent launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  const int n_items = a.plan[0];
  const int* list = plan_items(a, X);

  // thread 0: the block's item number k into the ring
  auto fetch = [&](int k) {
    Item& it = ring[k % RING_ITEMS];
    const int i = atomicAdd(a.plan + 1, 1);
    it.r = -1;
    it.nst = 0;
    if (i < n_items * X) {
      const int* p = list + ITEM_INTS * (i / X);
      it.x = i % X;
      it.h = it.x / passes;
      it.hp0 = (it.x % passes) * pass_heads(g);
      it.gp = min(pass_heads(g), g - it.hp0);
      it.r = p[0];
      it.seg = p[1];
      it.slot = p[2];
      it.t.nrows = p[4];
      it.t.lo = p[5];
      it.t.hi = p[6];
      it.t.table = a.tables + (long long)p[7] * a.W;
      it.wlo = it.t.lo;
      it.whi = it.t.hi;
      if (it.seg >= 0) {
        it.wlo = max(it.wlo, it.seg * seg_tok);
        it.whi = min(it.whi, (it.seg + 1) * seg_tok);
      }
      it.k0 = it.wlo / SPAN;
      it.nst = stages_of(it.wlo, it.whi);
    }
    s_fetched = k + 1;
  };

  // warp 0, the loads: lane `lane` loads box (tensor, sub-tile, token
  // group) of a stage; a box wholly outside its item's walk reads page
  // `pages`, past the map's end, which reads as zeros
  const int bx_v = lane / (H * GROUPS), bx_h = (lane / GROUPS) % H, bx_g = lane % GROUPS;
  const bool boxer = lane < 2 * H * GROUPS;
  // the page id of this lane's box of stage s of an item (`pages` outside
  // its walk)
  auto box_page = [&](const Item& it, int s) {
    const int tok = (it.k0 + s) * SPAN + bx_g * BOX;
    return boxer && tok + BOX > it.wlo && tok < it.whi ? it.t.table[tok / a.page] : a.pages;
  };
  int lk = 0, ls = 0, gl = 0;   // the item and stage to load next; stages issued
  int ahead = -1;               // the page id of stage (lk, ls) when read ahead (else -1)
  bool lend = false;
  // keep STAGES stages in flight (gc: stages consumed, ck: items consumed)
  auto top_up = [&](int gc, int ck) {
    while (!lend && gl - gc < STAGES && lk - ck < RING_ITEMS) {
      if (lane == 0 && lk == s_fetched) fetch(lk);
      __syncwarp();
      const Item& it = ring[lk % RING_ITEMS];
      if (it.r < 0) {
        lend = true;
      } else if (ls >= it.nst) {
        ++lk;
        ls = 0;
        ahead = -1;
      } else {
        const int b = gl % STAGES;
        const int tok = (it.k0 + ls) * SPAN + bx_g * BOX;
        const int pid = ahead >= 0 ? ahead : box_page(it, ls);
        if (lane == 0) hopper::mbar_arrive_expect_tx(&full[b], 2 * H * GROUPS * BOX_BYTES);
        __syncwarp();
        if (boxer)
          hopper::tma_load_4d((bx_v ? sv : sk) + b * SPAN * D + (bx_h * SPAN + bx_g * BOX) * 64,
                              bx_v ? &a.tm_v : &a.tm_k, &full[b], bx_h * 64, it.h, tok % a.page,
                              pid);
        ++ls;
        ++gl;
        // the next stage's page id, read while this one loads
        ahead = ls < it.nst ? box_page(it, ls) : -1;
      }
    }
  };

  float m[2], l[2], o[D / 8][4];
  auto reset = [&] {
#pragma unroll
    for (int e = 0; e < 2; ++e) m[e] = NEG_INF, l[e] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  };
  int mrows = 0;
  // fold a state (ms, ls, O = o_in(mr, c)) into the running output, pair by
  // pair: factors first (s_f[mr][WARPS] carries the running output,
  // [WARPS + 1] the state), then O
  auto fold_ml = [&](int mr, float ms, float lsum) {
    const float mn = fmaxf(tot_m[mr], ms);
    const float ft = carry(tot_m[mr], mn), fs = carry(ms, mn);
    tot_l[mr] = ft * tot_l[mr] + fs * lsum;
    tot_m[mr] = mn;
    s_f[mr][WARPS] = ft;
    s_f[mr][WARPS + 1] = fs;
  };
  auto fold_o = [&](auto o_in) {
    for (int i = tid; i < mrows * D; i += THREADS) {
      const int mr = i / D;
      tot_o[i] = s_f[mr][WARPS] * tot_o[i] + s_f[mr][WARPS + 1] * o_in(mr, i % D);
    }
  };
  auto scratch = [&](int w, int b) {   // warp w's state, in the free buffer b
    return reinterpret_cast<float*>((w < 2 ? sk : sv) + b * SPAN * D) + (w & 1) * M * D;
  };
  // a segment ends: merge the warps' states in warp order through the free
  // buffer b, fold the result into the running output, start afresh
  auto end_segment = [&](int b) {
    float* scr = scratch(warp, b);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int mr = (lane >> 2) + 8 * e;
      const float lq = flash::quad_sum(l[e]);
      if ((lane & 3) == 0) {
        s_m[warp][mr] = m[e];
        s_l[warp][mr] = lq;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(scr + mr * D + 8 * j + 2 * (lane & 3)) =
            make_float2(o[j][2 * e], o[j][2 * e + 1]);
    }
    __syncthreads();
    if (tid < mrows) {
      float ms = NEG_INF, lsum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) ms = fmaxf(ms, s_m[w][tid]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        s_f[tid][w] = carry(s_m[w][tid], ms);
        lsum += s_f[tid][w] * s_l[w][tid];
      }
      fold_ml(tid, ms, lsum);
    }
    __syncthreads();
    fold_o([&](int mr, int c) {
      float os = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) os += s_f[mr][w] * scratch(w, b)[mr * D + c];
      return os;
    });
    __syncthreads();
    reset();
  };

  int gc = 0;   // stages consumed
  for (int ck = 0;; ++ck) {
    if (warp == 0) top_up(gc, ck);
    if (tid == 0 && ck == s_fetched) fetch(ck);
    __syncthreads();
    const Item it = ring[ck % RING_ITEMS];
    if (it.r < 0) break;
    const int x = it.x, h = it.h, hp0 = it.hp0, gp = it.gp;
    const int row0 = it.r, wlo = it.wlo, whi = it.whi, k0 = it.k0, nst = it.nst;
    const int first = it.t.lo / seg_tok, last = it.t.hi > 0 ? (it.t.hi - 1) / seg_tok : 0;
    mrows = it.t.nrows * gp;   // (row, head) pairs: pair mr = row mr / gp, head mr % gp

    // the tile's queries, pair mr in row mr of sq (pairs past the tile are
    // zeros), the empty running output, this lane's two pairs (C fragment
    // rows lane / 4 and lane / 4 + 8)
    for (int i = tid; i < M * PPR; i += THREADS) {
      const int mr = i / PPR, c = i % PPR;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (mr < mrows) {
        const long long head = (long long)h * g + hp0 + mr % gp;
        v = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.q) +
                                            ((long long)(row0 + mr / gp) * a.n + head) * D + c * 8);
      }
      *reinterpret_cast<uint4*>(sq + swz<M>(mr, c)) = v;
    }
    for (int i = tid; i < M * D; i += THREADS) tot_o[i] = 0.f;
    if (tid < M) {
      tot_m[tid] = NEG_INF;
      tot_l[tid] = 0.f;
    }
    int hi_r[2], pos_r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int mr = (lane >> 2) + 8 * e;
      hi_r[e] = 0;
      pos_r[e] = 0;
      if (mr < mrows) {
        int lo;
        row_range(a, row0 + mr / gp, lo, hi_r[e]);
        pos_r[e] = a.positions[row0 + mr / gp];
      }
    }
    __syncthreads();
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      flash::ldmatrix_x4(qa[kk], sq + swz<M>((lane & 7) + 8 * ((lane >> 3) & 1), 2 * kk + (lane >> 4)));
    const float sl2 = a.scale * flash::LOG2E;
    reset();

    const int base = gc;
    for (int s = 0; s < nst; ++s) {
      const int buf = (base + s) % STAGES;
      hopper::mbar_wait(&full[buf], ((base + s) / STAGES) & 1);
      const int c0 = (k0 + s) * SPAN + warp * CH;
      if (c0 + CH > wlo && c0 < whi) {   // some row of the tile has a token here
        const T* kb = sk + buf * SPAN * D;
        const T* vb = sv + buf * SPAN * D;
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t b[4];
          flash::ldmatrix_x4(b, kb + swz<SPAN>(warp * CH + (lane & 7) + 8 * (lane >> 4),
                                               2 * kk + ((lane >> 3) & 1)));
          mma<T>(sc[0], qa[kk], b[0], b[1]);
          mma<T>(sc[1], qa[kk], b[2], b[3]);
        }
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int tok = c0 + 8 * j + 2 * (lane & 3) + u;
              const bool ok = tok < hi_r[e] && (a.window <= 0 || pos_r[e] - tok < a.window);
              v[2 * j + u] = ok ? sc[j][2 * e + u] * sl2 : NEG_INF;
            }
          }
          const float mx = flash::quad_max(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
          const float mn = fmaxf(m[e], mx);
          const float alpha = carry(m[e], mn);   // exactly 1 for a masked chunk
          float p[4], ps = 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            p[x] = v[x] <= NEG_INF * 0.5f ? 0.f : flash::ex2(v[x] - mn);
            ps += p[x];
          }
          l[e] = l[e] * alpha + ps;   // this lane's columns; summed over the quad at the end
          m[e] = mn;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][2 * e] *= alpha;
            o[j][2 * e + 1] *= alpha;
          }
          // P as hi + lo in T (about 16 bits of it, not T's 8 or 11), so the
          // only rounding P V adds to the fp32 path's is summation order
          float hi[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) hi[x] = round_to<T>(p[x]);
          pa[e] = pack2<T>(hi[0], hi[1]);       // A fragment: tokens 2t, 2t + 1
          pa[2 + e] = pack2<T>(hi[2], hi[3]);   // tokens 8 + 2t, 9 + 2t
          pl[e] = pack2<T>(p[0] - hi[0], p[1] - hi[1]);
          pl[2 + e] = pack2<T>(p[2] - hi[2], p[3] - hi[3]);
        }
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vb + swz<SPAN>(warp * CH + (lane & 7) + 8 * ((lane >> 3) & 1),
                                               2 * jj + (lane >> 4)));
          mma<T>(o[2 * jj], pa, b[0], b[1]);
          mma<T>(o[2 * jj + 1], pa, b[2], b[3]);
          mma<T>(o[2 * jj], pl, b[0], b[1]);
          mma<T>(o[2 * jj + 1], pl, b[2], b[3]);
        }
      }
      __syncthreads();   // every warp is done with this stage's buffer
      if (s == nst - 1 || (k0 + s + 1) % a.seg_stages == 0) end_segment(buf);
      if (warp == 0) top_up(base + s + 1, ck);   // refill it
    }
    gc = base + nst;

    // a segment of a tile that has several: hand the state to the
    // workspace; the last of the tile's segments to arrive folds them all,
    // in order
    if (it.seg >= 0) {
      auto at = [&](int z, int mr) {
        return (((long long)it.slot * X + x) * a.segs + z) * M + mr;
      };
      for (int i = tid; i < mrows * D; i += THREADS) {
        const int mr = i / D;
        a.ws_o[at(it.seg, mr) * D + i % D] = tot_o[i];
        if (i % D == 0) {
          a.ws_ml[2 * at(it.seg, mr)] = tot_m[mr];
          a.ws_ml[2 * at(it.seg, mr) + 1] = tot_l[mr];
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) s_flag = atomicAdd(plan_arrive(a) + it.slot * X + x, 1) == last - first;
      __syncthreads();
      const bool folds = s_flag;
      __syncthreads();
      if (!folds) continue;
      __threadfence();
      if (tid < M) {
        tot_m[tid] = NEG_INF;
        tot_l[tid] = 0.f;
      }
      for (int i = tid; i < M * D; i += THREADS) tot_o[i] = 0.f;
      __syncthreads();
      for (int z = first; z <= last; ++z) {
        if (tid < mrows)
          fold_ml(tid, __ldcg(a.ws_ml + 2 * at(z, tid)), __ldcg(a.ws_ml + 2 * at(z, tid) + 1));
        __syncthreads();
        fold_o([&](int mr, int c) { return __ldcg(a.ws_o + at(z, mr) * D + c); });
        __syncthreads();
      }
    }

    // the rows: O / l (no token attended: l == 0 -> exact zeros)
    T* out = static_cast<T*>(a.out);
    for (int i = tid; i < mrows * (D / 2); i += THREADS) {
      const int mr = i / (D / 2), c = 2 * (i % (D / 2));
      const float lsum = tot_l[mr];
      const bool none = lsum == 0.f;
      const long long head = (long long)h * g + hp0 + mr % gp;
      *reinterpret_cast<uint32_t*>(out + ((long long)(row0 + mr / gp) * a.n + head) * D + c) =
          pack2<T>(none ? 0.f : tot_o[mr * D + c] / lsum, none ? 0.f : tot_o[mr * D + c + 1] / lsum);
    }
    __syncthreads();   // the next item reuses shared memory
  }
}

// The pools' TMA maps (pools [pages, page, nkv, d], contiguous, 16-bit):
// global dims innermost first (d, nkv, page, pages) and the byte strides of
// nkv, page and pages; boxes of BOX tokens x 64 dims.  dtype 1 = bf16,
// 2 = fp16.  K6's tile routine (paged_prefill_tile.cuh) reads the same maps.
inline cudaError_t encode_pools(CUtensorMap* tm_k, CUtensorMap* tm_v, const void* k_pool,
                                const void* v_pool, int nkv, int page, int pages, int d,
                                int dtype) {
  const long long row = 2ll * d;
  const long long geo[7] = {d, nkv, page, pages, row, nkv * row, (long long)page * nkv * row};
  const CUtensorMapDataType type =
      dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = hopper::encode_rows_bf16(tm_k, k_pool, geo, BOX, type);
  if (e == cudaSuccess) e = hopper::encode_rows_bf16(tm_v, v_pool, geo, BOX, type);
  return e;
}

template <typename T, int D>
cudaError_t launch_typed(Args& a, cudaStream_t st) {
  constexpr int smem = Smem<D>::BYTES;
  cudaError_t e =
      cudaFuncSetAttribute(tile_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  a.blocks = 2 * sms;   // two an SM
  const int plan_smem = 4 * (6 * a.rows + 2 * ((a.rows + 31) / 32));
  e = cudaFuncSetAttribute(plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan_smem);
  if (e != cudaSuccess) return e;
  plan_kernel<<<1, PLAN_THREADS, plan_smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // programmatic dependent launch: the blocks start while the planner runs
  // and wait for its plan (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tile_kernel<T, D>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One K4 / K5 launch on the tile path: the planner, then the persistent
// blocks.  dtype 1 = bf16, 2 = fp16; d 64 or 128.
inline cudaError_t launch(Args& a, const void* k_pool, const void* v_pool, int d, int dtype,
                          cudaStream_t st) {
  cudaError_t e =
      encode_pools(&a.tm_k, &a.tm_v, k_pool, v_pool, a.nkv, a.page, a.pages, d, dtype);
  if (e != cudaSuccess) return e;
  if (dtype == 1 && d == 64) return launch_typed<__nv_bfloat16, 64>(a, st);
  if (dtype == 1 && d == 128) return launch_typed<__nv_bfloat16, 128>(a, st);
  if (dtype == 2 && d == 64) return launch_typed<__half, 64>(a, st);
  if (dtype == 2 && d == 128) return launch_typed<__half, 128>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace tile
}  // namespace paged
