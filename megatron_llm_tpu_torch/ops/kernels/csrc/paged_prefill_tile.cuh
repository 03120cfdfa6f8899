// Chunked-prefill paged attention on the tensor cores: the bf16 / fp16 path
// of the prefill kernel (K6, paged_prefill.cu) at head_dim 64 and 128
// (ops/kernels/__init__.py: paged_path), over plain pools in q's type and
// over quantized ones (int8 or fp8 e4m3 values, one fp32 scale a (page, kv
// head)).  fp32 q and head_dim 256 keep attend_row (paged_common.cuh).
//
// What holds attend_row back on a chunk: it is one block per (chunk token,
// kv head) with fp32 dots on CUDA cores, so each of a 64-token chunk's rows
// reads the chunk's whole context, 64x the pages (mostly from L2), and no
// two rows share a load.  The bound is the K / V pages of each sequence's
// context, each read once, at 3.35 TB/s (about 4 flops a byte: far below
// the tensor cores' ridge).  Here:
//
// * Tiles.  A tile is 64 (row, head) pairs of one kv head in the Pallas
//   kernel's kv-head-major order: 64 / g chunk tokens x the g heads of the
//   group (g > 64: one token, the heads in passes of 64), one wgmma m64
//   tile.  Its queries come straight from q's [b, s, n, d] layout (the g
//   heads of kv head h are contiguous in a token) into shared memory,
//   128B-swizzled.  Pairs past the chunk's end are zeros and are never
//   written.
// * Segments.  A tile walks the tokens [lo, hi) its rows can see: up to
//   its last row's position (capped by the table's width), from its first
//   row's window start (rounded down to a page).  The walk is cut at
//   absolute multiples of seg_stages stages, at most MAX_SEGS segments a
//   table (sized in Python from the shapes alone, to spread a chunk's
//   pages over the card: one SM streams these scattered 128-byte rows far
//   below its share of the card's rate); a block takes one (tile, segment)
//   pair, and the segments of a tile form one thread block cluster
//   (8-block clusters did not all fit on the card at once: they ran in two
//   waves).  A tile whose walk lies in one segment writes its rows
//   directly.  Otherwise each block leaves its state (m, l, O) in its
//   shared memory, and after a cluster barrier the walk's block r folds
//   pairs r, r + n, ... over every segment's state, in segment order,
//   through distributed shared memory (no workspace, no counter, no
//   atomic; a workspace folded by the last block to arrive spent far
//   longer in that one block's loads).  So the output is the same bits
//   from run to run, and a sequence's does not depend on the other
//   sequences of the launch at the same table width (the segments are cut
//   from the width W, which the launch's sequences share).
// * Loads.  K and V arrive in stages of SPAN = 64 tokens anchored at
//   multiples of 64, by TMA through K4's 4-D pool maps (paged_tile.cuh:
//   boxes of 8 tokens x 64 dims, 128B-swizzled; a box outside the walk
//   reads page `pages`, past the map's end, as zeros), into a ring of
//   stages with full and empty mbarriers kept fed by one producer warp;
//   page ids are read from the table one stage ahead.  Each stage is loaded
//   once for the tile's 64 pairs.
// * Products.  One consumer warpgroup: S = Q K^T by wgmma m64n64k16 from
//   shared memory (both K-major), the online softmax in fp32 on the
//   accumulator fragments (base 2, the scale folded in, the -1e30 sentinel
//   and the guard for rows masked so far; O takes its factor only when some
//   pair of the warp moved its maximum), O += P V by wgmma's register form
//   with V read MN-major through the transpose bit.  P enters two products,
//   its part in the pool's type and the rest (about 16 bits of P, as in
//   K4; one product was a few times less precise for a few percent of the
//   time).  A stage's products and softmax take longer than its loads, so
//   two blocks share an SM where the segments allow.
// * Masks.  A stage wholly at or below the tile's first row's position,
//   inside the table and inside every row's window takes no mask; the
//   stages that cross the rows' positions, the window's edge or the
//   table's end are masked per element.  Stages past the last row's
//   position and below the first row's window are never walked.
// * Quantized pools (S = int8_t or __nv_fp8_e4m3; the Pallas kernels'
//   _split_quant semantics: a page's values times its scale, in fp32).
//   wgmma reads K and V from shared memory in T, 128B-swizzled, so a stage
//   has to be converted there, and the consumer warpgroup is the walk's
//   bottleneck already: the conversion goes to the producer side, two
//   loader warps.  Warp 4 streams a stage's bytes by TMA through K4's
//   one-byte maps (paged_tile.cuh: boxes of 8 tokens x a row of d bytes)
//   into a byte ring of BST stages, its lanes 0-7 copying each 8-token
//   group's K and V scales beside them by cp.async (0 for the page past
//   the map's end, never read), all counted on the byte stage's mbarrier;
//   both loader warps then convert the stage, exactly (int8 and e4m3 are
//   exact in bf16 and fp16), into the 16-bit ring the consumers read, in
//   the layout TMA gives a plain pool, copy its scales beside it, fence
//   their writes for the async proxy and arrive on the stage's full
//   barrier; warp 4 refills the byte stage once both warps have read it.
//   The consumers' walk is the plain pool's but for the scales, applied per
//   column in fp32: S's column by its token's K scale (before the softmax
//   scale), P's by its V scale before P's hi / lo split (l sums the
//   unscaled P).  The byte ring (BST = 1 at d 128, 2 at d 64) keeps two
//   blocks an SM.
#pragma once

#include "paged_tile.cuh"   // the pool maps, swz, pack2, carry

namespace paged {
namespace prefill_tile {

constexpr int PAIRS = 64;                 // (row, head) pairs a tile holds: wgmma's m64
constexpr int SPAN = tile::SPAN;          // tokens a stage holds
constexpr int BOX = tile::BOX;            // tokens a TMA box holds
constexpr int CONSUMERS = 128;            // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int LOADERS = 64;               // quantized pools: two loader warps
constexpr int SUB_BYTES = PAIRS * 128;    // one [64 rows][64] 16-bit sub-tile
constexpr int BAR_CONSUMERS = 1;          // the consumers' named barrier
constexpr int BAR_LOADERS = 2;            // the loader warps' (quantized pools)
constexpr int MAX_SEGS = 4;               // segments a tile: the blocks of a cluster

// Heads a pass takes and chunk tokens a tile holds, for a GQA group of g
// heads (ops/kernels/__init__.py: prefill_tile_shape mirrors these to
// size the segments).
__host__ __device__ inline int pass_heads(int g) { return g < PAIRS ? g : PAIRS; }
__host__ __device__ inline int tile_tokens(int g) { return PAIRS / pass_heads(g); }
__host__ __device__ inline int head_passes(int g) {
  return (g + pass_heads(g) - 1) / pass_heads(g);
}

// Shared memory (bytes from a 1024-byte-aligned base): the queries [D / 64]
// sub-tiles, then the K ring and the V ring, each [STAGES][D / 64]
// sub-tiles; after the walk the ring holds the block's state for the
// cluster's fold, (m, l) [PAIRS][2] and O [PAIRS][PITCH] fp32.  A quantized
// pool adds the byte ring [BST][K, V][SPAN][D bytes] (tile::swzq), the scales
// of its stages [BST][16] and of the 16-bit ring's [STAGES][16] (K's 8
// groups, then V's), and the byte ring's barriers.  Two blocks an SM.
template <int D, bool QUANT = false>
struct Smem {
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int BST = D == 128 ? 1 : 2;   // byte stages (quantized)
  static constexpr int TILE = (D / 64) * SUB_BYTES;   // bytes of Q, or of a stage's K
  static constexpr int Q = 0, K = TILE, V = (1 + STAGES) * TILE;
  static constexpr int BYTE_STAGE = 2 * SPAN * D;   // bytes of a stage's K and V
  static constexpr int QB = (1 + 2 * STAGES) * TILE;
  static constexpr int SC = QB + BST * BYTE_STAGE;   // [BST][16], then [STAGES][16] floats
  static constexpr int BAR = SC + (BST + STAGES) * 16 * 4;   // bfull[BST]
  static constexpr int BYTES = (QUANT ? BAR + BST * 8 : QB) + 1024;   // + the base's alignment
  static constexpr int PITCH = D + 8;   // floats a pair's O row: conflict-free stores
  static constexpr int STATE = PAIRS * (2 + PITCH) * 4;   // bytes of the state
  static_assert(2 * (D / 64) * (SPAN / BOX) <= 32, "one lane of the producer a box");
  static_assert(STATE <= 2 * STAGES * TILE, "the state fits the ring");
};

// What a launch hands every block.  Tiles are numbered
// ((bi * nkv + h) * passes + pass) * tiles_a_pass + t; with segs > 1 the
// segs blocks of a tile form one cluster.
struct Args {
  CUtensorMap tm_k, tm_v;   // the pools [pages, page, nkv, D] (paged_tile.cuh: encode_pools)
  const float* k_scale;     // [pages, nkv] (quantized pools; else null)
  const float* v_scale;
  const void* q;            // [b, s, n, D]
  void* out;                // [b, s, n, D]
  const int* tables;        // [b, W]
  const int* start;         // [b]: the position of each sequence's first row
  int b, s, n, nkv, W, page, pages, window, seg_stages, segs;
  float scale;
};

// Threads a block: the consumers and the producer warp; a quantized pool's
// second loader warp.
template <bool QUANT>
struct Threads {
  static constexpr int value = QUANT ? CONSUMERS + LOADERS : THREADS;
};

// A block: tile blockIdx.x, segment blockIdx.y (its rank in the cluster).
// S: the pools' storage type (T: a plain pool; int8_t or __nv_fp8_e4m3:
// quantized, scaled by a.k_scale / a.v_scale).
template <typename T, typename S, int D>
__global__ void __launch_bounds__(Threads<!std::is_same<S, T>::value>::value, 2)
prefill_tile_kernel(const __grid_constant__ Args a) {
  constexpr bool QUANT = !std::is_same<S, T>::value;
  using L = Smem<D, QUANT>;
  constexpr int STAGES = L::STAGES;
  constexpr int H = D / 64;
  constexpr int PPR = D / 8;   // 16-byte pieces a row of D
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  T* const sq = reinterpret_cast<T*>(smem + L::Q);
  T* const sk = reinterpret_cast<T*>(smem + L::K);
  T* const sv = reinterpret_cast<T*>(smem + L::V);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the tile: sequence bi, kv head h, heads hp0 .. hp0 + gp - 1 of its
  // group, chunk tokens t0 .. t0 + ntok - 1; pair mr is token t0 + mr / gp,
  // head hp0 + mr % gp
  const int g = a.n / a.nkv, per = tile_tokens(g), passes = head_passes(g);
  const int nt = (a.s + per - 1) / per;
  int rest = blockIdx.x;
  const int t = rest % nt;
  rest /= nt;
  const int hp0 = (rest % passes) * pass_heads(g);
  rest /= passes;
  const int h = rest % a.nkv, bi = rest / a.nkv;
  const int gp = min(pass_heads(g), g - hp0);
  const int t0 = t * per, ntok = min(per, a.s - t0), mrows = ntok * gp;
  const int start = a.start[bi];
  const int p_first = start + t0, p_last = p_first + ntok - 1;
  const int cap = a.W * a.page;
  // the walk [lo, hi) (attend_row's page walk over the tile's rows)
  int lo = 0, hi = min(p_last + 1, cap);
  if (a.window > 0 && p_first - a.window + 1 > 0)
    lo = ((p_first - a.window + 1) / a.page) * a.page;
  if (lo >= hi) lo = hi = 0;   // no row sees a token: zeros
  const int seg_tok = a.seg_stages * SPAN;
  const int zf = lo / seg_tok, zl = hi > lo ? (hi - 1) / seg_tok : zf;
  const int z = blockIdx.y;
  if (z < zf || z > zl) {   // a segment outside the walk: nothing to do but
    if (zf < zl) {           // keep the cluster's barriers
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    return;
  }
  const int wlo = max(lo, z * seg_tok), whi = min(hi, (z + 1) * seg_tok);
  const int k0 = wlo / SPAN;
  const int nst = whi > wlo ? (whi + SPAN - 1) / SPAN - k0 : 0;
  const long long head0 = (long long)h * g + hp0;
  auto row_of = [&](int mr) {   // element offset of pair mr's row in q and out
    return (((long long)bi * a.s + t0 + mr / gp) * a.n + head0 + mr % gp) * D;
  };

  // a quantized pool's byte ring, its stages' scales, the 16-bit ring's
  // scales and the byte ring's barriers
  unsigned char* const qb = smem + L::QB;
  float* const s_bsc = reinterpret_cast<float*>(smem + L::SC);
  float* const s_sc = s_bsc + L::BST * 16;
  uint64_t* const bfull = reinterpret_cast<uint64_t*>(smem + L::BAR);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], QUANT ? LOADERS : 1);
      hopper::mbar_init(&empty[i], CONSUMERS);
    }
    if constexpr (QUANT) {
#pragma unroll
      for (int i = 0; i < L::BST; ++i) hopper::mbar_init(&bfull[i], 1 + SPAN / BOX);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if constexpr (QUANT) {
    if (warp >= CONSUMERS / 32) {
      // the loader warps: warp 4's lane `lane` loads byte box (tensor,
      // token group) of each stage and lanes 0-7 the groups' scales; both
      // warps convert
      const int lt = tid - CONSUMERS;
      const bool tma_warp = warp == CONSUMERS / 32;
      const int bx_v = lane / (SPAN / BOX), bx_g = lane % (SPAN / BOX);
      const bool boxer = lane < 2 * (SPAN / BOX);
      const int* table = a.tables + (long long)bi * a.W;
      auto box_page = [&](int i) {   // this lane's page id in stage i (`pages` outside the walk)
        const int tok = (k0 + i) * SPAN + bx_g * BOX;
        return boxer && tok + BOX > wlo && tok < whi ? table[tok / a.page] : a.pages;
      };
      int pid = 0;
      auto load = [&](int i) {   // warp 4: stage i's bytes and scales into byte stage i % BST
        const int slot = i % L::BST;
        if (lane == 0) hopper::mbar_arrive_expect_tx(&bfull[slot], L::BYTE_STAGE);
        __syncwarp();
        const int tok = (k0 + i) * SPAN + bx_g * BOX;
        if (boxer)
          hopper::tma_load_4d(qb + slot * L::BYTE_STAGE + (bx_v * SPAN + bx_g * BOX) * D,
                              bx_v ? &a.tm_v : &a.tm_k, &bfull[slot], 0, h, tok % a.page, pid);
        if (lane < SPAN / BOX) {   // K's box of group `lane`: the group's page
          const bool real = pid < a.pages;
          const long long at = real ? (long long)pid * a.nkv + h : 0;
          hopper::cp_async_4(s_bsc + slot * 16 + lane, a.k_scale + at, real ? 4 : 0);
          hopper::cp_async_4(s_bsc + slot * 16 + 8 + lane, a.v_scale + at, real ? 4 : 0);
          hopper::cp_async_mbar_arrive(&bfull[slot]);
        }
        pid = i + 1 < nst ? box_page(i + 1) : 0;   // the next stage's, while this one loads
      };
      if (tma_warp && nst > 0) {
        pid = box_page(0);
        for (int i = 0; i < min(L::BST, nst); ++i) load(i);
      }
      for (int i = 0; i < nst; ++i) {
        const int slot = i % L::BST, buf = i % STAGES;
        hopper::mbar_wait(&bfull[slot], (i / L::BST) & 1);
        hopper::mbar_wait(&empty[buf], ((i / STAGES) & 1) ^ 1);   // the consumers are done with it
        // 16-byte pieces (tensor, row, chunk c: dims 16 c .. 16 c + 15):
        // 8 adjacent threads read 128 adjacent bytes, conflict-free
        constexpr int CPR = D / 16;   // chunks a row
        const unsigned char* src = qb + slot * L::BYTE_STAGE;
#pragma unroll 4
        for (int p = lt; p < 2 * SPAN * CPR; p += LOADERS) {
          const int c = p % CPR, r = (p / CPR) % SPAN, tv = p / (CPR * SPAN);
          const uint4 x = *reinterpret_cast<const uint4*>(src + tv * SPAN * D +
                                                          tile::swzq<D>(r, 16 * c));
          const uint2 w0 = tile::widen4<T, S>(x.x), w1 = tile::widen4<T, S>(x.y);
          const uint2 w2 = tile::widen4<T, S>(x.z), w3 = tile::widen4<T, S>(x.w);
          T* const dst = (tv ? sv : sk) + buf * SPAN * D;
          *reinterpret_cast<uint4*>(dst + tile::swz<SPAN>(r, 2 * c)) =
              make_uint4(w0.x, w0.y, w1.x, w1.y);
          *reinterpret_cast<uint4*>(dst + tile::swz<SPAN>(r, 2 * c + 1)) =
              make_uint4(w2.x, w2.y, w3.x, w3.y);
        }
        if (lt < 16) s_sc[buf * 16 + lt] = s_bsc[slot * 16 + lt];
        hopper::fence_proxy_async();     // the writes, for wgmma's reads
        hopper::mbar_arrive(&full[buf]);
        hopper::named_sync(BAR_LOADERS, LOADERS);   // both warps have read byte stage `slot`
        if (tma_warp && i + L::BST < nst) load(i + L::BST);
      }
      if (zf < zl) {   // the cluster's barriers (the fold is the consumers')
        hopper::cluster_sync();
        hopper::cluster_sync();
      }
      return;
    }
  } else if (warp == CONSUMERS / 32) {
    // the producer: lane `lane` loads box (tensor, sub-tile, token group)
    // of each stage
    const int bx_v = lane / (H * (SPAN / BOX)), bx_h = (lane / (SPAN / BOX)) % H;
    const int bx_g = lane % (SPAN / BOX);
    const bool boxer = lane < 2 * H * (SPAN / BOX);
    const int* table = a.tables + (long long)bi * a.W;
    auto box_page = [&](int i) {   // this lane's page id in stage i (`pages` outside the walk)
      const int tok = (k0 + i) * SPAN + bx_g * BOX;
      return boxer && tok + BOX > wlo && tok < whi ? table[tok / a.page] : a.pages;
    };
    int pid = nst > 0 ? box_page(0) : 0;
    for (int i = 0; i < nst; ++i) {
      const int buf = i % STAGES;
      hopper::mbar_wait(&empty[buf], ((i / STAGES) & 1) ^ 1);   // the first pass finds it empty
      if (lane == 0)
        hopper::mbar_arrive_expect_tx(&full[buf], 2 * H * (SPAN / BOX) * tile::BOX_BYTES);
      __syncwarp();
      const int tok = (k0 + i) * SPAN + bx_g * BOX;
      if (boxer)
        hopper::tma_load_4d((bx_v ? sv : sk) + buf * SPAN * D + (bx_h * SPAN + bx_g * BOX) * 64,
                            bx_v ? &a.tm_v : &a.tm_k, &full[buf], bx_h * 64, h, tok % a.page,
                            pid);
      pid = i + 1 < nst ? box_page(i + 1) : 0;   // the next stage's, while this one loads
    }
    if (zf < zl) {   // the cluster's barriers (the fold is the consumers')
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    return;
  }

  // the consumers: the queries, pair mr in row mr (pairs past the tile are
  // zeros), loaded while the first stages arrive, for wgmma to read (the
  // generic proxy's writes fenced for the async proxy)
  {
    constexpr int PER_THREAD = PAIRS * PPR / CONSUMERS;
    uint4 v[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = tid + k * CONSUMERS, mr = i / PPR, c = i % PPR;
      v[k] = mr < mrows ? *reinterpret_cast<const uint4*>(static_cast<const T*>(a.q) +
                                                        row_of(mr) + c * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = tid + k * CONSUMERS;
      *reinterpret_cast<uint4*>(sq + tile::swz<PAIRS>(i / PPR, i % PPR)) = v[k];
    }
  }
  hopper::fence_proxy_async();
  hopper::named_sync(BAR_CONSUMERS, CONSUMERS);

  // warp w holds pairs 16 w + lane / 4 and + 8 of S and O
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[D / 8][4];
  {
    int pos_r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int mr = 16 * warp + (lane >> 2) + 8 * e;
      pos_r[e] = mr < mrows ? p_first + mr / gp : p_last;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    const float sl2 = a.scale * flash::LOG2E;
    const uint32_t q_addr = hopper::smem_u32(sq);
    const uint32_t k_addr = hopper::smem_u32(sk), v_addr = hopper::smem_u32(sv);
    for (int i = 0; i < nst; ++i) {
      const int buf = i % STAGES;
      hopper::mbar_wait(&full[buf], (i / STAGES) & 1);
      float s[SPAN / 8][4];
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * SUB_BYTES + (kk & 3) * 32;
        hopper::wgmma_ss_m64n64<T>(s, hopper::desc_sw128(q_addr + off, 0, 1024),
                                   hopper::desc_sw128(k_addr + buf * L::TILE + off, 0, 1024),
                                   kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      // the online softmax, pair by pair (scores in log2 units)
      const int c0 = (k0 + i) * SPAN;
      const bool bare = c0 + SPAN - 1 <= p_first && c0 + SPAN <= cap &&
                        (a.window <= 0 || p_last - c0 < a.window);
      // a quantized pool: column j (tokens 8 j .. 8 j + 7, one page) takes
      // its K scale beside the softmax scale
      const float* const scs = s_sc + buf * 16;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < SPAN / 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float v = s[j][2 * e + u] * (QUANT ? scs[j] * sl2 : sl2);
            if (!bare) {
              const int tok = c0 + 8 * j + 2 * (lane & 3) + u;
              const bool ok = tok < cap && tok <= pos_r[e] &&
                              (a.window <= 0 || pos_r[e] - tok < a.window);
              v = ok ? v : NEG_INF;
            }
            s[j][2 * e + u] = v;
            mx = fmaxf(mx, v);
          }
        const float mn = fmaxf(m[e], flash::quad_max(mx));
        const float alpha = tile::carry(m[e], mn);   // exactly 1 for a masked stage
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < SPAN / 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float v = s[j][2 * e + u];
            const float p = v <= NEG_INF * 0.5f ? 0.f : flash::ex2(v - mn);
            s[j][2 * e + u] = p;
            ps += p;
          }
        l[e] = l[e] * alpha + ps;   // this lane's columns; summed over the quad at the end
        m[e] = mn;
        // O takes the factor unless no pair of the warp moved its maximum
        // (a factor of exactly 1 leaves O's bits as they are)
        if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][2 * e] *= alpha;
            o[j][2 * e + 1] *= alpha;
          }
        }
      }
      // a quantized pool: P's column j times its V scale (l keeps the
      // unscaled sum)
      if constexpr (QUANT) {
#pragma unroll
        for (int j = 0; j < SPAN / 8; ++j) {
          const float vs = scs[8 + j];
#pragma unroll
          for (int x = 0; x < 4; ++x) s[j][x] *= vs;
        }
      }
      // P as A fragments, its part in T and the rest: tokens 16 t .. 16 t + 15
      uint32_t ph[SPAN / 16][4], pl[SPAN / 16][4];
#pragma unroll
      for (int tt = 0; tt < SPAN / 16; ++tt)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* src = s[2 * tt + (f >> 1)] + 2 * (f & 1);
          ph[tt][f] = tile::pack2<T>(src[0], src[1]);
          float h0, h1;   // the part in T, back in fp32
          if constexpr (std::is_same<T, __half>::value) {
            const float2 hf = __half22float2(*reinterpret_cast<const __half2*>(&ph[tt][f]));
            h0 = hf.x, h1 = hf.y;
          } else {   // a bf16 is the top half of an fp32
            h0 = __uint_as_float(ph[tt][f] << 16);
            h1 = __uint_as_float(ph[tt][f] & 0xffff0000u);
          }
          pl[tt][f] = tile::pack2<T>(src[0] - h0, src[1] - h1);
        }
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int tt = 0; tt < SPAN / 16; ++tt) {
        const uint64_t db = hopper::desc_sw128(v_addr + buf * L::TILE + tt * 2048, SUB_BYTES, 1024);
        if constexpr (D == 128) {
          hopper::wgmma_rs_m64n128_tb<T>(o, ph[tt], db);
          hopper::wgmma_rs_m64n128_tb<T>(o, pl[tt], db);
        } else {
          hopper::wgmma_rs_m64n64_tb<T>(o, ph[tt], db);
          hopper::wgmma_rs_m64n64_tb<T>(o, pl[tt], db);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[buf]);   // K and V of this stage are read
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = flash::quad_sum(l[e]);
  }

  // the tile's only segment: this warp's pairs, O / l (l == 0: no token,
  // zeros)
  T* const out = static_cast<T*>(a.out);
  if (zf == zl) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int mr = 16 * warp + (lane >> 2) + 8 * e;
      if (mr >= mrows) continue;
      const float inv = l[e] == 0.f ? 0.f : 1.f / l[e];
      T* const row = out + row_of(mr) + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            tile::pack2<T>(o[j][2 * e] * inv, o[j][2 * e + 1] * inv);
    }
    return;
  }

  // one of several segments: each block of the cluster leaves its state in
  // its shared memory (where the ring was: every stage is read), and block
  // zf + r folds pairs r, r + nz, ... over all of them, in segment order,
  // through distributed shared memory, 4 columns a thread (item tid + k
  // CONSUMERS), a segment's loads going out together
  constexpr int PITCH = L::PITCH;
  float* const st_ml = reinterpret_cast<float*>(smem + L::K);   // [PAIRS][2], then
  float* const st_o = st_ml + PAIRS * 2;                          // [PAIRS][PITCH]
  hopper::named_sync(BAR_CONSUMERS, CONSUMERS);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int mr = 16 * warp + (lane >> 2) + 8 * e;
    if ((lane & 3) == 0) *reinterpret_cast<float2*>(st_ml + 2 * mr) = make_float2(m[e], l[e]);
    float* const row = st_o + mr * PITCH + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(o[j][2 * e], o[j][2 * e + 1]);
  }
  hopper::cluster_sync();   // the states are published
  constexpr int ITEMS = (PAIRS / 2) * (D / 4) / CONSUMERS;   // at most, with nz >= 2
  const int nz = zl - zf + 1, mine = (mrows - (z - zf) + nz - 1) / nz;
  const uint32_t ml_addr = hopper::smem_u32(st_ml), o_addr = hopper::smem_u32(st_o);
  float M[ITEMS], Ls[ITEMS];
  float4 acc[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    M[k] = NEG_INF;
    Ls[k] = 0.f;
    acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  auto pair_of = [&](int k) { return z - zf + ((tid + k * CONSUMERS) / (D / 4)) * nz; };
  auto col_of = [&](int k) { return 4 * ((tid + k * CONSUMERS) % (D / 4)); };
  for (int zz = zf; zz <= zl; ++zz) {
    float2 ml[ITEMS];
    float4 oz[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (tid + k * CONSUMERS < mine * (D / 4)) {
        ml[k] = hopper::ld_cluster_f2(hopper::cluster_addr(ml_addr + 8 * pair_of(k), zz));
        oz[k] = hopper::ld_cluster_f4(
            hopper::cluster_addr(o_addr + 4 * (pair_of(k) * PITCH + col_of(k)), zz));
      }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (tid + k * CONSUMERS < mine * (D / 4)) {
        const float mn = fmaxf(M[k], ml[k].x);
        const float fa = tile::carry(M[k], mn), fb = tile::carry(ml[k].x, mn);
        Ls[k] = fa * Ls[k] + fb * ml[k].y;
        acc[k].x = fa * acc[k].x + fb * oz[k].x;
        acc[k].y = fa * acc[k].y + fb * oz[k].y;
        acc[k].z = fa * acc[k].z + fb * oz[k].z;
        acc[k].w = fa * acc[k].w + fb * oz[k].w;
        M[k] = mn;
      }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (tid + k * CONSUMERS < mine * (D / 4)) {
      const float inv = Ls[k] == 0.f ? 0.f : 1.f / Ls[k];
      T* const row = out + row_of(pair_of(k)) + col_of(k);
      *reinterpret_cast<uint32_t*>(row) = tile::pack2<T>(acc[k].x * inv, acc[k].y * inv);
      *reinterpret_cast<uint32_t*>(row + 2) = tile::pack2<T>(acc[k].z * inv, acc[k].w * inv);
    }
  hopper::cluster_sync();   // no block leaves while another reads its state
}

template <typename T, typename S, int D>
cudaError_t launch_typed(const Args& a, int tiles, cudaStream_t st) {
  constexpr bool QUANT = !std::is_same<S, T>::value;
  constexpr int smem = Smem<D, QUANT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(prefill_tile_kernel<T, S, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, a.segs);
  cfg.blockDim = dim3(Threads<QUANT>::value);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // a tile's segments: one cluster
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.segs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, prefill_tile_kernel<T, S, D>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One K6 launch on the tile path.  dtype 1 = bf16, 2 = fp16 (q's type); KV
// the pools' storage code (paged_common.cuh: Storage; 1 and 2 need
// a.k_scale / a.v_scale); d 64 or 128.
template <int KV>
inline cudaError_t launch(Args& a, const void* k_pool, const void* v_pool, int d, int dtype,
                          cudaStream_t st) {
  if (a.seg_stages < 1 || a.segs < 1) return cudaErrorInvalidValue;
  if (KV != 0 && (a.k_scale == nullptr || a.v_scale == nullptr)) return cudaErrorInvalidValue;
  cudaError_t e = tile::encode_pools(&a.tm_k, &a.tm_v, k_pool, v_pool, a.nkv, a.page, a.pages,
                                     d, KV == 0 ? dtype : 3);
  if (e != cudaSuccess) return e;
  const int g = a.n / a.nkv;
  const long long tiles = (long long)a.b * a.nkv * head_passes(g) *
                          ((a.s + tile_tokens(g) - 1) / tile_tokens(g));
  if (tiles > 0x7fffffffll || a.segs > MAX_SEGS) return cudaErrorInvalidConfiguration;
  using B = __nv_bfloat16;
  using F = __half;
  if (dtype == 1 && d == 64)
    return launch_typed<B, typename Storage<B, KV>::type, 64>(a, (int)tiles, st);
  if (dtype == 1 && d == 128)
    return launch_typed<B, typename Storage<B, KV>::type, 128>(a, (int)tiles, st);
  if (dtype == 2 && d == 64)
    return launch_typed<F, typename Storage<F, KV>::type, 64>(a, (int)tiles, st);
  if (dtype == 2 && d == 128)
    return launch_typed<F, typename Storage<F, KV>::type, 128>(a, (int)tiles, st);
  return cudaErrorInvalidValue;
}

}  // namespace prefill_tile
}  // namespace paged
