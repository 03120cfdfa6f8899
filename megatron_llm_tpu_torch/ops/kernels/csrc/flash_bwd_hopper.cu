// Flash-attention backward for Hopper: dq (K2) and dk / dv (K3) at bf16,
// head_dim 64 and 128, the training path's shapes.  fp32 and head_dim 256
// take the shared-memory kernels of flash_bwd.cu; the path is chosen once,
// in Python (ops/kernels/__init__.py: flash_path).
//
// Replaces the Pallas TPU kernels megatron_llm_tpu/ops/pallas/flash_attention.py
// (_bwd_dq_kernel and _bwd_dkv_kernel, launched by _bwd) and computes what
// flash_bwd.cu computes: each tile recomputes s = q k^T scale with the
// masks from global positions (causal, window, segment ids, ragged edges),
// p = exp(s - lse), dp = do v^T and ds = p (dp - delta) scale in fp32; P
// and dS are rounded to bf16 before the products they feed.  K2:
// dq = sum ds k.  K3: dv = sum p^T do and dk = sum ds^T q over every q tile
// of every query head of the kv head's group.  No atomics: a work tile
// owns its dq (K2) or dk / dv (K3) rows, so two runs give the same bits.
//
// Bound on the H100: the products (K2 three, K3 four, of 2 sq skv d flops
// a head, halved by the causal mask) at 989 TFLOP/s.  Design: K1's
// (flash_fwd_hopper.cu), with the roles of the tiles per kernel:
//
// * A work tile holds a 128-row "stationary" tile in shared memory (K2: Q
//   and dO of one q tile of one head; K3: K and V of one kv tile of one kv
//   head) and walks 64-row tiles of the other side (K2: K and V; K3: Q and
//   dO, head by head over the GQA group) through a ring of stages.
//   Persistent blocks take work tiles from a counter in device memory,
//   heaviest first within groups of heads whose walked tiles fit in L2
//   together (under the causal mask: K2's last q tiles, K3's first kv
//   tiles).
// * Warpgroup 0 produces at setmaxnreg 24: one thread hands work tiles to
//   the consumers and issues the TMA loads, with full / empty mbarriers
//   for the stationary tile and for each stage; its first warp stages each
//   walked tile's vectors (K2: the kv segment ids; K3: lse in log2 units,
//   delta and the q segment ids).
// * Warpgroups 1 and 2 consume at 240 registers, 64 stationary rows each,
//   and take turns issuing products (named barriers 1 and 2), so one's
//   elementwise pass runs under the other's products.
// * K2, a kv tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16 (both
//   operands K-major in shared memory); dS on the accumulator fragments;
//   dQ += dS K with dS repacked as register A fragments and K read MN-major
//   through the transpose bit.  The next tile's S and dP are issued with
//   this tile's dQ product and dS is formed while dQ runs.  Registers: dQ
//   (d / 2 fp32 a thread), S and dP (32 each), dS fragments (16).
// * K3, a q tile, in transposed form: S^T = K Q^T and dP^T = V dO^T (SS,
//   K-major), P^T and dS^T on the fragments, then dV += P^T dO and
//   dK += dS^T Q (register A; dO and Q MN-major).  dK and dV (d / 2 fp32
//   each) stay in registers for the work tile; with S^T and dP^T (64 more)
//   there is no room to run a tile's dV / dK products beside the next
//   tile's S^T / dP^T in one warpgroup, so a tile takes two turns and the
//   overlap comes from the other warpgroup.
// * Masks as in K1: a range of allowed columns a row (two compares) plus
//   the segment test, applied only on tiles tile_full rejects; masked
//   scores are -inf, so p = ex2(-inf) = 0 with no branch per element.
//   TMA's zero fill past the sequence is no mask (k = 0 still gives
//   p = exp(-lse)), so every row and column past it is masked.
#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {
namespace {

constexpr int BT = 128;             // rows of the stationary tile (64 a consumer)
constexpr int BW = 64;              // rows of a walked tile
constexpr int BTHREADS = 384;       // producer + two consumer warpgroups
constexpr int BCONSUMERS = 256;     // consumer threads
constexpr int ST_SUB = BT * 128;    // one [BT][64] bf16 sub-tile
constexpr int W_SUB = BW * 128;     // one [BW][64] bf16 sub-tile
constexpr int BAR_TURN = 1;         // named barriers 1, 2: the consumers' turns
constexpr int NJ = BW / 8;          // 8-column fragments of a score tile

struct BwdParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  Params p;
  int heads_group;    // heads whose tiles run side by side (decode_tile)
  int* tile_counter;  // work tiles handed out past the first round (zeroed)
};

struct Tile {
  int bi, h, t;  // batch; head (K2) or kv head (K3); stationary tile
  int lo, hi;    // walked tiles [lo, hi) (of each head of the group in K3)
};

// Work tile `idx` (false past the last).  Order: batch, head group,
// stationary tile heaviest first, head.
template <bool DKV>
__device__ __forceinline__ bool decode_tile(int idx, const BwdParams& bp, Tile& t) {
  const Params& p = bp.p;
  const int heads = DKV ? p.nkv : p.n;
  const int n_t = ((DKV ? p.skv : p.sq) + BT - 1) / BT;
  if (idx >= p.b * heads * n_t) return false;
  t.bi = idx / (heads * n_t);
  const int rem = idx - t.bi * heads * n_t;
  const int grp = rem / (bp.heads_group * n_t), r = rem - grp * bp.heads_group * n_t;
  const int g_heads = min(bp.heads_group, heads - grp * bp.heads_group);
  t.t = DKV ? r / g_heads : n_t - 1 - r / g_heads;
  t.h = grp * bp.heads_group + r % g_heads;
  t.lo = 0;
  t.hi = ((DKV ? p.sq : p.skv) + BW - 1) / BW;
  const int r0 = t.t * BT;
  if (DKV) {
    while (t.lo < t.hi && !run_tile(t.lo * BW, r0, BW, BT, p)) ++t.lo;
    while (t.hi > t.lo && !run_tile((t.hi - 1) * BW, r0, BW, BT, p)) --t.hi;
  } else {
    while (t.lo < t.hi && !run_tile(r0, t.lo * BW, BT, BW, p)) ++t.lo;
    while (t.hi > t.lo && !run_tile(r0, (t.hi - 1) * BW, BT, BW, p)) --t.hi;
  }
  return true;
}

// Shared memory (byte offsets from a 1024-byte-aligned base): the
// stationary tiles SA, SB (K2: Q, dO; K3: K, V), the walked tiles WA, WB
// [STAGES] (K2: K, V; K3: Q, dO), each NSUB sub-tiles; a stage's vectors
// [STAGES][3][BW] (K3: lse in log2 units, delta; both: segment ids); two
// work-tile slots; the barriers.  The ring's position runs on across work
// tiles.  STAGES: walked tiles in flight.  K2 consumes a kv tile in one
// turn, and with two stages it waits on its loads; K3 spends two turns on
// a q tile, and two stages keep it fed (more only leave less L1).
template <int D, bool DKV>
struct BwdSmem {
  static constexpr int STAGES = DKV ? 2 : 4;
  static constexpr int NSUB = D / 64;
  static constexpr int ST_TILE = NSUB * ST_SUB, W_TILE = NSUB * W_SUB;
  static constexpr int SA = 0, SB = ST_TILE;
  static constexpr int WA = 2 * ST_TILE, WB = WA + STAGES * W_TILE;
  static constexpr int VEC = WB + STAGES * W_TILE;
  static constexpr int SLOTS = VEC + STAGES * 3 * BW * 4;
  static constexpr int BARS = SLOTS + 8;
  // full / empty stationary, full / empty walked [STAGES], full / empty slot [2]
  static constexpr int N_BARS = 2 + 2 * STAGES + 4;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;  // + the base's alignment
};

struct Bars {
  uint64_t *full_s, *empty_s, *full_w, *empty_w, *full_t, *empty_t;
};

template <int D, bool DKV>
__device__ __forceinline__ void produce(const BwdParams& bp, unsigned char* smem,
                                        const Bars& b) {
  using L = BwdSmem<D, DKV>;
  constexpr int STAGES = L::STAGES;
  const Params& p = bp.p;
  const int lane = threadIdx.x;
  const int g = p.n / p.nkv;
  int* slots = reinterpret_cast<int*>(smem + L::SLOTS);
  const CUtensorMap* st_a = DKV ? &bp.tm_k : &bp.tm_q;
  const CUtensorMap* st_b = DKV ? &bp.tm_v : &bp.tm_do;
  const CUtensorMap* w_a = DKV ? &bp.tm_q : &bp.tm_k;
  const CUtensorMap* w_b = DKV ? &bp.tm_do : &bp.tm_v;
  uint32_t it = 0;  // walked tiles loaded so far: the ring's position
  int idx = blockIdx.x;
  for (int k = 0;; ++k) {
    // hand the tile to the consumers (past the last one: their signal to stop)
    hopper::mbar_wait(b.empty_t + (k & 1), ((k >> 1) & 1) ^ 1);
    if (lane == 0) {
      slots[k & 1] = idx;
      hopper::mbar_arrive(b.full_t + (k & 1));
    }
    Tile t;
    if (!decode_tile<DKV>(idx, bp, t)) break;
    hopper::mbar_wait(b.empty_s, (k & 1) ^ 1);  // the first tile finds it empty
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(b.full_s, 2 * L::ST_TILE);
      for (int s = 0; s < L::NSUB; ++s) {
        hopper::tma_load_4d(smem + L::SA + s * ST_SUB, st_a, b.full_s, 64 * s, t.h, t.t * BT,
                            t.bi);
        hopper::tma_load_4d(smem + L::SB + s * ST_SUB, st_b, b.full_s, 64 * s, t.h, t.t * BT,
                            t.bi);
      }
    }
    const int nw = t.hi - t.lo;
    const int walk = DKV ? g * nw : nw;
    for (int w = 0; w < walk; ++w, ++it) {
      const int st = it % STAGES;
      const uint32_t parity = ((it / STAGES) & 1) ^ 1;  // the first pass finds it empty
      // the walked tile's head and first row
      const int wh = DKV ? t.h * g + w / nw : t.h / g;
      const int r0 = (t.lo + (DKV ? w % nw : w)) * BW;
      hopper::mbar_wait(b.empty_w + st, parity);
      float* vec = reinterpret_cast<float*>(smem + L::VEC) + st * 3 * BW;
      int* seg = reinterpret_cast<int*>(vec + 2 * BW);
      if (DKV) {
        const long long row0 = ((long long)t.bi * p.n + wh) * p.sq;
        for (int j = lane; j < BW; j += 32) {
          const int qi = r0 + j;
          const bool ok = qi < p.sq;
          vec[j] = ok ? p.lse[row0 + qi] * LOG2E : 0.f;
          vec[BW + j] = ok ? p.delta[row0 + qi] : 0.f;
          if (p.seg_q != nullptr) seg[j] = ok ? p.seg_q[(long long)t.bi * p.sq + qi] : 0;
        }
      } else if (p.seg_kv != nullptr) {
        for (int j = lane; j < BW; j += 32) {
          const int kj = r0 + j;
          seg[j] = kj < p.skv ? p.seg_kv[(long long)t.bi * p.skv + kj] : 0;
        }
      }
      __syncwarp();  // then lane 0's arrive releases them with the tiles
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(b.full_w + st, 2 * L::W_TILE);
        for (int s = 0; s < L::NSUB; ++s) {
          hopper::tma_load_4d(smem + L::WA + st * L::W_TILE + s * W_SUB, w_a, b.full_w + st,
                              64 * s, wh, r0, t.bi);
          hopper::tma_load_4d(smem + L::WB + st * L::W_TILE + s * W_SUB, w_b, b.full_w + st,
                              64 * s, wh, r0, t.bi);
        }
      }
    }
    if (lane == 0) idx = atomicAdd(bp.tile_counter, 1) + gridDim.x;
    idx = __shfl_sync(0xffffffffu, idx, 0);
  }
}

// acc = A B^T: A the consumer's 64 stationary rows at a_addr (sub-tiles of
// ST_SUB bytes), B a walked tile at b_addr (sub-tiles of W_SUB bytes), both
// K-major, reduced over d.
template <int D>
__device__ __forceinline__ void mma_ss(float (&acc)[NJ][4], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    hopper::wgmma_ss_m64n64(acc, hopper::desc_sw128(a_addr + (kk >> 2) * ST_SUB + col, 0, 1024),
                            hopper::desc_sw128(b_addr + (kk >> 2) * W_SUB + col, 0, 1024),
                            kk > 0);
  }
}

// s = A1 B1^T and dp = A2 B2^T (mma_ss) as one commit group.
template <int D>
__device__ __forceinline__ void issue_ss2(float (&s)[NJ][4], float (&dp)[NJ][4], uint32_t a1,
                                          uint32_t b1, uint32_t a2, uint32_t b2) {
  hopper::fence_regs(s);
  hopper::fence_regs(dp);
  hopper::wgmma_fence();
  mma_ss<D>(s, a1, b1);
  mma_ss<D>(dp, a2, b2);
  hopper::wgmma_commit();
}

// acc += A B: A the consumer's [64][BW] operand in register fragments, B a
// walked tile at b_addr read MN-major (the transpose bit), reduced over its
// BW rows.
template <int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 8][4], const uint32_t (&a)[NJ / 2][4],
                                       uint32_t b_addr) {
#pragma unroll
  for (int t = 0; t < NJ / 2; ++t) {
    const uint64_t db = hopper::desc_sw128(b_addr + t * 2048, W_SUB, 1024);
    if constexpr (D == 128)
      hopper::wgmma_rs_m64n128_tb(acc, a[t], db);
    else
      hopper::wgmma_rs_m64n64_tb(acc, a[t], db);
  }
}

// Set the raw scores of pairs the masks rule out to -inf: columns outside
// [lo, hi) of each of the thread's two rows, and (segments) columns of
// another document.  col0: the tile's first column position; seg_col: the
// tile's column segment ids in shared memory.
__device__ __forceinline__ void mask_tile(float (&s)[NJ][4], const int (&lo)[2],
                                          const int (&hi)[2], int col0, bool segments,
                                          const int (&seg_row)[2], const int* seg_col) {
  const int gc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cj = col0 + 8 * j + gc + (e & 1);
      if (cj < lo[e >> 1] || cj >= hi[e >> 1]) s[j][e] = -INFINITY;
    }
  if (segments) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (seg_col[8 * j + gc + (e & 1)] != seg_row[e >> 1]) s[j][e] = -INFINITY;
  }
}

// acc += A B (mma_rs) as one commit group.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 8][4], const uint32_t (&a)[NJ / 2][4],
                                         uint32_t b) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  mma_rs<D>(acc, a, b);
  hopper::wgmma_commit();
}

// acc1 += A1 B1 and acc2 += A2 B2 (mma_rs) as one commit group.
template <int D>
__device__ __forceinline__ void issue_rs2(float (&acc1)[D / 8][4], const uint32_t (&a1)[NJ / 2][4],
                                          uint32_t b1, float (&acc2)[D / 8][4],
                                          const uint32_t (&a2)[NJ / 2][4], uint32_t b2) {
  hopper::fence_regs(acc1);
  hopper::fence_regs(acc2);
  hopper::wgmma_fence();
  mma_rs<D>(acc1, a1, b1);
  mma_rs<D>(acc2, a2, b2);
  hopper::wgmma_commit();
}

// K2's dS in place: s = p (dp - delta) scale with p = exp2(s sl2 - lse2) a
// row (s masked already).
__device__ __forceinline__ void ds_rows(float (&s)[NJ][4], const float (&dp)[NJ][4],
                                        const float (&lse2)[2], const float (&delta)[2],
                                        float sl2, float scale) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
      s[j][e] = pr * (dp[j][e] - delta[e >> 1]) * scale;
    }
}

// K3's P^T and dS^T in place: s = p = exp2(s sl2 - lse2), dp = p (dp -
// delta) scale, lse2 and delta a column (from shared memory; s masked
// already).
__device__ __forceinline__ void ds_cols(float (&s)[NJ][4], float (&dp)[NJ][4],
                                        const float* lse2, const float* delta, float sl2,
                                        float scale) {
  const int gc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + gc);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + gc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = ex2(fmaf(s[j][e], sl2, -((e & 1) ? l2.y : l2.x)));
      s[j][e] = pr;
      dp[j][e] = pr * (dp[j][e] - ((e & 1) ? dl.y : dl.x)) * scale;
    }
  }
}

template <int D>
__device__ __forceinline__ void consume_dq(const BwdParams& bp, unsigned char* smem,
                                           const Bars& b, int c) {
  using L = BwdSmem<D, false>;
  constexpr int STAGES = L::STAGES;
  constexpr int ND = D / 8;
  const Params& p = bp.p;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int* vec = reinterpret_cast<const int*>(smem + L::VEC);
  const uint32_t q_addr = hopper::smem_u32(smem + L::SA) + c * 64 * 128;
  const uint32_t do_addr = hopper::smem_u32(smem + L::SB) + c * 64 * 128;
  const uint32_t k_addr = hopper::smem_u32(smem + L::WA);
  const uint32_t v_addr = hopper::smem_u32(smem + L::WB);
  const float sl2 = p.scale * LOG2E;
  float dq[ND][4], s[NJ][4], dp[NJ][4];
  uint32_t da[NJ / 2][4];

  // Turns as in K1: consumer c issues its products after bar.sync on
  // BAR_TURN + c, then lets the other go; consumer 0 goes first and takes
  // the spare arrival at the end.
  const int my_turn = BAR_TURN + c, other_turn = BAR_TURN + (c ^ 1);
  if (c == 1) hopper::named_arrive(BAR_TURN, BCONSUMERS);
  const int* slots = reinterpret_cast<const int*>(smem + L::SLOTS);
  uint32_t it = 0;  // walked tiles consumed so far: the ring's position
  for (int k = 0;; ++k) {
    hopper::mbar_wait(b.full_t + (k & 1), (k >> 1) & 1);
    const int idx = slots[k & 1];
    hopper::mbar_arrive(b.empty_t + (k & 1));
    Tile t;
    if (!decode_tile<false>(idx, bp, t)) break;
    const int qw = t.t * BT + 64 * c;  // this warpgroup's first q row
    const int rows[2] = {qw + 16 * warp + (lane >> 2), qw + 16 * warp + (lane >> 2) + 8};
    float lse2[2], delta[2];
    int segq[2] = {0, 0}, lo[2], hi[2];  // allowed kv columns [lo, hi) a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = rows[i] < p.sq;
      const long long r = ((long long)t.bi * p.n + t.h) * p.sq + rows[i];
      lse2[i] = ok ? p.lse[r] * LOG2E : 0.f;
      delta[i] = ok ? p.delta[r] : 0.f;
      if (p.seg_q != nullptr && ok) segq[i] = p.seg_q[(long long)t.bi * p.sq + rows[i]];
      hi[i] = ok ? (p.causal ? min(p.skv, rows[i] + 1) : p.skv) : 0;
      lo[i] = p.window > 0 ? rows[i] - p.window + 1 : 0;
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

    const int* segk = vec + 2 * BW;  // + the stage's 3 * BW
    hopper::mbar_wait(b.full_s, k & 1);
    if (t.lo < t.hi) {
      int st = it % STAGES;
      hopper::mbar_wait(b.full_w + st, (it / STAGES) & 1);
      hopper::named_sync(my_turn, BCONSUMERS);
      issue_ss2<D>(s, dp, q_addr, k_addr + st * L::W_TILE, do_addr, v_addr + st * L::W_TILE);
      hopper::named_arrive(other_turn, BCONSUMERS);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      if (!tile_full(qw, t.lo * BW, 64, BW, p))
        mask_tile(s, lo, hi, t.lo * BW, p.seg_q != nullptr, segq, segk + st * 3 * BW);
      ds_rows(s, dp, lse2, delta, sl2, p.scale);
      to_a_frags<NJ>(da, s);
      for (int kt = t.lo + 1; kt < t.hi; ++kt) {
        const int prev = st;
        ++it;
        st = it % STAGES;
        hopper::mbar_wait(b.full_w + st, (it / STAGES) & 1);
        hopper::named_sync(my_turn, BCONSUMERS);
        issue_ss2<D>(s, dp, q_addr, k_addr + st * L::W_TILE, do_addr, v_addr + st * L::W_TILE);
        issue_rs<D>(dq, da, k_addr + prev * L::W_TILE);
        hopper::named_arrive(other_turn, BCONSUMERS);
        hopper::wgmma_wait<1>();  // S and dP of this tile done, dQ may run on
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        if (!tile_full(qw, kt * BW, 64, BW, p))
          mask_tile(s, lo, hi, kt * BW, p.seg_q != nullptr, segq, segk + st * 3 * BW);
        ds_rows(s, dp, lse2, delta, sl2, p.scale);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq);
        hopper::mbar_arrive(b.empty_w + prev);  // K and V of the last tile read
        to_a_frags<NJ>(da, s);
      }
      hopper::mbar_arrive(b.empty_s);  // the producer may load the next Q and dO
      issue_rs<D>(dq, da, k_addr + st * L::W_TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      hopper::mbar_arrive(b.empty_w + st);
      ++it;
    } else {
      hopper::mbar_arrive(b.empty_s);
    }
    const float one[2] = {1.f, 1.f};
    store_frags<ND>(p.out, ((long long)t.bi * p.sq * p.n + t.h) * D, (long long)p.n * D, dq,
                    rows, p.sq, one, p.out_f32);
  }
  if (c == 0) hopper::named_sync(BAR_TURN, BCONSUMERS);
}

template <int D>
__device__ __forceinline__ void consume_dkv(const BwdParams& bp, unsigned char* smem,
                                            const Bars& b, int c) {
  using L = BwdSmem<D, true>;
  constexpr int STAGES = L::STAGES;
  constexpr int ND = D / 8;
  const Params& p = bp.p;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = p.n / p.nkv;
  const float* vec = reinterpret_cast<const float*>(smem + L::VEC);
  const uint32_t k_addr = hopper::smem_u32(smem + L::SA) + c * 64 * 128;
  const uint32_t v_addr = hopper::smem_u32(smem + L::SB) + c * 64 * 128;
  const uint32_t q_addr = hopper::smem_u32(smem + L::WA);
  const uint32_t do_addr = hopper::smem_u32(smem + L::WB);
  const float sl2 = p.scale * LOG2E;
  float dk[ND][4], dv[ND][4], s[NJ][4], dp[NJ][4];
  uint32_t pa[NJ / 2][4], da[NJ / 2][4];

  const int my_turn = BAR_TURN + c, other_turn = BAR_TURN + (c ^ 1);
  if (c == 1) hopper::named_arrive(BAR_TURN, BCONSUMERS);
  const int* slots = reinterpret_cast<const int*>(smem + L::SLOTS);
  uint32_t it = 0;
  for (int k = 0;; ++k) {
    hopper::mbar_wait(b.full_t + (k & 1), (k >> 1) & 1);
    const int idx = slots[k & 1];
    hopper::mbar_arrive(b.empty_t + (k & 1));
    Tile t;
    if (!decode_tile<true>(idx, bp, t)) break;
    const int kw = t.t * BT + 64 * c;  // this warpgroup's first kv row
    const int rows[2] = {kw + 16 * warp + (lane >> 2), kw + 16 * warp + (lane >> 2) + 8};
    int segk[2] = {0, 0}, lo[2], hi[2];  // allowed q columns [lo, hi) a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = rows[i] < p.skv;
      if (p.seg_kv != nullptr && ok) segk[i] = p.seg_kv[(long long)t.bi * p.skv + rows[i]];
      lo[i] = p.causal ? rows[i] : 0;
      hi[i] = ok ? (p.window > 0 ? min(p.sq, rows[i] + p.window) : p.sq) : 0;
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

    hopper::mbar_wait(b.full_s, k & 1);
    const int nw = t.hi - t.lo, walk = g * nw;
    if (walk == 0) hopper::mbar_arrive(b.empty_s);
    for (int w = 0; w < walk; ++w, ++it) {
      const int st = it % STAGES;
      const int q0 = (t.lo + w % nw) * BW;
      const float* lse2 = vec + st * 3 * BW;
      const float* delta = lse2 + BW;
      hopper::mbar_wait(b.full_w + st, (it / STAGES) & 1);
      hopper::named_sync(my_turn, BCONSUMERS);
      issue_ss2<D>(s, dp, k_addr, q_addr + st * L::W_TILE, v_addr, do_addr + st * L::W_TILE);
      hopper::named_arrive(other_turn, BCONSUMERS);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      if (w == walk - 1) hopper::mbar_arrive(b.empty_s);  // K and V read for the last time
      if (!tile_full(q0, kw, BW, 64, p))
        mask_tile(s, lo, hi, q0, p.seg_q != nullptr, segk,
                  reinterpret_cast<const int*>(delta + BW));
      ds_cols(s, dp, lse2, delta, sl2, p.scale);
      to_a_frags<NJ>(pa, s);
      to_a_frags<NJ>(da, dp);
      hopper::named_sync(my_turn, BCONSUMERS);
      issue_rs2<D>(dv, pa, do_addr + st * L::W_TILE, dk, da, q_addr + st * L::W_TILE);
      hopper::named_arrive(other_turn, BCONSUMERS);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::mbar_arrive(b.empty_w + st);  // Q, dO and the vectors read
    }
    const float one[2] = {1.f, 1.f};
    const long long base = ((long long)t.bi * p.skv * p.nkv + t.h) * D;
    store_frags<ND>(p.dk, base, (long long)p.nkv * D, dk, rows, p.skv, one, p.out_f32);
    store_frags<ND>(p.dv, base, (long long)p.nkv * D, dv, rows, p.skv, one, p.out_f32);
  }
  if (c == 0) hopper::named_sync(BAR_TURN, BCONSUMERS);
}

template <int D, bool DKV>
__global__ void __launch_bounds__(BTHREADS, 1)
    bwd_kernel_hopper(const __grid_constant__ BwdParams bp) {
  using L = BwdSmem<D, DKV>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  const Bars b{bars, bars + 1, bars + 2, bars + 2 + STAGES, bars + 2 + 2 * STAGES,
               bars + 4 + 2 * STAGES};
  if (threadIdx.x == 0) {
    hopper::mbar_init(b.full_s, 1);
    hopper::mbar_init(b.empty_s, BCONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(b.full_w + s, 1);
      hopper::mbar_init(b.empty_w + s, BCONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(b.full_t + s, 1);
      hopper::mbar_init(b.empty_t + s, BCONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::regs_dec<24>();
    if (threadIdx.x < 32) produce<D, DKV>(bp, smem, b);
  } else {
    hopper::regs_inc<240>();
    if constexpr (DKV)
      consume_dkv<D>(bp, smem, b, threadIdx.x / 128 - 1);
    else
      consume_dq<D>(bp, smem, b, threadIdx.x / 128 - 1);
  }
}

template <int D, bool DKV>
cudaError_t launch_hopper(const Params& p, const long long* geo, int* tile_counter,
                          cudaStream_t st) {
  BwdParams bp{};
  bp.p = p;
  bp.tile_counter = tile_counter;
  // boxes: the stationary side's tiles BT rows, the walked side's BW
  const uint32_t q_rows = DKV ? BW : BT, kv_rows = DKV ? BT : BW;
  cudaError_t e = hopper::encode_rows_bf16(&bp.tm_q, p.q, geo, q_rows);
  if (e == cudaSuccess) e = hopper::encode_rows_bf16(&bp.tm_k, p.k, geo + 7, kv_rows);
  if (e == cudaSuccess) e = hopper::encode_rows_bf16(&bp.tm_v, p.v, geo + 14, kv_rows);
  if (e == cudaSuccess) e = hopper::encode_rows_bf16(&bp.tm_do, p.dout, geo + 21, q_rows);
  if (e != cudaSuccess) return e;
  // setmaxnreg moves registers inside what the block was launched with:
  // 24 + 2 x 240 for every 3 threads needs 168 a thread at launch, else
  // the consumers' setmaxnreg.inc would wait forever.
  static const int regs = [] {
    cudaFuncAttributes a{};
    return cudaFuncGetAttributes(&a, bwd_kernel_hopper<D, DKV>) == cudaSuccess ? a.numRegs : 0;
  }();
  if (regs < (24 + 2 * 240) / 3) {
    fprintf(stderr, "bwd_kernel_hopper<%d, %d>: %d registers a thread, 168 needed\n", D,
            (int)DKV, regs);
    return cudaErrorInvalidConfiguration;
  }
  constexpr int smem = BwdSmem<D, DKV>::BYTES;
  static_assert(smem <= 232448, "shared memory");
  e = cudaFuncSetAttribute(bwd_kernel_hopper<D, DKV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // bytes of walked tiles a work tile's head reads: K2 its kv head's K and
  // V (shared by the group's g heads), K3 the Q and dO of its g heads
  const int g = p.n / p.nkv;
  const long long walked = DKV ? 4ll * p.sq * D * g : std::max(1ll, 4ll * p.skv * D / g);
  const int heads = DKV ? p.nkv : p.n;
  bp.heads_group =
      (int)std::max(1ll, std::min<long long>(heads, L2_GROUP_BYTES / std::max(1ll, walked)));
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)p.b * heads * (((DKV ? p.skv : p.sq) + BT - 1) / BT);
  e = cudaMemsetAsync(tile_counter, 0, sizeof(int), st);
  if (e != cudaSuccess) return e;
  bwd_kernel_hopper<D, DKV>
      <<<(unsigned)std::min<long long>(tiles, sms), BTHREADS, smem, st>>>(bp);
  return cudaGetLastError();
}

}  // namespace

// `geo`: the TMA geometry of q, k, v and do, 7 values each (dims d, heads,
// s, b and the byte strides of heads, s, b), from ops/kernels/__init__.py;
// `tile_counter`: one int of device memory (zeroed here, on the stream);
// `dkv`: K3 (dk / dv into p.dk, p.dv) rather than K2 (dq into p.out).
cudaError_t launch_bwd_hopper(const Params& p, const long long* geo, int* tile_counter, int d,
                              bool dkv, cudaStream_t st) {
  if (geo == nullptr || tile_counter == nullptr) return cudaErrorInvalidValue;
  if (d == 64) return dkv ? launch_hopper<64, true>(p, geo, tile_counter, st)
                          : launch_hopper<64, false>(p, geo, tile_counter, st);
  if (d == 128) return dkv ? launch_hopper<128, true>(p, geo, tile_counter, st)
                           : launch_hopper<128, false>(p, geo, tile_counter, st);
  return cudaErrorInvalidValue;
}

}  // namespace flash
