// Flash-attention forward (K1) for Hopper: bf16 q / k / v at head_dim 64
// and 128, the training path's shapes.  fp32 and head_dim 256 take the
// shared-memory kernel in flash_fwd.cu; the path is chosen once, in Python
// (ops/kernels/__init__.py: flash_path).
//
// Replaces the Pallas TPU kernel megatron_llm_tpu/ops/pallas/flash_attention.py
// (_fwd_kernel, launched by _fwd) and computes what flash_fwd.cu computes:
// fp32 scores scaled after the product, masks from global positions
// (causal, window, segment ids, ragged edges), an online softmax in log2
// units with the -1e30 sentinel and the guard for rows masked so far, P
// rounded to bf16 before the P V product, 0 output and lse = m for fully
// masked rows, lse [b, n, sq] fp32, output bf16 or fp32.
//
// Bound on the H100: the two products (4 sq skv d flops a head, halved by
// the causal mask) at 989 TFLOP/s; at seq 4096 it is far above the ridge.
// Design, to keep the tensor cores busy:
//
// * Persistent blocks, one an SM, each taking work tiles (a 128-row q tile
//   of one head and batch) as it comes free: the first by block index,
//   then from a counter in device memory.  Tiles go in a fixed order:
//   groups of heads whose K / V fit in L2 together, in a group the q tiles
//   heaviest first (the longest causal kv range), so the light tiles fill
//   in at the end.  A block's next tile loads while it stores the last.
// * kv tiles of 128 rows at head_dim 128 and 64 alike: one score layout,
//   mask and softmax for both (a 176-row tile would give d 64's products
//   more work per softmax; the training path runs d 128).
// * Three warpgroups (384 threads).  Warpgroup 0 produces: one thread
//   fetches the next work tile and hands it to the consumers through a
//   two-slot ring, and issues TMA loads (hopper.cuh): the tile's Q once the
//   consumers are done with the last one, then K and V tiles into a ring
//   of two stages, each with a "full" barrier (TMA bytes landed) and an
//   "empty" barrier (both consumers done), for K and V apart; its first
//   warp also stages each kv tile's segment ids.  It gives its registers
//   away (setmaxnreg 24).
// * Warpgroups 1 and 2 consume, 64 q rows each, at 240 registers:
//   S = Q K^T by wgmma m64n128k16 from shared memory (both K-major), the
//   softmax on the accumulator fragments (masks only on tiles that are not
//   full), P repacked in registers as the A operand of O += P V (wgmma's
//   register form, V read MN-major through the transpose bit: never
//   transposed in memory).
// * Overlap: a warpgroup issues tile j's Q K^T and tile j-1's P V
//   together and runs tile j's softmax while P V runs; the two warpgroups
//   take turns issuing their products (named barriers 1 and 2), so one's
//   softmax runs under the other's products.
#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {
namespace {

constexpr int HBM = 128;              // q rows a work tile
constexpr int HBN = 128;              // kv rows a tile
constexpr int HTHREADS = 384;         // producer + two consumer warpgroups
constexpr int SUB_BYTES = 128 * 128;  // one [128 rows][64] bf16 sub-tile
constexpr int CONSUMERS = 256;        // consumer threads
constexpr int BAR_TURN = 1;           // named barriers 1, 2: the consumers' turns

struct HopperParams {
  CUtensorMap tm_q, tm_k, tm_v;
  Params p;
  int heads_group;   // heads whose tiles run side by side (decode_tile)
  int* tile_counter;  // work tiles handed out past the first round (zeroed)
};

struct Tile {
  int bi, h, qt, lo, hi;  // batch, head, q tile, kv tiles [lo, hi)
};

// Work tile `idx` (false past the last).  Tile order: batch, head group,
// q tile heaviest first, head.  Blocks take tiles in this order as they
// come free (the first round by block index, then from tile_counter), so
// the heavy causal tiles start first and the light ones fill in the end.
__device__ __forceinline__ bool decode_tile(int idx, const HopperParams& hp, Tile& t) {
  const Params& p = hp.p;
  const int n_qt = (p.sq + HBM - 1) / HBM;
  if (idx >= p.b * p.n * n_qt) return false;
  t.bi = idx / (p.n * n_qt);
  const int rem = idx - t.bi * p.n * n_qt;
  const int grp = rem / (hp.heads_group * n_qt), r = rem - grp * hp.heads_group * n_qt;
  const int g_heads = min(hp.heads_group, p.n - grp * hp.heads_group);
  t.qt = n_qt - 1 - r / g_heads;
  t.h = grp * hp.heads_group + r % g_heads;
  t.lo = 0;
  t.hi = (p.skv + HBN - 1) / HBN;  // the kv tiles to visit, for every role
  const int q0 = t.qt * HBM;
  while (t.lo < t.hi && !run_tile(q0, t.lo * HBN, HBM, HBN, p)) ++t.lo;
  while (t.hi > t.lo && !run_tile(q0, (t.hi - 1) * HBN, HBM, HBN, p)) --t.hi;
  return true;
}

// Shared memory (byte offsets from a 1024-byte-aligned base): Q, K [2
// stages], V [2 stages], each NSUB sub-tiles; segment ids [2][HBN]; two
// work-tile slots; the barriers.  The ring's position runs on across work
// tiles.
template <int D>
struct Smem {
  static constexpr int NSUB = D / 64;
  static constexpr int TILE = NSUB * SUB_BYTES;
  static constexpr int Q = 0, K = TILE, V = 3 * TILE, SEG = 5 * TILE;
  static constexpr int SLOTS = SEG + 2 * HBN * 4;  // int [2]: work tiles handed to consumers
  static constexpr int BARS = SLOTS + 8;
  // full / empty q; full k, full v, empty k, empty v, full / empty slot [2]
  static constexpr int N_BARS = 14;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;  // + the base's alignment
};

struct Bars {
  uint64_t *full_q, *empty_q, *full_k, *full_v, *empty_k, *empty_v, *full_t, *empty_t;
};

template <int D>
__device__ __forceinline__ void produce(const HopperParams& hp, unsigned char* smem,
                                        const Bars& b) {
  using L = Smem<D>;
  const Params& p = hp.p;
  const int lane = threadIdx.x;
  int* segk_s = reinterpret_cast<int*>(smem + L::SEG);
  int* slots = reinterpret_cast<int*>(smem + L::SLOTS);
  uint32_t it = 0;  // kv tiles loaded so far: the ring's position
  int idx = blockIdx.x;
  for (int k = 0;; ++k) {
    // hand the tile to the consumers (past the last one: their signal to stop)
    hopper::mbar_wait(b.empty_t + (k & 1), ((k >> 1) & 1) ^ 1);
    if (lane == 0) {
      slots[k & 1] = idx;
      hopper::mbar_arrive(b.full_t + (k & 1));
    }
    Tile t;
    if (!decode_tile(idx, hp, t)) break;
    const int kvh = t.h / (p.n / p.nkv);
    const int* seg_kv = p.seg_kv ? p.seg_kv + (long long)t.bi * p.skv : nullptr;
    hopper::mbar_wait(b.empty_q, (k & 1) ^ 1);  // the first tile finds Q empty
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(b.full_q, L::TILE);
      for (int s = 0; s < L::NSUB; ++s)
        hopper::tma_load_4d(smem + L::Q + s * SUB_BYTES, &hp.tm_q, b.full_q, 64 * s, t.h,
                            t.qt * HBM, t.bi);
    }
    for (int kt = t.lo; kt < t.hi; ++kt, ++it) {
      const int st = it & 1;
      const uint32_t parity = ((it >> 1) & 1) ^ 1;  // the first pass finds the ring empty
      const int kv0 = kt * HBN;
      hopper::mbar_wait(b.empty_k + st, parity);
      if (seg_kv != nullptr) {
        for (int j = lane; j < HBN; j += 32)
          segk_s[st * HBN + j] = kv0 + j < p.skv ? seg_kv[kv0 + j] : 0;
        __syncwarp();  // then lane 0's arrive releases them with the tile
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(b.full_k + st, L::TILE);
        for (int s = 0; s < L::NSUB; ++s)
          hopper::tma_load_4d(smem + L::K + st * L::TILE + s * SUB_BYTES, &hp.tm_k,
                              b.full_k + st, 64 * s, kvh, kv0, t.bi);
      }
      hopper::mbar_wait(b.empty_v + st, parity);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(b.full_v + st, L::TILE);
        for (int s = 0; s < L::NSUB; ++s)
          hopper::tma_load_4d(smem + L::V + st * L::TILE + s * SUB_BYTES, &hp.tm_v,
                              b.full_v + st, 64 * s, kvh, kv0, t.bi);
      }
    }
    if (lane == 0) idx = atomicAdd(hp.tile_counter, 1) + gridDim.x;
    idx = __shfl_sync(0xffffffffu, idx, 0);
  }
}

// s = Q K^T for the warpgroup's 64 rows against the K tile at k_addr.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[HBN / 8][4], uint32_t q_addr,
                                         uint32_t k_addr) {
  hopper::fence_regs(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * SUB_BYTES + (kk & 3) * 32;
    hopper::wgmma_ss_m64n128(s, hopper::desc_sw128(q_addr + off, 0, 1024),
                             hopper::desc_sw128(k_addr + off, 0, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// o += P V, P in A fragments, the V tile at v_addr.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 8][4], const uint32_t (&pa)[HBN / 16][4],
                                         uint32_t v_addr) {
  hopper::fence_regs(o);
  hopper::wgmma_fence();
#pragma unroll
  for (int t = 0; t < HBN / 16; ++t) {
    const uint64_t db = hopper::desc_sw128(v_addr + t * 2048, SUB_BYTES, 1024);
    if constexpr (D == 128)
      hopper::wgmma_rs_m64n128_tb(o, pa[t], db);
    else
      hopper::wgmma_rs_m64n64_tb(o, pa[t], db);
  }
  hopper::wgmma_commit();
}

// Set the raw scores of pairs the masks rule out to -inf: the rule of
// allowed() in flash_common.cuh, as a kv range [lo, hi) a row plus the
// segment test, without a branch per element.
__device__ __forceinline__ void mask_tile(float (&s)[HBN / 8][4], const int (&rows)[2],
                                          const int (&segq)[2], const int* segk, int kv0,
                                          const Params& p) {
  const int gc = (threadIdx.x & 3) * 2;
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = rows[i];
    hi[i] = qi >= p.sq ? kv0 : min(p.skv, p.causal ? qi + 1 : p.skv);
    lo[i] = p.window > 0 ? qi - p.window + 1 : kv0;
  }
#pragma unroll
  for (int j = 0; j < HBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = kv0 + 8 * j + gc + (e & 1);
      if (kj < lo[e >> 1] || kj >= hi[e >> 1]) s[j][e] = -INFINITY;
    }
  if (p.seg_q != nullptr) {
#pragma unroll
    for (int j = 0; j < HBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (segk[8 * j + gc + (e & 1)] != segq[e >> 1]) s[j][e] = -INFINITY;
  }
}

// The online softmax of one score tile in place (s becomes p), in log2
// units (m is the running max of s * scale * log2(e)); alpha is the factor
// the output accumulated so far must take.  A row masked so far keeps m =
// NEG_INF (-1e30) and has only -inf scores, so its p are 0 (the Pallas
// guard) and its alpha 1.
__device__ __forceinline__ void softmax_tile(float (&s)[HBN / 8][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const int (&rows)[2], const int (&segq)[2],
                                             const int* segk, int qw, int kv0, float sl2,
                                             const Params& p) {
  if (!tile_full(qw, kv0, 64, HBN, p)) mask_tile(s, rows, segq, segk, kv0, p);
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int j = 0; j < HBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1][j & 1] = fmaxf(mx[e >> 1][j & 1], s[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(fmaxf(mx[i][0], mx[i][1])) * sl2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < HBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = ex2(fmaf(s[j][e], sl2, -m[e >> 1]));
      s[j][e] = pr;
      sum[e >> 1][j & 1] += pr;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(sum[i][0] + sum[i][1]);
}

template <int ND>
__device__ __forceinline__ void rescale(float (&o)[ND][4], const float (&alpha)[2]) {
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    o[nd][0] *= alpha[0];
    o[nd][1] *= alpha[0];
    o[nd][2] *= alpha[1];
    o[nd][3] *= alpha[1];
  }
}

template <int D>
__device__ __forceinline__ void consume(const HopperParams& hp, unsigned char* smem,
                                        const Bars& b, int c) {
  using L = Smem<D>;
  constexpr int ND = D / 8;
  const Params& p = hp.p;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int* segk_s = reinterpret_cast<const int*>(smem + L::SEG);
  const uint32_t q_addr = hopper::smem_u32(smem + L::Q) + c * 64 * 128;
  const uint32_t k_addr = hopper::smem_u32(smem + L::K);
  const uint32_t v_addr = hopper::smem_u32(smem + L::V);
  const float sl2 = p.scale * LOG2E;  // scores in log2 units: exp2 below
  float o[ND][4], s[HBN / 8][4];
  uint32_t pa[HBN / 16][4];

  // Turns: consumer c issues its products after bar.sync on BAR_TURN + c,
  // then lets the other go (bar.arrive on the other's barrier).  Consumer
  // 0 goes first; each barrier sees as many arrivals as syncs (consumer 0
  // takes the spare one at the end).
  const int my_turn = BAR_TURN + c, other_turn = BAR_TURN + (c ^ 1);
  if (c == 1) hopper::named_arrive(BAR_TURN, CONSUMERS);
  const int* slots = reinterpret_cast<const int*>(smem + L::SLOTS);
  uint32_t it = 0;  // kv tiles consumed so far: the ring's position
  for (int k = 0;; ++k) {
    hopper::mbar_wait(b.full_t + (k & 1), (k >> 1) & 1);
    const int idx = slots[k & 1];
    hopper::mbar_arrive(b.empty_t + (k & 1));
    Tile t;
    if (!decode_tile(idx, hp, t)) break;
    const int qw = t.qt * HBM + 64 * c;  // this warpgroup's first q row
    const int rows[2] = {qw + 16 * warp + (lane >> 2), qw + 16 * warp + (lane >> 2) + 8};
    int segq[2] = {0, 0};
    if (p.seg_q != nullptr)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rows[i] < p.sq) segq[i] = p.seg_q[(long long)t.bi * p.sq + rows[i]];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};

    hopper::mbar_wait(b.full_q, k & 1);
    if (t.lo < t.hi) {
      int st = it & 1;
      hopper::mbar_wait(b.full_k + st, (it >> 1) & 1);
      hopper::named_sync(my_turn, CONSUMERS);
      issue_qk<D>(s, q_addr, k_addr + st * L::TILE);
      hopper::named_arrive(other_turn, CONSUMERS);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      softmax_tile(s, m, l, alpha, rows, segq, segk_s + st * HBN, qw, t.lo * HBN, sl2, p);
      hopper::mbar_arrive(b.empty_k + st);  // read K and its segment ids
      to_a_frags<HBN / 8>(pa, s);
      for (int kt = t.lo + 1; kt < t.hi; ++kt) {
        const int prev = st;
        const uint32_t prev_parity = (it >> 1) & 1;
        ++it;
        st = it & 1;
        hopper::mbar_wait(b.full_k + st, (it >> 1) & 1);
        hopper::named_sync(my_turn, CONSUMERS);
        issue_qk<D>(s, q_addr, k_addr + st * L::TILE);
        rescale(o, alpha);
        hopper::mbar_wait(b.full_v + prev, prev_parity);
        issue_pv<D>(o, pa, v_addr + prev * L::TILE);
        hopper::named_arrive(other_turn, CONSUMERS);
        hopper::wgmma_wait<1>();  // Q K^T of this tile done, P V may run on
        hopper::fence_regs(s);
        softmax_tile(s, m, l, alpha, rows, segq, segk_s + st * HBN, qw, kt * HBN, sl2, p);
        hopper::mbar_arrive(b.empty_k + st);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::mbar_arrive(b.empty_v + prev);
        to_a_frags<HBN / 8>(pa, s);
      }
      hopper::mbar_arrive(b.empty_q);  // the producer may load the next tile's Q
      rescale(o, alpha);
      hopper::mbar_wait(b.full_v + st, (it >> 1) & 1);
      issue_pv<D>(o, pa, v_addr + st * L::TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(b.empty_v + st);
      ++it;
    } else {
      hopper::mbar_arrive(b.empty_q);
    }

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_safe = l[i] == 0.f ? 1.f : l[i];  // fully masked rows -> 0
      inv[i] = 1.f / l_safe;
      if ((lane & 3) == 0 && rows[i] < p.sq)
        p.lse_out[((long long)t.bi * p.n + t.h) * p.sq + rows[i]] =
            l[i] == 0.f ? m[i] : m[i] * LN2 + logf(l[i]);
    }
    store_frags<ND>(p.out, ((long long)t.bi * p.sq * p.n + t.h) * D, (long long)p.n * D, o,
                    rows, p.sq, inv, p.out_f32);
  }
  if (c == 0) hopper::named_sync(BAR_TURN, CONSUMERS);
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
    fwd_kernel_hopper(const __grid_constant__ HopperParams hp) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  const Bars b{bars, bars + 1, bars + 2, bars + 4, bars + 6, bars + 8, bars + 10, bars + 12};
  if (threadIdx.x == 0) {
    hopper::mbar_init(b.full_q, 1);
    hopper::mbar_init(b.empty_q, CONSUMERS);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(b.full_t + s, 1);
      hopper::mbar_init(b.empty_t + s, CONSUMERS);
      hopper::mbar_init(b.full_k + s, 1);
      hopper::mbar_init(b.full_v + s, 1);
      hopper::mbar_init(b.empty_k + s, CONSUMERS);
      hopper::mbar_init(b.empty_v + s, CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::regs_dec<24>();
    if (threadIdx.x < 32) produce<D>(hp, smem, b);
  } else {
    hopper::regs_inc<240>();
    consume<D>(hp, smem, b, threadIdx.x / 128 - 1);
  }
}

template <int D>
cudaError_t launch_hopper(const Params& p, const long long* geo, int* tile_counter,
                          cudaStream_t st) {
  HopperParams hp{};
  hp.p = p;
  hp.tile_counter = tile_counter;
  cudaError_t e = hopper::encode_rows_bf16(&hp.tm_q, p.q, geo, HBM);
  if (e == cudaSuccess) e = hopper::encode_rows_bf16(&hp.tm_k, p.k, geo + 7, HBN);
  if (e == cudaSuccess) e = hopper::encode_rows_bf16(&hp.tm_v, p.v, geo + 14, HBN);
  if (e != cudaSuccess) return e;
  // setmaxnreg moves registers inside what the block was launched with:
  // 24 + 2 x 240 for every 3 threads needs 168 a thread at launch, else
  // the consumers' setmaxnreg.inc would wait forever.
  static const int regs = [] {
    cudaFuncAttributes a{};
    return cudaFuncGetAttributes(&a, fwd_kernel_hopper<D>) == cudaSuccess ? a.numRegs : 0;
  }();
  if (regs < (24 + 2 * 240) / 3) {
    fprintf(stderr, "fwd_kernel_hopper<%d>: %d registers a thread, 168 needed\n", D, regs);
    return cudaErrorInvalidConfiguration;
  }
  constexpr int smem = Smem<D>::BYTES;
  static_assert(smem <= 232448, "shared memory");
  e = cudaFuncSetAttribute(fwd_kernel_hopper<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  // kv bytes a q head reads (its kv head's K and V, shared by the group)
  const long long kv_bytes = std::max(1ll, 4ll * p.skv * D / (p.n / p.nkv));
  hp.heads_group = (int)std::max(1ll, std::min<long long>(p.n, L2_GROUP_BYTES / kv_bytes));
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)p.b * p.n * ((p.sq + HBM - 1) / HBM);
  e = cudaMemsetAsync(tile_counter, 0, sizeof(int), st);
  if (e != cudaSuccess) return e;
  fwd_kernel_hopper<D><<<(unsigned)std::min<long long>(tiles, sms), HTHREADS, smem, st>>>(hp);
  return cudaGetLastError();
}

}  // namespace

// `geo`: the TMA geometry of q, k and v, 7 values each (dims d, heads, s,
// b and the byte strides of heads, s, b), from ops/kernels/__init__.py;
// `tile_counter`: one int of device memory (zeroed here, on the stream).
cudaError_t launch_fwd_hopper(const Params& p, const long long* geo, int* tile_counter, int d,
                              cudaStream_t st) {
  if (geo == nullptr || tile_counter == nullptr) return cudaErrorInvalidValue;
  if (d == 64) return launch_hopper<64>(p, geo, tile_counter, st);
  if (d == 128) return launch_hopper<128>(p, geo, tile_counter, st);
  return cudaErrorInvalidValue;
}

}  // namespace flash
