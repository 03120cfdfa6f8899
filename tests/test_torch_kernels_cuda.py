"""The port's CUDA kernels against their plain PyTorch versions, on the
card: paged attention (K4 ragged, K5 decode, K6 prefill; K5 also bitwise
against K4 on the same rows; K4 on ticks shaped as its tile routine
groups rows, each row bitwise the same alone and in a permuted tick, the
path rule, a planted scale fault; K6 on chunks shaped as its tile
routine cuts them, bitwise across runs and alone or beside another
sequence at the same table width, a planted scale fault), flash attention (K1-K3, and the Hopper
kernels of K1 and of K2 / K3 at their tile edges, K2 / K3 also bitwise
across runs) and fused RMSNorm (K7 forward, K8 backward).

The kernels build and run only on an NVIDIA GPU with ``nvcc`` (there is
no interpret mode), so every test here is marked ``cuda`` and skips
without one; their CPU counterparts (the plain versions against the JAX
package) are in ``test_torch_paged_attention.py``.  This file imports
neither ``jax`` nor the JAX package, so it runs on a machine that has
only the port's dependencies::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from megatron_llm_tpu_torch.ops import kernels as pt_kernels
from megatron_llm_tpu_torch.ops import paged_attention as pt_paged
from megatron_llm_tpu_torch.tools.kernel_check import norm_rel
from megatron_llm_tpu_torch.tools.prefill_shapes import NORM_BAR, PLANTED

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels build and run "
                    "only on the card (chip_smoke.py runs them there)")

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
N_KV, PAGE, W = 2, 16, 8


def _ragged(g, d, dtype, seed=0, n_dead=3):
    """Three tables; decode rows on their own tables, a 6-row prefill
    span sharing one table, a row sharing a decode row's table, and dead
    rows (null table, position 0, horizon 0)."""
    rng = np.random.default_rng(seed)
    P = 24
    tables = np.zeros((4, W), np.int32)
    tables[1] = [3, 7, 1, 12, 0, 0, 0, 0]
    tables[2] = [5, 2, 9, 4, 15, 11, 20, 17]
    tables[3] = [8, 6, 14, 0, 0, 0, 0, 0]
    idx = [1, 2, 3, 3, 3, 3, 3, 3, 2] + [0] * n_dead
    pos = [57, 125, 32, 33, 34, 35, 36, 37, 3] + [0] * n_dead
    hor = [((p // 64) + 1) * 64 for p in pos[:-n_dead]] + [0] * n_dead
    arrs = dict(
        q=rng.normal(size=(len(idx), 1, N_KV * g, d)),
        k=rng.normal(size=(P, PAGE, N_KV, d)),
        v=rng.normal(size=(P, PAGE, N_KV, d)))
    dev = torch.device("cuda")
    f = {k: torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)
         for k, a in arrs.items()}
    i = {k: torch.tensor(a, dtype=torch.int32, device=dev)
         for k, a in dict(tables=tables, idx=idx, pos=pos, hor=hor).items()}
    return (f["q"], f["k"], f["v"], i["tables"], i["idx"], i["pos"],
            i["hor"]), n_dead


# Prefill chunks shaped as K6's tile routine cuts them (tiles of 64 / g
# chunk tokens x g heads; a table's walk in up to 4 segments): ``(b, s,
# starts)``.  ``prefill_layout`` builds them in numpy; the CPU tests hold
# the plain version to the JAX package on the same layouts.
PREFILL_LAYOUTS = {
    "base": (2, 21, (41, 5)),          # b 2, different starts
    "two-tiles": (1, 150, (30,)),      # s g over two tiles or more, ragged
    "at-zero": (2, 64, (0, 0)),        # chunks at position 0
    "long": (2, 40, (1100, 700)),      # contexts cut into segments
}


def prefill_layout(name, g, d, page, *, n_kv=2, seed=1):
    """``(q, k_pool, v_pool, block_tables, start)`` in numpy (fp32 / int32)
    for layout ``name`` at GQA group g: each sequence on its own pages of
    a pool, tables a page wider than the furthest chunk's end."""
    b, s, starts = PREFILL_LAYOUTS[name]
    rng = np.random.default_rng(seed)
    W = -(-(max(starts) + s) // page) + 1
    P = b * W + 1
    bt = rng.permutation(np.arange(1, P))[:b * W].reshape(b, W)
    q = rng.normal(size=(b, s, n_kv * g, d)).astype(np.float32)
    k = rng.normal(size=(P, page, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(P, page, n_kv, d)).astype(np.float32)
    return q, k, v, bt.astype(np.int32), np.asarray(starts, np.int32)


def _prefill(layout, g, d, dtype):
    q, k, v, bt, start = prefill_layout(layout, g, d, PAGE)
    dev = torch.device("cuda")
    return (*(torch.tensor(a, device=dev).to(dtype) for a in (q, k, v)),
            torch.tensor(bt, device=dev), torch.tensor(start, device=dev))


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_matches_plain(dtype, g, d, window):
    args, n_dead = _ragged(g, d, dtype)
    pt_kernels.reset_launch_counts()
    ker = pt_paged.paged_attention_ragged(*args, sliding_window=window)
    assert pt_kernels.paged_ragged_kernel.launches == 1
    ref = pt_paged.paged_attention_ragged(*args, sliding_window=window,
                                          use_kernel=False)
    assert pt_kernels.paged_ragged_kernel.launches == 1
    tol = TOL[dtype]
    torch.testing.assert_close(ker.float(), ref.float(), atol=tol, rtol=tol)
    assert (ker[-n_dead:] == 0).all()


@pytest.mark.parametrize("window", [None, 9, 100])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("layout", list(PREFILL_LAYOUTS))
def test_prefill_kernel_matches_plain(layout, dtype, g, d, window):
    """K6 against its plain version: the tile routine for bf16 / fp16 at
    head_dim 64 / 128 (a window of 100 crosses its 64-token stages),
    attend_row for fp32 and head_dim 256, as ``last_path`` says."""
    args = _prefill(layout, g, d, dtype)
    pt_kernels.reset_launch_counts()
    ker = pt_paged.paged_attention_prefill(*args, sliding_window=window)
    assert pt_kernels.paged_prefill_kernel.launches == 1
    assert pt_kernels.paged_prefill_kernel.last_path == (
        "tile" if dtype != torch.float32 and d in (64, 128) else "rows")
    ref = pt_paged.paged_attention_prefill(*args, sliding_window=window,
                                           use_kernel=False)
    tol = TOL[dtype]
    torch.testing.assert_close(ker.float(), ref.float(), atol=tol, rtol=tol)
    if dtype != torch.float32:
        assert norm_rel(ker, ref) <= NORM_BAR


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["two-tiles", "long"])
def test_prefill_planted_scale_fails_the_check(layout, dtype, g):
    """K6's tile routine run with its softmax scale 10% off must fail the
    norm bar that holds it to its plain version at the right scale: on a
    chunk over several tiles, and on contexts whose walk is folded across
    the 4 segments of a cluster ("long")."""
    q, k, v, bt, start = args = _prefill(layout, g, 128, dtype)
    if layout == "long":
        plan = pt_kernels.prefill_tile_plan(
            q.shape[1], q.shape[2], N_KV, bt.shape[1], PAGE,
            torch.cuda.get_device_properties(0).multi_processor_count)
        assert plan.segs == pt_kernels.PREFILL_MAX_SEGS
    scale = 1.0 / 128 ** 0.5
    ker = pt_paged.paged_attention_prefill(*args, scale=PLANTED * scale)
    assert pt_kernels.paged_prefill_kernel.last_path == "tile"
    ref = pt_paged.paged_attention_prefill(*args, scale=scale,
                                           use_kernel=False)
    assert norm_rel(ker, ref) > NORM_BAR


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["base", "long"])
def test_prefill_tile_is_bitwise_stable(layout, dtype, g, d):
    """K6's tile routine folds its segments in a fixed order without
    atomics: two launches on the same inputs are ``torch.equal``, and each
    sequence's output is ``torch.equal`` run alone and beside another at
    the same table width (the segments are cut from the width)."""
    q, k, v, bt, start = _prefill(layout, g, d, dtype)
    first = pt_paged.paged_attention_prefill(q, k, v, bt, start,
                                             sliding_window=100)
    again = pt_paged.paged_attention_prefill(q, k, v, bt, start,
                                             sliding_window=100)
    assert pt_kernels.paged_prefill_kernel.last_path == "tile"
    assert torch.equal(first, again)
    for i in range(q.shape[0]):
        alone = pt_paged.paged_attention_prefill(
            q[i:i + 1].contiguous(), k, v, bt[i:i + 1].contiguous(),
            start[i:i + 1].contiguous(), sliding_window=100)
        assert torch.equal(alone[0], first[i]), i


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    args, _ = _ragged(1, 64, torch.float32)
    q, k, v, tables, idx, pos, hor = args
    with pytest.raises(ValueError, match="head_dim"):
        pt_kernels.paged_ragged_kernel(q[..., :32].contiguous(),
                                       k[..., :32].contiguous(),
                                       v[..., :32].contiguous(), tables, idx,
                                       pos, hor, scale=0.1)
    with pytest.raises(ValueError, match="int32"):
        pt_kernels.paged_ragged_kernel(q, k, v, tables.long(), idx, pos, hor,
                                       scale=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        pt_kernels.paged_ragged_kernel(
            q, k.transpose(1, 2).contiguous().transpose(1, 2), v, tables, idx,
            pos, hor, scale=0.1)
    with pytest.raises(ValueError, match="dtype"):
        pt_kernels.paged_ragged_kernel(q.double(), k.double(), v.double(),
                                       tables, idx, pos, hor, scale=0.1)


# ---------------------------------------------------------------------------
# K4's tile routine (csrc/paged_tile.cuh): ticks shaped as it groups rows
# ---------------------------------------------------------------------------

# Ragged ticks whose rows the tile routine groups (adjacent rows on one
# table, cut at multiples of 16 / g rows); each is a list of
# (table, position) rows, table 0 the null table, position None a dead row
# (horizon 0).  ``ragged_layout`` builds them in numpy; the CPU tests hold
# the plain version to the Pallas kernel on the same layouts.
def _layout_rows(name, g):
    if name == "prefill-two-tiles":   # > 64 / g rows of one prefill chunk
        return ([(1, 30)] + [(2, 5 + i) for i in range(64 // g + 3)]
                + [(0, None)] * 2)
    if name == "verify":   # K + 1 = 5 rows a slot; slot 3 past k_eff = 2
        return ([(1, 40 + j) for j in range(5)]
                + [(2, 20 + j) for j in range(5)]
                + [(3, 60 + j) for j in range(3)] + [(0, 63), (0, 64)]
                + [(4, j) for j in range(6)] + [(0, None)] * 2)
    if name == "split":   # one table's rows split by another table's row
        return ([(1, 10 + i) for i in range(6)] + [(2, 50)]
                + [(1, 16 + i) for i in range(6)] + [(0, None)])
    if name == "dead-between":   # dead rows between live ones
        return [(1, 7), (0, None), (2, 33), (0, None), (1, 8), (0, None),
                (3, 12), (3, 13), (0, None)]
    if name == "long":   # contexts across the tile routine's segments
        return ([(1, 630), (2, 509), (2, 510), (2, 511), (2, 512), (2, 513),
                 (3, 100), (0, None)] + [(4, 600 + i) for i in range(18)])
    raise ValueError(name)


RAGGED_LAYOUTS = ("prefill-two-tiles", "verify", "split", "dead-between",
                  "long")


def ragged_layout(name, g, d, page, *, n_kv=2, seed=5):
    """``(q, k_pool, v_pool, tables, table_index, positions, horizons,
    live)`` in numpy (fp32 / int32) for layout ``name`` at GQA group g:
    tables of 12 pages (80 for ``long``) over a pool of 48 (96)."""
    rng = np.random.default_rng(seed)
    W, n_pages = (80, 96) if name == "long" else (12, 48)
    rows = _layout_rows(name, g)
    tables = np.zeros((5, W), np.int32)
    for t in range(1, 5):
        tables[t] = rng.permutation(np.arange(1, n_pages))[:W]
    idx = np.asarray([t for t, _ in rows], np.int32)
    pos = np.asarray([0 if p is None else p for _, p in rows], np.int32)
    live = np.asarray([p is not None for _, p in rows])
    hor = np.where(live, (pos // 64 + 1) * 64, 0).astype(np.int32)
    q = rng.normal(size=(len(rows), 1, n_kv * g, d)).astype(np.float32)
    k = rng.normal(size=(n_pages, page, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, page, n_kv, d)).astype(np.float32)
    return q, k, v, tables, idx, pos, hor, live


def _on_card(arrays, dtype):
    q, k, v, tables, idx, pos, hor, live = arrays
    dev = torch.device("cuda")
    f = [torch.tensor(a, device=dev).to(dtype) for a in (q, k, v)]
    i = [torch.tensor(a, device=dev) for a in (tables, idx, pos, hor)]
    return (*f, *i), torch.tensor(live, device=dev)


TOL[torch.float16] = 1e-2


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("g", [1, 3, 4, 32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("layout", RAGGED_LAYOUTS)
def test_ragged_layouts_match_plain(layout, dtype, d, g, window):
    """K4 against its plain version on ticks shaped as the tile routine
    groups them (g 3: tiles of 5 rows; g 32: one row, heads in two passes
    of 16); dead rows exact zeros."""
    args, live = _on_card(ragged_layout(layout, g, d, PAGE), dtype)
    pt_kernels.reset_launch_counts()
    ker = pt_paged.paged_attention_ragged(*args, sliding_window=window)
    ref = pt_paged.paged_attention_ragged(*args, sliding_window=window,
                                          use_kernel=False)
    assert pt_kernels.paged_ragged_kernel.launches == 1
    tol = TOL[dtype]
    torch.testing.assert_close(ker.float(), ref.float(), atol=tol, rtol=tol)
    assert (ker[~live] == 0).all()


@pytest.mark.parametrize("g", [1, 3, 4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("layout", RAGGED_LAYOUTS)
def test_ragged_rows_do_not_depend_on_their_tile(layout, dtype, g):
    """Each row's K4 output is bitwise the same in the full tick, alone,
    and in a permuted tick (which regroups the rows into other tiles)."""
    args, live = _on_card(ragged_layout(layout, g, 128, PAGE), dtype)
    q, k, v, tables, idx, pos, hor = args

    def k4(rows):
        return pt_paged.paged_attention_ragged(
            q[rows].contiguous(), k, v, tables, idx[rows].contiguous(),
            pos[rows].contiguous(), hor[rows].contiguous(), sliding_window=9)

    R = q.shape[0]
    full = k4(torch.arange(R, device=q.device))
    perm = torch.randperm(R, generator=torch.Generator().manual_seed(g))
    perm = perm.to(q.device)
    assert torch.equal(k4(perm)[torch.argsort(perm)], full)
    for r in range(R):
        assert torch.equal(k4(torch.tensor([r], device=q.device))[0],
                           full[r]), r


@pytest.mark.parametrize("g", [1, 4, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_segments_fold_the_same_in_a_block_or_across_blocks(
        dtype, g, monkeypatch):
    """The tile routine's planner spreads a long tile's 512-token segments
    over blocks through its workspace, or (no workspace) walks them in one
    block: each row's output is bitwise the same either way, for K4 and for
    K5 on the same rows."""
    args, _ = _on_card(ragged_layout("long", g, 128, PAGE), dtype)
    q, k, v, tables, idx, pos, hor = args
    assert pt_kernels.paged_segments(tables.shape[1], PAGE)[1] > 1
    spread = pt_kernels.paged_ragged_kernel(*args, scale=0.1)
    dec_spread = pt_kernels.paged_decode_kernel(q[:1], k, v, tables[1:2],
                                                pos[:1], scale=0.1)
    monkeypatch.setattr(pt_kernels, "PAGED_WS_CAP", 0)
    one_block = pt_kernels.paged_ragged_kernel(*args, scale=0.1)
    dec_one = pt_kernels.paged_decode_kernel(q[:1], k, v, tables[1:2],
                                             pos[:1], scale=0.1)
    assert torch.equal(spread, one_block)
    assert torch.equal(dec_spread, dec_one)
    assert torch.equal(dec_one[0], one_block[0])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_kernels_record_the_path_the_rule_picks(dtype, d):
    """K4 and K5 run the tile routine for bf16 / fp16 at head_dim 64 / 128
    and attend_row for fp32 and head_dim 256, and say so in ``last_path``."""
    want = ("tile" if dtype != torch.float32 and d in (64, 128) else "rows")
    assert pt_kernels.paged_path(dtype, d) == want
    args, _ = _on_card(ragged_layout("verify", 4, d, PAGE), dtype)
    q, k, v, tables, idx, pos, hor = args
    pt_kernels.paged_ragged_kernel(q, k, v, tables, idx, pos, hor, scale=0.1)
    pt_kernels.paged_decode_kernel(q[:5], k, v, tables[:5], pos[:5],
                                   scale=0.1)
    assert (pt_kernels.paged_ragged_kernel.last_path,
            pt_kernels.paged_decode_kernel.last_path) == (want, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_planted_scale_fails_the_check(dtype):
    """K4 run with its softmax scale 10% off must fail the bar that holds
    it to its plain version at the right scale."""
    args, _ = _on_card(ragged_layout("verify", 1, 128, PAGE), dtype)
    scale = 1.0 / 128 ** 0.5
    ker = pt_kernels.paged_ragged_kernel(*args, scale=1.1 * scale)
    ref = pt_paged.paged_attention_ragged(*args, scale=scale,
                                          use_kernel=False)
    tol = TOL[dtype]
    assert not torch.allclose(ker.float(), ref.float(), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# paged decode: K5
# ---------------------------------------------------------------------------


def _decode(n, nkv, d, dtype, seed=3):
    """Six rows, each on its own table: page boundaries (15, 16, 63, 64),
    a long context and position 0."""
    rng = np.random.default_rng(seed)
    P, Wd = 40, 10
    pos = np.asarray([15, 16, 63, 64, 150, 0], np.int32)
    tables = np.zeros((len(pos), Wd), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for i, p in enumerate(pos):
        npg = p // PAGE + 1
        tables[i, :npg] = perm[:npg]
        perm = np.roll(perm, -npg)
    dev = torch.device("cuda")
    q, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev).to(dtype)
               for shape in ((len(pos), 1, n, d), (P, PAGE, nkv, d),
                             (P, PAGE, nkv, d)))
    return (q, k, v, torch.tensor(tables, device=dev),
            torch.tensor(pos, device=dev))


DECODE_SHAPES = {"mha": (4, 4, 128), "gqa-4/2": (4, 2, 128),
                 "tinyllama-32/4": (32, 4, 64), "d256": (8, 2, 256)}


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_decode_kernel_matches_plain_and_ragged_bitwise(dtype, shape, window):
    n, nkv, d = DECODE_SHAPES[shape]
    q, k, v, tables, pos = _decode(n, nkv, d, dtype)
    pt_kernels.reset_launch_counts()
    ker = pt_paged.paged_attention_decode(q, k, v, tables, pos,
                                          sliding_window=window)
    ref = pt_paged.paged_attention_decode(q, k, v, tables, pos,
                                          sliding_window=window,
                                          use_kernel=False)
    # the same rows through the ragged kernel: table index = the row, a
    # horizon on the 64-token grid above the position
    b = pos.shape[0]
    idx = torch.arange(b, dtype=torch.int32, device=pos.device)
    ragged = pt_paged.paged_attention_ragged(
        q, k, v, tables, idx, pos, (pos // 64 + 1) * 64,
        sliding_window=window)
    torch.cuda.synchronize()
    assert pt_kernels.paged_decode_kernel.launches == 1
    tol = TOL[dtype]
    torch.testing.assert_close(ker.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(ker, ragged)


def test_decode_wrapper_raises_on_what_the_kernel_does_not_take():
    q, k, v, tables, pos = _decode(4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        pt_kernels.paged_decode_kernel(q[..., :32].contiguous(),
                                       k[..., :32].contiguous(),
                                       v[..., :32].contiguous(), tables, pos,
                                       scale=0.1)
    with pytest.raises(ValueError, match="int32"):
        pt_kernels.paged_decode_kernel(q, k, v, tables, pos.long(), scale=0.1)
    with pytest.raises(ValueError, match="block_tables"):
        pt_kernels.paged_decode_kernel(q, k, v, tables[:2], pos, scale=0.1)
    with pytest.raises(ValueError, match=r"\[b, 1, n, d\]"):
        pt_kernels.paged_decode_kernel(q.reshape(2, 3, 4, 64), k, v, tables,
                                       pos, scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.paged_decode_kernel(q.cpu(), k.cpu(), v.cpu(),
                                       tables.cpu(), pos.cpu(), scale=0.1)


# ---------------------------------------------------------------------------
# flash attention: K1 (forward), K2 (dq), K3 (dk / dv)
# ---------------------------------------------------------------------------

from megatron_llm_tpu_torch.ops import flash_attention as pt_flash  # noqa: E402

# fp32: summation order only (out / lse 1e-5; gradients 1e-4, longer sums);
# bf16: the kernels round P and dS to bf16 before their products and every
# output to bf16, the plain versions only the outputs (2e-2).
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
FLASH_VARIANTS = {
    "causal": dict(causal=True, window=None, segments=False),
    "window": dict(causal=True, window=100, segments=False),
    "segments": dict(causal=True, window=None, segments=True),
    "bidirectional": dict(causal=False, window=None, segments=False),
}


def _flash_inputs(g, d, dtype, s=300, seed=2):
    """b 2, s 300 (a ragged last tile), 2 kv heads with g query heads
    each; k and v are strided views into one fused tensor, as split_qkv
    makes them."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    n = 2 * g
    f = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=dev).to(dtype)
    q = f(rng.normal(size=(2, s, n, d)))
    kv = f(rng.normal(size=(2, s, 2, 2, d)))
    do = f(rng.normal(size=(2, s, n, d)))
    seg = torch.zeros((2, s), dtype=torch.int32, device=dev)
    seg[0, 120:] = 1
    seg[1, 37:] = 1
    seg[1, 250:] = 2
    return q, kv[:, :, :, 0], kv[:, :, :, 1], do, seg


@pytest.mark.parametrize("variant", list(FLASH_VARIANTS))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(dtype, g, d, variant):
    spec = FLASH_VARIANTS[variant]
    q, k, v, do, seg = _flash_inputs(g, d, dtype)
    seg = seg if spec["segments"] else None
    kw = dict(scale=1.0 / d ** 0.5, causal=spec["causal"],
              sliding_window=spec["window"])
    pt_kernels.reset_launch_counts()
    out, lse = pt_kernels.flash_fwd_kernel(q, k, v, seg, **kw)
    delta = pt_flash.flash_delta(out, do)
    dq = pt_kernels.flash_bwd_dq_kernel(q, k, v, do, lse, delta, seg, **kw)
    dk, dv = pt_kernels.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, seg, **kw)
    torch.cuda.synchronize()
    assert pt_kernels.launch_counts() == {
        "paged_ragged_kernel": 0, "paged_decode_kernel": 0,
        "paged_prefill_kernel": 0, "flash_fwd_kernel": 1, "flash_bwd_dq_kernel": 1,
        "flash_bwd_dkv_kernel": 1, "rms_norm_fwd_kernel": 0,
        "rms_norm_bwd_kernel": 0}
    r_out, r_lse = pt_flash.flash_fwd_plain(q, k, v, seg, seg, **kw)
    r_dq = pt_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, seg, seg, **kw)
    r_dk, r_dv = pt_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, seg,
                                              seg, **kw)
    fwd_tol, grad_tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), r_out.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    torch.testing.assert_close(lse, r_lse, atol=fwd_tol, rtol=fwd_tol)
    for name, ker, ref in (("dq", dq, r_dq), ("dk", dk, r_dk),
                           ("dv", dv, r_dv)):
        assert ker.dtype == dtype and ker.shape == ref.shape, name
        torch.testing.assert_close(ker.float(), ref.float(), atol=grad_tol,
                                   rtol=grad_tol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_launches_the_kernels(dtype):
    """``flash_attention`` on CUDA tensors: K1 in the forward, K2 and K3 in
    the backward, and the same gradients as the plain versions."""
    q, k, v, do, _ = _flash_inputs(4, 128, dtype, s=256)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    pt_kernels.reset_launch_counts()
    out = pt_flash.flash_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    counts = pt_kernels.launch_counts()
    assert (counts["flash_fwd_kernel"], counts["flash_bwd_dq_kernel"],
            counts["flash_bwd_dkv_kernel"]) == (1, 1, 1)
    scale = 1.0 / 128 ** 0.5
    r_out, lse = pt_flash.flash_fwd_plain(q, k, v, scale=scale)
    delta = pt_flash.flash_delta(r_out, do)
    refs = (pt_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale=scale),
            *pt_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                          scale=scale))
    _, grad_tol = FLASH_TOL[dtype]
    for t, ref in zip(leaves, refs):
        torch.testing.assert_close(t.grad.float(), ref.float(), atol=grad_tol,
                                   rtol=grad_tol)


def test_flash_wrappers_raise_on_what_the_kernels_do_not_take():
    q, k, v, do, seg = _flash_inputs(1, 64, torch.float32, s=128)
    kw = dict(scale=0.125)
    with pytest.raises(ValueError, match="head_dim"):
        pt_kernels.flash_fwd_kernel(q[..., :32].contiguous(),
                                    k[..., :32].contiguous(),
                                    v[..., :32].contiguous(), **kw)
    with pytest.raises(ValueError, match="dtype"):
        pt_kernels.flash_fwd_kernel(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="int32"):
        pt_kernels.flash_fwd_kernel(q, k, v, seg.long(), **kw)
    with pytest.raises(ValueError, match="last dimension"):
        pt_kernels.flash_fwd_kernel(
            q, k.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2), v, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.flash_fwd_kernel(q.cpu(), k.cpu(), v.cpu(), **kw)
    out, lse = pt_kernels.flash_fwd_kernel(q, k, v, **kw)
    with pytest.raises(ValueError, match="lse"):
        pt_kernels.flash_bwd_dq_kernel(q, k, v, do, lse.double(), lse, **kw)
    with pytest.raises(ValueError, match="out_dtype"):
        pt_kernels.flash_bwd_dkv_kernel(q, k, v, do, lse, lse,
                                        out_dtype=torch.bfloat16, **kw)


# K1's Hopper kernel (csrc/flash_fwd_hopper.cu: bf16 at head_dim 64 / 128)
# at the edges of its 128-row q and kv tiles, GQA groups 1 / 4 / 8 and every
# mask; bf16 and fp32 outputs, contiguous inputs and q / k / v sliced from one
# fused [b, s, n + 2 nkv, d] buffer (as the model's qkv leaves them).  Bars as
# chip_smoke.py holds the bf16 kernels: out within 1e-2 norm-relative error and
# atol = rtol = 2e-2 elementwise (P rounded to bf16 before P V, bf16 output),
# lse within 1e-5 (fp32 scores).
HOPPER_SEQS = [1, 63, 64, 65, 127, 128, 129, 300, 1000]
HOPPER_MASKS = {
    "causal": dict(causal=True, window=None, segments=False),
    "noncausal": dict(causal=False, window=None, segments=False),
    "window100": dict(causal=True, window=100, segments=False),
    "segments": dict(causal=True, window=None, segments=True),
}


def _hopper_inputs(s, g, d, fused, seed):
    """b 2, 2 kv heads with g query heads each; two or three documents per
    row for the segment mask."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    b, nkv = 2, 2
    n = g * nkv
    f = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=dev).to(torch.bfloat16)
    if fused:
        qkv = f(rng.normal(size=(b, s, n + 2 * nkv, d)))
        q, k, v = qkv[:, :, :n], qkv[:, :, n:n + nkv], qkv[:, :, n + nkv:]
    else:
        q, k, v = (f(rng.normal(size=(b, s, h, d))) for h in (n, nkv, nkv))
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    seg[0, s // 3:] = 1
    seg[0, (2 * s) // 3:] = 2
    seg[1, s // 2:] = 1
    return q, k, v, seg


@pytest.mark.parametrize("mask", list(HOPPER_MASKS))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("s", HOPPER_SEQS)
def test_flash_fwd_hopper_matches_plain(s, g, d, mask):
    spec = HOPPER_MASKS[mask]
    kw = dict(scale=1.0 / d ** 0.5, causal=spec["causal"],
              sliding_window=spec["window"])
    for fused in (False, True):
        q, k, v, seg = _hopper_inputs(s, g, d, fused, seed=s + 10 * g + d)
        seg = seg if spec["segments"] else None
        if fused:
            assert not q.is_contiguous() and not k.is_contiguous()
        for out_dtype in (None, torch.float32):
            pt_kernels.reset_launch_counts()
            out, lse = pt_kernels.flash_fwd_kernel(q, k, v, seg,
                                                   out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            assert pt_kernels.launch_counts()["flash_fwd_kernel"] == 1
            assert pt_kernels.flash_fwd_kernel.last_path == "hopper"
            r_out, r_lse = pt_flash.flash_fwd_plain(q, k, v, seg, seg,
                                                    out_dtype=out_dtype, **kw)
            assert out.dtype == (out_dtype or torch.bfloat16)
            assert out.shape == r_out.shape and lse.shape == r_lse.shape
            err = (out.float() - r_out.float())
            where = f"fused={fused} out={out.dtype}"
            assert torch.isfinite(out).all(), where
            assert float(err.norm() / r_out.float().norm()) <= 1e-2, where
            torch.testing.assert_close(out.float(), r_out.float(), atol=2e-2,
                                       rtol=2e-2, msg=where)
            torch.testing.assert_close(lse, r_lse, atol=1e-5, rtol=0.0,
                                       msg=where)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64),
                                     (torch.float32, 128)])
def test_flash_fwd_launches_the_path_the_rule_picks(dtype, d):
    """bf16 at head_dim 64 / 128 runs the Hopper kernel, everything else the
    shared-memory kernel; the counter moves once either way."""
    q, k, v, _ = _hopper_inputs(200, 4, d, False, seed=7)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    pt_kernels.reset_launch_counts()
    pt_kernels.flash_fwd_kernel.last_path = None
    out, lse = pt_kernels.flash_fwd_kernel(q, k, v, scale=1.0 / d ** 0.5)
    torch.cuda.synchronize()
    assert pt_kernels.launch_counts()["flash_fwd_kernel"] == 1
    want = "hopper" if dtype == torch.bfloat16 and d in (64, 128) else "smem"
    assert pt_kernels.flash_fwd_kernel.last_path == want
    assert pt_kernels.flash_path(dtype, d) == want
    r_out, r_lse = pt_flash.flash_fwd_plain(q, k, v, scale=1.0 / d ** 0.5)
    fwd_tol, _ = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), r_out.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    torch.testing.assert_close(lse, r_lse, atol=1e-5, rtol=0.0)


# K2 / K3's Hopper kernels (csrc/flash_bwd_hopper.cu: bf16 at head_dim 64 /
# 128) over the same matrix as K1's: seq 1-1000 around their 128-row
# stationary and 64-row walked tiles, GQA 1 / 4 / 8, d 64 / 128, every mask,
# bf16 and fp32 outputs, contiguous and fused-qkv inputs.  Both versions get
# the plain forward's lse and delta, so a forward difference does not reach
# the check.  Bars as chip_smoke.py's kernels phase holds the bf16 backward:
# each gradient within 1e-2 norm-relative error of the fp32 plain version
# and atol = rtol = 2e-2 elementwise (P and dS rounded to bf16 before their
# products, bf16 outputs).  The norm-relative bar has a floor of 1e-4 RMS
# (eighty times under bf16's step at 1): at seq 1 under the causal mask a
# row's one probability is 1, so dp = delta, ds = 0 in exact arithmetic, and
# both versions return dq and dk of rounding noise (~1e-7).


def _bwd_hopper_case(s, g, d, mask, fused, seed):
    spec = HOPPER_MASKS[mask]
    kw = dict(scale=1.0 / d ** 0.5, causal=spec["causal"],
              sliding_window=spec["window"])
    q, k, v, seg = _hopper_inputs(s, g, d, fused, seed)
    seg = seg if spec["segments"] else None
    rng = np.random.default_rng(seed + 1)
    do = torch.tensor(rng.normal(size=tuple(q.shape)), dtype=torch.float32,
                      device=q.device).to(torch.bfloat16)
    out, lse = pt_flash.flash_fwd_plain(q, k, v, seg, seg, **kw)
    delta = pt_flash.flash_delta(out, do)
    return (q, k, v, do, lse, delta, seg), kw


def _bwd_hopper_run(args, kw, out_dtype=None):
    q, k, v, do, lse, delta, seg = args
    dq = pt_kernels.flash_bwd_dq_kernel(q, k, v, do, lse, delta, seg,
                                        out_dtype=out_dtype, **kw)
    dk, dv = pt_kernels.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, seg,
                                             out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    return dq, dk, dv


@pytest.mark.parametrize("mask", list(HOPPER_MASKS))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("s", HOPPER_SEQS)
def test_flash_bwd_hopper_matches_plain(s, g, d, mask):
    for fused in (False, True):
        args, kw = _bwd_hopper_case(s, g, d, mask, fused, seed=s + 10 * g + d)
        q, k, v, do, lse, delta, seg = args
        for out_dtype in (None, torch.float32):
            pt_kernels.reset_launch_counts()
            got = _bwd_hopper_run(args, kw, out_dtype)
            counts = pt_kernels.launch_counts()
            assert counts["flash_bwd_dq_kernel"] == 1
            assert counts["flash_bwd_dkv_kernel"] == 1
            assert pt_kernels.flash_bwd_dq_kernel.last_path == "hopper"
            assert pt_kernels.flash_bwd_dkv_kernel.last_path == "hopper"
            ref_kw = dict(kw, out_dtype=out_dtype)
            refs = (pt_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, seg,
                                                seg, **ref_kw),
                    *pt_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  seg, seg, **ref_kw))
            for name, ker, ref in zip(("dq", "dk", "dv"), got, refs):
                where = f"{name} fused={fused} out={ker.dtype}"
                assert ker.dtype == (out_dtype or torch.bfloat16), where
                assert ker.shape == ref.shape, where
                assert torch.isfinite(ker).all(), where
                err = ker.float() - ref.float()
                floor = 1e-4 * ref.numel() ** 0.5
                assert float(err.norm()) <= 1e-2 * float(ref.float().norm()) \
                    + floor, where
                torch.testing.assert_close(ker.float(), ref.float(),
                                           atol=2e-2, rtol=2e-2, msg=where)


@pytest.mark.parametrize("mask", ["causal", "segments"])
def test_flash_bwd_hopper_is_deterministic(mask):
    """No atomics: two runs on the same inputs give the same bits."""
    args, kw = _bwd_hopper_case(1000, 4, 128, mask, True, seed=11)
    first = _bwd_hopper_run(args, kw)
    second = _bwd_hopper_run(args, kw)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_bwd_hopper_reads_do_as_a_transposed_view():
    """``do`` as the transposed view of a packed ``[b, n, s, d]`` gradient
    (what autograd hands the backward when the caller moved heads first):
    TMA reads it in place, and the gradients are the same bits as from a
    packed copy."""
    args, kw = _bwd_hopper_case(300, 4, 128, "causal", False, seed=5)
    q, k, v, do, lse, delta, seg = args
    view = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous() and pt_kernels.flash_rows_aligned(view)
    packed = _bwd_hopper_run(args, kw)
    viewed = _bwd_hopper_run((q, k, v, view, lse, delta, seg), kw)
    for name, a, b in zip(("dq", "dk", "dv"), packed, viewed):
        assert torch.equal(a, b), name


def test_flash_bwd_hopper_reads_a_broadcast_do():
    """``do`` broadcast over batch and sequence (stride 0 there, rows still
    16-byte aligned): TMA reads it in place, and the gradients are the same
    bits as from a packed copy."""
    args, kw = _bwd_hopper_case(300, 2, 128, "causal", False, seed=6)
    q, k, v, do, lse, delta, seg = args
    bcast = do[:1, :1].expand(do.shape)
    assert bcast.stride()[:2] == (0, 0) and pt_kernels.flash_rows_aligned(bcast)
    packed = _bwd_hopper_run((q, k, v, bcast.contiguous(), lse, delta, seg), kw)
    viewed = _bwd_hopper_run((q, k, v, bcast, lse, delta, seg), kw)
    for name, a, b in zip(("dq", "dk", "dv"), packed, viewed):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64),
                                     (torch.float32, 128)])
def test_flash_bwd_launches_the_path_the_rule_picks(dtype, d):
    """bf16 at head_dim 64 / 128 runs the Hopper kernels, everything else the
    shared-memory kernels; each counter moves once either way."""
    q, k, v, _ = _hopper_inputs(200, 4, d, False, seed=7)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    do = torch.randn(q.shape, device=q.device, dtype=torch.float32,
                     generator=torch.Generator(device=q.device).manual_seed(3)
                     ).to(dtype)
    kw = dict(scale=1.0 / d ** 0.5)
    out, lse = pt_flash.flash_fwd_plain(q, k, v, **kw)
    delta = pt_flash.flash_delta(out, do)
    pt_kernels.reset_launch_counts()
    pt_kernels.flash_bwd_dq_kernel.last_path = None
    pt_kernels.flash_bwd_dkv_kernel.last_path = None
    got = _bwd_hopper_run((q, k, v, do, lse, delta, None), kw)
    counts = pt_kernels.launch_counts()
    assert counts["flash_bwd_dq_kernel"] == counts["flash_bwd_dkv_kernel"] == 1
    want = "hopper" if dtype == torch.bfloat16 and d in (64, 128) else "smem"
    assert pt_kernels.flash_path(dtype, d) == want
    assert pt_kernels.flash_bwd_dq_kernel.last_path == want
    assert pt_kernels.flash_bwd_dkv_kernel.last_path == want
    refs = (pt_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
            *pt_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    _, grad_tol = FLASH_TOL[dtype]
    for ker, ref in zip(got, refs):
        torch.testing.assert_close(ker.float(), ref.float(), atol=grad_tol,
                                   rtol=grad_tol)



# ---------------------------------------------------------------------------
# fused RMSNorm: K7 (forward), K8 (backward)
# ---------------------------------------------------------------------------

from megatron_llm_tpu_torch.ops import rmsnorm as pt_rms  # noqa: E402
from megatron_llm_tpu_torch.tools import kernel_check as kc  # noqa: E402

# x type, w type: fp32 / fp32, bf16 or fp16 with an fp32 weight (the
# kernel-check tool's mix) and with a weight of their own type
RMS_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32),
             (torch.float16, torch.float16)]
# (rows, h): the vector path at h 2048 / 4096 (4099 rows: K8's chunks do
# not divide them), the scalar path at h 4100 (rows not 16-byte aligned),
# the widest row, and narrow ones
RMS_SHAPES = [(300, 2048), (4099, 4096), (777, 4100), (9, 16384), (5, 64),
              (3, 1)]


def _rms_inputs(rows, h, x_dtype, w_dtype, seed=4):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    x = torch.tensor(rng.normal(size=(rows, h)), dtype=torch.float32,
                     device=dev).to(x_dtype)
    w = torch.tensor(rng.normal(size=h) * 0.1 + 1.0, dtype=torch.float32,
                     device=dev).to(w_dtype)
    g = torch.tensor(rng.normal(size=(rows, h)), dtype=torch.float32,
                     device=dev).to(x_dtype)
    return x, w, g


@pytest.mark.parametrize("shape", RMS_SHAPES,
                         ids=[f"{r}x{h}" for r, h in RMS_SHAPES])
@pytest.mark.parametrize("types", RMS_TYPES,
                         ids=[f"{str(a)[6:]}-{str(b)[6:]}" for a, b in RMS_TYPES])
def test_rmsnorm_kernels_match_plain(types, shape):
    """K7 and K8 against the plain versions under the kernel-check tool's
    bars (fp32 y / dx 1e-5, dw 1e-5 norm-relative; bf16 / fp16 one step of
    the type), and dw bitwise the same on a second run."""
    x, w, g = _rms_inputs(*shape, *types)
    pt_kernels.reset_launch_counts()
    y = pt_kernels.rms_norm_fwd_kernel(x, w, 1e-6)
    dx, dw = pt_kernels.rms_norm_bwd_kernel(x, w, g, 1e-6)
    dx2, dw2 = pt_kernels.rms_norm_bwd_kernel(x, w, g, 1e-6)
    torch.cuda.synchronize()
    assert (pt_kernels.rms_norm_fwd_kernel.launches,
            pt_kernels.rms_norm_bwd_kernel.launches) == (1, 2)
    assert (y.dtype, dx.dtype, dw.dtype) == (types[0], types[0], types[1])
    r_y = pt_rms.rms_norm_fwd_plain(x, w, 1e-6)
    r_dx, r_dw = pt_rms.rms_norm_bwd_plain(x, w, g, 1e-6)
    for name, ok_err in (("y", kc.rms_close(y, r_y)),
                         ("dx", kc.rms_close(dx, r_dx)),
                         ("dw", kc.rms_dw_close(dw, r_dw))):
        assert ok_err[0], f"{name}: max abs err {ok_err[1]}"
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)


def test_rmsnorm_planted_eps_fails_the_check():
    """K7 / K8 with eps 0.2 (r about 10% off at unit-variance x) against
    the plain versions at eps 1e-6 must fail the bf16 check."""
    x, w, g = _rms_inputs(512, 4096, torch.bfloat16, torch.float32)
    y = pt_kernels.rms_norm_fwd_kernel(x, w, 0.2)
    dx, dw = pt_kernels.rms_norm_bwd_kernel(x, w, g, 0.2)
    assert not kc.rms_close(y, pt_rms.rms_norm_fwd_plain(x, w, 1e-6))[0]
    r_dx, r_dw = pt_rms.rms_norm_bwd_plain(x, w, g, 1e-6)
    assert not kc.rms_close(dx, r_dx)[0]
    assert not kc.rms_dw_close(dw, r_dw)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rms_norm_launches_the_kernels(dtype):
    """``fused_rms_norm`` on CUDA tensors of any leading shape: K7 in the
    forward, K8 in the backward (from a non-contiguous upstream gradient),
    the plain versions' results."""
    x, w, g = _rms_inputs(6 * 50, 512, dtype, torch.float32)
    x, g = x.reshape(6, 50, 512), g.reshape(6, 50, 512)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    pt_kernels.reset_launch_counts()
    y = pt_rms.fused_rms_norm(xl, wl)
    (y.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    counts = pt_kernels.launch_counts()
    assert (counts["rms_norm_fwd_kernel"],
            counts["rms_norm_bwd_kernel"]) == (1, 1)
    r_dx, r_dw = pt_rms.rms_norm_bwd_plain(x, w, g, 1e-6)
    assert kc.rms_close(y.detach(), pt_rms.rms_norm_fwd_plain(x, w, 1e-6))[0]
    assert kc.rms_close(xl.grad, r_dx)[0]
    assert kc.rms_dw_close(wl.grad, r_dw)[0]


def test_rmsnorm_wrappers_raise_on_what_the_kernels_do_not_take():
    x, w, g = _rms_inputs(8, 256, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.rms_norm_fwd_kernel(x.cpu(), w.cpu(), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        pt_kernels.rms_norm_fwd_kernel(x.t().contiguous().t(), w, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        pt_kernels.rms_norm_bwd_kernel(x, w, g.t().contiguous().t(), 1e-6)
    wide = torch.ones((2, 16392), device=x.device)
    with pytest.raises(ValueError, match="16384"):
        pt_kernels.rms_norm_fwd_kernel(wide, wide[0].contiguous(), 1e-6)
    with pytest.raises(ValueError, match="w dtype"):
        pt_kernels.rms_norm_fwd_kernel(x.bfloat16(), w.half(), 1e-6)
    with pytest.raises(ValueError, match="must match x"):
        pt_kernels.rms_norm_bwd_kernel(x, w, g.bfloat16(), 1e-6)
    with pytest.raises(ValueError, match="aligned"):
        pt_kernels.rms_norm_fwd_kernel(x.flatten()[1:1 + 8 * 255].view(8, 255),
                                       w[:255].contiguous(), 1e-6)
    with pytest.raises(ValueError, match="w on cpu"):
        pt_rms.fused_rms_norm(x, w.cpu())   # no silent move, no fallback
