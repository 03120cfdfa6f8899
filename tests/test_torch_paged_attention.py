"""The port's paged attention against the JAX package's.

The plain PyTorch versions of the three serving kernels (ragged tick,
speculative decode step, prefill chunk) are held against the JAX jnp
fallbacks and against the Pallas kernels run in interpret mode, on the
same numpy inputs: GQA group g in {1, 2, 4}, no window and a 9-token
sliding window, several block tables, rows that share a table, dead rows,
and decode rows at page boundaries.  Tolerance 2e-6 (float32,
the bar of the JAX package's own kernel-vs-fallback test).

Dead rows (horizon 0) are exact zeros in the Pallas kernel and the port;
the jnp fallback does not zero them, so it is compared on live rows only.
On CPU tensors the dispatch takes the plain version and no kernel launch
is counted.  The CUDA kernels are held against the plain versions on the
card in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops import paged_attention as jax_paged
from megatron_llm_tpu.ops.pallas.paged_attention import (
    paged_decode_kernel as pallas_decode,
    paged_prefill_kernel as pallas_prefill,
    paged_ragged_kernel as pallas_ragged,
)
from megatron_llm_tpu_torch.ops import kernels as pt_kernels
from megatron_llm_tpu_torch.ops import paged_attention as pt_paged

TOL = 2e-6
N_KV, D, PAGE, W = 2, 64, 8, 6


def _ragged_inputs(g, seed=0, n_dead=3):
    """Three tables over a 20-page pool; decode rows on their own tables,
    a 6-row prefill span sharing one table, and dead rows (null table,
    position 0, horizon 0)."""
    rng = np.random.default_rng(seed)
    n = N_KV * g
    P = 20
    kp = rng.normal(size=(P, PAGE, N_KV, D)).astype(np.float32)
    vp = rng.normal(size=(P, PAGE, N_KV, D)).astype(np.float32)
    tables = np.zeros((4, W), np.int32)          # table 0 = null
    tables[1] = [3, 7, 1, 12, 0, 0]
    tables[2] = [5, 2, 9, 4, 15, 11]
    tables[3] = [8, 6, 14, 0, 0, 0]
    idx = [1, 2, 3, 3, 3, 3, 3, 3, 2] + [0] * n_dead
    pos = [27, 45, 16, 17, 18, 19, 20, 21, 3] + [0] * n_dead
    hor = [((p // 64) + 1) * 64 for p in pos[:-n_dead]] + [0] * n_dead
    R = len(idx)
    q = rng.normal(size=(R, 1, n, D)).astype(np.float32)
    return (q, kp, vp, tables, np.asarray(idx, np.int32),
            np.asarray(pos, np.int32), np.asarray(hor, np.int32), n_dead)


def _prefill_inputs(g, seed=1):
    rng = np.random.default_rng(seed)
    n = N_KV * g
    P, s = 16, 11
    kp = rng.normal(size=(P, PAGE, N_KV, D)).astype(np.float32)
    vp = rng.normal(size=(P, PAGE, N_KV, D)).astype(np.float32)
    bt = np.asarray([[3, 9, 1, 14, 2], [6, 0, 0, 0, 0]], np.int32)
    bt[1] = [6, 11, 4, 0, 0]
    start = np.asarray([21, 5], np.int32)
    q = rng.normal(size=(2, s, n, D)).astype(np.float32)
    return q, kp, vp, bt, start


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_ragged_plain_matches_jax(g, window):
    q, kp, vp, tables, idx, pos, hor, n_dead = _ragged_inputs(g)
    scale = 1.0 / D ** 0.5
    pt_kernels.reset_launch_counts()
    ours = pt_paged.paged_attention_ragged(
        *_t(q, kp, vp, tables, idx, pos, hor), scale=scale,
        sliding_window=window).numpy()
    counts = pt_kernels.launch_counts()
    assert counts["paged_ragged_kernel"] == 0
    assert counts["paged_prefill_kernel"] == 0
    fallback = np.asarray(jax_paged.paged_attention_ragged(
        *_j(q, kp, vp, tables, idx, pos, hor), scale=scale,
        sliding_window=window, use_kernel=False))
    interp = np.asarray(pallas_ragged(
        *_j(q, kp, vp, tables, idx, pos, hor), scale=scale,
        sliding_window=window, interpret=True))
    live = slice(0, len(idx) - n_dead)
    np.testing.assert_allclose(ours[live], fallback[live], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ours, interp, atol=TOL, rtol=TOL)
    # dead rows: exact zeros, like the Pallas kernel
    assert (ours[-n_dead:] == 0).all() and (interp[-n_dead:] == 0).all()


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_prefill_plain_matches_jax(g, window):
    q, kp, vp, bt, start = _prefill_inputs(g)
    scale = 1.0 / D ** 0.5
    pt_kernels.reset_launch_counts()
    ours = pt_paged.paged_attention_prefill(
        *_t(q, kp, vp, bt, start), scale=scale,
        sliding_window=window).numpy()
    assert pt_kernels.paged_prefill_kernel.launches == 0
    fallback = np.asarray(jax_paged.paged_attention_prefill(
        *_j(q, kp, vp, bt, start), scale=scale, sliding_window=window,
        use_kernel=False))
    interp = np.asarray(pallas_prefill(
        *_j(q, kp, vp, bt, start), scale=scale, sliding_window=window,
        interpret=True))
    np.testing.assert_allclose(ours, fallback, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ours, interp, atol=TOL, rtol=TOL)


def test_prefill_rows_equal_ragged_rows_on_a_shared_table():
    """A prefill chunk's rows through the ragged tick (rows sharing one
    table) equal the same chunk through the prefill function."""
    q, kp, vp, bt, start = _prefill_inputs(2)
    b, s, n, d = q.shape
    rows_q = q[0].reshape(s, 1, n, d)
    tables = np.concatenate([np.zeros((1, bt.shape[1]), np.int32), bt[:1]])
    pos = start[0] + np.arange(s, dtype=np.int32)
    idx = np.ones((s,), np.int32)
    hor = ((pos // 64) + 1) * 64
    ragged = pt_paged.paged_attention_ragged(
        *_t(rows_q, kp, vp, tables, idx, pos, hor)).numpy()
    prefill = pt_paged.paged_attention_prefill(
        *_t(q[:1], kp, vp, bt[:1], start[:1])).numpy()
    np.testing.assert_allclose(ragged.reshape(1, s, n, d), prefill,
                               atol=TOL, rtol=TOL)


def test_horizon_bounds_the_page_walk():
    """A live row whose horizon stops short of its position attends only
    to the pages that start below the horizon, as the kernel walks."""
    q, kp, vp, tables, idx, pos, hor, _ = _ragged_inputs(1)
    hor = hor.copy()
    hor[1] = 16                       # row 1 at position 45: pages 0-1 only
    scale = 1.0 / D ** 0.5
    ours = pt_paged.paged_attention_ragged(
        *_t(q, kp, vp, tables, idx, pos, hor), scale=scale).numpy()
    interp = np.asarray(pallas_ragged(
        *_j(q, kp, vp, tables, idx, pos, hor), scale=scale, interpret=True))
    np.testing.assert_allclose(ours, interp, atol=TOL, rtol=TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers refuse CPU tensors (the dispatch never sends
    them there) — a refusal, not a silent plain fallback."""
    q, kp, vp, tables, idx, pos, hor, _ = _ragged_inputs(1)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.paged_ragged_kernel(
            *_t(q, kp, vp, tables, idx, pos, hor), scale=0.125)
    qp, kp2, vp2, bt, start = _prefill_inputs(1)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.paged_prefill_kernel(*_t(qp, kp2, vp2, bt, start),
                                        scale=0.125)



def _decode_inputs(g, seed=2):
    """Six rows, each on its own table over a 24-page pool: positions at
    page boundaries (7, 8, 15, 16), a long context and position 0."""
    rng = np.random.default_rng(seed)
    n = N_KV * g
    P = 24
    kp = rng.normal(size=(P, PAGE, N_KV, D)).astype(np.float32)
    vp = rng.normal(size=(P, PAGE, N_KV, D)).astype(np.float32)
    pos = np.asarray([7, 8, 15, 16, 45, 0], np.int32)
    bt = np.zeros((len(pos), W), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for i, p in enumerate(pos):
        npg = p // PAGE + 1
        bt[i, :npg] = perm[:npg]
        perm = np.roll(perm, -npg)
    q = rng.normal(size=(len(pos), 1, n, D)).astype(np.float32)
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_decode_plain_matches_jax(g, window):
    """K5's plain version against the Pallas ``_decode_kernel`` in
    interpret mode and the jnp fallback (MHA g 1, GQA 4/2 at g 2)."""
    q, kp, vp, bt, pos = _decode_inputs(g)
    scale = 1.0 / D ** 0.5
    pt_kernels.reset_launch_counts()
    ours = pt_paged.paged_attention_decode(
        *_t(q, kp, vp, bt, pos), scale=scale, sliding_window=window).numpy()
    assert pt_kernels.paged_decode_kernel.launches == 0
    fallback = np.asarray(jax_paged.paged_attention_decode(
        *_j(q, kp, vp, bt, pos), scale=scale, sliding_window=window,
        use_kernel=False))
    interp = np.asarray(pallas_decode(
        *_j(q, kp, vp, bt, pos), scale=scale, sliding_window=window,
        interpret=True))
    np.testing.assert_allclose(ours, fallback, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ours, interp, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [None, 9])
def test_decode_plain_equals_ragged_plain_on_the_same_rows(window):
    """A decode row is the ragged row with table index = its row and a
    horizon at or above position + 1."""
    q, kp, vp, bt, pos = _decode_inputs(2)
    idx = np.arange(len(pos), dtype=np.int32)
    hor = ((pos // 64) + 1) * 64
    dec = pt_paged.paged_attention_decode(
        *_t(q, kp, vp, bt, pos), sliding_window=window)
    rag = pt_paged.paged_attention_ragged(
        *_t(q, kp, vp, bt, idx, pos, hor), sliding_window=window)
    np.testing.assert_allclose(dec.numpy(), rag.numpy(), atol=TOL, rtol=TOL)


def test_decode_wrapper_refuses_cpu_tensors():
    q, kp, vp, bt, pos = _decode_inputs(1)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.paged_decode_kernel(*_t(q, kp, vp, bt, pos), scale=0.125)


# ---------------------------------------------------------------------------
# ticks shaped as the CUDA kernel's tile routine groups rows
# ---------------------------------------------------------------------------

from test_torch_kernels_cuda import RAGGED_LAYOUTS, ragged_layout  # noqa: E402


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("layout", RAGGED_LAYOUTS)
def test_ragged_layouts_plain_matches_pallas(layout, g, window):
    """The plain version against the Pallas ``_ragged_kernel`` in interpret
    mode on the layouts the CUDA kernel groups: a prefill run of > 64 / g
    rows on one table, K + 1 = 5 verify rows a slot with rows past k_eff on
    the null table, one table's rows split by another table's row, dead
    rows between live ones."""
    q, kp, vp, tables, idx, pos, hor, live = ragged_layout(layout, g, D, PAGE)
    scale = 1.0 / D ** 0.5
    ours = pt_paged.paged_attention_ragged(
        *_t(q, kp, vp, tables, idx, pos, hor), scale=scale,
        sliding_window=window).numpy()
    interp = np.asarray(pallas_ragged(
        *_j(q, kp, vp, tables, idx, pos, hor), scale=scale,
        sliding_window=window, interpret=True))
    np.testing.assert_allclose(ours, interp, atol=TOL, rtol=TOL)
    assert (ours[~live] == 0).all() and (interp[~live] == 0).all()


@pytest.mark.parametrize("layout", RAGGED_LAYOUTS)
def test_ragged_plain_rows_survive_permuting_and_splitting_the_tick(layout):
    """Each live row's plain output is bitwise the same when the tick's rows
    are permuted, and when the tick is split into two ticks of whole
    tables: a row's result depends on its own inputs, the per-row contract
    the CUDA kernel keeps too (on the card also for a row run alone; the
    plain version takes a table's rows as one batch, so there a row alone
    may round differently)."""
    q, kp, vp, tables, idx, pos, hor, live = ragged_layout(layout, 2, D, PAGE)
    args = _t(q, kp, vp, tables, idx, pos, hor)
    qt, kt, vt, tt, it, pt, ht = args

    def plain(rows):
        return pt_paged.paged_attention_ragged(
            qt[rows], kt, vt, tt, it[rows], pt[rows], ht[rows],
            sliding_window=9)

    R = len(idx)
    full = plain(torch.arange(R))
    perm = torch.randperm(R, generator=torch.Generator().manual_seed(7))
    permuted = plain(perm)[torch.argsort(perm)]
    tables_a = set(np.unique(idx)[::2].tolist())
    first = torch.tensor([r for r in range(R) if idx[r] in tables_a])
    second = torch.tensor([r for r in range(R) if idx[r] not in tables_a])
    split = torch.zeros_like(full)
    split[first], split[second] = plain(first), plain(second)
    for r in np.flatnonzero(live):
        assert torch.equal(permuted[r], full[r]), r
        assert torch.equal(split[r], full[r]), r


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_path_rule(dtype, d):
    """K4 / K5's device routine: the tensor-core tile routine for bf16 and
    fp16 at head_dim 64 and 128, attend_row for fp32 (TF32 keeps too few
    digits) and head_dim 256 (its accumulators do not fit)."""
    want = ("tile" if dtype != torch.float32 and d in (64, 128) else "rows")
    assert pt_kernels.paged_path(dtype, d) == want
    assert want in pt_kernels.PAGED_PATHS
