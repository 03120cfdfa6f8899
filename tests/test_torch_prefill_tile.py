"""K6's tile routine, the parts a CPU can check.

The CUDA kernel (``csrc/paged_prefill_tile.cuh``) runs only on the card
(``test_torch_kernels_cuda.py``).  Here: the plain prefill version, which
the card's tests hold the kernel to, against the JAX package's jnp
fallback and its Pallas ``_prefill_kernel`` in interpret mode on the
chunk layouts the tile routine cuts differently (more than 64 / g rows,
GQA g 8, chunks at position 0, a window), tolerance 2e-6 (float32, the
bar of the JAX package's own kernel-vs-fallback test); and the wrapper's
sizing of a launch, which is Python: the tile shape a chunk is cut by,
and how tables are cut into segments, from shapes alone.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops import paged_attention as jax_paged
from megatron_llm_tpu.ops.pallas.paged_attention import (
    paged_prefill_kernel as pallas_prefill,
)
from megatron_llm_tpu_torch.ops import kernels as pt_kernels
from megatron_llm_tpu_torch.ops import paged_attention as pt_paged
from test_torch_kernels_cuda import prefill_layout

TOL = 2e-6
D, PAGE = 64, 8


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("layout, g", [
    ("two-tiles", 1), ("two-tiles", 2), ("two-tiles", 8),
    ("at-zero", 1), ("at-zero", 2), ("at-zero", 8), ("base", 8)])
def test_prefill_plain_matches_jax_on_tile_layouts(layout, g, window):
    q, kp, vp, bt, start = prefill_layout(layout, g, D, PAGE)
    scale = 1.0 / D ** 0.5
    pt_kernels.reset_launch_counts()
    ours = pt_paged.paged_attention_prefill(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, start)), scale=scale,
        sliding_window=window).numpy()
    assert pt_kernels.paged_prefill_kernel.launches == 0
    j = [jnp.asarray(a) for a in (q, kp, vp, bt, start)]
    fallback = np.asarray(jax_paged.paged_attention_prefill(
        *j, scale=scale, sliding_window=window, use_kernel=False))
    interp = np.asarray(pallas_prefill(*j, scale=scale,
                                       sliding_window=window, interpret=True))
    np.testing.assert_allclose(ours, fallback, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ours, interp, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 32, 64, 96])
@pytest.mark.parametrize("s", [1, 21, 64, 150])
def test_prefill_tiles_cover_each_pair_once(g, s):
    """Tiles of 64 (row, head) pairs of one kv head, in the Pallas kernel's
    kv-head-major order (64 / g chunk tokens x the group's heads; g > 64:
    one token, heads in passes of 64), cover every (token, head) pair of a
    chunk exactly once: the shape the segments are sized from."""
    nkv, b = 2, 3
    heads, passes, tokens = pt_kernels.prefill_tile_shape(g)
    assert heads * tokens <= pt_kernels.PREFILL_PAIRS
    seen = np.zeros((b, s, nkv * g), np.int64)
    tiles = 0
    for bi in range(b):
        for h in range(nkv):
            for x in range(passes):
                for t in range(-(-s // tokens)):
                    hp0 = x * heads
                    gp = min(heads, g - hp0)
                    for mr in range(min(tokens, s - t * tokens) * gp):
                        seen[bi, t * tokens + mr // gp,
                             h * g + hp0 + mr % gp] += 1
                    tiles += 1
    assert (seen == 1).all()
    assert tiles == b * nkv * passes * -(-s // tokens)


@pytest.mark.parametrize("W, page", [(1, 16), (4, 16), (36, 16), (252, 16),
                                     (64, 8), (1000, 16)])
@pytest.mark.parametrize("s, n, nkv", [(64, 32, 32), (64, 32, 8),
                                       (64, 32, 4), (21, 8, 2)])
def test_prefill_segments_cover_the_table(s, n, nkv, W, page):
    """A table's stages are cut into at most ``PREFILL_MAX_SEGS`` segments
    of ``seg_stages`` 64-token stages, none empty."""
    stages = -(-(W * page) // pt_kernels.PAGED_SPAN)
    plan = pt_kernels.prefill_tile_plan(s, n, nkv, W, page, sms=132)
    assert 1 <= plan.segs <= pt_kernels.PREFILL_MAX_SEGS
    assert (plan.segs - 1) * plan.seg_stages < stages <= (
        plan.segs * plan.seg_stages)


def test_prefill_plan_at_the_serving_shapes():
    """The sizing at the smoke test's K6 shapes on a 132-SM H100: the mixed
    tick's 64-row chunk at 512 (Llama-2-7B: 32 tiles over 9 stages), the
    serve burst's first chunk (one stage: no segments), a chunk at the end
    of a 4096-token context, GQA 32/8 and the TinyLlama draft's 32/4."""
    plan = pt_kernels.prefill_tile_plan
    assert plan(64, 32, 32, 36, 16, 132) == (3, 3)
    assert plan(64, 32, 32, 4, 16, 132) == (1, 1)
    assert plan(64, 32, 32, 16, 16, 132) == (1, 4)
    assert plan(64, 32, 32, 252, 16, 132) == (16, 4)
    assert plan(64, 32, 8, 64, 16, 132) == (4, 4)
    assert plan(64, 32, 4, 36, 16, 132) == (3, 3)


def test_prefill_sizing_never_reads_start():
    """The launch is sized from shapes alone: the plan takes no positions
    and no batch size (a sequence's cuts do not depend on the others of
    the launch), and the wrapper reads nothing of ``start`` on the host (no
    sync)."""
    params = inspect.signature(pt_kernels.prefill_tile_plan).parameters
    assert "start" not in params and "b" not in params
    src = inspect.getsource(pt_kernels.paged_prefill_kernel)
    for read in ("start.item", "start.tolist", "start.cpu", "start.numpy",
                 "int(start", "max(start", "start.max"):
        assert read not in src


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_prefill_path_rule(dtype, d):
    """K6 takes the tile routine for bf16 / fp16 at head_dim 64 / 128 and
    attend_row for fp32 and head_dim 256 (the rule K4 / K5 follow); a CPU
    tensor never reaches the wrapper, which refuses it."""
    want = "tile" if dtype != torch.float32 and d in (64, 128) else "rows"
    assert pt_kernels.paged_path(dtype, d) == want
    q, kp, vp, bt, start = prefill_layout("base", 1, d, PAGE)
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.paged_prefill_kernel(
            *(torch.from_numpy(a).to(dtype) for a in (q, kp, vp)),
            torch.from_numpy(bt), torch.from_numpy(start), scale=0.1)
