"""Paged KV-cache attention: the serving path's three attention functions
(port of ``megatron_llm_tpu/ops/paged_attention.py``).

The engine stores the KV cache as a pool of fixed-size pages
``[num_pages, page_size, n_kv_heads, head_dim]`` shared by all in-flight
sequences; each sequence owns an ordered list of page ids (its block
table).  Page 0 is the null page: never allocated, idle rows point at it,
writes routed there are never attended.

Each function has two implementations with the same contract:

* the CUDA kernels in ``ops/kernels`` (``csrc/paged_ragged.cu``,
  ``csrc/paged_decode.cu`` and ``csrc/paged_prefill.cu``): the ragged
  tick, the speculative draft's decode step and the prefill chunk; they
  walk the rows' pages straight out of the pool, so no ``[rows, context]``
  gather ever materializes.  In bf16 / fp16 at head_dim 64 and 128 the
  ragged and decode kernels run ``csrc/paged_tile.cuh``: adjacent rows on
  one table share their page loads and the products run on the tensor
  cores, and a row's output does not depend on the rows beside it
  (``ops/kernels/__init__.py:paged_path``);
* the plain PyTorch versions below: gather the block-tabled pages into a
  dense view and run :func:`ops.attention.xla_attention` in fp32 — the
  kernels' arithmetic (fp32 scores, softmax and accumulator, output cast
  to the query dtype).  The CPU tests use them, and ``chip_smoke.py``
  holds the kernels against them on the card.

Dispatch is keyed on the tensor's device: CPU tensors take the plain
version; CUDA tensors launch the kernel, which raises on a shape or type
it does not take.  ``use_kernel=False`` selects the plain version on the
card too: it exists for the on-card reference comparison only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from megatron_llm_tpu_torch.ops import attention as attn_ops


class PagedState(NamedTuple):
    """Per-call addressing state threaded through ``model_forward``.

    ``positions`` is the position of the FIRST token of each row's block
    (decode / ragged rows feed one token; a prefill chunk feeds ``s``
    tokens at ``positions[0] .. positions[0] + s - 1``).

    Ragged batches set ``horizons`` (each row's kv horizon in tokens,
    bucketed to 64-token multiples; 0 = dead padding row that touches no
    page) and ``table_index``: ``block_tables`` then holds the tick's
    UNIQUE tables ``[T, max_pages]`` and ``table_index`` maps each row to
    its table."""

    block_tables: torch.Tensor                  # [b or T, pages] int32
    positions: torch.Tensor                     # [b] int32
    horizons: Optional[torch.Tensor] = None     # [R] int32
    table_index: Optional[torch.Tensor] = None  # [R] int32


def paged_gather_kv(k_pool, v_pool, block_tables: torch.Tensor):
    """Dense ``[b, pages * page_size, nkv, d]`` view of each row's pages —
    the gather the kernels exist to avoid."""
    b = block_tables.shape[0]
    nkv, d = k_pool.shape[-2], k_pool.shape[-1]
    idx = block_tables.long()
    return (k_pool[idx].reshape(b, -1, nkv, d),
            v_pool[idx].reshape(b, -1, nkv, d))


def _bias(allowed: torch.Tensor) -> torch.Tensor:
    return torch.where(allowed, 0.0, attn_ops.NEG_INF).float()


def paged_attention_ragged(
    q: torch.Tensor,            # [R, 1, n_heads, d] — one query row each
    k_pool: torch.Tensor,       # [num_pages, page_size, n_kv_heads, d]
    v_pool: torch.Tensor,
    tables: torch.Tensor,       # [T, max_pages] int32 — UNIQUE tables
    table_index: torch.Tensor,  # [R] int32 — each row's table
    positions: torch.Tensor,    # [R] int32 — each row's own position
    horizons: torch.Tensor,     # [R] int32 — kv horizon (0 = dead row)
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """One ragged batch of paged attention; returns ``[R, 1, n, d]``.

    Row ``i`` attends through ``tables[table_index[i]]`` to the positions
    ``kv <= positions[i]`` (and inside the sliding window) of the pages
    that start below ``horizons[i]``.  A row that attends to nothing — a
    dead row, horizon 0 — returns exact zeros."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"ragged rows are [R, 1, n, d], got {tuple(q.shape)}")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if use_kernel and _kernel_ok(q):
        from megatron_llm_tpu_torch.ops.kernels import paged_ragged_kernel

        return paged_ragged_kernel(
            q, k_pool, v_pool, tables, table_index, positions, horizons,
            scale=scale, sliding_window=sliding_window)
    return paged_ragged_plain(q, k_pool, v_pool, tables, table_index,
                              positions, horizons, scale=scale,
                              sliding_window=sliding_window)


def paged_ragged_plain(q, k_pool, v_pool, tables, table_index, positions,
                       horizons, *, scale: float,
                       sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the ragged kernel: the rows of each unique table
    are one query block against that table's gathered pages (a 64-row
    prefill chunk gathers its pages once, not 64 times)."""
    R, _, n, d = q.shape
    page = k_pool.shape[1]
    out = torch.zeros_like(q)
    idx = table_index.long()
    for t in torch.unique(idx).tolist():
        rows = torch.nonzero(idx == t).flatten()
        k_all, v_all = paged_gather_kv(k_pool, v_pool, tables[t:t + 1])
        kv_pos = torch.arange(k_all.shape[1], device=q.device)[None, :]
        pos = positions[rows].long()[:, None]
        hor = horizons[rows].long()[:, None]
        # the kernel walks whole pages that start below the horizon
        allowed = (kv_pos <= pos) & ((kv_pos // page) * page < hor)
        if sliding_window is not None:
            allowed &= pos - kv_pos < sliding_window
        ctx = attn_ops.xla_attention(
            q[rows].reshape(1, -1, n, d).float(), k_all.float(),
            v_all.float(), bias=_bias(allowed)[None, None], scale=scale)
        live = allowed.any(dim=-1)[:, None, None]
        out[rows] = torch.where(live, ctx[0], 0.0).to(q.dtype)[:, None]
    return out


def paged_attention_decode(
    q: torch.Tensor,             # [b, 1, n_heads, d] at `positions`
    k_pool: torch.Tensor,        # [num_pages, page_size, n_kv_heads, d]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_pages] int32 — each row's table
    positions: torch.Tensor,     # [b] int32 — q's position; attends to <= it
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """One decode step of paged attention; returns ``[b, 1, n, d]``.

    Row ``i`` attends to the positions ``kv <= positions[i]`` (and inside
    the sliding window) of its own table ``block_tables[i]``; its own K/V
    are written before the call.  A row's output is what the ragged
    function gives the same row (table index = its row, a horizon that
    does not bind): bitwise on the card, where both kernels walk the pages
    with one device function."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode expects [b, 1, n, d], got {tuple(q.shape)}")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if use_kernel and _kernel_ok(q):
        from megatron_llm_tpu_torch.ops.kernels import paged_decode_kernel

        return paged_decode_kernel(
            q, k_pool, v_pool, block_tables, positions,
            scale=scale, sliding_window=sliding_window)
    return paged_decode_plain(q, k_pool, v_pool, block_tables, positions,
                              scale=scale, sliding_window=sliding_window)


def paged_decode_plain(q, k_pool, v_pool, block_tables, positions, *,
                       scale: float,
                       sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the decode kernel."""
    k_all, v_all = paged_gather_kv(k_pool, v_pool, block_tables)
    kv_pos = torch.arange(k_all.shape[1], device=q.device)[None, :]
    pos = positions.long()[:, None]
    allowed = kv_pos <= pos
    if sliding_window is not None:
        allowed &= pos - kv_pos < sliding_window
    return attn_ops.xla_attention(
        q.float(), k_all.float(), v_all.float(),
        bias=_bias(allowed)[:, None, None], scale=scale).to(q.dtype)


def paged_attention_prefill(
    q: torch.Tensor,             # [b, s, n_heads, d] — chunk queries
    k_pool: torch.Tensor,        # [num_pages, page_size, n_kv_heads, d]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [b, kv_pages] int32
    start: torch.Tensor,         # [b] int32 — position of q[:, 0]
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """One prefill CHUNK of paged attention; returns ``[b, s, n, d]``.

    Query row ``j`` of sequence ``i`` sits at ``start[i] + j`` and attends
    to the positions ``<=`` it (and inside the sliding window) of ``i``'s
    block table; the chunk's own K/V are written before the call."""
    if q.dim() != 4:
        raise ValueError(f"prefill expects [b, s, n, d], got {tuple(q.shape)}")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if use_kernel and _kernel_ok(q):
        from megatron_llm_tpu_torch.ops.kernels import paged_prefill_kernel

        return paged_prefill_kernel(
            q, k_pool, v_pool, block_tables, start,
            scale=scale, sliding_window=sliding_window)
    return paged_prefill_plain(q, k_pool, v_pool, block_tables, start,
                               scale=scale, sliding_window=sliding_window)


def paged_prefill_plain(q, k_pool, v_pool, block_tables, start, *,
                        scale: float,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the prefill kernel."""
    s = q.shape[1]
    k_all, v_all = paged_gather_kv(k_pool, v_pool, block_tables)
    q_pos = (start.long()[:, None, None]
             + torch.arange(s, device=q.device)[None, :, None])
    kv_pos = torch.arange(k_all.shape[1], device=q.device)[None, None, :]
    allowed = kv_pos <= q_pos
    if sliding_window is not None:
        allowed &= q_pos - kv_pos < sliding_window
    return attn_ops.xla_attention(
        q.float(), k_all.float(), v_all.float(),
        bias=_bias(allowed)[:, None], scale=scale).to(q.dtype)


def _kernel_ok(q: torch.Tensor) -> bool:
    """Dispatch predicate: the kernels run on CUDA tensors; their wrappers
    check shapes and types and raise on what they do not take."""
    return q.device.type == "cuda"
