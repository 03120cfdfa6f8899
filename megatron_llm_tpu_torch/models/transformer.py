"""The transformer stack (port of ``megatron_llm_tpu/models/transformer.py``):
the dense forward of training and the forward over a paged KV pool of
serving.

Parameters keep the JAX tree's layout so weights carry over leaf for leaf:
layer leaves stacked ``[L, ...]``, kernels ``[in, out]``, a group-major
fused QKV projection (for each kv head: its g query heads, then K, then
V), and the GLU ``fc1`` as ``[h, 2, ffn]``.  Layer schema (one layer)::

    {'input_norm': {'scale': [h], 'bias'?: [h]},
     'attention':  {'qkv':   {'kernel': [h, (n+2*nkv)*d], 'bias'?},
                    'dense': {'kernel': [n*d, h],          'bias'?}},
     'post_norm':  {...},   # absent when parallel_attn
     'mlp_norm':   {...},   # parallel_layernorm only
     'mlp':        {'fc1': {'kernel': [h, 2, ffn] or [h, ffn], 'bias'?},
                    'fc2': {'kernel': [ffn, h],                'bias'?}}}

The dense forward attends through ``ops.attention.attention`` (the
flash-attention kernels on CUDA) and checkpoints each layer by the remat
policy of ``cfg.training.remat_policy`` (:func:`_remat_policy`).  The
paged forward (the engine's ragged tick and its prefill chunk) updates
the pool in place: each layer writes its rows' K/V through the block
tables, then attends.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from megatron_llm_tpu_torch.ops.activations import (
    GLU_BASE_ACTIVATIONS,
    get_mlp_activation,
)
from megatron_llm_tpu_torch.ops import attention as attn_ops
from megatron_llm_tpu_torch.ops import kv_quant
from megatron_llm_tpu_torch.ops.norms import norm
from megatron_llm_tpu_torch.ops.paged_attention import (
    PagedState,
    paged_attention_decode,
    paged_attention_prefill,
    paged_attention_ragged,
)
from megatron_llm_tpu_torch.ops.rope import apply_rotary_emb
from megatron_llm_tpu_torch.utils import rng as rng_mod

Params = Dict[str, Any]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel (+ bias)`` in ``x``'s dtype (fp32 master weights are
    cast to the compute dtype here); a 3-D GLU kernel ``[h, 2, ffn]`` runs
    as one GEMM and the chunk axis is restored on the output."""
    kernel = p["kernel"].to(x.dtype)
    if kernel.dim() == 3:
        y = x @ kernel.reshape(kernel.shape[0], -1)
        y = y.reshape(*y.shape[:-1], *kernel.shape[1:])
    else:
        y = x @ kernel
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def split_qkv(qkv: torch.Tensor, n_heads: int, n_kv_heads: int,
              head_dim: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split group-major fused QKV ``[..., (n+2*nkv)*d]`` into q/k/v."""
    g = n_heads // n_kv_heads
    *lead, _ = qkv.shape
    grouped = qkv.reshape(*lead, n_kv_heads, g + 2, head_dim)
    q = grouped[..., :g, :].reshape(*lead, n_heads, head_dim)
    k = grouped[..., g, :]
    v = grouped[..., g + 1, :]
    return q, k, v


def _paged_attention(cfg, q, k, v, paged: PagedState, kv_cache):
    """Write this block's K/V into the pool through the block tables, then
    attend over the tables (the serving path).  The pools are plain
    tensors or quantized ``kv_quant.QuantPagedKV`` containers; the write
    goes through ``kv_quant.paged_write``, which keeps the plain pool's
    scatter byte for byte."""
    m = cfg.model
    s = q.shape[1]
    scale = 1.0 / (m.kv_channels ** 0.5)
    pk, pv = kv_cache
    page_size = kv_quant.page_size_of(pk)
    pos = paged.positions.long()
    row_tables = paged.block_tables
    if paged.table_index is not None:
        row_tables = row_tables[paged.table_index.long()]
    wpos = pos[:, None] + torch.arange(s, device=q.device)[None, :]
    # clip: a chunk's padding rows may run past the table; clipped lookups
    # resolve to null-page entries, whose writes are never attended
    page_slot = torch.clamp(wpos // page_size, 0, row_tables.shape[1] - 1)
    page_ids = torch.gather(row_tables.long(), 1, page_slot)
    offs = wpos % page_size
    kv_quant.paged_write(pk, page_ids, offs, k)
    kv_quant.paged_write(pv, page_ids, offs, v)
    use_kernel = cfg.training.use_flash_attn
    if s == 1 and paged.horizons is not None:
        return paged_attention_ragged(
            q, pk, pv, paged.block_tables, paged.table_index, paged.positions,
            paged.horizons, scale=scale, sliding_window=m.sliding_window_size,
            use_kernel=use_kernel)
    if s == 1:   # the speculative draft's decode step: one table a row
        return paged_attention_decode(
            q, pk, pv, paged.block_tables, paged.positions, scale=scale,
            sliding_window=m.sliding_window_size, use_kernel=use_kernel)
    return paged_attention_prefill(
        q, pk, pv, paged.block_tables, paged.positions, scale=scale,
        sliding_window=m.sliding_window_size, use_kernel=use_kernel)


def attention_sublayer(cfg, p: Params, x: torch.Tensor, rope, position_ids,
                       kv_cache=None, paged: Optional[PagedState] = None, *,
                       segment_ids: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True) -> torch.Tensor:
    """Self-attention: project, rotate, attend, project back.

    ``x`` is ``[b, s, h]`` (post input-norm).  With ``paged`` the block
    attends through the paged pool ``kv_cache`` (this layer's ``(k_pool,
    v_pool)``, each ``[num_pages, page_size, nkv, d]`` or a quantized
    ``kv_quant.QuantPagedKV``, written in place):
    ``s == 1`` with ``paged.horizons`` set is the ragged tick, ``s == 1``
    without it a decode step (one table a row: the speculative draft's
    scan), ``s > 1`` a prefill chunk at ``paged.positions``.  Without
    ``paged`` the block attends densely over its own sequence (causal
    unless the model is bidirectional, with the sliding window and
    ``segment_ids``), through the flash-attention kernels on CUDA."""
    m = cfg.model
    b, s, _ = x.shape
    n, nkv, d = m.num_attention_heads, m.num_attention_heads_kv, m.kv_channels
    q, k, v = split_qkv(linear(p["qkv"], x), n, nkv, d)
    if rope is not None:
        cos, sin = rope
        q = apply_rotary_emb(q, cos, sin, position_ids)
        k = apply_rotary_emb(k, cos, sin, position_ids)
    if paged is not None:
        ctx = _paged_attention(cfg, q, k, v, paged, kv_cache)
    elif kv_cache is not None:
        raise ValueError("the dense-cache decode path belongs to the "
                         "legacy-engine slice of the port")
    else:
        ctx = attn_ops.attention(
            q, k, v, causal=not m.bidirectional,
            sliding_window=m.sliding_window_size, segment_ids=segment_ids,
            scale=1.0 / (d ** 0.5), use_flash=cfg.training.use_flash_attn,
            dropout_rate=0.0 if deterministic else m.attention_dropout,
            generator=generator,
            context_parallel_size=cfg.parallel.context_parallel_size)
    return linear(p["dense"], ctx.reshape(b, s, n * d))


def mlp_sublayer(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """fc1 -> activation -> fc2; GLU gates as ``y[.., 0, :] * act(y[.., 1, :])``."""
    m = cfg.model
    if m.glu_activation is not None:
        act = GLU_BASE_ACTIVATIONS[m.glu_activation]
        y = linear(p["fc1"], x)
        return linear(p["fc2"], y[..., 0, :] * act(y[..., 1, :]))
    act = get_mlp_activation(None, m.activation)
    return linear(p["fc2"], act(linear(p["fc1"], x)))


def block_forward(cfg, p: Params, hidden: torch.Tensor, *, rope,
                  position_ids, kv_cache=None,
                  paged: Optional[PagedState] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  dropout_seed: Optional[int] = None,
                  deterministic: bool = True,
                  hidden_dropout_rate: Optional[float] = None) -> torch.Tensor:
    """One pre-LN layer; ``parallel_attn`` runs attention and MLP from the
    same normed input and sums both into the residual.

    Dropout (attention, then the two residual branches) draws from a
    ``torch.Generator`` seeded with ``dropout_seed`` inside the layer, so
    a checkpointed layer's recompute draws the same masks."""
    m = cfg.model
    eps = m.layernorm_epsilon
    rate = m.hidden_dropout if hidden_dropout_rate is None else hidden_dropout_rate
    if "moe" in p or "cross_attention" in p:
        raise ValueError("MoE and cross-attention layers belong to later "
                         "slices of the port (dense decoder layers only)")
    gen = None
    if dropout_seed is not None and not deterministic:
        gen = torch.Generator(device=hidden.device)
        gen.manual_seed(dropout_seed)

    def dropout(x):
        if gen is None:
            return x
        return rng_mod.dropout(x, rate, gen)

    ln1 = norm(hidden, p["input_norm"], eps, m.use_rms_norm)
    attn_out = attention_sublayer(cfg, p["attention"], ln1, rope,
                                  position_ids, kv_cache, paged,
                                  segment_ids=segment_ids, generator=gen,
                                  deterministic=gen is None)
    if m.parallel_attn:
        mlp_in = (norm(hidden, p["mlp_norm"], eps, m.use_rms_norm)
                  if m.parallel_layernorm else ln1)
        mlp_out = mlp_sublayer(cfg, p["mlp"], mlp_in)
        return hidden + dropout(attn_out) + dropout(mlp_out)
    resid = hidden + dropout(attn_out)
    ln2 = norm(resid, p["post_norm"], eps, m.use_rms_norm)
    return resid + dropout(mlp_sublayer(cfg, p["mlp"], ln2))


def _lima_rates(cfg, num_layers: int) -> torch.Tensor:
    """LIMA per-layer dropout ramp 0 -> hidden_dropout."""
    m = cfg.model
    if not m.lima_dropout or num_layers <= 1:
        return torch.full((num_layers,), m.hidden_dropout, dtype=torch.float32)
    return torch.linspace(0.0, m.hidden_dropout, num_layers)


# Outputs the selective policies keep for the backward: the matrix
# products (the JAX package's checkpoint_dots); everything else in a layer
# is recomputed, the flash-attention forward included.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_policy(name: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy
    name; ``None`` means plain checkpointing (nothing saved)."""
    if name in ("none", "full"):
        return None
    if name in ("save_dots_and_attn", "save_attn_only"):
        raise ValueError(
            f"remat_policy {name!r} (saving the named attention output) "
            "belongs to the remat-policy slice of the port; use "
            "'save_dots_except_logits', 'selective' or 'full'")
    # 'save_dots_except_logits', 'selective', 'dots_saveable' and unknown
    # names: save the dots, as the JAX package's default
    return functools.partial(create_selective_checkpoint_contexts, _save_dots)


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i`` of the stacked ``[L, ...]`` tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def transformer_forward(cfg, stacked_layers: Params, hidden: torch.Tensor, *,
                        rope, position_ids=None, kv_caches=None,
                        paged: Optional[PagedState] = None,
                        segment_ids: Optional[torch.Tensor] = None,
                        dropout_seed: Optional[int] = None,
                        deterministic: bool = True) -> torch.Tensor:
    """Run the stacked layers as a loop.

    Serving: ``kv_caches`` is the stacked ``(k_pool, v_pool)`` pair
    ``[L, num_pages, page_size, nkv, d]`` (plain tensors, or quantized
    containers whose layers :func:`kv_quant.layer` slices), updated in
    place.  Training
    (no cache): each layer runs under ``torch.utils.checkpoint`` when
    ``cfg.parallel.recompute_granularity`` is set and autograd records —
    ``"full"`` recomputes everything, otherwise ``cfg.training.remat_policy``
    picks what is saved (:func:`_remat_policy`)."""
    num_layers = stacked_layers["input_norm"]["scale"].shape[0]
    rates = _lima_rates(cfg, cfg.model.num_layers)
    granularity = cfg.parallel.recompute_granularity
    remat = (kv_caches is None and granularity is not None
             and torch.is_grad_enabled())
    context_fn = None
    if remat:
        context_fn = _remat_policy(
            "full" if granularity == "full" else cfg.training.remat_policy)
    for i in range(num_layers):
        layer_seed = (None if dropout_seed is None
                      else rng_mod.fold(dropout_seed, i))

        def one_layer(h, i=i, layer_seed=layer_seed):
            return block_forward(
                cfg, layer_params(stacked_layers, i), h, rope=rope,
                position_ids=position_ids,
                kv_cache=(None if kv_caches is None
                          else (kv_quant.layer(kv_caches[0], i),
                                kv_quant.layer(kv_caches[1], i))),
                paged=paged, segment_ids=segment_ids, dropout_seed=layer_seed,
                deterministic=deterministic,
                hidden_dropout_rate=float(rates[i]))

        if not remat:
            hidden = one_layer(hidden)
        elif context_fn is None:
            hidden = checkpoint(one_layer, hidden, use_reentrant=False)
        else:
            hidden = checkpoint(one_layer, hidden, use_reentrant=False,
                                context_fn=context_fn)
    return hidden
