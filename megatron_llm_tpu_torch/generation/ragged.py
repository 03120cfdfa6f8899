"""The fused ragged engine tick (port of
``megatron_llm_tpu/generation/ragged.py``), plain and speculative.

A tick's work — the decode slots and the packed prefill-chunk rows —
runs as ONE row batch of single-token rows, each with its own
(token, position, block table, kv horizon): one forward, one attention
launch per layer.  Block tables arrive compressed: the tick's unique
tables are ``[null] + slot tables + prefill tables`` and each row names
its own; rows of one prefill request share one table.  Dead prefill rows
carry horizon 0, the null table and position 0: their writes land in the
null page and they attend to nothing.

Write-then-attend holds across the whole batch: every row's K/V lands
before any row attends, so a prefill row sees the K/V written by earlier
rows of its own chunk in the same tick.

The speculative tick (``spec_k = K > 0``) adds the draft model:

1. the packed prefill rows also run the draft forward into the draft
   pool (ragged kernel), so every prefilled page carries draft K/V;
2. the draft scan: ``K + 1`` one-token draft forwards, one table a row
   (the paged decode kernel).  Step ``j < K`` draws draft token
   ``d_{j+1}``; the last step only writes ``d_K``'s K/V, without which an
   all-accepted tick would leave a hole in the draft cache at ``d_K``'s
   position.  Rows past their own depth ``k_eff`` write and read through
   the null table, so a write at the sequence-budget edge never lands in
   the row's last live page;
3. one verify forward: the slots' ``K + 1`` positions flattened into
   ``b * (K + 1)`` rows at ``pos_i + j`` with slot ``i``'s table (rows
   past ``k_eff`` on the null table), then the prefill rows, in one
   ragged batch;
4. the acceptance rule (``speculative/verify.py``), and the emitted
   tokens' log-probs from the raw target logits.

The pools are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from megatron_llm_tpu_torch.generation import generation as gen
from megatron_llm_tpu_torch.generation.sampling import (
    draw_rows,
    filtered_logits_per_slot,
    sample_per_slot,
    stream_generator,
)
from megatron_llm_tpu_torch.generation.speculative.verify import (
    ACCEPT_STREAM,
    DRAFT_STREAM,
    EMIT_STREAM,
    speculative_acceptance,
)
from megatron_llm_tpu_torch.models.language_model import model_forward
from megatron_llm_tpu_torch.ops.paged_attention import PagedState


def row_horizons(positions: torch.Tensor) -> torch.Tensor:
    """Per-row kv horizon of LIVE rows: ``position + 1`` bucketed up to
    the BUCKET grid, so a row's bits depend only on (token, position)."""
    b = gen.BUCKET
    return ((positions // b) + 1) * b


def _with_prefill(tok, pos, idx, hor, tables, b, pre):
    """Append the packed prefill rows ``pre = (pre_tok, pre_pos,
    pre_tables, pre_index, pre_hor)`` (or nothing) to a row batch whose
    tables are ``[null] + b slot tables``."""
    if pre[0] is None:
        return tok, pos, idx, hor, tables
    pre_tok, pre_pos, pre_tables, pre_index, pre_hor = pre
    pre_idx = torch.where(pre_index >= 0, 1 + b + pre_index,
                          torch.zeros_like(pre_index))
    return (torch.cat([tok, pre_tok]), torch.cat([pos, pre_pos]),
            torch.cat([idx, pre_idx.to(torch.int32)]),
            torch.cat([hor, pre_hor]), torch.cat([tables, pre_tables]))


def _forward(cfg, params, pools, tok, pos, paged, rope_cache):
    logits, _ = model_forward(cfg, params, tok[:, None],
                              position_ids=pos[:, None], rope_cache=rope_cache,
                              kv_caches=pools, paged=paged)
    return logits[:, 0]


def make_ragged_tick_fn(cfg, *, rope_cache=None, draft_cfg=None, spec_k=0,
                        draft_rope_cache=None):
    """Build the ragged tick.  Signature, ``spec_k == 0``::

        (params, pool_k, pool_v, block_tables, positions, tokens,
         seeds, steps, temperature, top_k, top_p
         [, pre_tok, pre_pos, pre_tables, pre_index, pre_hor])
        -> (next_tok [b], logp [b])

    and ``spec_k == K > 0`` (a draft model present)::

        (params, draft_params, pool_k, pool_v, draft_k, draft_v,
         block_tables, positions, tokens, seeds, steps, temperature,
         top_k, top_p, k_eff [, pre_*])
        -> (emit [b, K+1], emit_logp [b, K+1], accepted [b], counts [b])

    ``block_tables`` ``[b, W]``, ``positions``/``tokens`` ``[b]`` (int32
    tensors on the engine's device) are the decode slots; ``seeds``,
    ``steps``, ``temperature``, ``top_k``, ``top_p`` and ``k_eff`` (each
    slot's speculation depth) are per-row values on the host.  The
    optional ``pre_*`` operands are the packed prefill rows:
    ``pre_tok``/``pre_pos``/``pre_hor`` ``[rows]``, ``pre_tables``
    ``[T_pre, W]`` (one per packed prefilling request) and ``pre_index``
    ``[rows]`` mapping each prefill row to its request's table (``-1`` =
    dead row).  The pools (plain tensors, or ``kv_quant.QuantPagedKV``
    containers of one-byte values and their scales) are updated in place.
    """
    vocab = cfg.model.vocab_size
    K = spec_k

    def tick(params, pool_k, pool_v, block_tables, positions, tokens,
             seeds, steps, temperature, top_k, top_p,
             pre_tok=None, pre_pos=None, pre_tables=None, pre_index=None,
             pre_hor=None):
        b = tokens.shape[0]
        dev = tokens.device
        null_tbl = torch.zeros((1, block_tables.shape[1]),
                               dtype=block_tables.dtype, device=dev)
        idx = 1 + torch.arange(b, dtype=torch.int32, device=dev)
        all_tok, all_pos, all_idx, all_hor, all_tbl = _with_prefill(
            tokens, positions, idx, row_horizons(positions),
            torch.cat([null_tbl, block_tables]), b,
            (pre_tok, pre_pos, pre_tables, pre_index, pre_hor))
        last = _forward(cfg, params, (pool_k, pool_v), all_tok, all_pos,
                        PagedState(all_tbl.contiguous(), all_pos.contiguous(),
                                   all_hor.to(torch.int32).contiguous(),
                                   all_idx.contiguous()), rope_cache)[:b]
        next_tok = sample_per_slot(
            last, seeds=seeds, steps=steps, top_k=top_k, top_p=top_p,
            temperature=temperature, vocab_size=vocab)
        return next_tok, gen._gather_token_log_probs(last, next_tok)

    def spec_tick(params, draft_params, pool_k, pool_v, draft_k, draft_v,
                  block_tables, positions, tokens, seeds, steps, temperature,
                  top_k, top_p, k_eff, pre_tok=None, pre_pos=None,
                  pre_tables=None, pre_index=None, pre_hor=None):
        b = tokens.shape[0]
        W = block_tables.shape[1]
        dev = tokens.device
        null_tbl = torch.zeros((1, W), dtype=block_tables.dtype, device=dev)
        sampled = np.flatnonzero(np.asarray(top_k) != 1).tolist()
        row_params = dict(
            top_k=torch.as_tensor(np.asarray(top_k), device=dev),
            top_p=torch.as_tensor(np.asarray(top_p), device=dev),
            temperature=torch.as_tensor(np.asarray(temperature), device=dev))
        k_eff_t = torch.as_tensor(np.asarray(k_eff), dtype=torch.int32,
                                  device=dev)

        # 1) draft prefill rows: every prefilled page carries draft K/V
        if pre_tok is not None:
            d_idx = torch.where(pre_index >= 0, 1 + pre_index,
                                torch.zeros_like(pre_index))
            _forward(draft_cfg, draft_params, (draft_k, draft_v), pre_tok,
                     pre_pos, PagedState(
                         torch.cat([null_tbl, pre_tables]).contiguous(),
                         pre_pos.contiguous(),
                         pre_hor.to(torch.int32).contiguous(),
                         d_idx.to(torch.int32).contiguous()),
                     draft_rope_cache)

        # 2) the draft scan: K + 1 one-token forwards; the last only writes
        # d_K's K/V.  Rows past their depth use the null table (and repeat
        # their last live position: they are discarded either way)
        tok = tokens
        draft_seq, q_seq = [], []
        for j in range(K + 1):
            live = j <= k_eff_t
            pos_j = positions + torch.clamp(k_eff_t, max=j)
            bt_j = torch.where(live[:, None], block_tables, null_tbl)
            logits = _forward(draft_cfg, draft_params, (draft_k, draft_v),
                              tok, pos_j, PagedState(bt_j.contiguous(),
                                                     pos_j.contiguous()),
                              draft_rope_cache)
            if j == K:
                break
            filt, greedy = filtered_logits_per_slot(logits, vocab_size=vocab,
                                                    **row_params)
            tok = draw_rows(filt, greedy, {
                i: stream_generator(seeds[i], steps[i], DRAFT_STREAM, j, dev)
                for i in sampled}).to(torch.int32)
            draft_seq.append(tok)
            q_seq.append(filt)
        draft_toks = torch.stack(draft_seq, dim=1)        # [b, K]
        q_filt = torch.stack(q_seq, dim=1)                # [b, K, v]

        # 3) one verify forward: row (slot i, offset j) feeds one token at
        # pos_i + j through slot i's table; rows past k_eff take the null
        # table; the prefill rows follow
        S = K + 1
        offs = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        live = (offs <= k_eff_t[:, None]).reshape(-1)
        flat_tok = torch.cat([tokens[:, None], draft_toks], dim=1).reshape(-1)
        flat_pos = (positions[:, None]
                    + torch.minimum(offs, k_eff_t[:, None])).reshape(-1)
        slot_ids = 1 + torch.arange(b, dtype=torch.int32,
                                    device=dev).repeat_interleave(S)
        flat_idx = torch.where(live, slot_ids, torch.zeros_like(slot_ids))
        all_tok, all_pos, all_idx, all_hor, all_tbl = _with_prefill(
            flat_tok, flat_pos, flat_idx, row_horizons(flat_pos),
            torch.cat([null_tbl, block_tables]), b,
            (pre_tok, pre_pos, pre_tables, pre_index, pre_hor))
        t_logits = _forward(
            cfg, params, (pool_k, pool_v), all_tok, all_pos,
            PagedState(all_tbl.contiguous(), all_pos.contiguous(),
                       all_hor.to(torch.int32).contiguous(),
                       all_idx.contiguous()), rope_cache)[:b * S]
        t_filt, t_greedy = filtered_logits_per_slot(
            t_logits, vocab_size=vocab,
            **{k: v.repeat_interleave(S) for k, v in row_params.items()})

        # 4) lossless acceptance; log-probs from the raw target logits
        u = torch.zeros((b, K), dtype=torch.float32, device=dev)
        for i in sampled:
            u[i] = torch.rand(K, generator=stream_generator(
                seeds[i], steps[i], ACCEPT_STREAM, 0, dev), device=dev)
        accepted, counts, emit = speculative_acceptance(
            draft_toks, q_filt, t_filt.reshape(b, S, -1),
            t_greedy.reshape(b, S),
            torch.as_tensor(np.asarray(top_k) == 1, device=dev), k_eff_t, u,
            {i: stream_generator(seeds[i], steps[i], EMIT_STREAM, 0, dev)
             for i in sampled})
        emit_logp = gen._gather_token_log_probs(t_logits.reshape(b, S, -1),
                                                emit)
        return emit, emit_logp, accepted, counts

    return spec_tick if K else tick
