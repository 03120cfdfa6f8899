"""Flash attention, forward and backward (port of
``megatron_llm_tpu/ops/pallas/flash_attention.py``).

:func:`flash_attention` takes ``[b, s, heads, d]`` tensors like the JAX
function of that name and runs a ``torch.autograd.Function`` that saves
``q, k, v, out, lse`` and recomputes the probabilities in the backward
(the flash-2 residual scheme).  On CUDA tensors the Function launches the
hand-written kernels (``ops/kernels/csrc/flash_fwd_hopper.cu`` /
``flash_fwd.cu`` K1, ``flash_bwd_hopper.cu`` / ``flash_bwd.cu`` K2 + K3, as
``kernels.flash_path`` picks) or raises; on CPU tensors it runs the plain
versions below, which compute the same function densely in fp32 with the
same masks, the same ``-1e30`` sentinel, zeros for fully masked rows and
the log-sum-exp laid out ``[b, n, sq, 1]``.  ``delta = rowsum(do * o)``
is formed in fp32 outside the kernels, as in the JAX ``_bwd``.

The wrappers also take ``out_dtype`` and a precomputed ``delta`` (the
JAX ``_fwd`` / ``_bwd`` arguments the ring-attention callers use), so a
context-parallel caller needs no kernel change.
"""

from __future__ import annotations

from typing import Optional

import torch

from megatron_llm_tpu_torch.ops import kernels

NEG_INF = -1e30


def _allowed(sq, skv, causal, sliding_window, seg_q, seg_kv, device):
    """Boolean ``[b or 1, 1, sq, skv]`` mask from global positions."""
    q_pos = torch.arange(sq, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    allowed = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        allowed &= q_pos >= kv_pos
    if sliding_window is not None:
        allowed &= (q_pos - kv_pos) < sliding_window
    allowed = allowed[None, None]
    if seg_q is not None:
        allowed = allowed & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    return allowed


def _heads_first(t: torch.Tensor, g: int = 1) -> torch.Tensor:
    """``[b, s, h, d]`` -> fp32 ``[b, h * g, s, d]`` (kv heads repeated for
    their g query heads)."""
    t = t.float().permute(0, 2, 1, 3)
    return t.repeat_interleave(g, dim=1) if g > 1 else t


def _scores(q, k, seg_q, seg_kv, scale, causal, sliding_window):
    """fp32 scores ``[b, n, sq, skv]`` and the allowed mask."""
    g = q.shape[2] // k.shape[2]
    s = torch.matmul(_heads_first(q), _heads_first(k, g).transpose(-1, -2))
    allowed = _allowed(q.shape[1], k.shape[1], causal, sliding_window, seg_q,
                       seg_kv, q.device)
    return s * scale, allowed


def flash_fwd_plain(q, k, v, seg_q=None, seg_kv=None, *, scale: float,
                    causal: bool = True, sliding_window: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None):
    """Dense fp32 version of K1: ``(out [b, sq, n, d], lse [b, n, sq, 1])``."""
    g = q.shape[2] // k.shape[2]
    s, allowed = _scores(q, k, seg_q, seg_kv, scale, causal, sliding_window)
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)   # fully masked rows -> 0 output
    out = torch.matmul(p, _heads_first(v, g)) / l_safe
    lse = m + torch.log(l_safe)
    return out.permute(0, 2, 1, 3).to(out_dtype or q.dtype), lse


def _dscores(q, k, v, do, lse, delta, seg_q, seg_kv, scale, causal,
             sliding_window):
    """Recomputed probabilities and ``ds = p * (dp - delta) * scale``."""
    g = q.shape[2] // k.shape[2]
    s, allowed = _scores(q, k, seg_q, seg_kv, scale, causal, sliding_window)
    p = torch.where(allowed, torch.exp(s - lse), 0.0)
    dp = torch.matmul(_heads_first(do), _heads_first(v, g).transpose(-1, -2))
    return p, p * (dp - delta) * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, seg_q=None, seg_kv=None, *,
                       scale: float, causal: bool = True,
                       sliding_window: Optional[int] = None,
                       out_dtype: Optional[torch.dtype] = None):
    """Dense fp32 version of K2: ``dq [b, sq, n, d]``."""
    g = q.shape[2] // k.shape[2]
    _, ds = _dscores(q, k, v, do, lse, delta, seg_q, seg_kv, scale, causal,
                     sliding_window)
    dq = torch.matmul(ds, _heads_first(k, g))
    return dq.permute(0, 2, 1, 3).to(out_dtype or q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, seg_q=None, seg_kv=None, *,
                        scale: float, causal: bool = True,
                        sliding_window: Optional[int] = None,
                        out_dtype: Optional[torch.dtype] = None):
    """Dense fp32 version of K3: ``(dk, dv)``, each ``[b, skv, nkv, d]``,
    summed over the g query heads of each kv head."""
    b, skv, nkv, d = k.shape
    g = q.shape[2] // nkv
    p, ds = _dscores(q, k, v, do, lse, delta, seg_q, seg_kv, scale, causal,
                     sliding_window)
    dv = torch.matmul(p.transpose(-1, -2), _heads_first(do))
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q))

    def per_kv_head(t):
        t = t.reshape(b, nkv, g, skv, d).sum(2)
        return t.permute(0, 2, 1, 3).to(out_dtype or k.dtype)

    return per_kv_head(dk), per_kv_head(dv)


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(do * o)`` in fp32, laid out ``[b, n, sq, 1]`` like lse."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).unsqueeze(
        -1).contiguous()


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _one_segment_tensor(seg_q, seg_kv) -> None:
    if seg_q is not None and seg_q is not seg_kv:
        raise ValueError("the flash kernels take one segment-id tensor for "
                         "q and kv")


def flash_fwd(q, k, v, seg_q=None, seg_kv=None, *, scale, causal=True,
              sliding_window=None, out_dtype=None):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if _on_card(q):
        _one_segment_tensor(seg_q, seg_kv)
        return kernels.flash_fwd_kernel(
            q, k, v, seg_q, scale=scale, causal=causal,
            sliding_window=sliding_window, out_dtype=out_dtype)
    return flash_fwd_plain(q, k, v, seg_q, seg_kv, scale=scale, causal=causal,
                           sliding_window=sliding_window, out_dtype=out_dtype)


def flash_bwd(q, k, v, out, lse, do, seg_q=None, seg_kv=None, *, scale,
              causal=True, sliding_window=None, delta=None, out_dtype=None):
    """``(dq, dk, dv)``: K2 and K3 on CUDA tensors, their plain versions on
    CPU tensors; ``delta`` defaults to :func:`flash_delta` of ``out``."""
    if delta is None:
        delta = flash_delta(out, do)
    kw = dict(scale=scale, causal=causal, sliding_window=sliding_window,
              out_dtype=out_dtype)
    if _on_card(q):
        _one_segment_tensor(seg_q, seg_kv)
        do = _rows_aligned(do)
        dq = kernels.flash_bwd_dq_kernel(q, k, v, do, lse, delta, seg_q, **kw)
        dk, dv = kernels.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, seg_q,
                                              **kw)
        return dq, dk, dv
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, seg_q, seg_kv, **kw)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, seg_q, seg_kv, **kw)
    return dq, dk, dv


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read its rows, else a contiguous
    copy."""
    return t if kernels.flash_rows_aligned(t) else t.contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward; K2 + K3 backward from the saved ``q, k, v, out, lse``."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale, causal, sliding_window):
        q, k, v = (_rows_aligned(t) if _on_card(t) else t for t in (q, k, v))
        out, lse = flash_fwd(q, k, v, segment_ids, segment_ids, scale=scale,
                             causal=causal, sliding_window=sliding_window)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.flash_args = (scale, causal, sliding_window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg = ctx.saved_tensors
        scale, causal, window = ctx.flash_args
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, seg, seg, scale=scale,
                               causal=causal, sliding_window=window)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[b, s, heads, head_dim]`` inputs (k / v may
    have fewer heads: grouped-query attention); returns ``[b, sq, n, d]``
    in q's dtype."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    return FlashAttentionFunction.apply(q, k, v, seg, float(scale),
                                        bool(causal), sliding_window)
