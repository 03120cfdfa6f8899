"""Quantized paged KV-cache storage: int8 / fp8 e4m3 pages with per-page
scales (port of ``megatron_llm_tpu/ops/kv_quant.py``).

Serving is bound by pool capacity before it is bound by flops: decode
slots, prefix-cache pages and speculative depth all come out of KV bytes.
``--kv_dtype int8|fp8`` stores the paged pool in one byte an element with
**per-page, per-KV-head symmetric absmax scales**: the page is the pool's
unit of allocation, sharing and eviction, so a page that moves through the
prefix trie or a copy-on-write clone carries exactly one scale row with it.

Layout (:class:`QuantPagedKV`):

* ``q``     — ``[..., num_pages, page_size, nkv, d]`` int8 /
  ``torch.float8_e4m3fn``
* ``scale`` — ``[..., num_pages, nkv]`` float32, ``x ~= q * scale``

Both carry the plain pool's leading dims (the stacked layer axis
included); :func:`layer` takes one layer's slice of either kind of pool.

Write path (:func:`paged_write`): every write of the engine — the ragged
tick's rows, a prefill chunk, the speculative draft scan — is "R rows,
each one token at ``(page_ids[r], offs[r])``", and consecutive rows of a
chunk or a verify block land in the SAME page, so the update is
page-granular and runs in three phases whose scatters are each
well-defined under duplicate page ids:

1. **scale update** — a page receiving an ``offs == 0`` write is fresh
   (its first token; what it holds is a previous tenant's): its scale
   restarts from this write's rows.  Otherwise the scale is ``max(old,
   incoming)``.  Both are scatter-max reductions, so duplicates compose.
2. **page requantize** — the written pages' content is re-rounded under
   the (possibly grown) scale, ``q' = round(q * old / new)``.  The ratio
   is per page, so every duplicate gathered copy computes the same bytes
   and the scatter back is deterministic; an unchanged scale round-trips
   exactly, a fresh page zeroes (ratio 0).
3. **token write** — each row's value quantized under the new scale at its
   own ``(page, offset)``.  Live rows write disjoint slots; only the null
   page sees duplicates, and its content is never attended.

The gathered copies keep a static ``[R, page, nkv, d]`` shape (no
``unique`` of device ids, which would sync the host every layer).  The
port updates the pool in place; the arithmetic, and so the bytes, are the
JAX package's.

Error bound: one whole-page quantization errs by at most ``scale / 2``;
an append that grows a page's scale re-rounds the earlier tokens once
more, and :func:`kv_error_bound` reports the single-growth figure as the
rule of thumb (the reference module's docstring has the derivation).

Read path: the plain versions of the paged attention functions
dequantize at the gather (:func:`dequant_gather`, in fp32); the CUDA
kernels read the one-byte pages and their scales themselves
(``ops/kernels/csrc/paged_common.cuh``), so device memory traffic stays at
the quantized bytes.

``kv_dtype="bf16"`` means a plain pool in the compute dtype and never
touches the quantized paths: plain writes keep the engine's original
scatter expression byte for byte.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

KV_DTYPES = ("bf16", "int8", "fp8")

# symmetric quantization ranges: int8 uses +-127 (round, then clip); fp8 is
# e4m3fn, whose largest finite value is 448 (clip before the cast: e4m3fn
# has no inf, so a clipped cast keeps even garbage pages finite)
_QMAX = {"int8": 127.0, "fp8": 448.0}
_QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

# scale floor for divisions only (stored scales keep their true value: an
# all-zero page dequantizes to exact zeros)
_EPS = 1e-20


class QuantPagedKV(NamedTuple):
    """One quantized paged cache: values + per-page, per-head scales."""

    q: torch.Tensor       # [..., num_pages, page_size, nkv, d] int8 / e4m3
    scale: torch.Tensor   # [..., num_pages, nkv] float32


PagedKV = Union[torch.Tensor, QuantPagedKV]


def is_quantized(pool: PagedKV) -> bool:
    return isinstance(pool, QuantPagedKV)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the tensor the index operations move: fp8 values as their
    raw bytes (indexing, gathers and scatters are byte moves either way,
    and every device's kernels take uint8)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def make_pool(shape, kv_dtype: str, compute_dtype: torch.dtype,
              device=None) -> PagedKV:
    """Zero-initialized pool of ``shape`` = ``[..., P, page, nkv, d]``: a
    plain ``compute_dtype`` tensor for ``bf16``, a :class:`QuantPagedKV`
    otherwise."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    shape = tuple(shape)
    if kv_dtype == "bf16":
        return torch.zeros(shape, dtype=compute_dtype, device=device)
    # zero bytes: +0.0 in e4m3 too
    q = torch.zeros(shape, dtype=torch.uint8, device=device)
    return QuantPagedKV(
        q=q.view(_QDTYPE[kv_dtype]),
        scale=torch.zeros(shape[:-3] + (shape[-2],), dtype=torch.float32,
                          device=device))


def layer(pool: PagedKV, i: int) -> PagedKV:
    """Layer ``i`` of a stacked ``[L, ...]`` pool, of either kind (a view:
    writes through it land in the stacked pool).  Indexing the container
    itself would pick one of its two fields, not a layer."""
    if is_quantized(pool):
        return QuantPagedKV(pool.q[i], pool.scale[i])
    return pool[i]


def page_size_of(pool: PagedKV) -> int:
    arr = pool.q if is_quantized(pool) else pool
    return arr.shape[-3]


def pool_nbytes(pool: PagedKV) -> int:
    """Device bytes of the pool's KV values (scales are counted apart by
    :func:`scale_nbytes`, so the per-page overhead stays visible)."""
    arr = pool.q if is_quantized(pool) else pool
    return arr.numel() * arr.element_size()


def scale_nbytes(pool: PagedKV) -> int:
    return (pool.scale.numel() * pool.scale.element_size()
            if is_quantized(pool) else 0)


def _qmax_of(pool: QuantPagedKV) -> float:
    return _QMAX["int8"] if pool.q.dtype == torch.int8 else _QMAX["fp8"]


def _kv_dtype_of(pool: QuantPagedKV) -> str:
    return "int8" if pool.q.dtype == torch.int8 else "fp8"


def _cast_q(x32: torch.Tensor, qdtype: torch.dtype) -> torch.Tensor:
    """fp32 -> storage rounding: round (half to even) and clip for int8, a
    clipped round-to-nearest-even cast for fp8."""
    if qdtype == torch.int8:
        return torch.clamp(torch.round(x32), -127.0, 127.0).to(torch.int8)
    return torch.clamp(x32, -_QMAX["fp8"], _QMAX["fp8"]).to(qdtype)


def quantize_pages(vals: torch.Tensor, kv_dtype: str) -> QuantPagedKV:
    """Whole-page quantization of ``vals`` ``[..., page, nkv, d]``: the
    monolithic-prefill scatter's form, and the one the error bound is
    stated against."""
    qmax = _QMAX[kv_dtype]
    v32 = vals.float()
    scale = torch.amax(torch.abs(v32), dim=(-3, -1)) / qmax   # [..., nkv]
    den = torch.clamp(scale, min=_EPS)
    q = _cast_q(v32 / den[..., None, :, None], _QDTYPE[kv_dtype])
    return QuantPagedKV(q=q, scale=scale)


def dequantize_pages(pages: QuantPagedKV, dtype=torch.float32) -> torch.Tensor:
    """``[..., page, nkv, d]`` values back in ``dtype``."""
    return (pages.q.float() * pages.scale[..., None, :, None]).to(dtype)


def kv_error_bound(vals: torch.Tensor, kv_dtype: str,
                   appends: bool = False) -> float:
    """Max absolute dequantization error for page content ``vals``
    ``[..., page, nkv, d]``: ``scale / 2`` per (page, head) for a
    single-shot page quantization; ``appends`` doubles it (one extra
    re-rounding under the final scale: the rule of thumb for pages filled
    by decode appends)."""
    qmax = _QMAX[kv_dtype]
    scale = torch.amax(torch.abs(vals.float()), dim=(-3, -1)) / qmax
    bound = float(torch.max(scale)) / 2.0
    return 2.0 * bound if appends else bound


# ---------------------------------------------------------------------------
# The write path
# ---------------------------------------------------------------------------


def paged_write(pool: PagedKV, page_ids: torch.Tensor, offs: torch.Tensor,
                vals: torch.Tensor) -> None:
    """Write ``vals[b, s, nkv, d]`` at ``(page_ids[b, s], offs[b, s])``,
    in place.

    Plain pools keep the engine's original scatter expression byte for
    byte.  Quantized pools run the three-phase page-granular update from
    the module docstring."""
    if not is_quantized(pool):
        pool[page_ids, offs] = vals.to(pool.dtype)
        return
    n = page_ids.numel()
    _quant_write_rows(pool, page_ids.reshape(n), offs.reshape(n),
                      vals.reshape(n, *vals.shape[2:]))


def _quant_write_rows(pool: QuantPagedKV, page_ids: torch.Tensor,
                      offs: torch.Tensor, vals: torch.Tensor) -> None:
    """R rows, one token each; collision-safe (see the module docstring)."""
    qdtype = pool.q.dtype
    qmax = _qmax_of(pool)
    num_pages, nkv = pool.scale.shape
    ids = page_ids.long()
    v32 = vals.float()                                      # [R, nkv, d]
    s_row = torch.amax(torch.abs(v32), dim=-1) / qmax       # [R, nkv]

    # 1) scale update.  offs == 0 marks the page's first token: the old
    # scale and content belong to a previous tenant and must not leak in.
    fresh = torch.zeros((num_pages,), dtype=torch.int32, device=ids.device)
    fresh.scatter_reduce_(0, ids, (offs == 0).to(torch.int32), "amax",
                          include_self=True)
    kept_scale = torch.where(fresh[:, None] > 0, 0.0, pool.scale)
    new_scale = kept_scale.scatter_reduce(
        0, ids[:, None].expand(-1, nkv), s_row, "amax", include_self=True)
    den = torch.clamp(new_scale, min=_EPS)

    # 2) requantize the written pages' content.  The ratio is per page, so
    # duplicate gathered copies rescale to the same bytes; fresh pages
    # zero (ratio 0), an unchanged scale round-trips exactly.
    ratio = (kept_scale / den)[ids]                         # [R, nkv]
    raw = _bytes(pool.q)
    gathered = raw[ids].view(qdtype).float()                # [R, page, nkv, d]
    requant = _cast_q(gathered * ratio[:, None, :, None], qdtype)
    raw[ids] = _bytes(requant)

    # 3) the tokens themselves, under the new scale
    tok_q = _cast_q(v32 / den[ids][..., None], qdtype)
    raw[ids, offs.long()] = _bytes(tok_q)
    pool.scale.copy_(new_scale)


def scatter_whole_pages(pool: PagedKV, page_ids: torch.Tensor,
                        pages: torch.Tensor) -> None:
    """Replace whole pages in place: ``pages`` ``[..., n, page, nkv, d]``
    is the computed content of ``page_ids`` ``[n]`` on every leading
    (layer) index — the monolithic prefill's write.  Plain pools keep the
    original ``[:, page_ids] = ...`` expression; quantized pools quantize
    each page in one shot (the tight error bound)."""
    if not is_quantized(pool):
        pool[:, page_ids] = pages.to(pool.dtype)
        return
    qp = quantize_pages(pages, _kv_dtype_of(pool))
    _bytes(pool.q)[:, page_ids] = _bytes(qp.q)
    pool.scale[:, page_ids] = qp.scale


# ---------------------------------------------------------------------------
# The read path (the plain versions; the CUDA kernels dequantize in-kernel)
# ---------------------------------------------------------------------------


def dequant_gather(pool: PagedKV, block_tables: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[T, W * page, nkv, d]`` dense view of the block-tabled pages.

    Plain pools return the gather as it is; quantized pools dequantize at
    the gather in fp32 (``k.float() * scale``, the kernels' arithmetic),
    then cast to ``dtype`` if one is given."""
    T = block_tables.shape[0]
    idx = block_tables.long()
    if not is_quantized(pool):
        nkv, d = pool.shape[-2], pool.shape[-1]
        return pool[idx].reshape(T, -1, nkv, d)
    nkv, d = pool.q.shape[-2], pool.q.shape[-1]
    g = _bytes(pool.q)[idx].view(pool.q.dtype).float()   # [T, W, page, nkv, d]
    s = pool.scale[idx]                                   # [T, W, nkv]
    out = (g * s[..., None, :, None]).reshape(T, -1, nkv, d)
    return out if dtype is None else out.to(dtype)
