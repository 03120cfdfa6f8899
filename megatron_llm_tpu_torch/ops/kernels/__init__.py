"""Python wrappers of the hand-written CUDA kernels (``csrc/``).

Each wrapper checks device, dtype, shape, alignment and contiguity and
raises on what its kernel does not take, allocates its output with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch returned an error, and counts its launches in a plain integer
(``paged_ragged_kernel.launches``) so a run can show that the main path
went through the kernel.  The wrappers only take CUDA tensors; the plain
PyTorch versions live beside the dispatch in ``ops/paged_attention.py``,
``ops/flash_attention.py`` and ``ops/rmsnorm.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from megatron_llm_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128, 256)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensors(name, q, k_pool, v_pool, ints):
    dev = q.device
    _check(dev.type == "cuda", f"{name}: q must be a CUDA tensor, got {dev}")
    _check(q.dtype in _DTYPES,
           f"{name}: dtype {q.dtype} not in fp32/bf16/fp16")
    for t_name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(t.device == dev, f"{name}: {t_name} on {t.device}, q on {dev}")
        _check(t.dtype == q.dtype,
               f"{name}: {t_name} dtype {t.dtype} != q dtype {q.dtype}")
    _check(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           f"{name}: pools must be [pages, page_size, nkv, d] and match, "
           f"got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    for t_name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _check(t.is_contiguous(), f"{name}: {t_name} must be contiguous")
        _check(t.data_ptr() % 16 == 0,
               f"{name}: {t_name} must be 16-byte aligned")
    for t_name, t in ints.items():
        _check(t.device == dev, f"{name}: {t_name} on {t.device}, q on {dev}")
        _check(t.dtype == torch.int32, f"{name}: {t_name} must be int32")
        _check(t.is_contiguous(), f"{name}: {t_name} must be contiguous")
    _, page, nkv, d = k_pool.shape
    n = q.shape[-2]
    _check(q.shape[-1] == d, f"{name}: q head_dim {q.shape[-1]} != pool {d}")
    _check(d in HEAD_DIMS, f"{name}: head_dim {d} not in {HEAD_DIMS}")
    _check(page % 8 == 0, f"{name}: page_size {page} not a multiple of 8")
    _check(n % nkv == 0, f"{name}: {n} heads not divisible by {nkv} kv heads")
    return page, nkv, d


def _raise_on(err: int, name: str, lib) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.paged_error_string(err).decode()}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _window(sliding_window: Optional[int]) -> int:
    return 0 if sliding_window is None else int(sliding_window)


def paged_ragged_kernel(q, k_pool, v_pool, tables, table_index, positions,
                        horizons, *, scale: float,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """CUDA ragged paged attention (``csrc/paged_ragged.cu``); same
    contract as ``ops.paged_attention.paged_attention_ragged``."""
    name = "paged_ragged_kernel"
    page, nkv, d = _check_tensors(name, q, k_pool, v_pool, dict(
        tables=tables, table_index=table_index, positions=positions,
        horizons=horizons))
    _check(q.dim() == 4 and q.shape[1] == 1,
           f"{name}: q must be [R, 1, n, d], got {tuple(q.shape)}")
    R, _, n, _ = q.shape
    _check(tables.dim() == 2, f"{name}: tables must be [T, max_pages]")
    for t_name, t in (("table_index", table_index), ("positions", positions),
                      ("horizons", horizons)):
        _check(tuple(t.shape) == (R,),
               f"{name}: {t_name} must be [{R}], got {tuple(t.shape)}")
    out = torch.empty_like(q)
    if R == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.paged_ragged_launch(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(tables),
            _ptr(table_index), _ptr(positions), _ptr(horizons), _ptr(out),
            R, n, nkv, d, tables.shape[1], page, float(scale),
            _window(sliding_window), _DTYPES[q.dtype], _stream(q.device))
    _raise_on(err, name, lib)
    paged_ragged_kernel.launches += 1
    return out


def paged_decode_kernel(q, k_pool, v_pool, block_tables, positions, *,
                        scale: float,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """CUDA paged decode attention (``csrc/paged_decode.cu``); same
    contract as ``ops.paged_attention.paged_attention_decode``."""
    name = "paged_decode_kernel"
    page, nkv, d = _check_tensors(name, q, k_pool, v_pool, dict(
        block_tables=block_tables, positions=positions))
    _check(q.dim() == 4 and q.shape[1] == 1,
           f"{name}: q must be [b, 1, n, d], got {tuple(q.shape)}")
    b, _, n, _ = q.shape
    _check(block_tables.dim() == 2 and block_tables.shape[0] == b,
           f"{name}: block_tables must be [{b}, max_pages], got "
           f"{tuple(block_tables.shape)}")
    _check(tuple(positions.shape) == (b,),
           f"{name}: positions must be [{b}], got {tuple(positions.shape)}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.paged_decode_launch(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(block_tables),
            _ptr(positions), _ptr(out), b, n, nkv, d, block_tables.shape[1],
            page, float(scale), _window(sliding_window), _DTYPES[q.dtype],
            _stream(q.device))
    _raise_on(err, name, lib)
    paged_decode_kernel.launches += 1
    return out


def paged_prefill_kernel(q, k_pool, v_pool, block_tables, start, *,
                         scale: float,
                         sliding_window: Optional[int] = None) -> torch.Tensor:
    """CUDA chunked-prefill paged attention (``csrc/paged_prefill.cu``);
    same contract as ``ops.paged_attention.paged_attention_prefill``."""
    name = "paged_prefill_kernel"
    page, nkv, d = _check_tensors(name, q, k_pool, v_pool, dict(
        block_tables=block_tables, start=start))
    _check(q.dim() == 4, f"{name}: q must be [b, s, n, d]")
    b, s, n, _ = q.shape
    _check(block_tables.dim() == 2 and block_tables.shape[0] == b,
           f"{name}: block_tables must be [{b}, kv_pages]")
    _check(tuple(start.shape) == (b,), f"{name}: start must be [{b}]")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    _check(s <= 65535, f"{name}: at most 65535 tokens per chunk, got {s}")
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.paged_prefill_launch(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(block_tables),
            _ptr(start), _ptr(out), b, s, n, nkv, d, block_tables.shape[1],
            page, float(scale), _window(sliding_window), _DTYPES[q.dtype],
            _stream(q.device))
    _raise_on(err, name, lib)
    paged_prefill_kernel.launches += 1
    return out


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_{fwd,bwd}.cu, csrc/flash_{fwd,bwd}_hopper.cu)
# ---------------------------------------------------------------------------

_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_rows_aligned(t: torch.Tensor) -> bool:
    """Whether the flash kernels can read ``t``'s rows with 16-byte loads
    (and TMA): a contiguous last dimension, a 16-byte-aligned start and
    16-byte strides."""
    esz = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((st * esz) % 16 == 0 for st in t.stride()[:-1]))


def _flash_strides(name, t_name, t, b, s, heads, d):
    """(batch, seq, head) element strides of a ``[b, s, heads, d]`` tensor
    whose rows the kernel reads with 16-byte loads."""
    _check(tuple(t.shape) == (b, s, heads, d),
           f"{name}: {t_name} must be [{b}, {s}, {heads}, {d}], got "
           f"{tuple(t.shape)}")
    _check(flash_rows_aligned(t),
           f"{name}: {t_name} must have a contiguous last dimension, a "
           f"16-byte-aligned start and 16-byte strides, strides {t.stride()}")
    return [t.stride(0), t.stride(1), t.stride(2)]


def _check_flash(name, q, k, v, extra, segment_ids):
    """Validate q ``[b, sq, n, d]``, k / v ``[b, skv, nkv, d]`` and the
    ``extra`` tensors; returns (dims, strides, segment pointer).  The
    device is checked last, so the type and layout checks also speak for
    tensors on the CPU."""
    dev = q.device
    _check(q.dtype in _FLASH_DTYPES,
           f"{name}: dtype {q.dtype} not in fp32/bf16")
    _check(q.dim() == 4 and k.dim() == 4,
           f"{name}: q and k must be [b, s, heads, d]")
    b, sq, n, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    _check(d in HEAD_DIMS, f"{name}: head_dim {d} not in {HEAD_DIMS}")
    _check(nkv > 0 and n % nkv == 0,
           f"{name}: {n} heads not divisible by {nkv} kv heads")
    strides = _flash_strides(name, "q", q, b, sq, n, d)
    for t_name, t, s, h in (("k", k, skv, nkv), ("v", v, skv, nkv),
                            *((nm, t, sq, n) for nm, t in extra)):
        _check(t.device == dev, f"{name}: {t_name} on {t.device}, q on {dev}")
        _check(t.dtype == q.dtype,
               f"{name}: {t_name} dtype {t.dtype} != q dtype {q.dtype}")
        strides += _flash_strides(name, t_name, t, b, s, h, d)
    _check(dev.type == "cuda", f"{name}: q must be a CUDA tensor, got {dev}")
    seg = None
    if segment_ids is not None:
        _check(sq == skv, f"{name}: segment ids need sq == skv")
        _check(segment_ids.device == dev and segment_ids.dtype == torch.int32
               and segment_ids.is_contiguous()
               and tuple(segment_ids.shape) == (b, sq),
               f"{name}: segment_ids must be a contiguous int32 [{b}, {sq}] "
               f"tensor on {dev}")
        seg = _ptr(segment_ids)
    return (b, sq, skv, n, nkv, d), strides, seg


def _check_rows(name, t_name, t, b, n, sq):
    _check(t.device.type == "cuda" and t.dtype == torch.float32
           and t.is_contiguous() and t.numel() == b * n * sq,
           f"{name}: {t_name} must be a contiguous fp32 [{b}, {n}, {sq}, 1] "
           f"CUDA tensor, got {t.dtype} {tuple(t.shape)}")


def _out_dtype(q, out_dtype):
    out_dtype = out_dtype or q.dtype
    _check(out_dtype in (q.dtype, torch.float32),
           f"out_dtype must be {q.dtype} or float32, got {out_dtype}")
    return out_dtype


def _flash_tail(dims, scale, causal, sliding_window, q, out_dtype):
    b, sq, skv, n, nkv, d = dims
    return (b, sq, skv, n, nkv, d, float(scale), int(bool(causal)),
            _window(sliding_window), _FLASH_DTYPES[q.dtype],
            int(out_dtype == torch.float32 and q.dtype != torch.float32),
            _stream(q.device))


FLASH_PATHS = ("smem", "hopper")   # the flash entry points' `path` codes


def flash_path(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels K1-K3 run: ``"hopper"`` (``csrc/flash_fwd_hopper.cu``,
    ``csrc/flash_bwd_hopper.cu``: TMA, wgmma, warp-specialised
    warpgroups) for bf16 at head_dim 64 and 128, ``"smem"`` (the
    shared-memory kernels of ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``)
    for every other type and head_dim."""
    if dtype == torch.bfloat16 and head_dim in (64, 128):
        return "hopper"
    return "smem"


def flash_tma_geometry(t: torch.Tensor) -> list:
    """The 4-D TMA map of a ``[b, s, heads, d]`` tensor with a contiguous
    last dimension: its dims innermost first ``(d, heads, s, b)``, then the
    byte strides of heads, s and b.  A dim of size 1 never moves the
    address, so it gets the stride a packed layout would give it (TMA
    wants a nonzero multiple of 16 there too)."""
    b, s, heads, d = t.shape
    esz = t.element_size()
    dims = [d, heads, s, b]
    strides = []
    prev = d * esz   # the packed stride of heads
    for size, st in zip((heads, s, b), (t.stride(2), t.stride(1),
                                        t.stride(0))):
        stride = st * esz if size > 1 else prev
        strides.append(stride)
        prev = stride * size
    return dims + strides


def _hopper_args(path, tensors):
    """The Hopper kernels' extra arguments: the TMA geometry of ``tensors``
    (a host array) and the persistent kernel's work-tile counter (one int
    of device memory, zeroed by the launch); ``(None, None)`` on the
    shared-memory path."""
    if path != "hopper":
        return None, None
    geo = [x for t in tensors for x in flash_tma_geometry(t)]
    counter = torch.empty(1, device=tensors[0].device, dtype=torch.int32)
    return (ctypes.c_longlong * len(geo))(*geo), counter


def _ptr_or_null(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else _ptr(t)


def flash_fwd_kernel(q, k, v, segment_ids=None, *, scale: float,
                     causal: bool = True, sliding_window: Optional[int] = None,
                     out_dtype: Optional[torch.dtype] = None):
    """CUDA flash-attention forward (K1; ``csrc/flash_fwd_hopper.cu`` or
    ``csrc/flash_fwd.cu`` as :func:`flash_path` picks, recorded in
    ``flash_fwd_kernel.last_path``); same contract as
    ``ops.flash_attention.flash_fwd_plain``: returns ``(out [b, sq, n, d],
    lse [b, n, sq, 1] fp32)``."""
    name = "flash_fwd_kernel"
    dims, strides, seg = _check_flash(name, q, k, v, (), segment_ids)
    b, sq, skv, n, nkv, d = dims
    out_dtype = _out_dtype(q, out_dtype)
    out = torch.empty((b, sq, n, d), device=q.device, dtype=out_dtype)
    lse = torch.empty((b, n, sq, 1), device=q.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    path = flash_path(q.dtype, d)
    geo, counter = _hopper_args(path, (q, k, v))
    lib = build.library()
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    *tail, stream = _flash_tail(dims, scale, causal, sliding_window, q,
                                out_dtype)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            _ptr(q), _ptr(k), _ptr(v), seg, seg, _ptr(out), _ptr(lse),
            c_strides, geo, _ptr_or_null(counter), *tail,
            FLASH_PATHS.index(path), stream)
    _raise_on(err, name, lib)
    flash_fwd_kernel.launches += 1
    flash_fwd_kernel.last_path = path
    return out, lse


def _bwd_checks(name, q, k, v, do, lse, delta, segment_ids):
    dims, strides, seg = _check_flash(name, q, k, v, (("do", do),),
                                      segment_ids)
    b, sq, _, n, _, _ = dims
    _check_rows(name, "lse", lse, b, n, sq)
    _check_rows(name, "delta", delta, b, n, sq)
    return dims, strides, seg


def _bwd_launch(name, entry, checked, q, k, v, do, lse, delta, outs, scale,
                causal, sliding_window, out_dtype):
    """Launch K2 (``entry`` flash_bwd_dq_launch) or K3 (flash_bwd_dkv_launch)
    into ``outs`` on the path :func:`flash_path` picks; returns the path."""
    dims, strides, seg = checked
    path = flash_path(q.dtype, dims[-1])
    geo, counter = _hopper_args(path, (q, k, v, do))
    lib = build.library()
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    *tail, stream = _flash_tail(dims, scale, causal, sliding_window, q,
                                out_dtype)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), seg,
            seg, *map(_ptr, outs), c_strides, geo, _ptr_or_null(counter),
            *tail, FLASH_PATHS.index(path), stream)
    _raise_on(err, name, lib)
    return path


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, segment_ids=None, *,
                        scale: float, causal: bool = True,
                        sliding_window: Optional[int] = None,
                        out_dtype: Optional[torch.dtype] = None):
    """CUDA flash-attention dq (K2; ``csrc/flash_bwd_hopper.cu`` or
    ``csrc/flash_bwd.cu`` as :func:`flash_path` picks, recorded in
    ``flash_bwd_dq_kernel.last_path``); same contract as
    ``ops.flash_attention.flash_bwd_dq_plain``."""
    name = "flash_bwd_dq_kernel"
    checked = _bwd_checks(name, q, k, v, do, lse, delta, segment_ids)
    out_dtype = _out_dtype(q, out_dtype)
    dq = torch.empty(q.shape, device=q.device, dtype=out_dtype)
    if dq.numel() == 0:
        return dq
    path = _bwd_launch(name, "flash_bwd_dq_launch", checked, q, k, v, do,
                       lse, delta, (dq,), scale, causal, sliding_window,
                       out_dtype)
    flash_bwd_dq_kernel.launches += 1
    flash_bwd_dq_kernel.last_path = path
    return dq


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, segment_ids=None, *,
                         scale: float, causal: bool = True,
                         sliding_window: Optional[int] = None,
                         out_dtype: Optional[torch.dtype] = None):
    """CUDA flash-attention dk / dv (K3; ``csrc/flash_bwd_hopper.cu`` or
    ``csrc/flash_bwd.cu`` as :func:`flash_path` picks, recorded in
    ``flash_bwd_dkv_kernel.last_path``); same contract as
    ``ops.flash_attention.flash_bwd_dkv_plain``."""
    name = "flash_bwd_dkv_kernel"
    checked = _bwd_checks(name, q, k, v, do, lse, delta, segment_ids)
    out_dtype = _out_dtype(q, out_dtype)
    dk = torch.empty(k.shape, device=q.device, dtype=out_dtype)
    dv = torch.empty(v.shape, device=q.device, dtype=out_dtype)
    if dk.numel() == 0:
        return dk, dv
    path = _bwd_launch(name, "flash_bwd_dkv_launch", checked, q, k, v, do,
                       lse, delta, (dk, dv), scale, causal, sliding_window,
                       out_dtype)
    flash_bwd_dkv_kernel.launches += 1
    flash_bwd_dkv_kernel.last_path = path
    return dk, dv


# ---------------------------------------------------------------------------
# fused RMSNorm (csrc/rmsnorm.cu)
# ---------------------------------------------------------------------------

RMS_NORM_MAX_H = 16384   # the widest row the kernels hold in registers


def _check_rms(name, x, w, others):
    """Validate x ``[rows, h]``, w ``[h]`` (fp32 or x's type) and the
    ``others`` tensors of x's shape and type; returns ``(rows, h)``."""
    dev = x.device
    _check(dev.type == "cuda", f"{name}: x must be a CUDA tensor, got {dev}")
    _check(x.dtype in _DTYPES, f"{name}: dtype {x.dtype} not in fp32/bf16/fp16")
    _check(x.dim() == 2, f"{name}: x must be [rows, h], got {tuple(x.shape)}")
    rows, h = x.shape
    _check(0 < h <= RMS_NORM_MAX_H,
           f"{name}: hidden size {h} outside the kernels' range 1..."
           f"{RMS_NORM_MAX_H}")
    _check(w.device == dev, f"{name}: w on {w.device}, x on {dev}")
    _check(w.dtype in (torch.float32, x.dtype),
           f"{name}: w dtype {w.dtype} must be float32 or x's {x.dtype}")
    _check(tuple(w.shape) == (h,),
           f"{name}: w must be [{h}], got {tuple(w.shape)}")
    for t_name, t in others:
        _check(t.device == dev and t.dtype == x.dtype and t.shape == x.shape,
               f"{name}: {t_name} must match x ({x.dtype} {tuple(x.shape)} "
               f"on {dev}), got {t.dtype} {tuple(t.shape)} on {t.device}")
    for t_name, t in (("x", x), ("w", w), *others):
        _check(t.is_contiguous(), f"{name}: {t_name} must be contiguous")
        _check(t.data_ptr() % 16 == 0,
               f"{name}: {t_name} must be 16-byte aligned")
    return rows, h


def rms_norm_fwd_kernel(x: torch.Tensor, w: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """CUDA fused RMSNorm forward (``csrc/rmsnorm.cu``, K7): ``y [rows, h]``
    in x's type; same contract as ``ops.rmsnorm.rms_norm_fwd_plain``."""
    name = "rms_norm_fwd_kernel"
    rows, h = _check_rms(name, x, w, ())
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rms_norm_fwd_launch(
            _ptr(x), _ptr(w), _ptr(y), rows, h, float(eps), _DTYPES[x.dtype],
            _DTYPES[w.dtype], _stream(x.device))
    _raise_on(err, name, lib)
    rms_norm_fwd_kernel.launches += 1
    return y


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rms_norm_chunk_rows(rows: int, device: torch.device) -> int:
    """Rows a K8 block takes: enough blocks for four on every SM."""
    return max(1, -(-rows // (4 * _sm_count(device))))


def rms_norm_bwd_kernel(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        eps: float):
    """CUDA fused RMSNorm backward (``csrc/rmsnorm.cu``, K8): ``(dx [rows,
    h] in x's type, dw [h] in w's type)``; same contract as
    ``ops.rmsnorm.rms_norm_bwd_plain``.  dw is summed without atomics,
    through an fp32 workspace of one row of partial sums a block."""
    name = "rms_norm_bwd_kernel"
    rows, h = _check_rms(name, x, w, (("g", g),))
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    chunk = _rms_norm_chunk_rows(rows, x.device)
    part = torch.empty((-(-rows // chunk), h), device=x.device,
                       dtype=torch.float32)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rms_norm_bwd_launch(
            _ptr(x), _ptr(w), _ptr(g), _ptr(dx), _ptr(dw), _ptr(part), rows,
            h, chunk, float(eps), _DTYPES[x.dtype], _DTYPES[w.dtype],
            _stream(x.device))
    _raise_on(err, name, lib)
    rms_norm_bwd_kernel.launches += 1
    return dx, dw


paged_ragged_kernel.launches = 0
paged_decode_kernel.launches = 0
paged_prefill_kernel.launches = 0
flash_fwd_kernel.launches = 0
flash_fwd_kernel.last_path = None
flash_bwd_dq_kernel.launches = 0
flash_bwd_dq_kernel.last_path = None
flash_bwd_dkv_kernel.launches = 0
flash_bwd_dkv_kernel.last_path = None
rms_norm_fwd_kernel.launches = 0
rms_norm_bwd_kernel.launches = 0

KERNELS = (paged_ragged_kernel, paged_decode_kernel, paged_prefill_kernel,
           flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
           rms_norm_fwd_kernel, rms_norm_bwd_kernel)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
