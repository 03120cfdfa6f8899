"""Python wrappers of the hand-written CUDA kernels (``csrc/``).

Each wrapper checks device, dtype, shape, alignment and contiguity and
raises on what its kernel does not take, allocates its output with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch returned an error, and counts its launches in a plain integer
(``paged_ragged_kernel.launches``) so a run can show that the main path
went through the kernel.

The launch path is lean, because for the small kernels (K5-K8) the host's
time a launch is what the caller pays: the checks build a message only
when one fails, the library is bound once, pointers and PyTorch's current
stream (its raw handle) go to ctypes as plain ints, and the launcher gets
the tensors' device index and switches device only when the calling
thread's current one differs (``csrc/device_guard.cuh``) instead of the
wrapper entering ``torch.cuda.device``.

The wrappers only take CUDA tensors; the plain PyTorch versions live
beside the dispatch in ``ops/paged_attention.py``,
``ops/flash_attention.py`` and ``ops/rmsnorm.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from megatron_llm_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128, 256)


def _library():
    """The kernel library, bound once: after the first build a launch reads
    this module's global instead of taking :func:`build.library`'s lock."""
    global _lib
    if _lib is None:
        _lib = build.library()
    return _lib


_lib = None


def _stream(device: int) -> int:
    """PyTorch's current stream on ``device``, as the raw handle the
    launchers take (no ``torch.cuda.Stream`` object is built)."""
    return torch._C._cuda_getCurrentRawStream(device)


def _launch_error(name: str, err: int):
    raise RuntimeError(
        f"{name} launch failed: {_lib.paged_error_string(err).decode()}")


def _window(sliding_window: Optional[int]) -> int:
    return 0 if sliding_window is None else int(sliding_window)


# The wrappers' checks run on every launch, so each tests with plain
# comparisons and builds its message only when the test fails.


def _check_paged(name, q, k_pool, v_pool, ints):
    """Validate q and the pools of a paged kernel and the int32 tensors
    ``ints`` (``(name, tensor)`` pairs); returns ``(device index, page,
    nkv, d)``."""
    if not q.is_cuda:
        raise ValueError(f"{name}: q must be a CUDA tensor, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in fp32/bf16/fp16")
    dev = q.get_device()
    for t_name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.get_device() != dev:
            raise ValueError(
                f"{name}: {t_name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(
                f"{name}: {t_name} dtype {t.dtype} != q dtype {q.dtype}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"{name}: pools must be [pages, page_size, nkv, d] and match, "
            f"got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    for t_name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")
    for t_name, t in ints:
        if t.get_device() != dev:
            raise ValueError(
                f"{name}: {t_name} on {t.device}, q on {q.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {t_name} must be int32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
    _, page, nkv, d = k_pool.shape
    n = q.shape[-2]
    if q.shape[-1] != d:
        raise ValueError(f"{name}: q head_dim {q.shape[-1]} != pool {d}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if page % 8:
        raise ValueError(f"{name}: page_size {page} not a multiple of 8")
    if n % nkv:
        raise ValueError(
            f"{name}: {n} heads not divisible by {nkv} kv heads")
    return dev, page, nkv, d


PAGED_PATHS = ("rows", "tile")   # the K4-K6 entry points' `path` codes


def paged_path(dtype: torch.dtype, head_dim: int) -> str:
    """Which device routine K4, K5 and K6 run: ``"tile"`` for bf16 and
    fp16 at head_dim 64 and 128 (K4 / K5: ``csrc/paged_tile.cuh``,
    adjacent rows on one block table share a block and its page loads;
    K6: ``csrc/paged_prefill_tile.cuh``, 64 (row, head) pairs of a chunk
    share each page load on wgmma; products on the tensor cores);
    ``"rows"`` (``csrc/paged_common.cuh``: ``attend_row``, a block per
    row, fp32 dots) for fp32, whose products in TF32 would keep too few
    digits, and for head_dim 256, whose accumulators do not fit the
    registers."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim in (64, 128):
        return "tile"
    return "rows"


# The tile routine's work (csrc/paged_tile.cuh): a tile's tokens are cut at
# multiples of a segment, each merged over the block's warps and folded in
# order; a planner on the device lists the items (a tile, or one segment of
# a long tile whose state goes through a workspace slot) for persistent
# blocks.  The wrapper sizes the plan and the workspace.
PAGED_SPAN = 64            # tokens a stage of the tile routine holds
PAGED_PAIRS = 16           # (row, head) pairs a tile holds
PAGED_SEG_MIN = 512        # tokens a segment holds, at least
PAGED_MAX_SEGS = 8         # segments a table of W pages is cut into, at most
PAGED_WS_CAP = 16 << 20    # bytes of workspace a launch may use for segments
PAGED_MAX_ROWS = 8192      # rows the planner takes (its shared memory)


def paged_segments(W: int, page: int):
    """``(stages a segment, segments a table)`` of the tile routine for
    tables of ``W`` pages: 512-token segments, longer ones where a table
    holds more than ``PAGED_MAX_SEGS`` of them."""
    tokens = W * page
    stages = max(PAGED_SEG_MIN // PAGED_SPAN,
                 -(-tokens // (PAGED_MAX_SEGS * PAGED_SPAN)))
    return stages, -(-tokens // (stages * PAGED_SPAN))


def _tile_args(path, rows, n, nkv, d, W, page, device):
    """A K4 / K5 launch's plan and workspace, one int32 allocation to keep
    alive over the launch, and the arguments ``(seg_stages, segs, slots,
    plan, ws_ml, ws_o)``: the plan's counters and items (paged_tile.cuh:
    Args), then ``slots`` workspace slots of (m, l) and O
    for every segment of a tile, head pass and pair (as many as
    PAGED_WS_CAP holds)."""
    if path != "tile":
        return None, (0, 0, 0, None, None, None)
    if rows > PAGED_MAX_ROWS:
        raise ValueError(f"the tile routine plans at most {PAGED_MAX_ROWS} "
                         f"rows a launch, got {rows}")
    stages, segs = paged_segments(W, page)
    g = n // nkv
    x = nkv * -(-g // min(g, PAGED_PAIRS))
    slot = x * segs * PAGED_PAIRS   # pairs a slot holds
    slots = 0 if segs == 1 else min(rows,
                                    PAGED_WS_CAP // (4 * slot * (d + 2)))
    n_plan = 2 + x * slots + 8 * rows * segs
    n_ml = 2 * slots * slot
    buf = torch.empty(n_plan + n_ml + d * slots * slot, dtype=torch.int32,
                      device=device)
    p = buf.data_ptr()
    return buf, (stages, segs, slots, p, p + 4 * n_plan,
                 p + 4 * (n_plan + n_ml))


def paged_ragged_kernel(q, k_pool, v_pool, tables, table_index, positions,
                        horizons, *, scale: float,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """CUDA ragged paged attention (``csrc/paged_ragged.cu``, on the device
    routine :func:`paged_path` picks, recorded in
    ``paged_ragged_kernel.last_path``); same contract as
    ``ops.paged_attention.paged_attention_ragged``."""
    name = "paged_ragged_kernel"
    dev, page, nkv, d = _check_paged(name, q, k_pool, v_pool, (
        ("tables", tables), ("table_index", table_index),
        ("positions", positions), ("horizons", horizons)))
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{name}: q must be [R, 1, n, d], got "
                         f"{tuple(q.shape)}")
    R, _, n, _ = q.shape
    if tables.dim() != 2:
        raise ValueError(f"{name}: tables must be [T, max_pages]")
    for t_name, t in (("table_index", table_index), ("positions", positions),
                      ("horizons", horizons)):
        if t.dim() != 1 or t.shape[0] != R:
            raise ValueError(f"{name}: {t_name} must be [{R}], got "
                             f"{tuple(t.shape)}")
    out = torch.empty_like(q)
    if R == 0:
        return out
    path = paged_path(q.dtype, d)
    W = tables.shape[1]
    ws, segs = _tile_args(path, R, n, nkv, d, W, page, q.device)
    err = _library().paged_ragged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        table_index.data_ptr(), positions.data_ptr(), horizons.data_ptr(),
        out.data_ptr(), R, n, nkv, d, W, page, k_pool.shape[0], float(scale),
        _window(sliding_window), *segs, _DTYPES[q.dtype],
        PAGED_PATHS.index(path), dev, _stream(dev))
    if err:
        _launch_error(name, err)
    paged_ragged_kernel.launches += 1
    paged_ragged_kernel.last_path = path
    return out


def paged_decode_kernel(q, k_pool, v_pool, block_tables, positions, *,
                        scale: float,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """CUDA paged decode attention (``csrc/paged_decode.cu``, on K4's device
    routine for the same :func:`paged_path`, recorded in
    ``paged_decode_kernel.last_path``); same contract as
    ``ops.paged_attention.paged_attention_decode``."""
    name = "paged_decode_kernel"
    dev, page, nkv, d = _check_paged(name, q, k_pool, v_pool, (
        ("block_tables", block_tables), ("positions", positions)))
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{name}: q must be [b, 1, n, d], got "
                         f"{tuple(q.shape)}")
    b, _, n, _ = q.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block_tables must be [{b}, max_pages], "
                         f"got {tuple(block_tables.shape)}")
    if positions.dim() != 1 or positions.shape[0] != b:
        raise ValueError(f"{name}: positions must be [{b}], got "
                         f"{tuple(positions.shape)}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    path = paged_path(q.dtype, d)
    W = block_tables.shape[1]
    ws, segs = _tile_args(path, b, n, nkv, d, W, page, q.device)
    err = _library().paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(), b, n,
        nkv, d, W, page, k_pool.shape[0], float(scale),
        _window(sliding_window), *segs, _DTYPES[q.dtype],
        PAGED_PATHS.index(path), dev, _stream(dev))
    if err:
        _launch_error(name, err)
    paged_decode_kernel.launches += 1
    paged_decode_kernel.last_path = path
    return out


# K6's tile routine (csrc/paged_prefill_tile.cuh): a tile is 64 (row, head)
# pairs of one kv head; its walk over the context is cut at multiples of a
# segment, each segment one block, and the segments of a tile (at most
# PREFILL_MAX_SEGS: one cluster) fold through distributed shared memory.
# The wrapper sizes the segments from the shapes alone (never from
# ``start``: no host sync).
PREFILL_PAIRS = 64          # (row, head) pairs a tile holds: wgmma's m64
PREFILL_BLOCKS_PER_SM = 2   # blocks an SM holds (the sizing's target)
PREFILL_MAX_SEGS = 4        # segments a tile: the blocks of a cluster


class PrefillPlan(NamedTuple):
    """The segments of a K6 tile-path launch, from shapes alone:
    ``seg_stages`` 64-token stages a segment and ``segs`` segments a table
    (the blocks of a cluster)."""
    seg_stages: int
    segs: int


def prefill_tile_shape(g: int):
    """``(heads a pass, passes, chunk tokens a tile)`` of K6's tile routine
    for a GQA group of g heads (``paged_prefill_tile.cuh``: pass_heads,
    head_passes, tile_tokens): a tile is 64 (row, head) pairs of one kv
    head."""
    heads = min(g, PREFILL_PAIRS)
    return heads, -(-g // heads), PREFILL_PAIRS // heads


@functools.lru_cache(maxsize=1024)
def prefill_tile_plan(s: int, n: int, nkv: int, W: int, page: int,
                      sms: int) -> PrefillPlan:
    """The segments of a K6 tile-path launch on a card of ``sms`` SMs: a
    segment holds enough stages that one sequence's tiles x segments about
    fill the card (``PREFILL_BLOCKS_PER_SM`` blocks an SM), and at least
    ``1 / PREFILL_MAX_SEGS`` of the table.  The cuts, and with them a row's
    arithmetic, depend on the chunk's shapes and the table's width ``W``,
    not on the batch: a sequence gives the same bits alone and beside
    others at the same table width.  Cached: a launch looks its shapes up."""
    _, passes, tokens = prefill_tile_shape(n // nkv)
    tiles_a_seq = nkv * passes * -(-s // tokens)
    stages = -(-(W * page) // PAGED_SPAN)
    seg = max(-(-(tiles_a_seq * stages) // (PREFILL_BLOCKS_PER_SM * sms)),
              -(-stages // PREFILL_MAX_SEGS), 1)
    return PrefillPlan(seg, max(1, -(-stages // seg)))


def paged_prefill_kernel(q, k_pool, v_pool, block_tables, start, *,
                         scale: float,
                         sliding_window: Optional[int] = None) -> torch.Tensor:
    """CUDA chunked-prefill paged attention (``csrc/paged_prefill.cu``, on
    the device routine :func:`paged_path` picks, recorded in
    ``paged_prefill_kernel.last_path``); same contract as
    ``ops.paged_attention.paged_attention_prefill``."""
    name = "paged_prefill_kernel"
    dev, page, nkv, d = _check_paged(name, q, k_pool, v_pool, (
        ("block_tables", block_tables), ("start", start)))
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [b, s, n, d]")
    b, s, n, _ = q.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block_tables must be [{b}, kv_pages]")
    if start.dim() != 1 or start.shape[0] != b:
        raise ValueError(f"{name}: start must be [{b}]")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    path = paged_path(q.dtype, d)
    if path == "rows" and s > 65535:
        raise ValueError(f"{name}: at most 65535 tokens per chunk on the "
                         f"rows routine, got {s}")
    W = block_tables.shape[1]
    plan = (prefill_tile_plan(s, n, nkv, W, page, _sm_count(q.device))
            if path == "tile" else PrefillPlan(0, 0))
    err = _library().paged_prefill_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), start.data_ptr(), out.data_ptr(), b, s, n,
        nkv, d, W, page, k_pool.shape[0], float(scale),
        _window(sliding_window), plan.seg_stages, plan.segs,
        _DTYPES[q.dtype], PAGED_PATHS.index(path), dev, _stream(dev))
    if err:
        _launch_error(name, err)
    paged_prefill_kernel.launches += 1
    paged_prefill_kernel.last_path = path
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
    if tuple(t.shape) != (b, s, heads, d):
        raise ValueError(f"{name}: {t_name} must be [{b}, {s}, {heads}, {d}], "
                         f"got {tuple(t.shape)}")
    if not flash_rows_aligned(t):
        raise ValueError(
            f"{name}: {t_name} must have a contiguous last dimension, a "
            f"16-byte-aligned start and 16-byte strides, strides {t.stride()}")
    return [t.stride(0), t.stride(1), t.stride(2)]


def _check_flash(name, q, k, v, extra, segment_ids):
    """Validate q ``[b, sq, n, d]``, k / v ``[b, skv, nkv, d]`` and the
    ``extra`` tensors; returns (dims, strides, segment pointer, device
    index).  The device is checked last, so the type and layout checks
    also speak for tensors on the CPU."""
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in fp32/bf16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be [b, s, heads, d]")
    b, sq, n, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if nkv <= 0 or n % nkv:
        raise ValueError(
            f"{name}: {n} heads not divisible by {nkv} kv heads")
    dev = q.get_device()
    strides = _flash_strides(name, "q", q, b, sq, n, d)
    for t_name, t, s, h in (("k", k, skv, nkv), ("v", v, skv, nkv),
                            *((nm, t, sq, n) for nm, t in extra)):
        if t.get_device() != dev:
            raise ValueError(
                f"{name}: {t_name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(
                f"{name}: {t_name} dtype {t.dtype} != q dtype {q.dtype}")
        strides += _flash_strides(name, t_name, t, b, s, h, d)
    if not q.is_cuda:
        raise ValueError(f"{name}: q must be a CUDA tensor, got {q.device}")
    seg = None
    if segment_ids is not None:
        if sq != skv:
            raise ValueError(f"{name}: segment ids need sq == skv")
        if not (segment_ids.get_device() == dev
                and segment_ids.dtype == torch.int32
                and segment_ids.is_contiguous()
                and tuple(segment_ids.shape) == (b, sq)):
            raise ValueError(
                f"{name}: segment_ids must be a contiguous int32 [{b}, {sq}] "
                f"tensor on {q.device}")
        seg = segment_ids.data_ptr()
    return (b, sq, skv, n, nkv, d), strides, seg, dev


def _check_rows(name, t_name, t, b, n, sq):
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
            and t.numel() == b * n * sq):
        raise ValueError(
            f"{name}: {t_name} must be a contiguous fp32 [{b}, {n}, {sq}, 1] "
            f"CUDA tensor, got {t.dtype} {tuple(t.shape)}")


def _out_dtype(q, out_dtype):
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(
            f"out_dtype must be {q.dtype} or float32, got {out_dtype}")
    return out_dtype


def _flash_tail(dims, scale, causal, sliding_window, q, out_dtype):
    b, sq, skv, n, nkv, d = dims
    return (b, sq, skv, n, nkv, d, float(scale), int(bool(causal)),
            _window(sliding_window), _FLASH_DTYPES[q.dtype],
            int(out_dtype == torch.float32 and q.dtype != torch.float32))


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


def _ptr_or_null(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_fwd_kernel(q, k, v, segment_ids=None, *, scale: float,
                     causal: bool = True, sliding_window: Optional[int] = None,
                     out_dtype: Optional[torch.dtype] = None):
    """CUDA flash-attention forward (K1; ``csrc/flash_fwd_hopper.cu`` or
    ``csrc/flash_fwd.cu`` as :func:`flash_path` picks, recorded in
    ``flash_fwd_kernel.last_path``); same contract as
    ``ops.flash_attention.flash_fwd_plain``: returns ``(out [b, sq, n, d],
    lse [b, n, sq, 1] fp32)``."""
    name = "flash_fwd_kernel"
    dims, strides, seg, dev = _check_flash(name, q, k, v, (), segment_ids)
    b, sq, skv, n, nkv, d = dims
    out_dtype = _out_dtype(q, out_dtype)
    out = torch.empty((b, sq, n, d), device=q.device, dtype=out_dtype)
    lse = torch.empty((b, n, sq, 1), device=q.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    path = flash_path(q.dtype, d)
    geo, counter = _hopper_args(path, (q, k, v))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    err = _library().flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg, seg, out.data_ptr(),
        lse.data_ptr(), c_strides, geo, _ptr_or_null(counter),
        *_flash_tail(dims, scale, causal, sliding_window, q, out_dtype),
        FLASH_PATHS.index(path), dev, _stream(dev))
    if err:
        _launch_error(name, err)
    flash_fwd_kernel.launches += 1
    flash_fwd_kernel.last_path = path
    return out, lse


def _bwd_checks(name, q, k, v, do, lse, delta, segment_ids):
    checked = _check_flash(name, q, k, v, (("do", do),), segment_ids)
    b, sq, _, n, _, _ = checked[0]
    _check_rows(name, "lse", lse, b, n, sq)
    _check_rows(name, "delta", delta, b, n, sq)
    return checked


def _bwd_launch(name, entry, checked, q, k, v, do, lse, delta, outs, scale,
                causal, sliding_window, out_dtype):
    """Launch K2 (``entry`` flash_bwd_dq_launch) or K3 (flash_bwd_dkv_launch)
    into ``outs`` on the path :func:`flash_path` picks; returns the path."""
    dims, strides, seg, dev = checked
    path = flash_path(q.dtype, dims[-1])
    geo, counter = _hopper_args(path, (q, k, v, do))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    err = getattr(_library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg, seg,
        *(t.data_ptr() for t in outs), c_strides, geo, _ptr_or_null(counter),
        *_flash_tail(dims, scale, causal, sliding_window, q, out_dtype),
        FLASH_PATHS.index(path), dev, _stream(dev))
    if err:
        _launch_error(name, err)
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
    ``others`` tensors of x's shape and type; returns ``(rows, h, device
    index)``."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not in fp32/bf16/fp16")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [rows, h], got {tuple(x.shape)}")
    rows, h = x.shape
    if not 0 < h <= RMS_NORM_MAX_H:
        raise ValueError(f"{name}: hidden size {h} outside the kernels' range "
                         f"1...{RMS_NORM_MAX_H}")
    dev = x.get_device()
    if w.get_device() != dev:
        raise ValueError(f"{name}: w on {w.device}, x on {x.device}")
    if w.dtype != torch.float32 and w.dtype != x.dtype:
        raise ValueError(
            f"{name}: w dtype {w.dtype} must be float32 or x's {x.dtype}")
    if w.dim() != 1 or w.shape[0] != h:
        raise ValueError(f"{name}: w must be [{h}], got {tuple(w.shape)}")
    for t_name, t in others:
        if not (t.get_device() == dev and t.dtype == x.dtype
                and t.shape == x.shape):
            raise ValueError(
                f"{name}: {t_name} must match x ({x.dtype} {tuple(x.shape)} "
                f"on {x.device}), got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    for t_name, t in (("x", x), ("w", w), *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")
    return rows, h, dev


def rms_norm_fwd_kernel(x: torch.Tensor, w: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """CUDA fused RMSNorm forward (``csrc/rmsnorm.cu``, K7): ``y [rows, h]``
    in x's type; same contract as ``ops.rmsnorm.rms_norm_fwd_plain``."""
    rows, h, dev = _check_rms("rms_norm_fwd_kernel", x, w, ())
    y = torch.empty_like(x)
    if rows == 0:
        return y
    err = _library().rms_norm_fwd_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, h, eps,
        _DTYPES[x.dtype], _DTYPES[w.dtype], dev, _stream(dev))
    if err:
        _launch_error("rms_norm_fwd_kernel", err)
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
    rows, h, dev = _check_rms(name, x, w, (("g", g),))
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    chunk = _rms_norm_chunk_rows(rows, x.device)
    part = torch.empty((-(-rows // chunk), h), device=x.device,
                       dtype=torch.float32)
    err = _library().rms_norm_bwd_launch(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), rows, h, chunk, eps,
        _DTYPES[x.dtype], _DTYPES[w.dtype], dev, _stream(dev))
    if err:
        _launch_error(name, err)
    rms_norm_bwd_kernel.launches += 1
    return dx, dw


paged_ragged_kernel.launches = 0
paged_ragged_kernel.last_path = None
paged_decode_kernel.launches = 0
paged_decode_kernel.last_path = None
paged_prefill_kernel.launches = 0
paged_prefill_kernel.last_path = None
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
