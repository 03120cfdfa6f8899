"""Check and time the port's hand-written kernels on the card.

The port of ``tools/tpu_kernel_check.py`` (the hardware half of the kernel
tests) and of ``tools/mfu_sweep.py``'s ``rmsnorm_micro``.  The CPU tests
hold each kernel's plain PyTorch version against the JAX package; this
tool holds the kernels against those plain versions on the card and
times them:

    python -m megatron_llm_tpu_torch.tools.kernel_check [--quick]

Checks, in order (``--quick`` cuts the flash sweep to seq 1024 and 4096):

* numerics: flash attention (K1 forward, K2 dq, K3 dk / dv through
  ``ops.flash_attention.flash_attention``) against its plain versions in
  the JAX tool's eight cases, bf16;
* RMSNorm: fused RMSNorm (K7 forward, K8 backward through
  ``ops.rmsnorm.fused_rms_norm``) against its plain versions at
  ``(4, 1024, 2048)``, bf16 x and an fp32 weight;
* flash sweep: forward + backward time of K1-K3, of the port's dense
  attention and of PyTorch's ``scaled_dot_product_attention`` over
  sequence lengths; flash must beat the dense path at the longest;
* window: K1-K3 with a 256-token window at seq 8192 must take under
  half the time of full causal attention (masked tiles are skipped);
* long context: forward + backward at seq 32768 must fit;
* RMSNorm micro: K7 + K8 against the eager norm and ``F.rms_norm`` at
  ``(16, 1024, 1024)`` bf16, with the JAX micro's verdict on wiring the
  fused kernels into the model;
* RMSNorm at the model's shapes: K7, K8, their plain versions and ``F.rms_norm`` at
  the model's shapes (a train sequence ``[4096, 4096]``, a serve tick
  ``[80, 4096]``), with the host's µs a launch;
* K7's launch stages: the host µs a call of each stage of K7's launch at
  the serve-tick shape (checks, allocation, device, stream, the ctypes
  call), beside the whole wrapper and ``F.rms_norm``.

Prints one ``PASS`` / ``FAIL`` line per check and the timing tables;
:func:`main` returns 0 iff every check passes.  It runs on the card only:
without CUDA it raises (there is no kernel to check on the CPU).  Times
are CUDA-event times of back-to-back calls (:func:`cuda_ms`): what a
caller pays, the host's time where the host takes longer than the card.
The RMSNorm tables add the kernels' device time (:func:`device_ms`),
which the host does not hide.  ``chip_smoke.py`` times the kernels with
the same two functions and bounds them with :func:`bound`.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from megatron_llm_tpu_torch.ops import norms
from megatron_llm_tpu_torch.ops.attention import (
    make_attention_bias,
    xla_attention,
)
from megatron_llm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
    flash_delta,
    flash_fwd_plain,
)
from megatron_llm_tpu_torch.ops.rmsnorm import (
    fused_rms_norm,
    rms_norm_bwd,
    rms_norm_bwd_plain,
    rms_norm_fwd,
    rms_norm_fwd_plain,
)
from megatron_llm_tpu_torch.utils.device import resolve_device

FAILURES: List[str] = []
# H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, dense operations/s by type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# Flash agreement in bf16, the bars chip_smoke.py holds the training path's
# kernels to: elementwise atol = rtol = 2e-2 (bf16 output rounding) and a
# norm-relative error of at most 1e-2 per output (the kernels round P and
# dS to bf16 before their products).
FLASH_TOL = 2e-2
FLASH_NORM_REL = 1e-2

# RMSNorm agreement.  Both sides do fp32 math and round once, so:
# fp32 outputs (y, dx) within RMS_FP32_ATOL (the row sums' order);
# bf16 / fp16 outputs within one step of their type at the larger of the
# two magnitudes, plus RMS_FP32_ATOL for the fp32 values they round (which
# matters only where dx's two terms cancel to far below them);
# dw in fp32 within RMS_DW_NORM_REL norm-relative (the sum over rows in
# another order).
RMS_FP32_ATOL = 1e-5
RMS_DW_NORM_REL = 1e-5

# name, b, s, n, nkv, d, window, segmented, causal (the JAX tool's cases)
NUMERICS_CASES = [
    ("causal", 2, 1024, 8, 8, 128, None, False, True),
    ("gqa4", 2, 1024, 8, 2, 128, None, False, True),
    ("sliding256", 1, 2048, 4, 4, 128, 256, False, True),
    ("segments", 1, 1024, 4, 4, 128, None, True, True),
    ("gqa_sliding", 1, 2048, 8, 2, 128, 512, False, True),
    ("d256", 1, 2048, 4, 4, 256, None, False, True),
    ("bidir", 2, 1024, 8, 8, 128, None, False, False),
    ("bidir_segments", 1, 1024, 4, 4, 128, None, True, False),
]
EPS = 1e-6   # the RMSNorm epsilon of every check and timing
RMSNORM_SHAPE = (4, 1024, 2048)
MICRO_SHAPE = (16, 1024, 1024)
MODEL_SHAPES = {"train sequence": (4096, 4096), "serve tick": (80, 4096)}
HOST_CALLS = 200   # calls a host_us reading takes where the card is slower
SWEEP = dict(b=4, n=16, d=128)


def check(name: str, ok: bool, detail: str = "") -> None:
    line = f"{'PASS' if ok else 'FAIL'} {name}"
    if detail:
        line += f"  ({detail})"
    print(line, flush=True)
    if not ok:
        FAILURES.append(name)


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _randn(shape, gen, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------


def norm_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.detach().float(), ref.detach().float()
    return float(torch.linalg.vector_norm(a - ref)
                 / torch.linalg.vector_norm(ref).clamp_min(1e-30))


def flash_close(a: torch.Tensor, ref: torch.Tensor):
    """``(ok, max abs err, norm-relative err)`` of a flash output against
    its plain version under the bf16 bars."""
    a, ref = a.detach().float(), ref.detach().float()
    err = (a - ref).abs()
    rel = norm_rel(a, ref)
    ok = (bool((err <= FLASH_TOL + FLASH_TOL * ref.abs()).all())
          and bool(torch.isfinite(a).all()) and rel <= FLASH_NORM_REL)
    return ok, float(err.max()), rel


def rms_close(a: torch.Tensor, ref: torch.Tensor):
    """``(ok, max abs err)`` of an RMSNorm output (y, dx, or a dw in bf16 /
    fp16) against its plain version (the rules above)."""
    af, rf = a.detach().float(), ref.detach().float()
    err = (af - rf).abs()
    lim = torch.full_like(err, RMS_FP32_ATOL)
    if a.dtype != torch.float32:
        fi = torch.finfo(a.dtype)
        mag = torch.maximum(af.abs(), rf.abs()).clamp_min(fi.tiny)
        lim += torch.exp2(torch.floor(torch.log2(mag))) * fi.eps
    ok = (a.dtype == ref.dtype and a.shape == ref.shape
          and bool(torch.isfinite(af).all()) and bool((err <= lim).all()))
    return ok, float(err.max())


def rms_dw_close(a: torch.Tensor, ref: torch.Tensor):
    """``(ok, max abs err, norm-relative err)`` of dw: fp32 by its
    norm-relative error, bf16 / fp16 as :func:`rms_close`."""
    rel = norm_rel(a, ref)
    if a.dtype != torch.float32:
        return (*rms_close(a, ref), rel)
    ok = (a.dtype == ref.dtype and bool(torch.isfinite(a).all())
          and rel <= RMS_DW_NORM_REL)
    return ok, float((a - ref).detach().abs().max()), rel


# ---------------------------------------------------------------------------
# timing and bounds (the card only)
# ---------------------------------------------------------------------------


def cuda_ms(fn: Callable[[], object], iters: int = 20,
            warmup: int = 3) -> float:
    """ms a call of ``iters`` back-to-back calls, timed by CUDA events: the
    device's time or the host's, whichever is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn: Callable[[], object], iters: int = 10,
              warmup: int = 2) -> float:
    """ms of CUDA work a call: the device time that ``iters`` calls
    launch, summed from ``torch.profiler``'s trace.  Gaps in which the card
    waits for the host are not counted, so a small kernel whose wrapper
    takes longer on the host than the kernel on the card is timed by the
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # now and then the profiler records no device activity at all (twice
    # running, in one of four runs of the smoke test on an H100): a few more
    # windows before that is an error
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
                 for ev in prof.key_averages()
                 if str(getattr(ev, "device_type", "")).endswith("CUDA"))
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device time")


def host_us(fn: Callable[[], object], n: int = 10000,
            warmup: int = 20) -> float:
    """Host µs a call of ``n`` back-to-back calls by ``time.perf_counter_ns``,
    with no synchronisation inside: what the caller's thread spends to
    enqueue a call, not what the card spends on it.  Keep ``n`` times the
    launches a call makes under CUDA's queue of pending launches
    (about a thousand) where the card is the slower, or the host waits on
    the queue and the time is the card's."""
    import time

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / n / 1e3


def bound(nbytes: float, flops: float, dtype: str):
    """``(ms, "bytes" or "operations")``: the least time the card could
    take, bytes over the memory rate or operations over the peak rate of
    the type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_flops(b, s, n, d, causal=True) -> float:
    """QK^T and PV of the forward (the JAX tool's count)."""
    f = 2 * 2 * b * n * s * s * d
    return f / 2 if causal else f


def _fwd_bwd(fn, leaves, do):
    """A closure running ``fn`` forward and backward into fresh grads."""
    return lambda: torch.autograd.grad(fn(*leaves), leaves, do)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def numerics_checks(dev: torch.device) -> None:
    """K1-K3 through the autograd Function against the plain versions,
    forward and dq / dk / dv, in bf16."""
    for name, b, s, n, nkv, d, window, segmented, causal in NUMERICS_CASES:
        gen = _gen(dev, 17)
        q = _randn((b, s, n, d), gen, torch.bfloat16)
        k = _randn((b, s, nkv, d), gen, torch.bfloat16)
        v = _randn((b, s, nkv, d), gen, torch.bfloat16)
        do = _randn((b, s, n, d), gen, torch.bfloat16)
        seg = None
        if segmented:
            seg = (torch.arange(s, device=dev)[None, :] >= s // 3).to(
                torch.int32).expand(b, s).contiguous()
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, causal=causal, sliding_window=window,
                              segment_ids=seg)
        grads = torch.autograd.grad(out, leaves, do)
        kw = dict(scale=1.0 / d ** 0.5, causal=causal, sliding_window=window)
        r_out, lse = flash_fwd_plain(q, k, v, seg, seg, **kw)
        delta = flash_delta(r_out, do)
        refs = (flash_bwd_dq_plain(q, k, v, do, lse, delta, seg, seg, **kw),
                *flash_bwd_dkv_plain(q, k, v, do, lse, delta, seg, seg, **kw))
        ok, err, rel = flash_close(out, r_out)
        check(f"flash fwd {name}", ok, f"max_err={err:.2e} norm_rel={rel:.2e}")
        for gname, a, r in zip(("dq", "dk", "dv"), grads, refs):
            ok, err, rel = flash_close(a, r)
            check(f"flash bwd {name} {gname}", ok,
                  f"max_err={err:.2e} norm_rel={rel:.2e}")
        del q, k, v, do, leaves, out, grads, r_out, lse, delta, refs
        _free(dev)


def rmsnorm_check(dev: torch.device) -> None:
    """K7 / K8 through ``fused_rms_norm`` against the plain versions: bf16
    x, fp32 w = 0.1 N(0, 1) + 1, a random upstream gradient."""
    gen = _gen(dev, 3)
    shape = RMSNORM_SHAPE
    x = _randn(shape, gen, torch.bfloat16)
    w = _randn((shape[-1],), gen) * 0.1 + 1.0
    g = _randn(shape, gen, torch.bfloat16)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fused_rms_norm(xl, wl, EPS)
    dx, dw = torch.autograd.grad(y, (xl, wl), g)
    r_dx, r_dw = rms_norm_bwd_plain(x, w, g, EPS)
    ok, err = rms_close(y, rms_norm_fwd_plain(x, w, EPS))
    check("rmsnorm fwd", ok, f"max_err={err:.2e}")
    ok, err = rms_close(dx, r_dx)
    check("rmsnorm bwd dx", ok, f"max_err={err:.2e}")
    ok, err, rel = rms_dw_close(dw, r_dw)
    check("rmsnorm bwd dw", ok, f"max_err={err:.2e} norm_rel={rel:.2e}")
    del x, w, g, xl, wl, y, dx, dw, r_dx, r_dw
    _free(dev)


def _flash_time(dev, s, window=None, b=None, n=None, nkv=None, d=None):
    """Forward + backward ms of K1-K3 at ``[b, s, n, d]`` bf16, causal."""
    b = b or SWEEP["b"]
    n = n or SWEEP["n"]
    d = d or SWEEP["d"]
    gen = _gen(dev, 5)
    leaves = [_randn((b, s, h, d), gen, torch.bfloat16).requires_grad_(True)
              for h in (n, nkv or n, nkv or n)]
    do = _randn((b, s, n, d), gen, torch.bfloat16)
    return cuda_ms(_fwd_bwd(
        lambda q, k, v: flash_attention(q, k, v, causal=True,
                                        sliding_window=window), leaves, do),
        iters=3)


def flash_sweep(dev: torch.device, quick: bool = False) -> None:
    """Forward + backward time over sequence lengths: K1-K3, the port's
    dense attention (``ops.attention.xla_attention``, the JAX tool's "xla"
    column) and ``scaled_dot_product_attention``."""
    b, n, d = SWEEP["b"], SWEEP["n"], SWEEP["d"]
    seqs = [1024, 4096] if quick else [1024, 2048, 4096, 8192]
    print(f"\n-- flash fwd+bwd, ms a step: b {b}, {n} heads, d {d}, "
          f"causal, bf16 (TFLOP/s = 3 x forward matmul flops over the "
          f"time) --")
    print(f"{'seq':>6} {'flash':>9} {'dense':>9} {'sdpa':>9} "
          f"{'flash TF/s':>11} {'sdpa TF/s':>10}", flush=True)
    rows = {}
    for s in seqs:
        gen = _gen(dev, 5)
        leaves = [_randn((b, s, n, d), gen, torch.bfloat16).requires_grad_(
            True) for _ in range(3)]
        do = _randn((b, s, n, d), gen, torch.bfloat16)
        t_flash = cuda_ms(_fwd_bwd(
            lambda q, k, v: flash_attention(q, k, v, causal=True), leaves,
            do), iters=3)
        try:
            bias = make_attention_bias(s, device=dev)
            t_dense = cuda_ms(_fwd_bwd(
                lambda q, k, v: xla_attention(q, k, v, bias=bias), leaves,
                do), iters=2)
        except torch.cuda.OutOfMemoryError:
            t_dense = None
        bias = None
        _free(dev)
        heads_first = [t.detach().transpose(1, 2).contiguous().requires_grad_(
            True) for t in leaves]
        t_sdpa = cuda_ms(_fwd_bwd(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
            heads_first, do.transpose(1, 2).contiguous()), iters=3)
        flops = 3 * attention_flops(b, s, n, d)
        rows[s] = (t_flash, t_dense, t_sdpa)
        dense = "OOM" if t_dense is None else f"{t_dense:.3f}"
        print(f"{s:>6} {t_flash:>9.3f} {dense:>9} {t_sdpa:>9.3f} "
              f"{flops / t_flash / 1e9:>11.1f} {flops / t_sdpa / 1e9:>10.1f}",
              flush=True)
        del leaves, do, heads_first
        _free(dev)
    s = seqs[-1]
    t_flash, t_dense, _ = rows[s]
    check("flash beats the dense path at the longest seq",
          t_dense is None or t_flash <= t_dense,
          f"flash {t_flash:.3f} ms vs dense "
          f"{'OOM' if t_dense is None else f'{t_dense:.3f} ms'} @ seq {s}")


def window_check(dev: torch.device) -> None:
    """A 256-token window at seq 8192 must take under half the time of
    full causal attention: the kernels skip the tiles the window masks."""
    s, w = 8192, 256
    t_full = _flash_time(dev, s)
    t_win = _flash_time(dev, s, window=w)
    _free(dev)
    check("sliding window skips masked tiles", t_win < 0.5 * t_full,
          f"window {w}: {t_win:.3f} ms vs full causal {t_full:.3f} ms "
          f"(x{t_win / t_full:.3f}) @ seq {s}")


def long_context_fit(dev: torch.device) -> None:
    """Forward + backward through K1-K3 at seq 32768 (b 1, 8 / 2 heads,
    d 128) must fit on the card."""
    b, s, n, nkv, d = 1, 32768, 8, 2, 128
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t = _flash_time(dev, s, b=b, n=n, nkv=nkv, d=d)
    except torch.cuda.OutOfMemoryError as e:
        check("32K-seq fwd+bwd fits", False, f"OutOfMemoryError: {e}")
        _free(dev)
        return
    flops = 3 * attention_flops(b, s, n, d)
    check("32K-seq fwd+bwd fits", True,
          f"{t:.3f} ms, {flops / t / 1e9:.1f} TFLOP/s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    _free(dev)


def rmsnorm_micro(dev: torch.device) -> None:
    """Fused (K7 + K8) against the eager norm the model runs and
    ``F.rms_norm``, forward + backward at ``(16, 1024, 1024)`` bf16 with a
    bf16 weight of ones, the best of three CUDA-event timings, and the
    verdict of ``tools/mfu_sweep.py`` on those times."""
    gen = _gen(dev, 0)
    x = _randn(MICRO_SHAPE, gen, torch.bfloat16)
    w = torch.ones(MICRO_SHAPE[-1], device=dev, dtype=torch.bfloat16)
    g = _randn(MICRO_SHAPE, gen, torch.bfloat16)
    leaves = [x.requires_grad_(True), w.requires_grad_(True)]
    h = MICRO_SHAPE[-1]
    ways = {
        "fused K7+K8": lambda a, b: fused_rms_norm(a, b, EPS),
        "eager ops.norms.rms_norm": lambda a, b: norms.rms_norm(a, b, EPS),
        "F.rms_norm": lambda a, b: F.rms_norm(a, (h,), b, EPS),
    }
    us = {}
    for name, fn in ways.items():
        step = _fwd_bwd(fn, leaves, g)
        us[name] = (1e3 * min(cuda_ms(step) for _ in range(3)),
                    1e3 * device_ms(step))
    fused, eager = us["fused K7+K8"][0], us["eager ops.norms.rms_norm"][0]
    verdict = ("wire the fused kernels (K7/K8) into the model path"
               if fused < 0.95 * eager else
               "the eager norm wins or ties - keep the eager path")
    print(f"\n-- rmsnorm micro: {MICRO_SHAPE} bf16, fwd+bwd: us a step, "
          f"back to back (device us a step) --", flush=True)
    for name, (ev_us, dev_us) in us.items():
        print(f"  {name:26s} {ev_us:9.1f} ({dev_us:.1f})", flush=True)
    print(f"  fused / eager {fused / eager:.3f}: {verdict}", flush=True)
    del x, w, g, leaves
    _free(dev)


def rmsnorm_work(rows: int, h: int, x_dtype: torch.dtype,
                 w_dtype: torch.dtype):
    """``{"K7": (bytes, flops), "K8": (bytes, flops)}``: every input read
    once, every output written once; fp32 operations an element (K7: x^2,
    its sum, x * r * w; K8: x^2, x * g * w and their sums, g * x * r and its
    sum, r * g * w - x * r^3 * mean)."""
    xe = rows * h * torch.finfo(x_dtype).bits // 8
    we = h * torch.finfo(w_dtype).bits // 8
    return {"K7": (2 * xe + we, 4.0 * rows * h),
            "K8": (3 * xe + 2 * we, 12.0 * rows * h)}


def rmsnorm_times(dev: torch.device, rows: int, h: int,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """K7 and K8 at ``[rows, h]`` with a weight of the same type:
    ``ms`` (the kernel), ``plain_ms`` and ``library_ms`` (``F.rms_norm``
    forward; its backward as forward + backward less forward) in CUDA-event
    ms, each kernel / plain pair the better of two timings taken in turns
    (plain, kernel, kernel, plain); the kernel's ``device_ms``; its host
    µs a launch ``host_us`` (:func:`host_us`; K7 also ``F.rms_norm``'s,
    ``library_host_us``); and its ``bytes``, ``flops``, ``bound_ms`` and
    ``bound_by``."""
    gen = _gen(dev, 11)
    x = _randn((rows, h), gen, dtype)
    w = _randn((h,), gen) * 0.1 + 1.0
    w = w.to(dtype)
    g = _randn((rows, h), gen, dtype)
    pairs = {
        "K7": (lambda: rms_norm_fwd(x, w, EPS),
               lambda: rms_norm_fwd_plain(x, w, EPS)),
        "K8": (lambda: rms_norm_bwd(x, w, g, EPS),
               lambda: rms_norm_bwd_plain(x, w, g, EPS)),
    }
    out = {}
    for name, (ker, plain) in pairs.items():
        # 100 calls a reading: at the serve tick both K7 and F.rms_norm are
        # host-bound, and 20 calls left host jitter in the comparison
        p1, k1, k2, p2 = (cuda_ms(f, iters=100) for f in (plain, ker, ker,
                                                           plain))
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         device_ms=device_ms(ker, iters=20),
                         host_us=host_us(ker, n=HOST_CALLS))
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]

    def lib_fwd():
        with torch.no_grad():
            return F.rms_norm(x, (h,), w, EPS)

    lib_both = _fwd_bwd(lambda a, b: F.rms_norm(a, (h,), b, EPS), leaves, g)
    t_fwd = min(cuda_ms(lib_fwd, iters=100) for _ in range(2))
    t_both = min(cuda_ms(lib_both, iters=100) for _ in range(2))
    out["K7"]["library_ms"] = t_fwd
    out["K7"]["library_host_us"] = host_us(lib_fwd, n=HOST_CALLS)
    out["K8"]["library_ms"] = t_both - t_fwd
    for name, (nbytes, flops) in rmsnorm_work(rows, h, dtype, dtype).items():
        b_ms, b_by = bound(nbytes, flops, "float32")
        out[name].update(bytes=nbytes, flops=flops, bound_ms=b_ms,
                         bound_by=b_by)
    del x, w, g, leaves
    _free(dev)
    return out


def rmsnorm_shapes(dev: torch.device) -> None:
    """K7 / K8 beside their plain versions and ``F.rms_norm`` at the
    model's shapes, bf16."""
    print("\n-- rmsnorm at the model's shapes, bf16 x and w: ms back to back "
          "(the kernel's device ms; the bound and its share of the device "
          "ms) --", flush=True)
    print(f"{'shape':>22} {'kernel':>9} {'device':>8} {'bound':>8} "
          f"{'share':>6} {'plain':>9} {'F.rms_norm':>10} {'host us':>8} "
          f"{'F host us':>9}", flush=True)
    for label, (rows, h) in MODEL_SHAPES.items():
        t = rmsnorm_times(dev, rows, h)
        for name in ("K7", "K8"):
            r = t[name]
            print(f"{name + ' ' + label:>22} {r['ms']:>9.4f} "
                  f"{r['device_ms']:>8.4f} {r['bound_ms']:>8.4f} "
                  f"{r['bound_ms'] / r['device_ms']:>6.1%} "
                  f"{r['plain_ms']:>9.4f} {r['library_ms']:>10.4f} "
                  f"{r['host_us']:>8.2f} "
                  f"{r.get('library_host_us', float('nan')):>9.2f}",
                  flush=True)


def rmsnorm_launch_stages(dev: torch.device, n: int = 10000) -> dict:
    """Host µs a call of each stage of K7's launch at the serve-tick shape
    (``MODEL_SHAPES["serve tick"]``, bf16 x and w), by :func:`host_us`: the
    wrapper's checks, the output's allocation, two ways each to enter the
    tensor's device, to name PyTorch's current stream and to hand the
    pointers to ctypes, the whole wrapper, ``ops.rmsnorm.rms_norm_fwd``
    (what the K7 rows time) and ``F.rms_norm``.  Prints the table and
    returns it."""
    import ctypes

    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.ops.kernels import build

    rows, h = MODEL_SHAPES["serve tick"]
    gen = _gen(dev, 13)
    x = _randn((rows, h), gen, torch.bfloat16)
    w = (_randn((h,), gen) * 0.1 + 1.0).to(torch.bfloat16)
    y = torch.empty_like(x)
    idx = x.get_device()
    fn = build.library().rms_norm_fwd_launch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    st = torch.cuda.current_stream(dev).cuda_stream
    c_ptr = ctypes.c_void_p

    def enter_device():
        with torch.cuda.device(x.device):
            pass

    stages = {
        "checks (kernels._check_rms)":
            lambda: kernels._check_rms("rms_norm_fwd_kernel", x, w, ()),
        "allocation (torch.empty_like)": lambda: torch.empty_like(x),
        "device: with torch.cuda.device": enter_device,
        "device: x.get_device()": lambda: x.get_device(),
        "stream: torch.cuda.current_stream": lambda: c_ptr(
            torch.cuda.current_stream(x.device).cuda_stream),
        "library: build.library()": build.library,
        "ctypes call, c_void_p objects": lambda: fn(
            c_ptr(x.data_ptr()), c_ptr(w.data_ptr()), c_ptr(y.data_ptr()),
            rows, h, EPS, 1, 1, idx, c_ptr(st)),
        "ctypes call, plain ints": lambda: fn(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, h, EPS, 1, 1, idx,
            st),
        "wrapper (kernels.rms_norm_fwd_kernel)":
            lambda: kernels.rms_norm_fwd_kernel(x, w, EPS),
        "K7 as timed (ops.rmsnorm.rms_norm_fwd)":
            lambda: rms_norm_fwd(x, w, EPS),
        "F.rms_norm": lambda: F.rms_norm(x, (h,), w, EPS),
    }
    if raw is not None:
        stages["stream: torch._C._cuda_getCurrentRawStream"] = (
            lambda: raw(idx))
    out = {name: host_us(f, n) for name, f in stages.items()}
    print(f"\n-- K7's launch, host us a call over {n} calls at "
          f"[{rows}, {h}] bf16 (perf_counter, no sync inside) --", flush=True)
    for name, us in out.items():
        print(f"  {name:46s} {us:8.2f}", flush=True)
    del x, w, y
    _free(dev)
    return out


def _free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


CHECKS = (numerics_checks, rmsnorm_check, flash_sweep, window_check,
          long_context_fit, rmsnorm_micro, rmsnorm_shapes,
          rmsnorm_launch_stages)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="sweep seq 1024 and 4096 only")
    args = ap.parse_args(argv)
    dev = resolve_device(None)   # the card; raises without CUDA
    # the plain versions' fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({kind})", flush=True)
    FAILURES.clear()
    for run in CHECKS:
        if run is flash_sweep:
            run(dev, quick=args.quick)
        else:
            run(dev)
    print(f"\n{len(FAILURES)} failures"
          + (f": {FAILURES}" if FAILURES else ""), flush=True)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
