#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``megatron_llm_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as the checks run it
    python3 chip_smoke.py --phases build,kernels,train,train-check
    python3 chip_smoke.py --phases build,kernels,spec   # speculative slice
    python3 chip_smoke.py --phases build,kernels,kernel-check   # K7 / K8
    python3 chip_smoke.py --profile       # + a serve burst under the profiler

Phases:

1. ``build``: print the card's name and power limit, build the CUDA
   kernels from ``megatron_llm_tpu_torch/ops/kernels/csrc``.
2. ``kernels``: hold each kernel against its plain PyTorch version on the
   card.  Paged attention (K4 ragged, K5 decode, K6 prefill) at the
   serving path's shapes (Llama-2-7B attention: 32 heads, head_dim 128,
   page 16, contexts up to 2048, live and dead rows), a GQA 32/8 shape, a
   sliding-window case and the TinyLlama draft's GQA 32/4 at head_dim 64,
   in fp32 (atol 1e-5) and bf16 (atol = rtol = 1e-2), and a speculative
   verify tick (8 slots x 5 rows on their tables, the chunk, dead rows);
   dead rows must be exact zeros, K5 must equal K4 bitwise on the same
   rows, K4 / K5 must have run the routine ``paged_path`` names (bf16: the
   tensor-core tile routine, ``csrc/paged_tile.cuh``; fp32: attend_row),
   and each live row's K4 output must be bitwise the same run alone and in
   a permuted tick; K6 must run the routine ``paged_path`` names (bf16:
   ``csrc/paged_prefill_tile.cuh``) and give the same bits on two
   launches.  K6 is timed (bf16) on the mixed tick's chunk and, through
   ``tools/prefill_shapes.py``, on the serve burst's log-prob chunks at
   0-192, a chunk at 3968, GQA 32/8 and the draft's 32/4 heads at d 64,
   each held to its plain version elementwise and by norm, with a planted
   scale fault that must fail the norm bar; the serve burst's K6 launches
   are priced at the end.  K4 is also timed on the mixed tick's 8 decode rows
   alone, on a decode-only tick (8 x 2048), on the verify tick and on the
   serve burst's two tick kinds (its 8 prompts half-way through their new
   tokens, alone and beside a 64-row chunk), each beside its bound (each
   page once).  Flash
   attention (K1 forward, K2 dq, K3 dk/dv) at the
   training shape (b 1, seq 4096, 32 heads, head_dim 128, causal), GQA
   32/8, a 100-token window, two packed documents, bidirectional,
   head_dim 64 / 256 at seq 1024, the ragged ends of K1's 128-row tiles
   (seq 1000 and 77, GQA 32/8, documents) and q / k / v sliced from one
   fused qkv buffer (seq 2048), in fp32 (out and lse atol 1e-5, grads
   atol = rtol = 1e-4: summation order) and with bf16 inputs, once with
   bf16 and once with fp32 outputs (lse atol 1e-5; every other output
   within 1e-2 norm-relative error and atol = rtol = 2e-2: the kernels
   round P and dS to bf16 before their products).  bf16 K1-K3 at head_dim
   64 / 128 run the Hopper kernels (``csrc/flash_fwd_hopper.cu``,
   ``csrc/flash_bwd_hopper.cu``; each row of the ``kernels`` line names
   its ``path``), fp32 and head_dim 256 the shared-memory ones.  Each of
   K1-K3 run with its softmax scale 10% off must fail the bf16 check.
   Fused RMSNorm (K7 forward, K8 backward) at h 2048, 4096 and 4100 (the
   scalar path), row
   counts that K8's chunks do and do not divide, with fp32 x and w, bf16
   x with an fp32 w, and bf16 x and w, under the kernel-check tool's bars
   (fp32 y / dx atol 1e-5, dw norm-relative 1e-5; bf16 one step of the
   type); K8's dw and dx bitwise the same on a second run; K7 / K8 with an
   eps of 0.2 (r about 10% off) must fail the bf16 check.  Times every
   kernel and its plain version with CUDA events, its host time a launch
   (``host_us``: perf counter over back-to-back calls, no sync inside), and
   as the yardstick PyTorch's ``scaled_dot_product_attention`` forward and
   backward for K1-K3 and ``torch.nn.functional.rms_norm`` for K7 / K8 (K7
   also at the kernel-check tool's serve-tick shape ``[80, 4096]``), and
   each
   kernel's device time (``torch.profiler``, ``device_ms`` in the
   ``kernels`` line): where a wrapper takes longer on the host than its
   kernel on the card, back to back the event time is the host's.  K1-K3
   and SDPA are timed again at head_dim 64 (the ``d64_*`` keys of their
   rows).  The timers and the bound are the kernel-check tool's.
3. ``kernel-check``: the port's kernel-check tool
   (``megatron_llm_tpu_torch.tools.kernel_check.main([])``, in-process,
   a few seconds on an H100): flash numerics in the JAX tool's eight cases, the RMSNorm
   check through ``fused_rms_norm``, the flash sequence sweep against the
   dense path and SDPA, the sliding-window skip, the 32K-sequence fit, the
   RMSNorm micro and the RMSNorm times at the model's shapes.  Every check
   must pass, and K1, K2, K3, K7 and K8 (counters set to 0 just before)
   must each have launched.
4. ``serve``: start the port's server in-process on an ephemeral port
   (``--model_name llama2-7b``, full width and depth, bf16 random weights
   from a seed, NullTokenizer) and send concurrent ``PUT /api`` requests:
   greedy, one sampled with a seed, one with ``logprobs``.  Every answer
   must be 200 with the right lengths, and both paged kernels' launch
   counters (set to 0 just before) must be > 0 after, K4 and K6 on the
   tile routine; the K4 launches are split into ticks that carried prefill rows
   and decode-only ticks (counted on the host from the engine's tick plan)
   and priced apart at the end.  With ``--profile`` a
   second burst of fresh greedy prompts runs under ``torch.profiler``
   and the device's busy share, the top device kernels and the top host
   operators are printed.
5. ``tick``: one ragged tick of the same model (decode rows plus a 64-row
   prefill chunk) twice on the same inputs — through the kernels, and
   through the plain versions (``use_kernel=False``); the logits must agree
   within 5e-2 * max|logit| (bf16 rounding over 32 layers).
6. ``spec``: speculative decoding.  (a) fp32 at Llama-2-7B width and 4
   layers (TF32 off): engines at ``spec_k=4`` and ``spec_k=0`` on the same
   greedy prompts must give identical tokens and log-probs within 1e-4,
   with an independent 1-layer draft (acceptance about 0: the correction
   path) and with an identity pair (a 2-layer draft, the target its
   extension to 4 layers; acceptance >= 0.99).  (b) bf16 at full depth:
   the target is the identity extension of a 2-layer draft; the serve
   phase's burst goes through the port's server at ``spec_k=4``
   (adaptive), then through a ``spec_k=0`` engine on the same target.
   Every answer 200 with its lengths, K5, K4 and K6 launched (counters set
   to 0 just before), K4 and K6 on the tile routine, acceptance >= 0.9;
   prints ticks, tokens a tick, wall time and decode tokens/s of both.  (c) a TinyLlama-shaped draft (22
   layers, hidden 2048, 32/4 heads: K5 at g 8, d 64) on the same target,
   one greedy burst: every answer 200, K5 launched, K4 on the tile
   routine.
7. ``train``: the port's training entry point
   (``megatron_llm_tpu_torch.finetune.main``) on Llama-2-7B at full width
   cut to 8 of its 32 layers, seq 4096, micro batch 1,
   global batch 4 (4 microbatches accumulate), bf16 compute over fp32
   master weights, selective recompute, AdamW; 12 iterations over an
   indexed dataset of random documents drawn from 300 token ids, written
   from ``--seed`` into a temporary directory, then one validation batch
   outside the timed window.  Every loss must be finite, the last at least
   1 nat below the first, and K1, K2 and K3 (counters set to 0 just
   before) must each have launched on the Hopper kernels, K2 and K3 384
   times (8 layers x 4 microbatches x 12 steps), K1 768 (twice that:
   selective recompute).  Prints the steady step time,
   tokens/s and MFU against 989 TFLOP/s.
8. ``train-check``: one train step of the same model at 2 layers and seq
   2048, on the same weights and batch, through the flash kernels and
   through the plain attention path (``--use_flash_attn false``), in bf16
   and with fp32 weights and compute: the loss, the gradient norm and each
   layer's attention gradient norms within ``TRAIN_CHECK_TOL``; the same
   step with K1's softmax scale 10% off must fall outside them.

Prints the ``{"kernels": [...]}`` line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result line, when a phase fails or there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

PHASES = ("build", "kernels", "kernel-check", "serve", "tick", "spec",
          "train", "train-check")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


class RaggedCase:
    """A ragged tick's attention inputs: one slot a context, each with
    ``verify_rows`` rows on its own table (a decode row at position ctx - 1,
    or a speculative verify's K + 1 rows at ctx - K - 1 .. ctx - 1), one
    prefill chunk of ``chunk`` rows sharing one table, and ``n_dead`` dead
    rows (null table, horizon 0)."""

    def __init__(self, torch, gen, dev, dtype, *, n, nkv, d=128, page=16,
                 contexts, chunk_start, chunk=64, n_dead=8, window=None,
                 verify_rows=1):
        self.n, self.nkv, self.d, self.page = n, nkv, d, page
        self.window = window
        W = 2048 // page
        tables = [[0] * W]
        next_page = 1
        rows_tbl, rows_pos, rows_hor = [], [], []
        for ctx in contexts:          # a slot's rows: the last at ctx - 1
            npg = -(-ctx // page)
            tables.append(list(range(next_page, next_page + npg))
                          + [0] * (W - npg))
            next_page += npg
            for p in range(ctx - verify_rows, ctx):
                rows_tbl.append(len(tables) - 1)
                rows_pos.append(p)
                rows_hor.append((p // 64 + 1) * 64)
        end = chunk_start + chunk      # prefill chunk rows
        npg = -(-end // page)
        tables.append(list(range(next_page, next_page + npg))
                      + [0] * (W - npg))
        next_page += npg
        for p in range(chunk_start, end):
            rows_tbl.append(len(tables) - 1)
            rows_pos.append(p)
            rows_hor.append(-(-(p + 1) // 64) * 64)
        for _ in range(n_dead):        # dead rows
            rows_tbl.append(0)
            rows_pos.append(0)
            rows_hor.append(0)
        self.n_dead = n_dead
        i32 = dict(dtype=torch.int32, device=dev)
        self.tables = torch.tensor(tables, **i32)
        self.idx = torch.tensor(rows_tbl, **i32)
        self.pos = torch.tensor(rows_pos, **i32)
        self.hor = torch.tensor(rows_hor, **i32)
        P = next_page
        R = len(rows_pos)
        self.k = torch.randn((P, page, nkv, d), generator=gen, device=dev,
                             dtype=torch.float32).to(dtype)
        self.v = torch.randn((P, page, nkv, d), generator=gen, device=dev,
                             dtype=torch.float32).to(dtype)
        self.q = torch.randn((R, 1, n, d), generator=gen, device=dev,
                             dtype=torch.float32).to(dtype)
        ns = len(contexts) * verify_rows    # the slots' rows
        # the chunk as a prefill call: [1, chunk, n, d] at chunk_start
        self.pre_q = self.q[ns:ns + chunk].reshape(1, chunk, n, d).contiguous()
        self.pre_bt = self.tables[-1:, :npg].contiguous()
        self.pre_start = torch.tensor([chunk_start], **i32)
        self.scale = 1.0 / d ** 0.5
        # work this data needs: pages each table's rows attend, once
        esz = self.q.element_size()
        attended_tokens = sum(contexts) + end
        self.ragged_bytes = (2 * self.q.numel() * esz
                             + 2 * attended_tokens * nkv * d * esz
                             + 4 * (self.tables.numel() + 3 * R))
        ctx_per_row = [p + 1 for p in rows_pos[:len(rows_pos) - n_dead]]
        if window:
            ctx_per_row = [min(c, window) for c in ctx_per_row]
        self.ragged_flops = 4.0 * n * d * sum(ctx_per_row)
        self.prefill_bytes = (2 * self.pre_q.numel() * esz
                              + 2 * end * nkv * d * esz
                              + 4 * (self.pre_bt.numel() + 1))
        self.prefill_flops = 4.0 * n * d * sum(ctx_per_row[ns:])
        # each slot's last row as one K5 call: each row through its own table
        nd = len(contexts)
        last = slice(verify_rows - 1, ns, verify_rows)
        self.dec_q = self.q[last].contiguous()
        self.dec_bt = self.tables[1:1 + nd].contiguous()
        self.dec_pos = self.pos[last].contiguous()
        # the same rows for K4: table index = the row, a horizon on the
        # 64-token grid above the position
        self.dec_idx = torch.arange(nd, **i32)
        self.dec_hor = (self.dec_pos // 64 + 1) * 64
        self.decode_bytes = (2 * self.dec_q.numel() * esz
                             + 2 * sum(contexts) * nkv * d * esz
                             + 4 * (self.dec_bt.numel() + nd))
        self.decode_flops = 4.0 * n * d * sum(ctx_per_row[last])

    def ragged(self, use_kernel):
        from megatron_llm_tpu_torch.ops.paged_attention import (
            paged_attention_ragged)

        return paged_attention_ragged(
            self.q, self.k, self.v, self.tables, self.idx, self.pos, self.hor,
            scale=self.scale, sliding_window=self.window,
            use_kernel=use_kernel)

    def ragged_rows(self, rows):
        """K4 on the tick's rows ``rows`` (an index tensor), in that order."""
        from megatron_llm_tpu_torch.ops.paged_attention import (
            paged_attention_ragged)

        return paged_attention_ragged(
            self.q[rows].contiguous(), self.k, self.v, self.tables,
            self.idx[rows].contiguous(), self.pos[rows].contiguous(),
            self.hor[rows].contiguous(), scale=self.scale,
            sliding_window=self.window)

    def decode(self, use_kernel):
        from megatron_llm_tpu_torch.ops.paged_attention import (
            paged_attention_decode)

        return paged_attention_decode(
            self.dec_q, self.k, self.v, self.dec_bt, self.dec_pos,
            scale=self.scale, sliding_window=self.window,
            use_kernel=use_kernel)

    def decode_as_ragged(self):
        """K4 on K5's rows."""
        from megatron_llm_tpu_torch.ops.paged_attention import (
            paged_attention_ragged)

        return paged_attention_ragged(
            self.dec_q, self.k, self.v, self.dec_bt, self.dec_idx,
            self.dec_pos, self.dec_hor, scale=self.scale,
            sliding_window=self.window)

    def prefill(self, use_kernel):
        from megatron_llm_tpu_torch.ops.paged_attention import (
            paged_attention_prefill)

        return paged_attention_prefill(
            self.pre_q, self.k, self.v, self.pre_bt, self.pre_start,
            scale=self.scale, sliding_window=self.window,
            use_kernel=use_kernel)


def _rows_stand_alone(torch, case, seed):
    """K4's per-row contract: every live row's output in the full tick is
    bitwise the same as the row run alone and as the row in a permuted
    tick (which regroups the rows into other tiles).  Returns the rows that
    differ, as ``["permuted"]`` and row indices."""
    full = case.ragged(True)
    R = case.q.shape[0]
    perm = torch.randperm(R, generator=torch.Generator().manual_seed(seed))
    perm = perm.to(case.q.device)
    bad = []
    if not torch.equal(case.ragged_rows(perm)[torch.argsort(perm)], full):
        bad.append("permuted")
    for r in range(R - case.n_dead):
        one = torch.tensor([r], device=case.q.device)
        if not torch.equal(case.ragged_rows(one)[0], full[r]):
            bad.append(r)
    return bad


# host µs a launch (perf counter, no sync inside): calls a reading takes
HOST_CALLS = 200


def phase_kernels(dev, report, args):
    import torch

    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.tools.kernel_check import (
        bound,
        cuda_ms,
        device_ms,
        host_us,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    contexts = [2048, 1537, 1024, 700, 333, 129, 64, 17]
    cases = {
        "llama2-7b": dict(n=32, nkv=32, contexts=contexts, chunk_start=512),
        "gqa-32/8": dict(n=32, nkv=8, contexts=contexts, chunk_start=960),
        "window-100": dict(n=32, nkv=8, contexts=contexts[:4],
                           chunk_start=200, window=100),
        # the TinyLlama-shaped draft's attention (spec phase, part c)
        "gqa-32/4-d64": dict(n=32, nkv=4, d=64, contexts=contexts,
                             chunk_start=512),
        # a speculative verify tick: each slot's K + 1 = 5 rows on its table
        "verify-llama2-7b": dict(n=32, nkv=32, contexts=contexts,
                                 chunk_start=512, verify_rows=SPEC_K + 1),
    }
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
    # K4-K6's device routine by type (ops/kernels/__init__.py:paged_path;
    # every case here is at head_dim 64 or 128)
    want_path = {torch.float32: "rows", torch.bfloat16: "tile"}
    kernels.reset_launch_counts()
    worst = {"paged_ragged": 0.0, "paged_decode": 0.0, "paged_prefill": 0.0}
    for name, spec in cases.items():
        for dtype, (atol, rtol) in tol.items():
            case = RaggedCase(torch, gen, dev, dtype, **spec)
            # K5 shares K4's walk: bitwise equal to K4 on the same rows
            dec, dec_k4 = case.decode(True), case.decode_as_ragged()
            torch.cuda.synchronize()
            if not torch.equal(dec, dec_k4):
                raise AssertionError(
                    f"paged_decode differs from paged_ragged on the same rows "
                    f"({name} {dtype}): max abs "
                    f"{float((dec.float() - dec_k4.float()).abs().max())}")
            log(f"  paged_decode  {name:16s} {str(dtype):14s} bitwise equal "
                f"to paged_ragged on its {dec.shape[0]} rows")
            for kname, fn in (("paged_ragged", case.ragged),
                              ("paged_decode", case.decode),
                              ("paged_prefill", case.prefill)):
                ker = fn(True)
                if kname == "paged_prefill":   # K6's routine, the same bits twice
                    again = fn(True)
                    path = kernels.paged_prefill_kernel.last_path
                    if path != want_path[dtype] or not torch.equal(ker, again):
                        raise AssertionError(
                            f"paged_prefill on {name} {dtype}: the {path} "
                            f"routine (want {want_path[dtype]}), two launches "
                            f"equal: {torch.equal(ker, again)}")
                ref = fn(False)
                torch.cuda.synchronize()
                err = (ker.float() - ref.float()).abs()
                lim = atol + rtol * ref.float().abs()
                ok = bool((err <= lim).all()) and bool(
                    torch.isfinite(ker.float()).all())
                max_err = float(err.max())
                if kname == "paged_ragged":
                    dead = ker[-case.n_dead:]
                    ok = ok and bool((dead == 0).all())
                log(f"  {kname:13s} {name:16s} {str(dtype):14s} "
                    f"max_abs_err={max_err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"{kname} disagrees with its plain version on "
                        f"{name} {dtype}: max abs err {max_err}")
                if name == "llama2-7b" and dtype == torch.bfloat16:
                    worst[kname] = max_err
            paths = (kernels.paged_ragged_kernel.last_path,
                     kernels.paged_decode_kernel.last_path)
            if paths != (want_path[dtype],) * 2:
                raise AssertionError(f"K4 / K5 ran the {paths} routines on "
                                     f"{name} {dtype}, not "
                                     f"{want_path[dtype]}")
            bad = _rows_stand_alone(torch, case, seed=len(name))
            log(f"  paged_ragged  {name:16s} {str(dtype):14s} "
                f"{case.q.shape[0] - case.n_dead} live rows bitwise the same "
                f"alone and in a permuted tick: {not bad}")
            if bad:
                raise AssertionError(
                    f"paged_ragged rows {bad[:8]} of {name} {dtype} differ "
                    f"alone or in a permuted tick from the full tick")
    # times at the serving path's shape, in its working type (bf16)
    case = RaggedCase(torch, gen, dev, torch.bfloat16, **cases["llama2-7b"])
    rows = {}
    for kname, fn, nbytes, flops in (
            ("paged_ragged", case.ragged, case.ragged_bytes,
             case.ragged_flops),
            ("paged_decode", case.decode, case.decode_bytes,
             case.decode_flops),
            ("paged_prefill", case.prefill, case.prefill_bytes,
             case.prefill_flops)):
        ms_plain_1 = cuda_ms(lambda: fn(False))
        ms_k_1 = cuda_ms(lambda: fn(True))
        ms_k_2 = cuda_ms(lambda: fn(True))
        ms_plain_2 = cuda_ms(lambda: fn(False))
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        dev_ms = device_ms(lambda: fn(True), iters=20)
        rows[kname] = dict(ms=min(ms_k_1, ms_k_2),
                           plain_ms=min(ms_plain_1, ms_plain_2),
                           device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by,
                           bytes=nbytes, flops=flops,
                           host_us=host_us(lambda: fn(True), n=HOST_CALLS),
                           max_abs_err=worst[kname])
        log(f"  {kname}: kernel {ms_k_1:.4f}/{ms_k_2:.4f} ms (device "
            f"{dev_ms:.4f} ms, host {rows[kname]['host_us']:.1f} us a "
            f"launch), plain {ms_plain_1:.4f}/{ms_plain_2:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
    rows["paged_ragged"]["path"] = kernels.paged_ragged_kernel.last_path
    rows["paged_decode"]["path"] = kernels.paged_decode_kernel.last_path
    report["kernels"] = rows
    k4 = rows["paged_ragged"]

    def k4_tick(key, tick, what, work):
        """K4 on another tick of bf16 rows (``work``: its bytes and flops):
        events (twice, the better), device time and bound, into the K4 row
        as ``<key>_*``."""
        ms = min(cuda_ms(tick) for _ in range(2))
        b_ms, b_by = bound(*work, "bfloat16")
        k4.update({f"{key}_ms": ms, f"{key}_device_ms": device_ms(tick),
                   f"{key}_bound_ms": b_ms})
        print(f"kernels: paged_ragged on {what}: {ms:.4f} ms by events "
              f"(device {k4[key + '_device_ms']:.4f} ms), bound {b_ms:.4f} "
              f"ms ({b_by}), {100 * b_ms / ms:.1f}% of the bound",
              flush=True)

    print(f"kernels: paged_ragged ({k4['path']} routine) on the mixed tick "
          f"(8 decode rows, a 64-row chunk, 8 dead rows): {k4['ms']:.4f} ms "
          f"by events (device {k4['device_ms']:.4f} ms), bound "
          f"{k4['bound_ms']:.4f} ms, {100 * k4['bound_ms'] / k4['ms']:.1f}% "
          f"of the bound", flush=True)
    # the same 8 decode rows alone (decode-only ticks are priced with it)
    k4_tick("decode_rows", case.decode_as_ragged,
            "the mixed tick's 8 decode rows alone",
            work=(case.decode_bytes, case.decode_flops))
    # a decode-only tick at full context: 8 rows x 2048 tokens
    full = RaggedCase(torch, gen, dev, torch.bfloat16, n=32, nkv=32,
                      contexts=[2048] * 8, chunk_start=0, chunk=0, n_dead=0)
    k4_tick("decode_only", lambda: full.ragged(True),
            "a decode-only tick of 8 rows x 2048 tokens",
            work=(full.ragged_bytes, full.ragged_flops))
    # a speculative verify tick: 8 slots x 5 rows, the chunk, dead rows
    verify = RaggedCase(torch, gen, dev, torch.bfloat16,
                        **cases["verify-llama2-7b"])
    k4_tick("verify", lambda: verify.ragged(True),
            f"a verify tick ({len(contexts)} slots x {SPEC_K + 1} rows on "
            f"their tables, the 64-row chunk, 8 dead rows; each page once "
            f"in the bound)", work=(verify.ragged_bytes, verify.ragged_flops))
    # the serve burst's two tick kinds (the serve phase prices its K4
    # launches with them): its 8 prompts half-way through their new tokens,
    # alone and beside a 64-row prefill chunk
    serve_ctx = [n + NEW_TOKENS // 2 for n in PROMPT_LENS]
    for key, chunk in (("serve_decode", 0), ("serve_mixed", 64)):
        tick = RaggedCase(torch, gen, dev, torch.bfloat16, n=32, nkv=32,
                          contexts=serve_ctx, chunk_start=256 if chunk else 0,
                          chunk=chunk,
                          n_dead=8 if chunk else 0)
        k4_tick(key, lambda: tick.ragged(True),
                f"the serve burst's {len(serve_ctx)} decode rows"
                + (" and a 64-row chunk at 256" if chunk else ""),
                work=(tick.ragged_bytes, tick.ragged_flops))
    del full, verify, tick
    prefill_shapes(torch, gen, dev, rows["paged_prefill"])
    flash_kernels(dev, report)
    rmsnorm_kernels(dev, report)


def prefill_shapes(torch, gen, dev, k6):
    """K6 (bf16) at the mixed tick's chunk ((a), already timed: the table's
    row) and at ``tools/prefill_shapes.py``'s other shapes, each held to
    its plain version (elementwise and by norm, with a planted scale fault
    that must fail the norm bar) and timed by events (the better of two),
    on the device and on the host a launch, beside its bound: into the K6
    row as ``<key>_*``."""
    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.tools.prefill_shapes import K6_SHAPES, measure

    k6["path"] = kernels.paged_prefill_kernel.last_path
    print(f"kernels: paged_prefill ({k6['path']} routine) on (a) the mixed "
          f"tick's 64-row chunk at 512: {k6['ms']:.4f} ms by events (device "
          f"{k6['device_ms']:.4f} ms, host {k6['host_us']:.1f} us a launch), "
          f"bound {k6['bound_ms']:.4f} ms, "
          f"{100 * k6['bound_ms'] / k6['device_ms']:.1f}% of it on the "
          f"device", flush=True)
    for key, spec, what in K6_SHAPES:
        k6.update(measure(torch, gen, dev, key, spec, what))


class FlashCase:
    """Flash-attention inputs ``[b, s, heads, d]``: q and do contiguous, k
    and v strided views into one fused tensor (as ``split_qkv`` leaves v),
    or with ``fused`` q, k and v all sliced from one ``[b, s, n + 2 nkv,
    d]`` buffer (as the model's qkv projection leaves them); two packed
    documents when ``segments``."""

    def __init__(self, torch, gen, dev, dtype, *, s, n, nkv, d, causal=True,
                 window=None, segments=False, fused=False, b=1):
        from megatron_llm_tpu_torch.ops.flash_attention import _allowed

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        if fused:
            qkv = randn(b, s, n + 2 * nkv, d)
            self.q, self.k, self.v = (qkv[:, :, :n], qkv[:, :, n:n + nkv],
                                      qkv[:, :, n + nkv:])
            self.do = randn(b, s, n, d)
        else:
            self.q, self.do = randn(b, s, n, d), randn(b, s, n, d)
            kv = randn(b, s, nkv, 2, d)
            self.k, self.v = kv[:, :, :, 0], kv[:, :, :, 1]
        self.seg = None
        if segments:
            self.seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
            self.seg[:, (3 * s) // 5:] = 1
        self.kw = dict(scale=1.0 / d ** 0.5, causal=causal,
                       sliding_window=window)
        # the work this data needs: allowed (q, kv) pairs of every head
        pairs = int(_allowed(s, s, causal, window, self.seg, self.seg,
                             dev).sum()) * (b if self.seg is None else 1)
        esz = self.q.element_size()
        tile = b * s * n * d * esz          # one [b, s, n, d] tensor
        kv_tile = b * s * nkv * d * esz
        rows = 4 * b * n * s                # one fp32 [b, n, s] vector
        seg = 0 if self.seg is None else 4 * b * s
        self.work = {   # name: (bytes, flops): 2 * pairs * d flops a product
            "flash_fwd": (2 * tile + 2 * kv_tile + rows + seg,
                          2 * 2.0 * pairs * d * n),
            "flash_bwd_dq": (3 * tile + 2 * kv_tile + 2 * rows + seg,
                             3 * 2.0 * pairs * d * n),
            "flash_bwd_dkv": (2 * tile + 4 * kv_tile + 2 * rows + seg,
                              4 * 2.0 * pairs * d * n),
        }

    def plain_fwd(self):
        from megatron_llm_tpu_torch.ops import flash_attention as fa

        return fa.flash_fwd_plain(self.q, self.k, self.v, self.seg, self.seg,
                                  **self.kw)

    def residuals(self):
        """The plain forward's lse and delta, which both backward versions
        get, so a forward difference does not reach the backward check."""
        from megatron_llm_tpu_torch.ops import flash_attention as fa

        out, lse = self.plain_fwd()
        self.lse, self.delta = lse, fa.flash_delta(out, self.do)
        return out, lse

    def run(self, name, use_kernel, out_dtype=None, scale=None):
        """One kernel (``use_kernel``) or its plain version on the case's
        inputs; ``scale`` overrides the softmax scale (a planted fault)."""
        from megatron_llm_tpu_torch.ops import flash_attention as fa
        from megatron_llm_tpu_torch.ops import kernels

        c = self
        kw = dict(c.kw, out_dtype=out_dtype)
        if scale is not None:
            kw["scale"] = scale
        if name == "flash_fwd":
            if use_kernel:
                return kernels.flash_fwd_kernel(c.q, c.k, c.v, c.seg, **kw)
            return fa.flash_fwd_plain(c.q, c.k, c.v, c.seg, c.seg, **kw)
        args = (c.q, c.k, c.v, c.do, c.lse, c.delta)
        if name == "flash_bwd_dq":
            if use_kernel:
                return (kernels.flash_bwd_dq_kernel(*args, c.seg, **kw),)
            return (fa.flash_bwd_dq_plain(*args, c.seg, c.seg, **kw),)
        if use_kernel:
            return kernels.flash_bwd_dkv_kernel(*args, c.seg, **kw)
        return fa.flash_bwd_dkv_plain(*args, c.seg, c.seg, **kw)


FLASH_SHAPE = dict(s=4096, n=32, nkv=32, d=128)   # the training shape
FLASH_SHAPE_D64 = dict(FLASH_SHAPE, d=64)         # timed beside it
FLASH_CASES = {
    "train-shape": FLASH_SHAPE,
    "gqa-32/8": dict(FLASH_SHAPE, nkv=8),
    "window-100": dict(FLASH_SHAPE, nkv=8, window=100),
    "segments": dict(FLASH_SHAPE, segments=True),
    "bidirectional": dict(FLASH_SHAPE, s=2048, causal=False),
    "d64": dict(s=1024, n=32, nkv=32, d=64),
    "d256": dict(s=1024, n=16, nkv=16, d=256),
    # the edges of K1's 128-row tiles: ragged q and kv ends, a sequence
    # shorter than one tile, with GQA and documents
    "ragged-1000": dict(s=1000, n=32, nkv=8, d=128, segments=True),
    "ragged-77": dict(s=77, n=32, nkv=8, d=128, segments=True),
    # q, k and v strided views of one fused qkv buffer
    "strided": dict(FLASH_SHAPE, s=2048, nkv=8, fused=True),
}
# Each mode: the inputs' type, the outputs' type, (atol, rtol) of out and
# of the gradients, the atol of lse, and the bound on each output's
# norm-relative error ||kernel - plain|| / ||plain|| (None: not held).
# fp32 runs the shared-memory kernels: summation order only (out and lse
# 1e-5; gradients, longer sums, 1e-4).  bf16 inputs run the kernels that
# train (the Hopper kernels of K1-K3; d 256 the shared-memory ones), once
# with bf16 outputs (as training calls them) and
# once with fp32 outputs (as a ring caller does), against the fp32 plain
# versions on the same inputs.  The kernels round P and dS to bf16 before
# their products: each output is held by its norm-relative error (1e-2;
# H100 readings up to 2.7e-3) and elementwise at 2e-2 (bf16 output
# rounding).  lse is fp32 from fp32 scores in every mode: 1e-5, about ten
# fp32 steps at |lse| ~ 9 (readings up to 1.9e-6).
FLASH_MODES = {
    "float32": dict(dtype="float32", out=None, fwd=(1e-5, 0.0),
                    bwd=(1e-4, 1e-4), lse=1e-5, norm=None),
    "bfloat16": dict(dtype="bfloat16", out=None, fwd=(2e-2, 2e-2),
                     bwd=(2e-2, 2e-2), lse=1e-5, norm=1e-2),
    "bf16>fp32": dict(dtype="bfloat16", out="float32", fwd=(2e-2, 2e-2),
                      bwd=(2e-2, 2e-2), lse=1e-5, norm=1e-2),
}
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PLANTED_SCALE = 1.1   # a softmax scale 10% off, which every check must catch


def _flash_agree(torch, kname, ker, ref, mode):
    """Hold a kernel's outputs against its plain version's under ``mode``:
    ``(ok, max abs err over all outputs, largest norm-relative error of
    out / dq / dk / dv, max abs err of lse or None)``."""
    ok, max_err, norm_rel, lse_err = True, 0.0, 0.0, None
    for i, (a, r) in enumerate(zip(ker, ref)):
        a, r = a.float(), r.float()
        err = (a - r).abs()
        max_err = max(max_err, float(err.max()))
        ok = ok and bool(torch.isfinite(a).all())
        if kname == "flash_fwd" and i == 1:
            lse_err = float(err.max())
            ok = ok and lse_err <= mode["lse"]
            continue
        atol, rtol = mode["fwd" if kname == "flash_fwd" else "bwd"]
        ok = ok and bool((err <= atol + rtol * r.abs()).all())
        rel = float(torch.linalg.vector_norm(a - r)
                    / torch.linalg.vector_norm(r).clamp_min(1e-30))
        norm_rel = max(norm_rel, rel)
        if mode["norm"] is not None:
            ok = ok and rel <= mode["norm"]
    return ok, max_err, norm_rel, lse_err


def _fmt_agree(max_err, norm_rel, lse_err):
    lse = "" if lse_err is None else f" lse_err={lse_err:.3e}"
    return f"max_abs_err={max_err:.3e} norm_rel={norm_rel:.3e}{lse}"


def _sdpa(torch, case):
    """PyTorch's scaled_dot_product_attention on the case's inputs
    ([b, n, s, d] copies): forward ms, backward ms (forward + backward less
    forward) and the device kernels it ran."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from megatron_llm_tpu_torch.tools.kernel_check import cuda_ms

    q, k, v, do = (t.transpose(1, 2).contiguous()
                   for t in (case.q, case.k, case.v, case.do))
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, is_causal=True).backward(do)

    fwd_ms = min(cuda_ms(fwd) for _ in range(2))
    both_ms = min(cuda_ms(fwd_bwd) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    names = sorted({ev.key[:60] for ev in prof.key_averages()
                    if str(getattr(ev, "device_type", "")).endswith("CUDA")})
    return fwd_ms, both_ms - fwd_ms, names


def flash_kernels(dev, report):
    import torch

    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.tools.kernel_check import (
        bound,
        cuda_ms,
        device_ms,
        host_us,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    kernels.reset_launch_counts()
    worst = {}
    readings = {}
    for cname, spec in FLASH_CASES.items():
        for mname, mode in FLASH_MODES.items():
            case = FlashCase(torch, gen, dev, getattr(torch, mode["dtype"]),
                             **spec)
            case.residuals()
            out = mode["out"] and getattr(torch, mode["out"])
            for kname in FLASH_NAMES:
                ker = case.run(kname, True, out)
                ref = case.run(kname, False, out)
                torch.cuda.synchronize()
                ok, *reading = _flash_agree(torch, kname, ker, ref, mode)
                log(f"  {kname:13s} {cname:13s} {mname:9s} "
                    f"{_fmt_agree(*reading)} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"{kname} disagrees with its plain version on "
                        f"{cname} {mname}: {_fmt_agree(*reading)}")
                if cname == "train-shape":
                    readings[f"{kname} {mname}"] = reading
                    if mname == "bfloat16":
                        worst[kname] = reading[0]
            del case
            torch.cuda.empty_cache()
    report["flash_readings"] = readings
    # times at the training shape, in its working type (bf16)
    case = FlashCase(torch, gen, dev, torch.bfloat16, **FLASH_SHAPE)
    case.residuals()
    # the checks' power: each kernel run with a softmax scale 10% off must
    # fail the bf16 check that holds the kernels of the training path
    for kname in FLASH_NAMES:
        ker = case.run(kname, True, torch.float32,
                       scale=PLANTED_SCALE * case.kw["scale"])
        ref = case.run(kname, False, torch.float32)
        ok, *reading = _flash_agree(torch, kname, ker, ref,
                                    FLASH_MODES["bf16>fp32"])
        print(f"kernels: planted fault (scale x{PLANTED_SCALE}) in "
              f"{kname}: {_fmt_agree(*reading)}, "
              f"{'PASSED: the check has no power' if ok else 'caught'}",
              flush=True)
        if ok:
            raise AssertionError(f"{kname} with a scale {PLANTED_SCALE}x "
                                 f"off passed the bf16 check")
        readings[f"{kname} planted"] = reading
    print("kernels: flash agreement at the training shape: " + "; ".join(
        f"{key} {_fmt_agree(*r)}" for key, r in readings.items()), flush=True)
    sdpa_fwd, sdpa_bwd, sdpa_names = _sdpa(torch, case)
    rows = report["kernels"]
    for kname in FLASH_NAMES:
        ms_plain_1 = cuda_ms(lambda: case.run(kname, False), iters=3)
        ms_k_1 = cuda_ms(lambda: case.run(kname, True))
        ms_k_2 = cuda_ms(lambda: case.run(kname, True))
        ms_plain_2 = cuda_ms(lambda: case.run(kname, False), iters=3)
        dev_ms = device_ms(lambda: case.run(kname, True), iters=5)
        nbytes, flops = case.work[kname]
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        rows[kname] = dict(
            ms=min(ms_k_1, ms_k_2), plain_ms=min(ms_plain_1, ms_plain_2),
            device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            flops=flops, max_abs_err=worst[kname],
            host_us=host_us(lambda: case.run(kname, True), n=HOST_CALLS),
            tflop_s=flops / min(ms_k_1, ms_k_2) / 1e9,
            library_ms=sdpa_fwd if kname == "flash_fwd" else sdpa_bwd)
        # which kernel the training shape ran
        rows[kname]["path"] = getattr(kernels, kname + "_kernel").last_path
        log(f"  {kname}: kernel {ms_k_1:.4f}/{ms_k_2:.4f} ms (device "
            f"{dev_ms:.4f} ms), plain "
            f"{ms_plain_1:.4f}/{ms_plain_2:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), "
            f"{rows[kname]['tflop_s']:.1f} TFLOP/s")
    print(f"kernels: flash at b 1, seq 4096, 32 heads, d 128, causal, bf16: "
          f"K1 ({rows['flash_fwd']['path']} kernel) "
          f"{rows['flash_fwd']['ms']:.4f} ms, K2 "
          f"({rows['flash_bwd_dq']['path']}) "
          f"{rows['flash_bwd_dq']['ms']:.4f} ms, K3 "
          f"({rows['flash_bwd_dkv']['path']}) "
          f"{rows['flash_bwd_dkv']['ms']:.4f} ms; "
          f"scaled_dot_product_attention forward {sdpa_fwd:.4f} ms, "
          f"backward {sdpa_bwd:.4f} ms (device kernels: "
          f"{'; '.join(sdpa_names)})", flush=True)
    report["sdpa_kernels"] = sdpa_names
    del case
    torch.cuda.empty_cache()
    # the same times at head_dim 64 (b 1, seq 4096, 32 heads, causal, bf16)
    case = FlashCase(torch, gen, dev, torch.bfloat16, **FLASH_SHAPE_D64)
    case.residuals()
    sdpa_fwd, sdpa_bwd, _ = _sdpa(torch, case)
    for kname in FLASH_NAMES:
        ms = min(cuda_ms(lambda: case.run(kname, True)) for _ in range(2))
        dev_ms = device_ms(lambda: case.run(kname, True), iters=5)
        b_ms, _ = bound(*case.work[kname], "bfloat16")
        rows[kname].update(
            d64_ms=ms, d64_device_ms=dev_ms, d64_bound_ms=b_ms,
            d64_library_ms=sdpa_fwd if kname == "flash_fwd" else sdpa_bwd,
            d64_path=getattr(kernels, kname + "_kernel").last_path)
    print(f"kernels: flash at b 1, seq 4096, 32 heads, d 64, causal, bf16: " +
          ", ".join(f"{kname} ({rows[kname]['d64_path']}) "
                    f"{rows[kname]['d64_ms']:.4f} ms (device "
                    f"{rows[kname]['d64_device_ms']:.4f}, bound "
                    f"{rows[kname]['d64_bound_ms']:.4f})"
                    for kname in FLASH_NAMES) +
          f"; scaled_dot_product_attention forward {sdpa_fwd:.4f} ms, "
          f"backward {sdpa_bwd:.4f} ms", flush=True)
    del case
    torch.cuda.empty_cache()


# (rows, h): h 2048 and 4096 on the vector path, 4100 on the scalar path;
# K8 takes rows in chunks of ceil(rows / (4 * SMs)): 8 rows on an H100 for
# 4096 rows (a whole number of chunks) and for 4099 (a ragged last chunk)
RMS_SHAPES = ((1000, 2048), (4096, 4096), (4099, 4096), (777, 4100))
RMS_MODES = {"float32": ("float32", "float32"),
             "bf16 x, fp32 w": ("bfloat16", "float32"),
             "bfloat16": ("bfloat16", "bfloat16")}
RMS_PLANTED_EPS = 0.2   # r about 10% off at unit-variance x
RMS_NAMES = ("rms_norm_fwd", "rms_norm_bwd")


def _rms_run(x, w, g, eps):
    """K7's y and K8's (dx, dw) on the same inputs."""
    from megatron_llm_tpu_torch.ops import kernels

    return (kernels.rms_norm_fwd_kernel(x, w, eps),
            *kernels.rms_norm_bwd_kernel(x, w, g, eps))


def _rms_agree(x, w, g, outs, eps=1e-6):
    """``(ok, max abs err)`` of K7 / K8's outputs against the plain
    versions at ``eps``, under the kernel-check tool's bars."""
    from megatron_llm_tpu_torch.ops import rmsnorm as rms
    from megatron_llm_tpu_torch.tools import kernel_check as kc

    y, dx, dw = outs
    r_dx, r_dw = rms.rms_norm_bwd_plain(x, w, g, eps)
    res = (kc.rms_close(y, rms.rms_norm_fwd_plain(x, w, eps)),
           kc.rms_close(dx, r_dx), kc.rms_dw_close(dw, r_dw)[:2])
    return [ok for ok, _ in res], [err for _, err in res]


def rmsnorm_kernels(dev, report):
    import torch

    from megatron_llm_tpu_torch.tools import kernel_check as kc

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    worst = {}

    def inputs(rows, h, x_dtype, w_dtype):
        x = torch.randn((rows, h), generator=gen, device=dev).to(x_dtype)
        w = (torch.randn((h,), generator=gen, device=dev) * 0.1
             + 1.0).to(w_dtype)
        g = torch.randn((rows, h), generator=gen, device=dev).to(x_dtype)
        return x, w, g

    for rows, h in RMS_SHAPES:
        for mname, (xd, wd) in RMS_MODES.items():
            x, w, g = inputs(rows, h, getattr(torch, xd), getattr(torch, wd))
            outs = _rms_run(x, w, g, 1e-6)
            torch.cuda.synchronize()
            oks, errs = _rms_agree(x, w, g, outs)
            log(f"  rms_norm [{rows}, {h}] {mname:14s} max_abs_err y "
                f"{errs[0]:.3e} dx {errs[1]:.3e} dw {errs[2]:.3e} "
                f"{'ok' if all(oks) else 'FAIL'}")
            if not all(oks):
                raise AssertionError(
                    f"rms_norm kernels disagree with their plain versions at "
                    f"[{rows}, {h}] {mname}: y / dx / dw ok {oks}, max abs "
                    f"err {errs}")
            if (rows, h) == (4096, 4096) and mname == "bfloat16":
                worst = {"rms_norm_fwd": errs[0],
                         "rms_norm_bwd": max(errs[1], errs[2])}
    # K8 without atomics: the same dx and dw on a second run
    x, w, g = inputs(4099, 4096, torch.bfloat16, torch.float32)
    first, second = _rms_run(x, w, g, 1e-6), _rms_run(x, w, g, 1e-6)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"kernels: rms_norm_bwd dx and dw bitwise the same on a second run: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("rms_norm kernels are not deterministic")
    # the checks' power: K7 / K8 at eps 0.2 against the plain versions at
    # 1e-6 must fail the bf16 check on each output
    oks, errs = _rms_agree(x, w, g, _rms_run(x, w, g, RMS_PLANTED_EPS))
    print(f"kernels: planted fault (eps {RMS_PLANTED_EPS}) in rms_norm: max "
          f"abs err y {errs[0]:.3e} dx {errs[1]:.3e} dw {errs[2]:.3e}, "
          f"{'PASSED: the check has no power' if any(oks) else 'caught'}",
          flush=True)
    if any(oks):
        raise AssertionError(f"rms_norm at eps {RMS_PLANTED_EPS} passed the "
                             f"check on y / dx / dw: {oks}")
    del x, w, g, first, second
    # times at the train sequence's shape, bf16 x and w
    t = kc.rmsnorm_times(dev, 4096, 4096, torch.bfloat16)
    rows = report["kernels"]
    for kname, key in zip(RMS_NAMES, ("K7", "K8")):
        r = t[key]
        rows[kname] = dict(max_abs_err=worst[kname], **r)
        log(f"  {kname}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms, host {r['host_us']:.1f} us a launch), "
            f"plain {r['plain_ms']:.4f} ms, "
            f"F.rms_norm {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.1f} MB)")
    # K7 again at the kernel-check tool's serve-tick shape, where the host's
    # time a launch decides the event time
    rows_s, h_s = kc.MODEL_SHAPES["serve tick"]
    t7 = kc.rmsnorm_times(dev, rows_s, h_s, torch.bfloat16)["K7"]
    rows["rms_norm_fwd"].update({
        "serve_tick_" + key: t7[key] for key in (
            "ms", "device_ms", "host_us", "library_ms", "library_host_us",
            "bound_ms")})
    print(f"kernels: rms_norm_fwd at the serve tick's [{rows_s}, {h_s}] bf16: "
          f"K7 {t7['ms']:.4f} ms by events (device {t7['device_ms']:.4f} ms, "
          f"host {t7['host_us']:.2f} us a launch), F.rms_norm "
          f"{t7['library_ms']:.4f} ms (host {t7['library_host_us']:.2f} us)",
          flush=True)
    print(f"kernels: rms_norm at [4096, 4096] bf16, back to back: K7 "
          f"{rows['rms_norm_fwd']['ms']:.4f} ms (host "
          f"{rows['rms_norm_fwd']['host_us']:.2f} us a launch, F.rms_norm "
          f"{rows['rms_norm_fwd']['library_host_us']:.2f} us), K8 "
          f"{rows['rms_norm_bwd']['ms']:.4f} ms (device "
          f"{rows['rms_norm_fwd']['device_ms']:.4f} / "
          f"{rows['rms_norm_bwd']['device_ms']:.4f} ms); bounds "
          f"{rows['rms_norm_fwd']['bound_ms']:.4f} / "
          f"{rows['rms_norm_bwd']['bound_ms']:.4f} ms; F.rms_norm forward "
          f"{rows['rms_norm_fwd']['library_ms']:.4f} ms, backward "
          f"{rows['rms_norm_bwd']['library_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the port's kernel-check tool
# ---------------------------------------------------------------------------

KERNEL_CHECK_WRAPPERS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                         "flash_bwd_dkv_kernel", "rms_norm_fwd_kernel",
                         "rms_norm_bwd_kernel")


def phase_kernel_check(dev, report, args):
    import gc

    import torch

    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.tools import kernel_check

    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    rc = kernel_check.main([])
    launches = {k: kernels.launch_counts()[k] for k in KERNEL_CHECK_WRAPPERS}
    print(f"kernel-check: exit code {rc}; kernel launches "
          f"{json.dumps(launches)}", flush=True)
    if rc != 0:
        raise AssertionError(f"kernel_check failed: {kernel_check.FAILURES}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched by kernel_check")
    report["kernel_check_launches"] = launches
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the port's server on Llama-2-7B
# ---------------------------------------------------------------------------

PROMPT_LENS = (100, 171, 242, 313, 384, 455, 526, 600)
NEW_TOKENS = 64


def _put(port: int, body: dict, timeout: float = 900.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(body).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _burst(port: int, bodies):
    """Send every body as its own concurrent PUT /api; returns
    ``([(status, body, seconds)], wall seconds)``."""
    results = [None] * len(bodies)

    def client(i):
        t = time.time()
        results[i] = (*_put(port, bodies[i]), time.time() - t)

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results, time.time() - t0


def serve_bodies(rng, vocab: int, new_tokens: int = NEW_TOKENS,
                 greedy_only: bool = False):
    """The serve burst: one prompt of each of ``PROMPT_LENS`` tokens drawn
    from ``rng``, greedy, but for one sampled request with a seed and one
    with prompt log-probs (the chunk path) unless ``greedy_only``.
    Returns ``(prompts, bodies)``."""
    prompts = [rng.integers(1, vocab, size=n).tolist() for n in PROMPT_LENS]
    bodies = []
    for i, p in enumerate(prompts):
        body = {"prompts": [" ".join(map(str, p))],
                "tokens_to_generate": new_tokens, "top_k": 1}
        if i == 1 and not greedy_only:   # one sampled request with a seed
            body = dict(body, top_k=40, temperature=0.8, random_seed=1234)
        if i == 2 and not greedy_only:   # one with prompt log-probs
            body["logprobs"] = True
        bodies.append(body)
    return prompts, bodies


def check_answers(results, prompts, bodies) -> int:
    """Every answer 200 with its prompt, the asked number of tokens (or
    fewer, ending on NullTokenizer's eod 0) and, where asked, finite
    log-probs <= 0; returns the tokens generated."""
    import numpy as np

    generated = 0
    for i, (res, p) in enumerate(zip(results, prompts)):
        if res is None:
            raise AssertionError(f"request {i} got no answer")
        code, body, _ = res
        if code != 200:
            raise AssertionError(f"request {i}: HTTP {code} {body}")
        toks = [int(t) for t in body["text"][0].split()]
        n_gen = len(toks) - len(p)
        want = bodies[i]["tokens_to_generate"]
        if toks[:len(p)] != p or not (
                n_gen == want or (0 < n_gen < want and toks[-1] == 0)):
            raise AssertionError(f"request {i}: {n_gen} tokens generated")
        if bodies[i].get("logprobs"):
            lp = body["logprobs"][0]
            if len(lp) != len(toks) - 1 or not all(
                    np.isfinite(x) and x <= 0 for x in lp):
                raise AssertionError(f"request {i}: bad logprobs")
        generated += n_gen
    return generated


def _profiled_burst(port: int, bodies, engine) -> dict:
    """One burst under ``torch.profiler``: the device's busy share of the
    wall time (one stream, so activity does not overlap), the device time
    by kernel name, and the host's self time by operator."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    try:   # the engine ticks on its own thread
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        config = None
    ticks0 = engine.ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        results, wall = _burst(port, bodies)
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"profiled request {i}: {res}")
    device: dict = {}
    host: dict = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
            device[ev.key[:48]] = device.get(ev.key[:48], 0.0) + us / 1e3
        else:
            host[ev.key[:48]] = (host.get(ev.key[:48], 0.0)
                                 + ev.self_cpu_time_total / 1e3)
    device_ms = sum(device.values())
    return dict(wall_s=wall, ticks=engine.ticks - ticks0, device_ms=device_ms,
                busy_share=device_ms / (wall * 1e3),
                top_device=sorted(device.items(), key=lambda kv: -kv[1])[:8],
                top_host=sorted(host.items(), key=lambda kv: -kv[1])[:8])


def _print_profile(profile: dict, tick_s: float) -> None:
    if not profile["device_ms"]:
        print("serve profile: the profiler recorded no device activity; "
              "device busy share not measured", flush=True)
        return

    def fmt(rows):
        return "; ".join(f"{name} {ms:.1f} ms" for name, ms in rows)

    per_tick = profile["device_ms"] / profile["ticks"]
    print(f"serve profile (second burst, under torch.profiler): "
          f"{profile['wall_s']:.3f} s wall, {profile['ticks']} ticks, "
          f"{profile['device_ms']:.1f} ms of device activity, busy "
          f"{100 * profile['busy_share']:.1f}% under the profiler; "
          f"{per_tick:.2f} ms of device time per tick against "
          f"{1e3 * tick_s:.2f} ms per tick unprofiled: busy "
          f"{100 * per_tick / (1e3 * tick_s):.1f}%", flush=True)
    print(f"serve profile: device time by kernel: "
          f"{fmt(profile['top_device'])}", flush=True)
    print(f"serve profile: host self time by operator (all threads the "
          f"profiler saw): {fmt(profile['top_host'])}", flush=True)


def _tick_kinds(engine) -> dict:
    """Split the engine's ticks, and the K4 launches they make, into ticks
    that carried prefill rows and decode-only ticks, from the tick plan the
    engine builds (``_plan_ragged_prefill``'s spans) and K4's host-side
    launch counter: no device read.  Returns ``{"prefill": [ticks,
    launches], "decode": [ticks, launches]}``, filled as the engine ticks."""
    from megatron_llm_tpu_torch.ops import kernels

    counts = {"prefill": [0, 0], "decode": [0, 0]}
    kind = ["decode"]
    plan, tick = engine._plan_ragged_prefill, engine._tick_fn

    def planned():
        out = plan()
        kind[0] = "prefill" if out[0] else "decode"
        return out

    def ticked(*a, **kw):
        n0 = kernels.paged_ragged_kernel.launches
        out = tick(*a, **kw)
        counts[kind[0]][0] += 1
        counts[kind[0]][1] += kernels.paged_ragged_kernel.launches - n0
        return out

    engine._plan_ragged_prefill, engine._tick_fn = planned, ticked
    return counts


def _assert_k4_tile(where: str, wrappers=("paged_ragged_kernel",)) -> None:
    """The bf16 model at head_dim 128 runs K4 (and each of ``wrappers``)
    on the tensor-core routine."""
    from megatron_llm_tpu_torch.ops import kernels

    for name in wrappers:
        path = getattr(kernels, name).last_path
        if path != "tile":
            raise AssertionError(f"{name} ran the {path} routine on "
                                 f"{where}, not the tile routine")


def phase_serve(dev, report, args):
    import numpy as np
    import torch

    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.tools.run_text_generation_server import (
        build_server)

    argv = ["--model_name", "llama2-7b", "--random_init",
            "--tokenizer_type", "NullTokenizer", "--vocab_size", "32000",
            "--params_dtype", "bfloat16", "--seed", str(args.seed),
            "--device", "cuda", "--port", "0"]
    if args.num_layers:
        argv += ["--num_layers", str(args.num_layers)]
    t0 = time.time()
    server, _ = build_server(argv)
    torch.cuda.synchronize()
    engine = server.engine
    m = engine.cfg.model
    log(f"  model: {m.num_layers} layers, hidden {m.hidden_size}, "
        f"{m.num_attention_heads}/{m.num_attention_heads_kv} heads, ffn "
        f"{m.ffn_hidden_size}, vocab {m.vocab_size}, "
        f"{engine.params['layers']['mlp']['fc1']['kernel'].dtype}; "
        f"{engine.max_slots} slots x {engine.max_seq} tokens, "
        f"{engine.pool.num_pages} pages; set-up {time.time() - t0:.1f}s")
    port = server.start_background("127.0.0.1", 0)
    rng = np.random.default_rng(args.seed)
    prompts, bodies = serve_bodies(rng, m.vocab_size)
    profile = None
    kinds = _tick_kinds(engine)
    try:
        kernels.reset_launch_counts()
        results, wall = _burst(port, bodies)
        launches = kernels.launch_counts()
        kinds = {kind: list(c) for kind, c in kinds.items()}
        ttft = sorted(engine.recent_ttft_s)
        ticks = engine.ticks
        if args.profile:   # a second burst of fresh greedy prompts
            profile = _profiled_burst(port, [
                {"prompts": [" ".join(map(str, rng.integers(
                    1, m.vocab_size, size=n).tolist()))],
                 "tokens_to_generate": NEW_TOKENS, "top_k": 1}
                for n in PROMPT_LENS], engine)
    finally:
        server.stop()
    generated = check_answers(results, prompts, bodies)
    launches = {meta["wrapper"]: launches[meta["wrapper"]]
                for meta in KERNEL_META.values()
                if meta["launches_from"] == "serve_launches"}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    _assert_k4_tile("the serve burst",
                    ("paged_ragged_kernel", "paged_prefill_kernel"))
    if kinds["prefill"][1] + kinds["decode"][1] != launches[
            "paged_ragged_kernel"]:
        raise AssertionError(f"K4 launches by tick kind {kinds} do not add "
                             f"up to {launches['paged_ragged_kernel']}")
    report["serve_launches"] = launches
    report["serve_tick_kinds"] = kinds
    report["serve"] = dict(
        requests=len(bodies), generated_tokens=generated, wall_s=wall,
        decode_tokens_per_s=generated / wall,
        ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
        ticks=ticks, latency_max_s=max(r[2] for r in results))
    print(f"serve: {len(bodies)} concurrent PUT /api, {generated} tokens in "
          f"{wall:.3f} s: decode {generated / wall:.2f} tokens/s", flush=True)
    print(f"serve: TTFT p50 {ttft[len(ttft) // 2]:.3f} s, max "
          f"{ttft[-1]:.3f} s over {len(ttft)} requests; {ticks} ticks",
          flush=True)
    print(f"serve: kernel launches on the main path {json.dumps(launches)}",
          flush=True)
    print(f"serve: ticks that carried prefill rows {kinds['prefill'][0]} "
          f"({kinds['prefill'][1]} K4 launches), decode-only ticks "
          f"{kinds['decode'][0]} ({kinds['decode'][1]} K4 launches); K4 on "
          f"the tile routine, K6 too", flush=True)
    if profile is not None:
        report["serve_profile"] = profile
        _print_profile(profile, wall / ticks)
    engine.pool = None
    report["model"] = (engine.cfg, engine.params)


# ---------------------------------------------------------------------------
# phase 5: one full-width ragged tick through the kernels and the plain path
# ---------------------------------------------------------------------------


def phase_tick(dev, report, args):
    import copy

    import torch

    from megatron_llm_tpu_torch.models.language_model import model_forward
    from megatron_llm_tpu_torch.ops.paged_attention import PagedState

    cfg, params = report.pop("model")
    torch.cuda.empty_cache()
    m = cfg.model
    page, W = 16, 2048 // 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    contexts = [2000, 1500, 1024, 700, 333, 129, 64, 17]
    chunk_start, chunk, n_dead = 512, 64, 4
    tables = [[0] * W]
    nxt = 1
    for ctx in contexts + [chunk_start + chunk]:
        npg = -(-ctx // page)
        tables.append(list(range(nxt, nxt + npg)) + [0] * (W - npg))
        nxt += npg
    pos = ([c - 1 for c in contexts] + list(range(chunk_start,
                                                  chunk_start + chunk))
           + [0] * n_dead)
    idx = (list(range(1, 1 + len(contexts))) + [len(tables) - 1] * chunk
           + [0] * n_dead)
    hor = [((p // 64) + 1) * 64 for p in pos[:-n_dead]] + [0] * n_dead
    i32 = dict(dtype=torch.int32, device=dev)
    paged = PagedState(torch.tensor(tables, **i32), torch.tensor(pos, **i32),
                       torch.tensor(hor, **i32), torch.tensor(idx, **i32))
    R = len(pos)
    tokens = torch.randint(1, m.vocab_size, (R, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    shape = (m.num_layers, nxt, page, m.num_attention_heads_kv, m.kv_channels)
    dtype = params["embedding"]["word_embeddings"].dtype
    pk0 = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    pv0 = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.training.use_flash_attn = False   # use_kernel=False
    out = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        pools = (pk0.clone(), pv0.clone())
        with torch.no_grad():
            logits, _ = model_forward(c, params, tokens,
                                      position_ids=paged.positions[:, None],
                                      kv_caches=pools, paged=paged)
        torch.cuda.synchronize()
        out[name] = logits.float()
        del pools
    k, p = out["kernel"], out["plain"]
    if tuple(k.shape[:2]) != (R, 1) or k.shape[-1] < m.vocab_size:
        raise AssertionError(f"logits shape {tuple(k.shape)}")
    if not bool(torch.isfinite(k).all()):
        raise AssertionError("non-finite logits through the kernels")
    err = float((k - p).abs().max())
    lim = 5e-2 * float(p.abs().max())
    print(f"tick: {R} rows ({len(contexts)} decode, {chunk} prefill, "
          f"{n_dead} dead) x {m.num_layers} layers: max |kernel - plain| "
          f"logit {err:.4f}, bound {lim:.4f} (5e-2 * max|logit|)", flush=True)
    report["tick"] = dict(rows=R, max_abs_logit_err=err, bound=lim)
    if not err <= lim:
        raise AssertionError(f"tick logits disagree: {err} > {lim}")
    del out, k, p

    # the same tick with an fp32 copy of the weights and pools: no bf16
    # rounding between the layers, so only the kernels' summation order
    # separates the two paths
    def to32(tree):
        if isinstance(tree, dict):
            return {key: to32(val) for key, val in tree.items()}
        return tree.float()

    params32 = to32(params)
    out = {}
    for name, use_kernel in (("kernel", True), ("plain", False)):
        c32 = copy.deepcopy(cfg)
        c32.training.params_dtype = "float32"
        c32.training.use_flash_attn = use_kernel
        pools = (pk0.float(), pv0.float())
        with torch.no_grad():
            logits, _ = model_forward(c32, params32, tokens,
                                      position_ids=paged.positions[:, None],
                                      kv_caches=pools, paged=paged)
        torch.cuda.synchronize()
        out[name] = logits
        del pools
    err32 = float((out["kernel"] - out["plain"]).abs().max())
    lim32 = 1e-3 * float(out["plain"].abs().max())
    print(f"tick fp32: max |kernel - plain| logit {err32:.3e}, bound "
          f"{lim32:.3e} (1e-3 * max|logit|, fp32 summation order)",
          flush=True)
    report["tick"].update(max_abs_logit_err_fp32=err32, bound_fp32=lim32)
    if not err32 <= lim32:
        raise AssertionError(f"fp32 tick logits disagree: {err32} > {lim32}")


# ---------------------------------------------------------------------------
# phase 6: speculative decoding through the port's engine and server
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_CHECK_LAYERS = 4     # the fp32 check's target depth
SPEC_CHECK_LENS = (100, 171, 242, 313)
SPEC_CHECK_NEW = 32
SPEC_LOGP_TOL = 1e-4      # fp32: summation order only
SPEC_MIN_ACCEPT = {"fp32": 0.99, "bf16": 0.9}
# TinyLlama/TinyLlama-1.1B's published shape (its config.json)
TINYLLAMA = dict(num_layers=22, hidden_size=2048, num_attention_heads=32,
                 num_attention_heads_kv=4, ffn_hidden_size=5632,
                 vocab_size=32000, max_position_embeddings=2048,
                 seq_length=2048)


def _llama_cfg(dtype_name, num_layers=None):
    """Llama-2-7B's configuration at ``num_layers`` (default: all 32),
    with the serve phase's tokenizer and vocab."""
    from megatron_llm_tpu_torch.config.arguments import parse_args

    argv = ["--model_name", "llama2-7b", "--tokenizer_type", "NullTokenizer",
            "--vocab_size", "32000", "--params_dtype", dtype_name]
    if num_layers:
        argv += ["--num_layers", str(num_layers)]
    return parse_args(argv)


def _seeded_gen(dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _random_params(cfg, seed, dev):
    from megatron_llm_tpu_torch.models import init_model_params
    from megatron_llm_tpu_torch.utils.device import compute_dtype

    return init_model_params(cfg, _seeded_gen(dev, seed), device=dev,
                             dtype=compute_dtype(cfg))


def _greedy_engine_run(engine, prompts, new_tokens):
    """Greedy generations of ``prompts`` through ``engine`` on this
    thread: ``([(tokens, log-probs)], wall seconds)``."""
    import torch

    t0 = time.time()
    reqs = [engine.submit(p, new_tokens, top_k=1) for p in prompts]
    engine.run_until_idle()
    torch.cuda.synchronize()
    return [r.result(timeout=600) for r in reqs], time.time() - t0


def _spec_fp32_check(dev, args, rng):
    """Part (a): spec_k = 4 against spec_k = 0 on the same greedy prompts,
    fp32 at Llama-2-7B width and 4 layers, with an independent 1-layer
    draft (acceptance about 0: the correction path) and with the identity
    pair (a 2-layer draft, the target its extension to 4 layers)."""
    import numpy as np
    import torch

    from megatron_llm_tpu_torch.generation import (
        ContinuousBatchingEngine,
        DraftModel,
    )
    from megatron_llm_tpu_torch.generation.speculative import (
        extend_params_identity,
    )

    cfg = _llama_cfg("float32", SPEC_CHECK_LAYERS)
    prompts = [rng.integers(1, cfg.model.vocab_size, size=n).tolist()
               for n in SPEC_CHECK_LENS]
    d1cfg, d2cfg = _llama_cfg("float32", 1), _llama_cfg("float32", 2)
    d2 = _random_params(d2cfg, args.seed + 12, dev)
    pairs = {
        "independent 1-layer draft": (
            _random_params(cfg, args.seed + 10, dev),
            DraftModel(d1cfg, _random_params(d1cfg, args.seed + 11, dev))),
        "identity pair (2-layer draft, 4-layer extension)": (
            extend_params_identity(d2cfg, d2, cfg,
                                   _seeded_gen(dev, args.seed + 13)),
            DraftModel(d2cfg, d2)),
    }
    rows = {}
    for name, (target, draft) in pairs.items():
        kw = dict(device=dev, max_slots=4, max_seq=1024)
        base, _ = _greedy_engine_run(
            ContinuousBatchingEngine(cfg, target, None, **kw), prompts,
            SPEC_CHECK_NEW)
        eng = ContinuousBatchingEngine(cfg, target, None, spec_k=SPEC_K,
                                       spec_draft=draft, **kw)
        spec, _ = _greedy_engine_run(eng, prompts, SPEC_CHECK_NEW)
        same = all(a[0] == b[0] for a, b in zip(base, spec))
        dlp = max(float(np.abs(np.asarray(a[1]) - np.asarray(b[1])).max())
                  for a, b in zip(base, spec)) if same else float("inf")
        stats = eng.spec_stats()
        acc = stats["acceptance_rate"]
        print(f"spec fp32 ({name}): {len(prompts)} greedy prompts x "
              f"{SPEC_CHECK_NEW} tokens, spec_k {SPEC_K} vs 0: tokens "
              f"{'identical' if same else 'DIFFER'}, max |d logp| {dlp:.3e} "
              f"(bound {SPEC_LOGP_TOL:g}), acceptance {acc}, tokens per "
              f"tick {stats['tokens_per_tick']}", flush=True)
        rows[name] = dict(tokens_identical=same, max_abs_logp_diff=dlp,
                          acceptance_rate=acc,
                          tokens_per_tick=stats["tokens_per_tick"])
        if not same or not dlp <= SPEC_LOGP_TOL:
            raise AssertionError(f"spec fp32 ({name}): tokens identical "
                                 f"{same}, max |d logp| {dlp}")
        if "identity" in name and not acc >= SPEC_MIN_ACCEPT["fp32"]:
            raise AssertionError(f"spec fp32 ({name}): acceptance {acc}")
        del eng, base, spec
    del pairs, d2
    return rows


def _served_burst(engine, bodies, profile_bodies=None):
    """Serve ``bodies`` as one concurrent burst through the port's server
    on ``engine``, then ``profile_bodies`` (if given) under the profiler;
    returns ``(results, wall seconds, ticks, launches, profile)``, the
    launch counts those of the first burst alone (set to 0 just before)."""
    from megatron_llm_tpu_torch.generation.server import MegatronServer
    from megatron_llm_tpu_torch.ops import kernels

    server = MegatronServer(engine)
    port = server.start_background("127.0.0.1", 0)
    ticks0 = engine.ticks
    profile = None
    try:
        kernels.reset_launch_counts()
        results, wall = _burst(port, bodies)
        launches = kernels.launch_counts()
        ticks = engine.ticks - ticks0
        if profile_bodies is not None:
            profile = _profiled_burst(port, profile_bodies, engine)
    finally:
        server.stop()
    return results, wall, ticks, launches, profile


def phase_spec(dev, report, args):
    """Speculative decoding: (a) the fp32 gate, spec against non-spec;
    (b) the bf16 serve burst on a full-depth Llama-2-7B through the
    port's server, spec_k 4 adaptive, beside the same burst at spec_k 0;
    (c) a TinyLlama-shaped draft on the same target."""
    import gc

    import numpy as np
    import torch

    from megatron_llm_tpu_torch.generation import (
        ContinuousBatchingEngine,
        DraftModel,
    )
    from megatron_llm_tpu_torch.generation.speculative import (
        extend_params_identity,
    )
    from megatron_llm_tpu_torch.models import make_config
    from megatron_llm_tpu_torch.tokenizer import build_tokenizer

    report.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed + 7)
    out = {"fp32": _spec_fp32_check(dev, args, rng)}
    gc.collect()
    torch.cuda.empty_cache()

    # (b) full depth, bf16: the target is the identity extension of a
    # 2-layer Llama-2-7B-width draft
    cfg = _llama_cfg("bfloat16", args.num_layers)
    dcfg = _llama_cfg("bfloat16", 2)
    draft = DraftModel(dcfg, _random_params(dcfg, args.seed, dev))
    t0 = time.time()
    target = extend_params_identity(dcfg, draft.params, cfg,
                                    _seeded_gen(dev, args.seed + 1))
    tokenizer = build_tokenizer(cfg)
    m = cfg.model
    log(f"  spec target: {m.num_layers} layers of Llama-2-7B width, bf16, "
        f"the identity extension of a {dcfg.model.num_layers}-layer draft; "
        f"set-up {time.time() - t0:.1f}s")
    prompts, bodies = serve_bodies(rng, m.vocab_size)
    # --profile: a second burst of fresh greedy prompts on each engine
    profile_bodies = (serve_bodies(rng, m.vocab_size, greedy_only=True)[1]
                      if args.profile else None)
    served = {}
    for name, kw in (("spec", dict(spec_k=SPEC_K, spec_draft=draft,
                                   spec_adaptive=True)),
                     ("plain", {})):
        engine = ContinuousBatchingEngine(cfg, target, tokenizer, device=dev,
                                          **kw)
        results, wall, ticks, launches, profile = _served_burst(
            engine, bodies, profile_bodies)
        generated = check_answers(results, prompts, bodies)
        served[name] = dict(wall_s=wall, ticks=ticks,
                            generated_tokens=generated,
                            decode_tokens_per_s=generated / wall,
                            tick_s=wall / ticks, launches=launches)
        if name == "spec":
            stats = engine.spec_stats()
            served[name]["spec_stats"] = stats
            report["spec_launches"] = launches
        if profile is not None:
            served[name]["profile"] = profile
            print(f"spec serve profile ({name}):", flush=True)
            _print_profile(profile, wall / ticks)
        engine.pool = None
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    stats = served["spec"]["spec_stats"]
    for name, row in served.items():
        extra = (f", {stats['tokens_per_tick']} tokens per decode tick, "
                 f"acceptance {stats['acceptance_rate']}"
                 if name == "spec" else "")
        print(f"spec serve ({name}, {m.num_layers} layers bf16): "
              f"{len(bodies)} concurrent PUT /api, "
              f"{row['generated_tokens']} tokens in {row['wall_s']:.3f} s: "
              f"decode {row['decode_tokens_per_s']:.2f} tokens/s, "
              f"{row['ticks']} ticks, {1e3 * row['tick_s']:.1f} ms a tick"
              f"{extra}", flush=True)
    spec_l = report["spec_launches"]
    k5_a_tick = spec_l["paged_decode_kernel"] / served["spec"]["ticks"]
    print(f"spec serve: kernel launches on the main path {json.dumps(spec_l)}"
          f" (K5 a tick: {k5_a_tick:.1f})", flush=True)
    for wrapper in ("paged_decode_kernel", "paged_ragged_kernel",
                    "paged_prefill_kernel"):
        if spec_l[wrapper] <= 0:
            raise AssertionError(f"{wrapper} never launched on the spec path")
    _assert_k4_tile("the bf16 spec burst",
                    ("paged_ragged_kernel", "paged_prefill_kernel"))
    if not (stats["acceptance_rate"] or 0.0) >= SPEC_MIN_ACCEPT["bf16"]:
        raise AssertionError(f"identity-pair acceptance {stats}")
    out["serve"] = served
    del draft
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a TinyLlama-shaped draft (random weights from a second seed)
    tcfg = make_config("llama2", params_dtype="bfloat16", **TINYLLAMA)
    tiny = DraftModel(tcfg, _random_params(tcfg, args.seed + 1, dev))
    tm = tcfg.model
    g, d = tm.num_attention_heads // tm.num_attention_heads_kv, tm.kv_channels
    prompts, bodies = serve_bodies(rng, m.vocab_size, NEW_TOKENS // 2,
                                   greedy_only=True)
    engine = ContinuousBatchingEngine(cfg, target, tokenizer, device=dev,
                                      spec_k=SPEC_K, spec_draft=tiny)
    results, wall, ticks, launches, _ = _served_burst(engine, bodies)
    generated = check_answers(results, prompts, bodies)
    stats = engine.spec_stats()
    print(f"spec tinyllama draft ({tm.num_layers} layers, hidden "
          f"{tm.hidden_size}, {tm.num_attention_heads}/"
          f"{tm.num_attention_heads_kv} heads: g {g}, d {d}): "
          f"{generated} tokens in {wall:.3f} s, {ticks} ticks, acceptance "
          f"{stats['acceptance_rate']}, K5 launches "
          f"{launches['paged_decode_kernel']}", flush=True)
    if (g, d) != (8, 64) or launches["paged_decode_kernel"] <= 0:
        raise AssertionError(f"K5 at g {g}, d {d}: {launches}")
    _assert_k4_tile("the TinyLlama-draft burst")
    out["tinyllama"] = dict(wall_s=wall, ticks=ticks, generated=generated,
                            spec_stats=stats, launches=launches)
    report["spec"] = out
    engine.pool = None
    del engine, tiny, target
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: training through the port's entry point
# ---------------------------------------------------------------------------

TRAIN_ITERS = 12
# 8 of Llama-2-7B's 32 layers: fp32 masters, gradients and two Adam moments
# take 16 bytes a parameter, 108 GB at 32 layers
TRAIN_LAYERS = 8


def write_corpus(prefix: str, seed: int, n_docs: int = 320,
                 vocab: int = 32000, n_ids: int = 300) -> int:
    """An indexed dataset of random documents over ``n_ids`` token ids
    (Zipf-weighted, drawn from ``seed``), written with the port's builder;
    returns its token count."""
    import numpy as np

    from megatron_llm_tpu_torch.data.indexed_dataset import make_builder

    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, vocab), size=n_ids, replace=False)
    weights = 1.0 / np.arange(1, n_ids + 1)
    weights /= weights.sum()
    builder = make_builder(prefix + ".bin", vocab_size=vocab)
    total = 0
    for _ in range(n_docs):
        doc = rng.choice(ids, size=int(rng.integers(1000, 3000)), p=weights)
        builder.add_doc(doc)
        total += doc.size
    builder.finalize(prefix + ".idx")
    return total


def phase_train(dev, report, args):
    import gc
    import math
    import tempfile

    import torch

    from megatron_llm_tpu_torch import finetune
    from megatron_llm_tpu_torch.config.arguments import parse_args
    from megatron_llm_tpu_torch.observability.flops import flops_per_token
    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.tokenizer import build_tokenizer
    from megatron_llm_tpu_torch.tools.kernel_check import PEAK_FLOPS
    from megatron_llm_tpu_torch.training import (
        build_gpt_data_iterators,
        evaluate,
        make_eval_step,
    )

    # the serve phase's 7B weights: its server and engine hold them in
    # reference cycles, which only the collector frees
    report.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        prefix = os.path.join(tmp, "corpus_text_document")
        n_tokens = write_corpus(prefix, args.seed)
        # no evaluation inside pretrain's timed window: one validation
        # batch is read after the run
        argv = ["--model_name", "llama2-7b",
                "--num_layers", str(TRAIN_LAYERS),
                "--seq_length", "4096", "--micro_batch_size", "1",
                "--global_batch_size", "4", "--train_iters", str(TRAIN_ITERS),
                "--lr", "3e-4", "--min_lr", "3e-5", "--lr_warmup_iters", "2",
                "--params_dtype", "bfloat16", "--data_path", prefix,
                "--split", "90,10,0", "--tokenizer_type", "NullTokenizer",
                "--vocab_size", "32000",
                "--eval_interval", str(TRAIN_ITERS + 1),
                "--eval_iters", "1", "--log_interval", "1",
                "--seed", str(args.seed)]
        cfg = parse_args(argv, n_devices=1)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.time()
        result = finetune.main(argv + ["--device", "cuda"])
        wall = time.time() - t0
        launches = kernels.launch_counts()
        loader, (_, valid_ds, _) = build_gpt_data_iterators(
            cfg, build_tokenizer(cfg))
        valid = loader(valid_ds, 0)
        try:
            val_loss = evaluate(cfg, result["params"], make_eval_step(cfg),
                                valid, device=dev)["lm loss"]
        finally:
            valid.close()
    losses = [loss for _, loss in result["loss_series"]]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if len(losses) != TRAIN_ITERS or result["iteration"] != TRAIN_ITERS:
        raise AssertionError(f"{result['iteration']} iterations, "
                             f"{len(losses)} losses logged")
    if not all(math.isfinite(x) for x in losses + [val_loss]):
        raise AssertionError(f"non-finite loss: {losses}, validation "
                             f"{val_loss}")
    if not losses[-1] <= losses[0] - 1.0:
        raise AssertionError(f"the loss fell by {losses[0] - losses[-1]:.3f} "
                             f"nats (< 1.0): {losses}")
    flash = {k: v for k, v in launches.items() if k.startswith("flash")}
    for name, n in flash.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # K1 runs twice a layer and microbatch (the forward and selective
    # recompute's second forward), K2 and K3 once (the backward), all on
    # the Hopper kernels
    per_step = TRAIN_LAYERS * 4 * TRAIN_ITERS
    for name, want in (("flash_fwd_kernel", 2 * per_step),
                       ("flash_bwd_dq_kernel", per_step),
                       ("flash_bwd_dkv_kernel", per_step)):
        path = getattr(kernels, name).last_path
        if flash[name] != want or path != "hopper":
            raise AssertionError(
                f"{name} launched {flash[name]} times (want {want}) on the "
                f"{path} kernel (want hopper)")
    step_s = 1.0 / result["steady_steps_per_sec"]
    tps = result["tokens_per_sec"]
    mfu = flops_per_token(cfg) * tps / PEAK_FLOPS["bfloat16"]
    report["train_launches"] = launches
    report["train"] = dict(
        layers=TRAIN_LAYERS, iterations=TRAIN_ITERS, losses=losses,
        validation_loss=val_loss, first_step_s=result["warmup_time"],
        step_s=step_s, tokens_per_s=tps, mfu=mfu, peak_memory_gb=peak_gb,
        corpus_tokens=n_tokens, wall_s=wall)
    print(f"train: Llama-2-7B full width, {TRAIN_LAYERS} of 32 layers, "
          f"seq 4096, global batch 4 = 4 microbatches of 1, bf16 over fp32 "
          f"masters, selective recompute, AdamW; {TRAIN_ITERS} steps in "
          f"{wall:.1f} s (first step {result['warmup_time']:.2f} s)",
          flush=True)
    print(f"train: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({', '.join(f'{x:.3f}' for x in losses)}); validation loss after "
          f"the run {val_loss:.4f}", flush=True)
    print(f"train: steady step {step_s:.4f} s, {tps:.1f} tokens/s, MFU "
          f"{100 * mfu:.2f}% of 989 TFLOP/s ({flops_per_token(cfg) / 1e9:.3f} "
          f"GFLOP/token), peak memory {peak_gb:.1f} GB, on {card_line()}",
          flush=True)
    print(f"train: kernel launches on the main path {json.dumps(flash)}",
          flush=True)
    if args.profile:
        prof = _profiled_train_step(cfg, result, dev)
        report["train_profile"] = prof
        print(f"train profile (one more step under torch.profiler, after the "
              f"counted run): {prof['wall_s']:.3f} s wall, "
              f"{prof['device_ms']:.1f} ms of device activity ("
              f"{100 * prof['device_ms'] / (1e3 * prof['wall_s']):.1f}% busy)",
              flush=True)
        for group, ms in prof["groups"]:
            print(f"train profile: {group}: {ms:.1f} ms", flush=True)
        print("train profile: top device kernels: " + "; ".join(
            f"{name} {ms:.1f} ms ({n})" for name, ms, n in prof["top"]),
            flush=True)
    del result


def _profiled_train_step(cfg, result, dev) -> dict:
    """One train step of the trained params under ``torch.profiler``: its
    wall time, the device time, and the device time by kernel name and by
    group (flash kernels, GEMMs, the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from megatron_llm_tpu_torch.training_step import make_train_step

    seq, gbs = cfg.data.seq_length, cfg.training.global_batch_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tok = torch.randint(1, cfg.model.vocab_size, (gbs, seq + 1),
                        generator=gen, device=dev)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "loss_mask": torch.ones((gbs, seq), device=dev),
             "position_ids": torch.arange(seq, device=dev)[None].expand(
                 gbs, seq).contiguous()}
    step = make_train_step(cfg)
    it = result["iteration"]
    step(result["params"], result["opt_state"], batch, it)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = step(result["params"], result["opt_state"], batch, it + 1)
        float(m["lm loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
            name = ev.key[:60]
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + us / 1e3, n + ev.count)
    groups = {"flash kernels (K1-K3)": 0.0, "GEMMs (cuBLAS)": 0.0,
              "everything else": 0.0}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        if "flash::" in name or "fwd_kernel" in name or "bwd_d" in name:
            groups["flash kernels (K1-K3)"] += ms
        elif "gemm" in low or "nvjet" in low or "sm90_xmma" in low \
                or "cutlass" in low:
            groups["GEMMs (cuBLAS)"] += ms
        else:
            groups["everything else"] += ms
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                 key=lambda r: -r[1])[:12]
    return dict(wall_s=wall, device_ms=sum(ms for ms, _ in by_name.values()),
                groups=sorted(groups.items(), key=lambda kv: -kv[1]), top=top)


# ---------------------------------------------------------------------------
# phase 8: one train step through the kernels and through the plain path
# ---------------------------------------------------------------------------

# Relative bounds on (the loss, the global gradient norm, the gradient norm
# of each layer's attention qkv and dense kernels), kernels against the
# plain path.  At init on random tokens the loss is about ln(32000)
# whatever attention does; the attention leaves' gradients are where the
# flash kernels show.  bf16: P / dS rounded to bf16 in the kernels, bf16
# scores in the plain path (H100 readings 6.9e-5, 6.3e-5, 1.2e-4); fp32:
# summation order only (8.5e-8, 0, 0).  Both paths are deterministic; the
# bounds sit 7-12x above the nonzero readings.  K1 with its scale 10% off reads
# 0.20 on the gradient norm and 0.38 on the attention leaves.
TRAIN_CHECK_TOL = {
    "bfloat16": (5e-4, 5e-4, 1e-3),
    "float32": (1e-6, 1e-6, 1e-6),
}


def phase_train_check(dev, report, args):
    import torch

    from megatron_llm_tpu_torch.models import make_config
    from megatron_llm_tpu_torch.models.language_model import init_model_params
    from megatron_llm_tpu_torch.ops import flash_attention as fa
    from megatron_llm_tpu_torch.ops import kernels
    from megatron_llm_tpu_torch.optimizer.optimizer import (
        AdamW,
        init_optimizer_state,
    )
    from megatron_llm_tpu_torch.training_step import make_train_step

    class AttentionGradNorms(AdamW):
        """AdamW that first keeps each layer's attention gradient norms."""

        def step(self, params, grads, state, prescale=1.0):
            att = grads["layers"]["attention"]
            self.leaf_norms = torch.cat([
                att[leaf]["kernel"].float().flatten(1).norm(dim=1)
                for leaf in ("qkv", "dense")]).tolist()
            return super().step(params, grads, state, prescale)

    def one_step(dtype_name, use_flash):
        cfg = make_config("llama2-7b", num_layers=2, seq_length=seq,
                          vocab_size=32000, params_dtype=dtype_name,
                          use_flash_attn=use_flash, micro_batch_size=1,
                          global_batch_size=1, train_iters=10)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 2)
        params = init_model_params(cfg, gen, device=dev, dtype=torch.float32)
        tok = torch.randint(1, 32000, (1, seq + 1), generator=gen, device=dev)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
                 "loss_mask": torch.ones((1, seq), device=dev),
                 "position_ids": torch.arange(seq, device=dev)[None]}
        opt = AttentionGradNorms(cfg)
        kernels.reset_launch_counts()
        m = make_train_step(cfg, opt)(params, init_optimizer_state(params),
                                      batch, 0)
        res = (float(m["lm loss"]), float(m["grad_norm"]), opt.leaf_norms,
               [n for k, n in kernels.launch_counts().items()
                if k.startswith("flash")])
        del params, m
        torch.cuda.empty_cache()
        return res

    def rels(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]),
                max(abs(x - y) / abs(y) for x, y in zip(a[2], b[2])))

    report.pop("model", None)
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = 2048
    rows = {}
    real_fwd = fa.flash_fwd
    for dtype_name, tol in TRAIN_CHECK_TOL.items():
        ker, plain = one_step(dtype_name, True), one_step(dtype_name, False)
        # the check's power: K1 with a softmax scale 10% off must fail it
        fa.flash_fwd = lambda *a, scale, **kw: real_fwd(
            *a, scale=PLANTED_SCALE * scale, **kw)
        try:
            planted = one_step(dtype_name, True)
        finally:
            fa.flash_fwd = real_fwd
        r, r_planted = rels(ker, plain), rels(planted, plain)
        rows[dtype_name] = dict(
            loss_kernel=ker[0], loss_plain=plain[0], grad_norm_kernel=ker[1],
            grad_norm_plain=plain[1], loss_rel=r[0], grad_norm_rel=r[1],
            attention_leaf_rel=r[2], planted_rel=r_planted)
        print(f"train-check {dtype_name}: 2 layers, seq {seq}: loss "
              f"{ker[0]:.6f} vs {plain[0]:.6f} (rel {r[0]:.2e}, bound "
              f"{tol[0]:g}), grad norm {ker[1]:.6f} vs {plain[1]:.6f} (rel "
              f"{r[1]:.2e}, bound {tol[1]:g}), attention leaves' grad norms "
              f"rel {r[2]:.2e} (bound {tol[2]:g}); planted fault (K1 scale "
              f"x{PLANTED_SCALE}) rel {r_planted[0]:.2e} / {r_planted[1]:.2e}"
              f" / {r_planted[2]:.2e}; flash launches {ker[3]} through the "
              f"kernels, {plain[3]} through the plain path", flush=True)
        if min(ker[3]) <= 0 or max(plain[3]) != 0:
            raise AssertionError(f"flash launches (K1, K2, K3) {ker[3]} "
                                 f"through the kernels, {plain[3]} through "
                                 f"the plain path")
        if not all(x <= t for x, t in zip(r, tol)):
            raise AssertionError(f"train-check {dtype_name}: rel {r} over "
                                 f"the bounds {tol}")
        if all(x <= t for x, t in zip(r_planted, tol)):
            raise AssertionError(f"train-check {dtype_name}: a planted fault "
                                 f"passed (rel {r_planted})")
    report["train_check"] = rows


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNEL_META = {
    "flash_fwd": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/flash_fwd_hopper.cu",
        replaces="megatron_llm_tpu/ops/pallas/flash_attention.py:77",
        wrapper="flash_fwd_kernel", launches_from="train_launches",
        library_note="torch.nn.functional.scaled_dot_product_attention "
                     "forward, is_causal=True"),
    "flash_bwd_dq": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/flash_bwd_hopper.cu",
        replaces="megatron_llm_tpu/ops/pallas/flash_attention.py:214",
        wrapper="flash_bwd_dq_kernel", launches_from="train_launches",
        library_note="scaled_dot_product_attention backward (dq, dk and dv "
                     "together: the same time stands on K2 and K3)"),
    "flash_bwd_dkv": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/flash_bwd_hopper.cu",
        replaces="megatron_llm_tpu/ops/pallas/flash_attention.py:264",
        wrapper="flash_bwd_dkv_kernel", launches_from="train_launches",
        library_note="scaled_dot_product_attention backward (dq, dk and dv "
                     "together: the same time stands on K2 and K3)"),
    "paged_ragged": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/paged_tile.cuh",
        replaces="megatron_llm_tpu/ops/pallas/paged_attention.py:215",
        wrapper="paged_ragged_kernel", launches_from="serve_launches",
        library_note="no single PyTorch call reads a paged KV pool"),
    "paged_decode": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/paged_tile.cuh",
        replaces="megatron_llm_tpu/ops/pallas/paged_attention.py:61",
        wrapper="paged_decode_kernel", launches_from="spec_launches",
        library_note="no single PyTorch call reads a paged KV pool"),
    "paged_prefill": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/"
               "paged_prefill_tile.cuh",
        replaces="megatron_llm_tpu/ops/pallas/paged_attention.py:134",
        wrapper="paged_prefill_kernel", launches_from="serve_launches",
        library_note="no single PyTorch call reads a paged KV pool"),
    "rms_norm_fwd": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/rmsnorm.cu",
        replaces="megatron_llm_tpu/ops/pallas/rmsnorm.py:29",
        wrapper="rms_norm_fwd_kernel", launches_from="kernel_check_launches",
        library_note="torch.nn.functional.rms_norm forward"),
    "rms_norm_bwd": dict(
        source="megatron_llm_tpu_torch/ops/kernels/csrc/rmsnorm.cu",
        replaces="megatron_llm_tpu/ops/pallas/rmsnorm.py:35",
        wrapper="rms_norm_bwd_kernel", launches_from="kernel_check_launches",
        library_note="torch.nn.functional.rms_norm backward (forward and "
                     "backward less forward)"),
}


# the extra timings a kernel row may carry (head_dim 64; K4's other ticks;
# K7 at the serve tick's shape; K6's shapes come from tools/prefill_shapes.py)
ROW_EXTRAS = ("d64_", "decode_rows_", "decode_only_", "verify_",
              "serve_decode_", "serve_mixed_", "serve_tick_")


def print_k4_price(k4: dict, kinds: dict) -> None:
    """K4's share of the serve burst, launches x (time - bound), with the
    ticks that carried prefill rows and the decode-only ticks priced apart
    (kernels phase, events): at the serve-shaped ticks, and at the mixed
    tick and its 8 decode rows (contexts up to 2048)."""
    for label, pre_key, dec_key in (("serve-shaped", "serve_mixed_",
                                     "serve_decode_"),
                                    ("2048-token", "", "decode_rows_")):
        pre_ms, pre_b = k4[pre_key + "ms"], k4[pre_key + "bound_ms"]
        dec_ms, dec_b = k4[dec_key + "ms"], k4[dec_key + "bound_ms"]
        pre = kinds["prefill"][1] * (pre_ms - pre_b)
        dec = kinds["decode"][1] * (dec_ms - dec_b)
        print(f"K4 over the serve burst, {label} ticks: "
              f"{kinds['prefill'][1]} launches on ticks with prefill rows x "
              f"({pre_ms:.4f} - {pre_b:.4f}) ms + {kinds['decode'][1]} on "
              f"decode-only ticks x ({dec_ms:.4f} - {dec_b:.4f}) ms = "
              f"{pre:.1f} + {dec:.1f} = {pre + dec:.1f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_layers", type=int, default=None,
                    help="cut the model's depth (default: the full 32)")
    ap.add_argument("--profile", action="store_true",
                    help="serve a second burst (in the serve phase, and on "
                         "the spec phase's spec and plain engines), and run "
                         "one more train step, under torch.profiler and "
                         "print the device's busy share and the top device "
                         "kernels (and host operators of the bursts); adds "
                         "minutes")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p!r}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this smoke "
            "test needs an NVIDIA GPU")
        return 2
    torch.cuda.init()   # the memory statistics need the allocator up
    try:
        from megatron_llm_tpu_torch.ops.kernels import build
    except ImportError as e:
        log(f"chip_smoke: the port's package is not importable ({e}); run "
            "from the root of a checkout of the repository")
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    report: dict = {}
    failed = []
    if "build" in phases:
        t0 = time.time()
        try:
            lib = build.build(verbose=True)
            build.library()
            log(f"build: {lib} in {time.time() - t0:.1f}s")
        except Exception:
            traceback.print_exc()
            failed.append("build")
    for name, fn in (("kernels", phase_kernels),
                     ("kernel-check", phase_kernel_check),
                     ("serve", phase_serve),
                     ("tick", phase_tick), ("spec", phase_spec),
                     ("train", phase_train),
                     ("train-check", phase_train_check)):
        if name not in phases or failed:
            continue
        if name == "tick" and "model" not in report:
            log("phase tick needs the serve phase's model")
            failed.append(name)
            continue
        t0 = time.time()
        log(f"phase {name}:")
        try:
            fn(dev, report, args)
            log(f"phase {name}: ok in {time.time() - t0:.1f}s")
        except Exception:
            traceback.print_exc()
            failed.append(name)
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    if "kernels" in report and "serve_tick_kinds" in report:
        print_k4_price(report["kernels"]["paged_ragged"],
                       report["serve_tick_kinds"])
        from megatron_llm_tpu_torch.tools.prefill_shapes import serve_price

        serve_price(report["kernels"]["paged_prefill"],
                    report["serve_launches"]["paged_prefill_kernel"])
    if "kernels" in report:
        from megatron_llm_tpu_torch.tools.prefill_shapes import K6_SHAPES

        extras = ROW_EXTRAS + tuple(key for key, _, _ in K6_SHAPES)
        line = []
        for kname, meta in KERNEL_META.items():
            row = report["kernels"][kname]
            line.append({
                "name": kname, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"],
                "launches": report.get(meta["launches_from"], {}).get(
                    meta["wrapper"]),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "kernel_ms": row["ms"], "device_ms": row["device_ms"],
                "host_us": row["host_us"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"),
                "library_note": meta["library_note"],
                "path": row.get("path", "single"),
                **{k: row[k] for k in row
                   if k in ("tflop_s", "library_host_us")
                   or k.startswith(extras)},
            })
        print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
