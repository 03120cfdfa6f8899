"""Check and time the chunked-prefill paged-attention kernel (K6) on the card
at the serving path's shapes.

    python megatron_llm_tpu_torch/tools/prefill_shapes.py [--root DIR]

Each shape of ``K6_SHAPES`` (bf16; one 64-row chunk on its own block
table, as wide as the engine makes it) goes through
``ops.paged_attention.paged_attention_prefill`` with the kernel and with
its plain version.  The kernel must agree elementwise (``TOL`` abs + rel)
and by norm (``NORM_BAR``), and a launch at a softmax scale 10% off must
fail the norm bar (the check can see a wrong kernel).  Then it is timed by
CUDA events (the better of two), on the device (``torch.profiler``) and
on the host a launch, beside its bound.  The smoke test runs the same
measurement (:func:`measure`); run as a script, this prints one JSON
object a shape and the serve burst's price, ``--launches`` x (time -
bound) over the serve burst's chunks.

``--root DIR`` imports ``megatron_llm_tpu_torch`` from another checkout,
to time an older commit's kernel on the same shapes and the same card in
one run: its package needs ``ops.paged_attention.paged_attention_prefill``
and ``tools.kernel_check``'s timers.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

TOL = 1e-2        # bf16: |kernel - plain| <= TOL + TOL |plain| everywhere
NORM_BAR = 1e-2   # bf16: |kernel - plain|_2 <= NORM_BAR |plain|_2
PLANTED = 1.1     # the planted fault: the softmax scale 10% off
HOST_CALLS = 200  # launches a host-µs reading takes

# K6's timed shapes beside the mixed tick's chunk (timed by the smoke
# test's kernels phase): (b) the serve burst's log-prob chunks, (c) a
# chunk at the end of Llama-2's 4096-token context, (d) GQA 32/8, (e) the
# TinyLlama draft's shape; key prefix, case, what
K6_SHAPES = (
    *((f"serve_c{p}_", dict(n=32, nkv=32, start=p),
       f"(b) the serve burst's log-prob chunk at {p}")
      for p in (0, 64, 128, 192)),
    ("long_", dict(n=32, nkv=32, start=3968),
     "(c) 64 rows at 3968, Llama-2-7B"),
    ("gqa_", dict(n=32, nkv=8, start=960), "(d) gqa-32/8, 64 rows at 960"),
    ("draft_", dict(n=32, nkv=4, d=64, start=512),
     "(e) the draft's 32/4 heads at d 64, 64 rows at 512"),
)
SERVE_KEYS = tuple(key for key, _, _ in K6_SHAPES
                   if key.startswith("serve_c"))


class PrefillCase:
    """One prefill chunk of ``s`` rows at ``start`` on its own block table,
    as wide as the engine makes it (the chunk's end bucketed up to 64
    tokens), pages in a random order; the work this data needs: q and the
    output, each K / V page once, the causal (or window's) tokens a row."""

    def __init__(self, torch, gen, dev, dtype, *, n, nkv, start, d=128,
                 page=16, s=64, window=None):
        W = -(-(start + s) // 64) * 64 // page
        self.bt = (torch.randperm(W, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(1, W)
        self.start = torch.tensor([start], dtype=torch.int32, device=dev)
        self.q = torch.randn((1, s, n, d), generator=gen, device=dev).to(dtype)
        self.k, self.v = (torch.randn((W + 1, page, nkv, d), generator=gen,
                                      device=dev).to(dtype) for _ in range(2))
        self.scale, self.window = 1.0 / d ** 0.5, window
        esz = self.q.element_size()
        ctx = [min(p + 1, window or p + 1) for p in range(start, start + s)]
        self.bytes = (2 * self.q.numel() * esz + 2 * (start + s) * nkv * d * esz
                      + 4 * (W + 1))
        self.flops = 4.0 * n * d * sum(ctx)

    def run(self, use_kernel=True, scale=None):
        from megatron_llm_tpu_torch.ops.paged_attention import (
            paged_attention_prefill)

        return paged_attention_prefill(
            self.q, self.k, self.v, self.bt, self.start,
            scale=self.scale if scale is None else scale,
            sliding_window=self.window, use_kernel=use_kernel)


def measure(torch, gen, dev, key, spec, what) -> dict:
    """Check K6 (bf16) on one shape of ``K6_SHAPES`` and time it: the
    readings as ``<key>*`` entries.  Raises if the kernel disagrees with
    its plain version or the planted fault passes the norm bar."""
    from megatron_llm_tpu_torch.tools.kernel_check import (
        bound,
        cuda_ms,
        device_ms,
        host_us,
        norm_rel,
    )

    pc = PrefillCase(torch, gen, dev, torch.bfloat16, **spec)
    ker, ref = pc.run().float(), pc.run(use_kernel=False).float()
    planted = pc.run(scale=PLANTED * pc.scale).float()
    err = (ker - ref).abs()
    rel, planted_rel = norm_rel(ker, ref), norm_rel(planted, ref)
    if not (bool((err <= TOL + TOL * ref.abs()).all()) and rel <= NORM_BAR):
        raise AssertionError(f"paged_prefill disagrees with its plain version "
                             f"on {what}: max abs err {float(err.max())}, "
                             f"norm-relative {rel}")
    if planted_rel <= NORM_BAR:
        raise AssertionError(f"paged_prefill at a scale {PLANTED}x off passes "
                             f"the norm bar on {what}: {planted_rel}")
    b_ms, b_by = bound(pc.bytes, pc.flops, "bfloat16")
    row = {f"{key}ms": min(cuda_ms(pc.run) for _ in range(2)),
           f"{key}device_ms": device_ms(pc.run),
           f"{key}host_us": host_us(pc.run, n=HOST_CALLS),
           f"{key}bound_ms": b_ms, f"{key}max_abs_err": float(err.max()),
           f"{key}norm_rel": rel, f"{key}planted_norm_rel": planted_rel}
    dv = row[f"{key}device_ms"]
    print(f"kernels: paged_prefill on {what}: {row[key + 'ms']:.4f} ms by "
          f"events (device {dv:.4f} ms, host {row[key + 'host_us']:.1f} us a "
          f"launch), bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / dv:.1f}% of "
          f"it on the device; max abs err {float(err.max()):.3e}, "
          f"norm-relative {rel:.3e} (bar {NORM_BAR}; at a {PLANTED}x scale "
          f"{planted_rel:.3e})", flush=True)
    return row


def serve_price(k6: dict, launches: int) -> dict:
    """K6's share of the serve burst, ``launches`` x (time - bound) at the
    shape of its log-prob chunks (a quarter of the launches at each of
    ``SERVE_KEYS``), by events and on the device, in ms."""
    price = {}
    for label, t in (("events", "ms"), ("device", "device_ms")):
        parts = [k6[key + t] - k6[key + "bound_ms"] for key in SERVE_KEYS]
        price[label] = launches / len(parts) * sum(parts)
        print(f"K6 over the serve burst ({label}): {launches} launches, a "
              f"quarter at each chunk x (" + " + ".join(
                  f"{p:.4f}" for p in parts) + f") / {len(parts)} ms = "
              f"{price[label]:.1f} ms", flush=True)
    return price


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="import megatron_llm_tpu_torch from the checkout at "
                    "DIR (default: this file's)")
    ap.add_argument("--launches", type=int, default=128,
                    help="K6 launches of the serve burst to price (the "
                    "smoke test's serve phase counts 128)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    import megatron_llm_tpu_torch

    pkg = Path(megatron_llm_tpu_torch.__file__).resolve()
    if Path(args.root).resolve() not in pkg.parents:
        raise SystemExit(f"prefill_shapes: imported {pkg}, not the package "
                         f"under {args.root} (run this file by its path)")
    if not torch.cuda.is_available():
        raise SystemExit("prefill_shapes: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    print(f"prefill_shapes: {megatron_llm_tpu_torch.__file__} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    k6 = {}
    for key, spec, what in K6_SHAPES:
        k6.update(measure(torch, gen, dev, key, spec, what))
        print(json.dumps({"shape": key, **{k: v for k, v in k6.items()
                                           if k.startswith(key)}}),
              flush=True)
    serve_price(k6, args.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
