"""Launch the REST text-generation server of the PyTorch port.

    python -m megatron_llm_tpu_torch.tools.run_text_generation_server \\
        --model_name llama2-7b --random_init --tokenizer_type NullTokenizer \\
        --vocab_size 32000 --port 5000 [--device cuda|cpu] \\
        [--kv_dtype int8|fp8] \\
        [--spec_k 4 --spec_draft "llama2:num_layers=2" --spec_adaptive true]

Takes the flags of ``tools/run_text_generation_server.py`` (any
``Config`` flag passes through to ``parse_args``) plus ``--device``: the
server runs on ``cuda`` unless ``--device cpu`` is given, and raises when
CUDA is asked for and missing.  It serves the continuous-batching engine
over a paged KV pool; ``--random_init`` makes seeded random weights
(``--seed``).  ``--kv_dtype int8|fp8`` stores the KV pool (target and
draft) in one byte an element with per-page scales (``ops/kv_quant.py``;
default ``bf16``: a plain pool in the compute dtype); ``/health``
reports ``kv_pool_bytes`` and ``kv_scale_bytes``.  ``--spec_k K
--spec_draft SPEC`` serves with speculative decoding: a draft model built
from SPEC (``family:key=val,...``, seeded random weights, the target's
vocab) proposes up to K tokens a slot each tick.  Flags of features outside this slice (``--load`` of an
orbax checkpoint, a ``@/ckpt`` draft, ``--legacy_engine``, router
registration, serving roles, ``--tp``/``--pp`` > 1, ...) raise a ``ValueError`` naming the
later slice.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch


def _later(flag: str, slice_name: str) -> None:
    raise ValueError(f"{flag} is not in this slice of the PyTorch port (it "
                     f"comes with the {slice_name} slice)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--model_name", default="llama2")
    ap.add_argument("--load", help="checkpoint directory to serve")
    ap.add_argument("--tokenizer_type", default="HFTokenizer")
    ap.add_argument("--tokenizer_model", help="tokenizer name/path")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000,
                    help="0 = ephemeral: the bound port is printed")
    ap.add_argument("--random_init", action="store_true",
                    help="serve seeded random weights (smoke test)")
    ap.add_argument("--legacy_engine", action="store_true")
    ap.add_argument("--register_url")
    ap.add_argument("--register_interval", type=float, default=2.0)
    ap.add_argument("--advertise_url")
    ap.add_argument("--serving_role", default="unified",
                    choices=("unified", "prefill", "decode"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def build_server(argv: Optional[List[str]] = None) -> Tuple[object, object]:
    """Parse ``argv`` and build ``(server, args)``; the server is bound by
    the caller (``server.bind`` / ``server.start_background``)."""
    from megatron_llm_tpu_torch.config.arguments import parse_args
    from megatron_llm_tpu_torch.generation.engine import (
        ContinuousBatchingEngine,
    )
    from megatron_llm_tpu_torch.generation.server import MegatronServer
    from megatron_llm_tpu_torch.models import init_model_params
    from megatron_llm_tpu_torch.models.families import validate_family
    from megatron_llm_tpu_torch.tokenizer import build_tokenizer
    from megatron_llm_tpu_torch.utils.device import compute_dtype, resolve_device

    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    if args.legacy_engine:
        _later("--legacy_engine", "legacy-engine")
    if args.register_url or args.advertise_url:
        _later("router registration (--register_url/--advertise_url)",
               "router")
    if args.serving_role != "unified":
        _later(f"--serving_role {args.serving_role}", "disaggregated-serving")
    if args.load:
        _later("--load (orbax checkpoints)", "checkpoint-loading")
    if not args.random_init:
        ap.error("--random_init is required (checkpoint loading comes with "
                 "a later slice)")
    device = resolve_device(args.device)
    cfg = parse_args(
        ["--model_name", args.model_name] + extra
        + ["--tokenizer_type", args.tokenizer_type]
        + (["--tokenizer_model", args.tokenizer_model]
           if args.tokenizer_model else []))
    validate_family(cfg)
    tokenizer = build_tokenizer(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.training.seed)
    params = init_model_params(cfg, gen, device=device,
                               dtype=compute_dtype(cfg))
    inf = cfg.inference
    engine = ContinuousBatchingEngine(
        cfg, params, tokenizer, device=device, kv_dtype=inf.kv_dtype,
        spec_k=inf.spec_k, spec_draft=inf.spec_draft,
        spec_adaptive=inf.spec_adaptive)
    return MegatronServer(engine), args


def main(argv: Optional[List[str]] = None) -> None:
    server, args = build_server(argv)
    port = server.bind(args.host, args.port)
    eng = server.engine
    print(f"serving (continuous-batching, sched={eng.policy.name}, "
          f"kv_dtype={eng.kv_dtype}, spec_k={eng.spec_k}, "
          f"device={eng.device}) on "
          f"http://{args.host}:{port}/api",
          flush=True)
    server.serve()


if __name__ == "__main__":
    main()
