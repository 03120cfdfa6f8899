"""The port's request validation (``generation/server.py:_validate``)
against the JAX package's, payload by payload: the same 400 message where
the reference refuses, the same parsed fields where both accept.  Three
well-formed requests for features of later slices (beam search,
streaming, KV handoff) pass the reference's checks and get the port's
later-slice refusal instead.
"""

import pytest

from megatron_llm_tpu.generation.server import _validate as jax_validate
from megatron_llm_tpu_torch.generation.server import _validate

BASE = {"prompts": ["hi"], "tokens_to_generate": 4}

# (case id, extra fields on BASE)
REFUSED = [
    ("stop_token-str", {"stop_token": "x"}),
    ("length_penalty-str", {"length_penalty": "x"}),
    ("priority-42", {"priority": 42}),
    ("priority-str", {"priority": "a"}),
    ("ttft_deadline-negative", {"ttft_deadline_ms": -1}),
    ("tpot_deadline-str", {"tpot_deadline_ms": "x"}),
    ("tpot_deadline-bool", {"tpot_deadline_ms": True}),
    ("priority-negative", {"priority": -1}),
    ("beam_width-0", {"beam_width": 0}),
    ("beam_width-two-prompts", {"beam_width": 2, "prompts": ["a", "b"]}),
    ("stream-str", {"stream": "yes"}),
    ("top_k-and-top_p", {"top_k": 2, "top_p": 0.5}),
    ("temperature-0", {"temperature": 0}),
    ("random_seed-below", {"random_seed": -2}),
    ("no-prompts", {"prompts": None}),
    # the first fault in the reference's order decides the message
    ("priority-and-stop_token", {"priority": 42, "stop_token": "x"}),
    ("deadline-and-stream", {"ttft_deadline_ms": 0, "stream": "yes"}),
]

ACCEPTED = [
    ("defaults", {}),
    ("stop_token", {"stop_token": 2}),
    ("length_penalty-int", {"length_penalty": 2}),
    ("length_penalty-float", {"length_penalty": 0.5}),
    ("priority-0", {"priority": 0}),
    ("priority-9", {"priority": 9}),
    ("deadlines", {"ttft_deadline_ms": 250, "tpot_deadline_ms": 12.5}),
    ("sampling", {"top_p": 0.9, "temperature": 0.7, "random_seed": 3}),
    ("stream-false", {"stream": False}),
]

LATER_SLICE = [
    ("beam_width-2", {"beam_width": 2}, "beam_width"),
    ("stream-true", {"stream": True}, "stream"),
    ("handoff_to", {"handoff_to": "http://127.0.0.1:1"}, "handoff_to"),
]


def _payload(extra):
    payload = dict(BASE, **extra)
    return {k: v for k, v in payload.items() if v is not None}


@pytest.mark.parametrize("extra", [c[1] for c in REFUSED],
                         ids=[c[0] for c in REFUSED])
def test_refused_with_the_reference_message(extra):
    want_params, want = jax_validate(_payload(extra))
    got_params, got = _validate(_payload(extra))
    assert want_params is None and want
    assert got_params is None
    assert got == want


@pytest.mark.parametrize("extra", [c[1] for c in ACCEPTED],
                         ids=[c[0] for c in ACCEPTED])
def test_accepted_with_the_reference_fields(extra):
    want, want_err = jax_validate(_payload(extra))
    got, got_err = _validate(_payload(extra))
    assert want_err is None and got_err is None
    assert got == want


@pytest.mark.parametrize("extra,field", [c[1:] for c in LATER_SLICE],
                         ids=[c[0] for c in LATER_SLICE])
def test_later_slice_features_refused(extra, field):
    want, want_err = jax_validate(_payload(extra))
    assert want_err is None and want is not None
    got, got_err = _validate(_payload(extra))
    assert got is None
    assert got_err.startswith(field)
    assert "slice of the PyTorch port" in got_err
