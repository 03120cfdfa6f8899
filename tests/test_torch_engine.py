"""The port's continuous-batching engine and server against the JAX
package's engine, on the same weights (float32, jnp fallbacks on the JAX
side, plain PyTorch versions on the port's CPU side).

Four prompts of 5/63/64/130 tokens; the 130-token prompt starts with the
64-token one, and the 64-token prompt arrives after the 130-token one has
filled the prefix cache, so the trie match AND copy-on-write run.  16 new
tokens each: greedy tokens identical, generated and prompt log-probs
within 1e-4.  Cache on and off give identical tokens in the port; the
pool's refcounts return to all-free; a sampled request's tokens do not
depend on the slot it lands in; an in-process server answers ``PUT
/api`` with the engine's tokens and ``tokens_to_generate: 0`` with a 400.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.generation import ContinuousBatchingEngine as JaxEngine
from megatron_llm_tpu.models import init_model_params as jax_init
from megatron_llm_tpu.models import make_config as jax_make_config
from megatron_llm_tpu_torch.generation import ContinuousBatchingEngine
from megatron_llm_tpu_torch.generation.server import MegatronServer
from megatron_llm_tpu_torch.models import make_config
from megatron_llm_tpu_torch.tokenizer.tokenizer import _NullTokenizer
from megatron_llm_tpu_torch.weights import params_from_jax_numpy

VOCAB = 67
NEW = 16
TOL = 1e-4
CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           num_attention_heads_kv=2, ffn_hidden_size=128, seq_length=256,
           max_position_embeddings=256, vocab_size=VOCAB,
           hidden_dropout=0.0, attention_dropout=0.0,
           params_dtype="float32", use_flash_attn=False)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_make_config("llama2", **CFG)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    pcfg = make_config("llama2", **CFG)
    pparams = params_from_jax_numpy(jax.device_get(jparams), "cpu",
                                    torch.float32)
    return jcfg, jparams, pcfg, pparams


def _prompts():
    rng = np.random.default_rng(0)
    p64 = rng.integers(2, VOCAB, size=64).tolist()
    p130 = p64 + rng.integers(2, VOCAB, size=66).tolist()
    p5 = rng.integers(2, VOCAB, size=5).tolist()
    p63 = rng.integers(2, VOCAB, size=63).tolist()
    greedy = dict(top_k=1)
    # wave 1 fills the trie with the 130-token prompt's pages; wave 2's
    # 64-token prompt then matches four full pages (page-aligned: COW)
    wave1 = [(p130, greedy), (p5, greedy)]
    wave2 = [(p64, greedy), (p63, dict(top_k=1, return_log_probs=True))]
    return wave1, wave2


def _serve(engine):
    out = []
    for wave in _prompts():
        reqs = [engine.submit(p, NEW, **kw) for p, kw in wave]
        engine.run_until_idle()
        out += [(r.result(timeout=60), r.prompt_log_probs) for r in reqs]
    return out


def _port_engine(models, **kw):
    pcfg, pparams = models[2], models[3]
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 160)
    return ContinuousBatchingEngine(pcfg, pparams, None, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(models):
    jcfg, jparams = models[0], models[1]
    jeng = JaxEngine(jcfg, jparams, None, max_slots=4, max_seq=160)
    peng = _port_engine(models)
    return _serve(jeng), jeng, _serve(peng), peng


def test_greedy_tokens_identical_to_jax(runs):
    jax_out, _, port_out, _ = runs
    for ((jt, _), _), ((pt, _), _) in zip(jax_out, port_out):
        assert pt == jt


def test_log_probs_match_jax(runs):
    jax_out, _, port_out, _ = runs
    for ((_, jl), jpl), ((_, pl), ppl) in zip(jax_out, port_out):
        np.testing.assert_allclose(pl, jl, atol=TOL, rtol=0)
        assert (jpl is None) == (ppl is None)
        if jpl is not None:
            assert len(ppl) == len(jpl) == 62
            np.testing.assert_allclose(ppl, jpl, atol=TOL, rtol=0)


def test_trie_match_and_cow_ran_like_jax(runs):
    _, jeng, _, peng = runs
    assert peng.cow_copies == jeng.cow_copies == 1
    assert peng.prefix_hit_tokens == jeng.prefix_hit_tokens >= 64


def test_pool_returns_to_all_free(runs):
    peng = runs[3]
    assert int(peng.pool.refcounts.sum()) == 0
    assert peng.pool.num_available == peng.pool.num_pages - 1
    assert peng._committed == 0
    assert all(s is None for s in peng._slots)


def test_cache_off_gives_identical_tokens(models, runs):
    port_out = runs[2]
    off = _serve(_port_engine(models, prefix_cache=False))
    assert [t for (t, _), _ in off] == [t for (t, _), _ in port_out]


def test_sampled_tokens_independent_of_slot(models):
    prompt = [7, 8, 9, 10, 11]
    kw = dict(top_k=5, temperature=0.9, seed=1234)
    alone = _port_engine(models)
    r = alone.submit(prompt, NEW, **kw)
    alone.run_until_idle()
    crowded = _port_engine(models)
    others = [crowded.submit([3 + i, 4, 5], NEW, top_k=1) for i in range(2)]
    r2 = crowded.submit(prompt, NEW, **kw)
    crowded.run_until_idle()
    assert (r._slot, r2._slot) == (0, 2)   # the slots they ran in
    assert r.result(1)[0] == r2.result(1)[0]
    assert all(o.result(1) for o in others)
    # a different seed draws a different stream
    other = _port_engine(models)
    r3 = other.submit(prompt, NEW, **dict(kw, seed=99))
    other.run_until_idle()
    assert r3.result(1)[0] != r.result(1)[0]


def test_server_answers_put_api(models):
    engine = _port_engine(models)
    engine.tokenizer = _NullTokenizer(VOCAB)
    server = MegatronServer(engine)
    port = server.start_background("127.0.0.1", 0)
    try:
        def put(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api", data=json.dumps(body).encode(),
                method="PUT", headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        prompt = [5, 17, 42, 9, 33]
        code, body = put({"prompts": [" ".join(map(str, prompt))],
                          "tokens_to_generate": 8, "top_k": 1,
                          "logprobs": True})
        assert code == 200, body
        direct = _port_engine(models)
        r = direct.submit(prompt, 8, top_k=1, termination_id=0)
        direct.run_until_idle()
        want = r.result(1)[0]
        assert body["text"][0] == " ".join(map(str, want))
        assert len(body["logprobs"][0]) == len(want) - 1
        code, body = put({"prompts": ["1 2 3"], "tokens_to_generate": 0,
                          "logprobs": True})
        assert code == 400 and "tokens_to_generate=0" in body["error"]
        code, body = put({"prompts": ["1 2 3"], "beam_width": 2})
        assert code == 400 and "slice" in body["error"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["max_slots"] == 4
        assert health["device"] == "cpu"
    finally:
        server.stop()


@pytest.mark.parametrize("kw,match", [
    (dict(spec_k=2), "speculative"),
    (dict(kv_dtype="int4"), "kv_dtype"),
    (dict(sched_policy="priority"), "scheduling"),
    (dict(ragged=False), "legacy"),
    (dict(prefill_chunk=0), "legacy"),
    (dict(tick_pipeline_depth=2), "pipelined"),
])
def test_out_of_slice_options_raise(models, kw, match):
    with pytest.raises(ValueError, match=match):
        _port_engine(models, **kw)


def test_cuda_default_device_raises_without_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    pcfg, pparams = models[2], models[3]
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(pcfg, pparams, None)
