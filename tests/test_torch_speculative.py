"""The port's speculative decoding against the JAX package's, and its
mechanics.

Fixtures mirror ``tests/test_speculative.py``: a 2-layer target, an
independent 1-layer narrower draft (acceptance about 0, so the correction
path runs), and a same-width 1-layer draft with its identity-extended
target (acceptance 1.0).  JAX weights carry over by
``weights.params_from_jax_numpy``; everything is float32 with the jnp
fallbacks on the JAX side and the plain PyTorch versions on the port's.

* the acceptance rule against JAX's on the same drafts, logits, depths
  and uniforms, and against the speculative-sampling law in distribution;
* the spec engine against the JAX spec engine (greedy: identical tokens,
  log-probs within 1e-4, equal draft and accepted counts, prefix-cache hit
  and copy-on-write included), and against the port's own non-spec engine
  (identical tokens, log-probs within 1e-5; cache on and off, a stop
  token inside a block);
* the two faults the JAX package found (a draft-KV hole after an
  all-accepted tick; a write past the budget edge into a live page), the
  adaptive depth, the shared page ids, the options that raise, ``/health``
  and the server CLI.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.generation import ContinuousBatchingEngine as JaxEngine
from megatron_llm_tpu.generation import DraftModel as JaxDraft
from megatron_llm_tpu.generation.speculative import (
    extend_params_identity as jax_extend,
)
from megatron_llm_tpu.generation.speculative import (
    speculative_acceptance as jax_acceptance,
)
from megatron_llm_tpu.models import init_model_params as jax_init
from megatron_llm_tpu.models import make_config as jax_make_config
from megatron_llm_tpu_torch.generation import (
    ContinuousBatchingEngine,
    DraftModel,
    resolve_draft,
)
from megatron_llm_tpu_torch.generation.sampling import stream_generator
from megatron_llm_tpu_torch.generation.server import MegatronServer
from megatron_llm_tpu_torch.generation.speculative import (
    check_draft_compat,
    extend_params_identity,
)
from megatron_llm_tpu_torch.generation.speculative.draft import (
    parse_draft_spec,
)
from megatron_llm_tpu_torch.generation.speculative.verify import (
    ACCEPT_STREAM,
    DRAFT_STREAM,
    EMIT_STREAM,
    accept_prefix,
    speculative_acceptance,
)
from megatron_llm_tpu_torch.models import make_config, model_forward
from megatron_llm_tpu_torch.weights import params_from_jax_numpy

VOCAB = 67
NEVER = 10 ** 9   # a termination id no token reaches
GREEDY = dict(top_k=1, termination_id=NEVER)


def _flags(layers, hidden, heads, nkv, ffn):
    return dict(num_layers=layers, hidden_size=hidden,
                num_attention_heads=heads, num_attention_heads_kv=nkv,
                ffn_hidden_size=ffn, seq_length=128,
                max_position_embeddings=256, vocab_size=VOCAB,
                hidden_dropout=0.0, attention_dropout=0.0,
                params_dtype="float32", use_flash_attn=False)


TARGET = _flags(2, 64, 4, 2, 128)
DRAFT = _flags(1, 32, 2, 2, 64)
AGREE = _flags(1, 64, 4, 2, 128)


def _port(tree):
    return params_from_jax_numpy(jax.device_get(tree), "cpu", torch.float32)


@pytest.fixture(scope="module")
def models():
    j = {name: jax_make_config("llama2", **f)
         for name, f in (("cfg", TARGET), ("dcfg", DRAFT), ("acfg", AGREE))}
    jp = jax_init(j["cfg"], jax.random.PRNGKey(0))
    jd = jax_init(j["dcfg"], jax.random.PRNGKey(1))
    ja = jax_init(j["acfg"], jax.random.PRNGKey(2))
    j_agree = jax_extend(j["acfg"], ja, j["cfg"], jax.random.PRNGKey(3))
    p = {name: make_config("llama2", **f)
         for name, f in (("cfg", TARGET), ("dcfg", DRAFT), ("acfg", AGREE))}
    return {
        "jax": dict(cfg=j["cfg"], params=jp, agree_params=j_agree,
                    draft=JaxDraft(j["dcfg"], jd),
                    agree_draft=JaxDraft(j["acfg"], ja)),
        "port": dict(cfg=p["cfg"], params=_port(jp),
                     agree_params=_port(j_agree),
                     draft=DraftModel(p["dcfg"], _port(jd)),
                     agree_draft=DraftModel(p["acfg"], _port(ja))),
    }


def _engine(m, params="params", **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 128)
    return ContinuousBatchingEngine(m["cfg"], m[params], None, device="cpu",
                                    **kw)


def _run(eng, jobs, one_by_one=True):
    """Tokens and log-probs of each job; one by one, later jobs hit the
    prefix cache of earlier ones."""
    batches = [[j] for j in jobs] if one_by_one else [jobs]
    out = []
    for batch in batches:
        reqs = [eng.submit(p, n, **kw) for p, n, kw in batch]
        eng.run_until_idle()
        out += [r.result(timeout=60) for r in reqs]
    return out


def _greedy_jobs(n_new=18):
    """``tests/test_speculative.py``'s jobs: four prompts sharing three
    full pages, a short one, and two page-aligned duplicates (the second
    takes the copy-on-write path)."""
    shared = [2 + (i * 7) % 60 for i in range(48)]
    jobs = [(shared + [3 + (i * 11 + j) % 60 for j in range(3 + 9 * i)],
             n_new, GREEDY) for i in range(4)]
    jobs.append(([5, 9, 2], n_new, GREEDY))
    jobs += [(list(shared), 10, GREEDY)] * 2
    return jobs


def _same(a, b, tol):
    for (t0, l0), (t1, l1) in zip(a, b):
        assert t0 == t1
        np.testing.assert_allclose(l1, l0, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------


def _acceptance_inputs(seed=0, b=24, K=3, v=11):
    rng = np.random.default_rng(seed)
    t_filt = rng.normal(size=(b, K + 1, v)).astype(np.float32) * 2
    q_filt = rng.normal(size=(b, K, v)).astype(np.float32) * 2
    t_greedy = t_filt.argmax(-1).astype(np.int32)
    draft = rng.integers(0, v, size=(b, K)).astype(np.int32)
    agree = rng.random((b, K)) < 0.6    # many drafts the greedy rows accept
    draft = np.where(agree, t_greedy[:, :K], draft).astype(np.int32)
    greedy_row = rng.random(b) < 0.5
    k_eff = rng.integers(0, K + 1, size=b).astype(np.int32)
    u = rng.random((b, K)).astype(np.float32)
    return draft, q_filt, t_filt, t_greedy, greedy_row, k_eff, u


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_acceptance_rule_matches_jax():
    args = _acceptance_inputs()
    draft, q_filt, t_filt, t_greedy, greedy_row, k_eff, u = args
    b, K = draft.shape
    j_acc, j_cnt, j_emit = (np.asarray(x) for x in jax_acceptance(
        *(jnp.asarray(a) for a in args),
        jax.vmap(jax.random.PRNGKey)(jnp.arange(b))))
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    gens = {i: stream_generator(i, 0, EMIT_STREAM)
            for i in np.flatnonzero(~greedy_row)}
    acc, cnt, emit = (x.numpy() for x in speculative_acceptance(*t, gens))
    np.testing.assert_array_equal(acc, j_acc)
    np.testing.assert_array_equal(cnt, j_cnt)
    assert 0 < acc.sum() and (acc < k_eff).any()   # both paths ran
    for i in range(b):
        a = acc[i]
        np.testing.assert_array_equal(emit[i, :a], j_emit[i, :a])
        if greedy_row[i]:
            assert emit[i, a] == j_emit[i, a] == t_greedy[i, a]
    # the residual: max(p - q, 0) / Z at the first rejection, p after
    # every valid draft was accepted
    _, _, resid = accept_prefix(*t)
    p, q = _softmax(t_filt), _softmax(q_filt)
    rows = np.arange(b)
    want = np.maximum(p[rows, acc] - q[rows, np.minimum(acc, K - 1)], 0)
    want /= want.sum(-1, keepdims=True)
    want = np.where((acc >= k_eff)[:, None], p[rows, acc], want)
    np.testing.assert_allclose(resid.numpy(), want, atol=1e-6, rtol=0)


def test_acceptance_is_lossless_in_distribution():
    """n = 4000 synthetic sampled rows over v = 8 (``test_speculative.py``'s
    setup): the first emitted token is distributed as p_1.  For a correct
    sampler E[TV] <= 0.5 * sqrt(2 / (pi n)) * sqrt(v - 1) = 0.0167 here
    (E|p^_i - p_i| <= sqrt(2 p_i (1 - p_i) / (pi n)), Cauchy-Schwarz over
    the v outcomes); the bound 0.05 is three times that.  Emitting the
    draft's q instead of the rule's output must fail it."""
    rng = np.random.default_rng(0)
    v, K, n = 8, 3, 4000
    q_dist = rng.dirichlet(np.ones(v), size=K)
    p_dist = rng.dirichlet(np.ones(v), size=K + 1)
    draft = np.stack([rng.choice(v, size=n, p=q_dist[j]) for j in range(K)],
                     axis=1)
    u = rng.random((n, K)).astype(np.float32)
    q_filt = torch.log(torch.tensor(q_dist, dtype=torch.float32))
    t_filt = torch.log(torch.tensor(p_dist, dtype=torch.float32))
    acc, _, emit = speculative_acceptance(
        torch.from_numpy(draft), q_filt.expand(n, K, v),
        t_filt.expand(n, K + 1, v),
        t_filt.argmax(-1).expand(n, K + 1), torch.zeros(n, dtype=torch.bool),
        torch.full((n,), K), torch.from_numpy(u),
        {i: stream_generator(i, 0, EMIT_STREAM) for i in range(n)})
    first = np.bincount(emit[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(first - p_dist[0]).sum()
    assert tv < 0.05, tv
    assert 0.5 * np.abs(np.bincount(draft[:, 0], minlength=v) / n
                        - p_dist[0]).sum() > 0.05   # the test has power
    # the first draft's acceptance rate is sum(min(p_1, q_1)) (4 sigma)
    theo = np.minimum(p_dist[0], q_dist[0]).sum()
    assert abs(float((acc >= 1).float().mean()) - theo) < 0.03


def test_streams_depend_on_seed_step_stream_and_draw_only():
    def draw(*a):
        return torch.rand(4, generator=stream_generator(*a)).tolist()

    assert draw(7, 3, DRAFT_STREAM, 1) == draw(7, 3, DRAFT_STREAM, 1)
    seen = {tuple(draw(*a)) for a in [
        (7, 3, DRAFT_STREAM, 0), (7, 3, DRAFT_STREAM, 1),
        (7, 3, ACCEPT_STREAM, 0), (7, 3, EMIT_STREAM, 0),
        (7, 4, DRAFT_STREAM, 0), (8, 3, DRAFT_STREAM, 0)]}
    assert len(seen) == 6


# ---------------------------------------------------------------------------
# the draft bundle
# ---------------------------------------------------------------------------


def test_weights_bridge_carries_a_draft(models):
    jd, pd = models["jax"]["draft"], models["port"]["draft"]
    assert pd.num_params == jd.num_params
    tok = np.asarray([[4, 8, 15, 16, 23, 42]], np.int32)
    from megatron_llm_tpu.models import model_forward as jax_forward

    want = np.asarray(jax_forward(jd.cfg, jd.params, jnp.asarray(tok))[0])
    got, _ = model_forward(pd.cfg, pd.params, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_identity_extension_agrees_with_its_draft(models):
    m = models["port"]
    ad = m["agree_draft"]
    gen = torch.Generator()
    gen.manual_seed(5)
    ext = extend_params_identity(ad.cfg, ad.params, m["cfg"], gen)
    tok = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    a, _ = model_forward(ad.cfg, ad.params, tok)
    b, _ = model_forward(m["cfg"], ext, tok)
    assert torch.equal(a, b)
    assert not torch.equal(ext["layers"]["attention"]["qkv"]["kernel"][1],
                           torch.zeros_like(
                               ext["layers"]["attention"]["qkv"]["kernel"][1]))
    with pytest.raises(ValueError, match="hidden_size"):
        extend_params_identity(models["port"]["draft"].cfg,
                               models["port"]["draft"].params, m["cfg"], gen)


def test_parse_and_resolve_draft_spec(models):
    fam, ov, load = parse_draft_spec(
        "llama2:num_layers=2,hidden_size=256,use_flash_attn=false")
    assert (fam, ov, load) == ("llama2", {"num_layers": 2, "hidden_size": 256,
                                          "use_flash_attn": False}, None)
    assert parse_draft_spec("llama2:num_layers=1@/ckpt/d")[2] == "/ckpt/d"
    with pytest.raises(ValueError, match="key=val"):
        parse_draft_spec("llama2:num_layers")
    d = resolve_draft("llama2:num_layers=1,hidden_size=32,"
                      "num_attention_heads=2,ffn_hidden_size=64",
                      models["port"]["cfg"], device="cpu")
    assert d.cfg.model.vocab_size == VOCAB    # inherited from the target
    assert d.params["embedding"]["word_embeddings"].dtype == torch.float32
    with pytest.raises(ValueError, match="checkpoint"):
        resolve_draft("llama2:num_layers=1@/ckpt/d", models["port"]["cfg"],
                      device="cpu")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,draft", [(1, "draft"), (3, "draft"),
                                     (1, "agree_draft"), (3, "agree_draft")])
def test_spec_engine_matches_jax_spec_engine(models, k, draft):
    target = "params" if draft == "draft" else "agree_params"
    j, p = models["jax"], models["port"]
    jeng = JaxEngine(j["cfg"], j[target], None, max_slots=4, max_seq=128,
                     spec_k=k, spec_draft=j[draft])
    peng = _engine(p, target, spec_k=k, spec_draft=p[draft])
    jobs = _greedy_jobs()
    _same(_run(jeng, jobs), _run(peng, jobs), 1e-4)
    assert peng.spec_draft_tokens == jeng.spec_draft_tokens > 0
    assert peng.spec_accepted_tokens == jeng.spec_accepted_tokens
    assert peng.cow_copies == jeng.cow_copies >= 1


@pytest.mark.parametrize("cache", [True, False])
def test_spec_matches_nonspec_greedy(models, cache):
    m = models["port"]
    jobs = _greedy_jobs()
    base = _run(_engine(m, prefix_cache=cache), jobs, one_by_one=cache)
    for k, draft, target in ((3, "draft", "params"),
                             (4, "agree_draft", "agree_params")):
        if target != "params":
            base = _run(_engine(m, target, prefix_cache=cache), jobs,
                        one_by_one=cache)
        eng = _engine(m, target, prefix_cache=cache, spec_k=k,
                      spec_draft=m[draft])
        _same(base, _run(eng, jobs, one_by_one=cache), 1e-5)
        assert eng.spec_ticks > 0


def test_stop_token_inside_a_block(models):
    """A termination token inside an accepted block cuts generation where
    non-speculative decode stops."""
    m = models["port"]
    prompt = [5, 9, 2, 33, 17]
    gen0 = _run(_engine(m, "agree_params"), [(prompt, 16, GREEDY)])[0][0]
    stop = gen0[len(prompt) + 4]
    jobs = [(prompt, 16, dict(top_k=1, termination_id=stop))]
    base = _run(_engine(m, "agree_params"), jobs)
    eng = _engine(m, "agree_params", spec_k=4, spec_draft=m["agree_draft"],
                  spec_adaptive=False)
    _same(base, _run(eng, jobs), 1e-5)
    assert base[0][0][-1] == stop and len(base[0][0]) < len(prompt) + 16
    assert eng.spec_emitted_tokens < eng.spec_ticks * 5   # cut in a block


def test_identity_pair_accepts_everything_over_a_long_generation(models):
    """All-accepted ticks every time, 100 tokens long.  Without the draft
    scan's last write step, d_K's draft K/V would be a hole after each
    such tick: the draft cache must hold, at every position of the kept
    sequence, the K/V the target's first layer (the same layer: the
    identity pair) wrote there."""
    m = models["port"]
    eng = _engine(m, "agree_params", spec_k=4, spec_draft=m["agree_draft"],
                  spec_adaptive=False, prefix_cache=False)
    req = eng.submit([3, 1, 4, 1, 5], 100, **GREEDY)
    pages = []
    while not req.finished:
        pages = list(req._pages) or pages
        eng.step()
    stats = eng.spec_stats()
    assert stats["acceptance_rate"] == 1.0, stats
    assert stats["tokens_per_tick"] > 4.5
    assert eng.spec_emitted_tokens > 2 * eng.spec_ticks
    n = len(req.seq_tokens) - 1      # positions fed through both models
    pool = eng.pool
    for draft, target in ((pool.draft_k, pool.k), (pool.draft_v, pool.v)):
        d = draft[0, pages].reshape(-1, *draft.shape[3:])[:n]
        t = target[0, pages].reshape(-1, *target.shape[3:])[:n]
        torch.testing.assert_close(d, t, atol=1e-5, rtol=0)


def test_adaptive_depth_shrinks_on_low_acceptance(models):
    m = models["port"]
    jobs = [([3, 1, 4, 1, 5], 24, GREEDY)]
    fixed = _engine(m, spec_k=4, spec_draft=m["draft"], spec_adaptive=False)
    adaptive = _engine(m, spec_k=4, spec_draft=m["draft"])
    out_f = _run(fixed, jobs)
    req = adaptive.submit(*jobs[0][:2], **jobs[0][2])
    adaptive.run_until_idle()
    assert adaptive.spec_draft_tokens < fixed.spec_draft_tokens
    assert req._spec_ema < 0.5
    assert req.result(1) == out_f[0]
    assert fixed.spec_emitted_tokens == adaptive.spec_emitted_tokens


def test_draft_pool_shares_page_ids_and_drains(models):
    m = models["port"]
    eng = _engine(m, spec_k=3, spec_draft=m["draft"], prefix_cache=False)
    pool = eng.pool
    dm = m["draft"].cfg.model
    assert pool.draft_k.shape == (dm.num_layers, pool.num_pages, 16,
                                  dm.num_attention_heads_kv, dm.kv_channels)
    assert pool.kv_pool_bytes() == sum(
        t.numel() * 4 for t in (pool.k, pool.v, pool.draft_k, pool.draft_v))
    _run(eng, _greedy_jobs(), one_by_one=False)
    assert np.all(pool.refcounts == 0)
    assert pool.num_free == pool.num_pages - 1
    assert eng._committed == 0


def test_budget_edge_writes_no_live_page(models):
    """A slot at the sequence budget's edge (max_seq 64 = 4 pages): the
    rows past its depth write through the null table, never into its own
    last page — a clipped write there would land on live positions."""
    m = models["port"]
    eng = _engine(m, "agree_params", max_slots=1, max_seq=64,
                  prefix_cache=False, spec_k=4, spec_draft=m["agree_draft"],
                  spec_adaptive=False)
    req = eng.submit(list(range(2, 60)), 6, **GREEDY)
    pool = eng.pool
    edge_ticks = 0
    while not req.finished:
        pos = int(eng._positions[0])
        k = min(4, req.max_new_tokens - len(req.generated) - 1)
        live = req._phase == "decode"
        if live:
            pages = list(req._pages)
            before = [t[:, pages].clone() for t in
                      (pool.k, pool.v, pool.draft_k, pool.draft_v)]
        eng.step()
        if not live or pos + 4 < 64:
            continue
        edge_ticks += 1
        kept = torch.ones(len(pages) * 16, dtype=torch.bool)
        kept[pos:pos + k + 1] = False   # the positions this tick writes
        for old, t in zip(before, (pool.k, pool.v, pool.draft_k,
                                   pool.draft_v)):
            new = t[:, pages].reshape(t.shape[0], -1, *t.shape[3:])
            old = old.reshape_as(new)
            assert torch.equal(new[:, kept], old[:, kept])
    assert edge_ticks >= 1 and len(req.generated) == 6


@pytest.mark.parametrize("kw,match", [
    (dict(spec_k=2), "draft"),
    (dict(spec_k=2, spec_draft="DRAFT", prefill_chunk=0), "chunked prefill"),
    (dict(spec_k=2, spec_draft="DRAFT", kv_dtype="int4"), "kv_dtype"),
    (dict(spec_k=2, spec_draft="DRAFT", ragged=False), "legacy"),
    (dict(spec_k=2, spec_draft="DRAFT", tick_pipeline_depth=2), "pipelined"),
    (dict(spec_k=2, spec_draft="llama2:num_layers=1@/ckpt"), "checkpoint"),
    (dict(spec_k=2, spec_draft="llama2:num_layers=1,vocab_size=68"),
     "vocab"),
])
def test_options_that_raise(models, kw, match):
    m = models["port"]
    if kw.get("spec_draft") == "DRAFT":
        kw = dict(kw, spec_draft=m["draft"])
    with pytest.raises(ValueError, match=match):
        _engine(m, **kw)


def test_draft_compat_rejects_short_positions(models):
    short = make_config("llama2", **dict(DRAFT, seq_length=64,
                                         max_position_embeddings=64))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        check_draft_compat(models["port"]["cfg"], short, max_seq=128)


def test_health_carries_spec(models):
    m = models["port"]
    eng = _engine(m, spec_k=2, spec_draft=m["draft"])
    _run(eng, _greedy_jobs(n_new=6)[:2])
    spec = MegatronServer(eng).health()["spec"]
    assert spec["enabled"] and spec["spec_k"] == 2
    assert spec["draft_tokens"] > 0 and spec["acceptance_rate"] is not None
    assert MegatronServer(_engine(m)).health()["spec"] == {"enabled": False}


def test_server_cli_serves_with_a_draft():
    from megatron_llm_tpu_torch.tools.run_text_generation_server import (
        build_server,
    )

    server, _ = build_server([
        "--model_name", "llama2", "--random_init", "--tokenizer_type",
        "NullTokenizer", "--vocab_size", "512", "--num_layers", "2",
        "--hidden_size", "128", "--num_attention_heads", "4",
        "--ffn_hidden_size", "256", "--params_dtype", "float32",
        "--use_flash_attn", "false", "--seq_length", "256",
        "--max_position_embeddings", "256", "--device", "cpu",
        "--spec_k", "2", "--spec_draft",
        "llama2:num_layers=1,hidden_size=64,num_attention_heads=4,"
        "ffn_hidden_size=128"])
    eng = server.engine
    assert eng.spec_k == 2 and eng.draft_cfg.model.num_layers == 1
    port = server.start_background("127.0.0.1", 0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api", method="PUT",
            data=json.dumps({"prompts": ["5 17 42"], "tokens_to_generate": 8,
                             "top_k": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            body = json.loads(resp.read())
        toks = body["text"][0].split()
        assert toks[:3] == ["5", "17", "42"] and 3 < len(toks) <= 11
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as resp:
            spec = json.loads(resp.read())["spec"]
        assert spec["enabled"] and spec["draft_tokens"] > 0
    finally:
        server.stop()
