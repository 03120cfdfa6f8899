"""The port's quantized paged KV cache (``ops/kv_quant.py``) against the JAX
package's, and its contracts in the port's engine.

* **Write path, bitwise**: the same fp32 rows through both packages'
  ``paged_write`` give the same value bytes and scales, int8 and fp8: a
  16-row chunk that fills one page (colliding rows), a fresh page over a
  stale scale, a mid-page append that grows the scale, writes to the null
  page (its colliding slots excepted: garbage by design).
  ``quantize_pages``, ``dequantize_pages`` and ``scatter_whole_pages``
  bitwise too; ``kv_error_bound`` within 1e-7 relative.
* **Engine against engine**: the port's engine and the JAX engine at
  ``kv_dtype`` int8 and fp8 on the same weights (3 layers, fp32): 3
  prompts x 12 greedy tokens identical, token and prompt log-probs within
  the reference's ``LOGPROB_GATE`` (5e-3, ``tests/test_kv_quant.py``);
  after prefill the pools' scales agree to 1e-6 relative and their values
  by at most one quantum.
* **The reference's contracts, in the port**, on the reference's own
  sanity workload (``tests/test_kv_quant.py``: a 1-layer draft and its
  identity extension, here to 3 layers, 3 prompts of 37 tokens): int8 /
  fp8 greedy tokens equal the plain pool's; prefix cache on (with a
  copy-on-write clone) and off give equal tokens and log-probs at int8;
  speculative decoding at int8 gives the plain tokens with every draft
  token accepted; an int8 pool's value bytes are half a bf16 pool's, and
  its scales take L * P * nkv * 4 bytes per cache.
* **Where the contract stops**: a page's bytes depend on how its rows were
  grouped into writes (a growing scale re-rounds what the page holds), and
  the draft scan writes one row a step where the verify writes K + 1 at
  once.  On a wider model (hidden 1024, vocab 32000) at fp8 the reference
  engine's own speculative tokens part from its plain ones and it rejects
  drafts of the identity pair; the port's engine gives the JAX engine's
  tokens and acceptance counts there, token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.generation import ContinuousBatchingEngine as JaxEngine
from megatron_llm_tpu.models import init_model_params as jax_init
from megatron_llm_tpu.models import make_config as jax_make_config
from megatron_llm_tpu.ops import kv_quant as J
from megatron_llm_tpu_torch.generation import ContinuousBatchingEngine
from megatron_llm_tpu_torch.generation.engine import PagedKVPool
from megatron_llm_tpu_torch.generation.server import MegatronServer
from megatron_llm_tpu_torch.generation.speculative import (
    extend_params_identity,
)
from megatron_llm_tpu_torch.models import make_config
from megatron_llm_tpu_torch.ops import kv_quant as P
from megatron_llm_tpu_torch.weights import (
    kv_pool_from_jax_numpy,
    params_from_jax_numpy,
)

KV = ("int8", "fp8")
LOGPROB_GATE = 5e-3       # the reference's own gate (tests/test_kv_quant.py)
PAGE, NKV, D = 16, 4, 64
GREEDY = dict(top_k=1, termination_id=0, use_eod_for_termination=False)
CFG = dict(num_layers=3, hidden_size=64, num_attention_heads=4,
           num_attention_heads_kv=2, ffn_hidden_size=128, vocab_size=512,
           seq_length=256, max_position_embeddings=256, hidden_dropout=0.0,
           attention_dropout=0.0, params_dtype="float32",
           use_flash_attn=False)
# the reference's sanity workload (tests/test_kv_quant.py: CFG_KW, its
# models fixture and _prompts), its target extended to 3 layers
REF_CFG = dict(CFG, num_attention_heads_kv=4)


# ---------------------------------------------------------------------------
# ops/kv_quant.py against the JAX package's, bitwise
# ---------------------------------------------------------------------------


def _bytes_jax(pool):
    return np.asarray(pool.q).view(np.uint8), np.asarray(pool.scale)


def _bytes_port(pool):
    return P._bytes(pool.q).view(torch.uint8).numpy(), pool.scale.numpy()


def _write_cases(rng):
    """``name -> [(page_ids [1, s], offs [1, s], vals [1, s, nkv, d])]``,
    written in order into a fresh 6-page pool."""
    def write(pages, offs, vals):
        return np.array([pages]), np.array([offs]), vals

    def normal(rows, sigma):
        return rng.normal(0, sigma, (1, rows, NKV, D))

    return {
        # a 16-row chunk that fills page 1: every row collides on it
        "chunk-fills-a-page": [write([1] * 16, list(range(16)),
                                     normal(16, 2))],
        # page 2 held a huge tenant; a fresh write at offset 0 resets it
        "fresh-over-stale": [
            write([2], [0], np.full((1, 1, NKV, D), 1e3)),
            write([2], [1], normal(1, 9)),
            write([2], [0], normal(1, .5)),
        ],
        # appends that grow page 3's scale and re-round what it holds
        "append-grows-scale": [
            write([3, 3], [0, 1], normal(2, 1)),
            write([3], [2], normal(1, 5)),
            write([3], [3], normal(1, 9)),
        ],
        # dead rows routed to the null page beside live rows
        "null-page": [write([4, 0, 0, 5, 0], [0, 0, 0, 7, 3], normal(5, 4))],
    }


@pytest.mark.parametrize("case", ["chunk-fills-a-page", "fresh-over-stale",
                                  "append-grows-scale", "null-page"])
@pytest.mark.parametrize("kv_dtype", KV)
def test_paged_write_bitwise_equal_to_jax(kv_dtype, case):
    writes = _write_cases(np.random.default_rng(0))[case]
    jp = J.make_pool((6, PAGE, NKV, D), kv_dtype, jnp.float32)
    pp = P.make_pool((6, PAGE, NKV, D), kv_dtype, torch.float32)
    for ids, offs, vals in writes:
        vals = vals.astype(np.float32)
        jp = J.paged_write(jp, jnp.asarray(ids, jnp.int32),
                           jnp.asarray(offs, jnp.int32), jnp.asarray(vals))
        P.paged_write(pp, torch.tensor(ids, dtype=torch.int32),
                      torch.tensor(offs, dtype=torch.int32),
                      torch.from_numpy(vals))
        (jq, js), (pq, ps) = _bytes_jax(jp), _bytes_port(pp)
        assert np.array_equal(js, ps)
        # the null page's colliding slots hold whichever row won: garbage
        # by design, never attended
        ok = jq == pq
        ok[0, np.unique(offs[ids == 0])] = True
        assert ok.all()
    if case == "fresh-over-stale":      # the stale 1e3 scale did not leak
        assert float(pp.scale[2].max()) < 0.1


@pytest.mark.parametrize("kv_dtype", KV)
def test_quantize_scatter_and_bound_bitwise_equal_to_jax(kv_dtype):
    rng = np.random.default_rng(1)
    vals = rng.normal(0, 3, (2, 3, PAGE, NKV, D)).astype(np.float32)
    jq = J.quantize_pages(jnp.asarray(vals), kv_dtype)
    pq = P.quantize_pages(torch.from_numpy(vals), kv_dtype)
    assert np.array_equal(_bytes_jax(jq)[0], _bytes_port(pq)[0])
    assert np.array_equal(_bytes_jax(jq)[1], _bytes_port(pq)[1])
    assert np.array_equal(np.asarray(J.dequantize_pages(jq, jnp.float32)),
                          P.dequantize_pages(pq, torch.float32).numpy())
    for appends in (False, True):
        jb = J.kv_error_bound(jnp.asarray(vals), kv_dtype, appends=appends)
        pb = P.kv_error_bound(torch.from_numpy(vals), kv_dtype,
                              appends=appends)
        assert abs(jb - pb) <= 1e-7 * abs(jb)
    # whole pages over a stacked [L, P, ...] pool
    jp = J.make_pool((2, 6, PAGE, NKV, D), kv_dtype, jnp.float32)
    pp = P.make_pool((2, 6, PAGE, NKV, D), kv_dtype, torch.float32)
    ids = np.array([4, 1, 5], np.int32)
    jp = J.scatter_whole_pages(jp, jnp.asarray(ids), jnp.asarray(vals))
    P.scatter_whole_pages(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    for a, b in zip(_bytes_jax(jp), _bytes_port(pp)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kv_dtype", KV)
def test_pool_bridge_and_dequant_gather(kv_dtype):
    """``weights.kv_pool_from_jax_numpy`` carries a JAX pool byte for byte,
    and both packages' dequantizing gathers agree bitwise in fp32."""
    rng = np.random.default_rng(2)
    vals = rng.normal(0, 2, (7, PAGE, NKV, D)).astype(np.float32)
    jq = J.quantize_pages(jnp.asarray(vals), kv_dtype)
    pq = kv_pool_from_jax_numpy(np.asarray(jq.q), np.asarray(jq.scale), "cpu")
    assert pq.q.dtype == P.make_pool((1, PAGE, NKV, D), kv_dtype, None).q.dtype
    for a, b in zip(_bytes_jax(jq), _bytes_port(pq)):
        assert np.array_equal(a, b)
    tables = np.array([[3, 1, 0], [6, 2, 5]], np.int32)
    want = np.asarray(J.dequant_gather(jq, jnp.asarray(tables), jnp.float32))
    got = P.dequant_gather(pq, torch.from_numpy(tables)).numpy()
    assert np.array_equal(want, got)


def test_layer_accessor_and_pool_bytes():
    """``kv_quant.layer`` takes a layer of either kind of stacked pool (a
    view); indexing the container itself would take a field.  Value bytes:
    int8 is half of bf16; scales L * P * nkv * 4 bytes a cache."""
    shape = (3, 5, PAGE, NKV, D)
    plain = P.make_pool(shape, "bf16", torch.bfloat16)
    quant = P.make_pool(shape, "int8", torch.bfloat16)
    assert not P.is_quantized(plain) and P.is_quantized(quant)
    assert P.pool_nbytes(quant) * 2 == P.pool_nbytes(plain)
    assert P.scale_nbytes(quant) == 3 * 5 * NKV * 4
    assert P.scale_nbytes(plain) == 0
    for i in range(3):
        lay = P.layer(quant, i)
        assert lay.q.shape == shape[1:] and lay.scale.shape == (5, NKV)
        lay.scale[1, 0] = float(i + 1)
        assert float(quant.scale[i, 1, 0]) == i + 1
        assert P.layer(plain, i).shape == shape[1:]
    assert quant[1] is quant.scale       # the trap the accessor avoids
    assert P.page_size_of(quant) == P.page_size_of(plain) == PAGE


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jax_make_config("llama2", **CFG)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    pcfg = make_config("llama2", **CFG)
    pparams = params_from_jax_numpy(jax.device_get(jparams), "cpu",
                                    torch.float32)
    # the reference's identity pair: its 1-layer draft (PRNGKey(1)), the
    # target its extension (to 3 layers here; the extra layers add nothing)
    dcfg = make_config("llama2", **dict(REF_CFG, num_layers=1))
    dparams = params_from_jax_numpy(
        jax.device_get(jax_init(jax_make_config("llama2", **dict(
            REF_CFG, num_layers=1)), jax.random.PRNGKey(1))), "cpu",
        torch.float32)
    tcfg = make_config("llama2", **REF_CFG)
    target = extend_params_identity(dcfg, dparams, tcfg,
                                    torch.Generator().manual_seed(2))
    return dict(jcfg=jcfg, jparams=jparams, pcfg=pcfg, pparams=pparams,
                dcfg=dcfg, dparams=dparams, tcfg=tcfg, target=target)


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG["vocab_size"], length).tolist()
            for _ in range(n)]


def _port(models, kv_dtype, which="port", **kw):
    """The port's engine on the engine-vs-engine weights (``which="port"``)
    or on the reference's identity pair's target (``"target"``)."""
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 128)
    cfg, params = ((models["pcfg"], models["pparams"]) if which == "port"
                   else (models["tcfg"], models["target"]))
    return ContinuousBatchingEngine(cfg, params, None, device="cpu",
                                    kv_dtype=kv_dtype, **kw)


def _run(engine, jobs, n_new):
    """``jobs``: (prompt, extra submit kwargs); returns per job (tokens,
    log-probs, prompt log-probs)."""
    reqs = [engine.submit(p, n_new, **GREEDY, **kw) for p, kw in jobs]
    engine.run_until_idle()
    out = []
    for r in reqs:
        toks, lps = r.result(timeout=120)
        out.append((toks, np.asarray(lps), r.prompt_log_probs))
    return out


def _jobs():
    p = _prompts(3, 37, seed=3)
    return [(p[0], {}), (p[1], {}), (p[2], dict(return_log_probs=True))]


@pytest.fixture(scope="module", params=KV)
def engine_pair(request, models):
    kv_dtype = request.param
    jeng = JaxEngine(models["jcfg"], models["jparams"], None, max_slots=4,
                     max_seq=128, kv_dtype=kv_dtype)
    peng = _port(models, kv_dtype)
    return kv_dtype, _run(jeng, _jobs(), 12), _run(peng, _jobs(), 12)


def test_engine_tokens_and_log_probs_match_jax(engine_pair):
    kv_dtype, jax_out, port_out = engine_pair
    worst = 0.0
    for (jt, jl, jpl), (pt, pl, ppl) in zip(jax_out, port_out):
        assert pt == jt, kv_dtype
        worst = max(worst, float(np.abs(pl - jl).max()))
        assert (jpl is None) == (ppl is None)
        if jpl is not None:
            assert len(ppl) == len(jpl) == 36
            worst = max(worst, float(np.abs(np.asarray(ppl)
                                            - np.asarray(jpl)).max()))
    print(f"{kv_dtype}: max |log-prob port - jax| {worst:.3e}")
    assert worst <= LOGPROB_GATE


def _ordered_codes(q: np.ndarray) -> np.ndarray:
    """Storage codes in value order: int8 as it is; e4m3 bytes
    (sign-magnitude) mapped so that adjacent values differ by one."""
    if q.dtype == np.int8:
        return q.astype(np.int32)
    b = q.view(np.uint8).astype(np.int32)
    return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)


@pytest.mark.parametrize("kv_dtype", KV)
def test_pools_after_prefill_match_jax(models, kv_dtype):
    """After the prompts' prefill (one new token: the first tick re-feeds
    the last prompt token), the port's pools hold the JAX engine's scales
    to 1e-6 relative and its values to within one quantum."""
    jeng = JaxEngine(models["jcfg"], models["jparams"], None, max_slots=4,
                     max_seq=128, kv_dtype=kv_dtype)
    peng = _port(models, kv_dtype)
    _run(jeng, _jobs(), 1)
    _run(peng, _jobs(), 1)
    worst_scale, worst_q = 0.0, 0
    for jpool, ppool in ((jeng.pool.k, peng.pool.k),
                         (jeng.pool.v, peng.pool.v)):
        js, ps = np.asarray(jpool.scale), ppool.scale.numpy()
        assert js.shape == ps.shape and (js[:, 1:] > 0).any()
        rel = np.abs(js - ps) / np.maximum(np.abs(js), 1e-30)
        worst_scale = max(worst_scale, float(rel[:, 1:].max()))
        jq = _ordered_codes(np.asarray(jpool.q))
        pq = _ordered_codes(P._bytes(ppool.q).view(torch.uint8).numpy()
                            .view(np.int8 if kv_dtype == "int8"
                                  else np.uint8))
        worst_q = max(worst_q, int(np.abs(jq - pq)[:, 1:].max()))
    print(f"{kv_dtype}: scales rel {worst_scale:.2e}, values {worst_q} "
          f"quantum")
    assert worst_scale <= 1e-6 and worst_q <= 1


@pytest.mark.parametrize("kv_dtype", KV)
def test_greedy_tokens_equal_the_plain_pools(models, kv_dtype):
    """int8 and fp8 greedy tokens equal the plain pool's on the short
    horizon (the reference's test_greedy_agreement_short_horizon, on the
    identity pair's 3-layer target)."""
    jobs = [(p, {}) for p in _prompts(3, 37)]
    base = _run(_port(models, "bf16", "target"), jobs, 12)
    got = _run(_port(models, kv_dtype, "target"), jobs, 12)
    for (tb, _, _), (tq, _, _) in zip(base, got):
        assert tb == tq


def test_prefix_cache_on_off_equal_at_int8(models):
    """A warm prefix cache replays quantized pages and their scales, a
    page-aligned full match through a copy-on-write clone: tokens and
    log-probs equal a cache-off engine's."""
    shared, tail = _prompts(1, 48, seed=4)[0], _prompts(1, 6, seed=5)[0]
    warm = _port(models, "int8", "target")
    _run(warm, [(shared + tail, {})], 8)    # caches the three full pages
    hits = warm.prefix_hit_tokens
    warm_out = _run(warm, [(shared, {})], 8)
    assert warm.prefix_hit_tokens - hits == 48 and warm.cow_copies == 1
    cold_out = _run(_port(models, "int8", "target", prefix_cache=False),
                    [(shared, {})], 8)
    assert warm_out[0][0] == cold_out[0][0]
    assert np.array_equal(warm_out[0][1], cold_out[0][1])


def test_copy_on_write_clones_the_scales(models):
    eng = _port(models, "int8", max_slots=2)
    _run(eng, [(p, {}) for p in _prompts(2, 20, seed=6)], 4)
    k, v = eng.pool.k, eng.pool.v
    eng._copy_page(1, 7)
    for pool in (k, v):
        assert torch.equal(pool.scale[:, 7], pool.scale[:, 1])
        assert torch.equal(pool.q[:, 7], pool.q[:, 1])
        assert (pool.scale[:, 1] > 0).all()


def test_speculative_equals_plain_at_int8(models):
    """Speculation at int8: the identity pair's spec tokens equal the
    non-speculative tokens, and the draft's every token is accepted (both
    models read the same quantized page discipline)."""
    jobs = [(p, {}) for p in _prompts(3, 37)]
    plain = _run(_port(models, "int8", "target"), jobs, 12)
    eng = _port(models, "int8", "target", spec_k=2,
                spec_draft=(models["dcfg"], models["dparams"]))
    spec = _run(eng, jobs, 12)
    for (tp, _, _), (ts, _, _) in zip(plain, spec):
        assert tp == ts
    assert P.is_quantized(eng.pool.draft_k)
    assert eng.spec_draft_tokens > 0
    assert eng.spec_accepted_tokens == eng.spec_draft_tokens


def test_pool_bytes_and_health(models):
    """An int8 pool's value bytes are half a bf16 pool's at equal pages;
    its scales take L * P * nkv * 4 bytes a cache; ``/health`` reports
    both beside ``kv_dtype``."""
    cfg = make_config("llama2", **dict(CFG, params_dtype="bfloat16"))
    p16 = PagedKVPool(cfg, 33, PAGE, device="cpu")
    p8 = PagedKVPool(cfg, 33, PAGE, device="cpu", kv_dtype="int8")
    assert p8.kv_pool_bytes() * 2 == p16.kv_pool_bytes()
    assert p16.kv_scale_bytes() == 0
    assert p8.kv_scale_bytes() == 3 * 33 * 2 * 4 * 2
    eng = _port(models, "fp8")
    health = MegatronServer(eng).health()
    assert health["kv_dtype"] == "fp8"
    assert health["kv_pool_bytes"] == eng.pool.kv_pool_bytes() > 0
    assert health["kv_scale_bytes"] == eng.pool.kv_scale_bytes() > 0


def test_speculative_matches_jax_where_quantization_parts_it_from_plain():
    """fp8 pools on a wider identity pair (hidden 1024, vocab 32000; a
    2-layer draft, its 4-layer extension): the JAX engine's speculative
    tokens part from its plain ones and it rejects some drafts (rounding
    in differently grouped writes, not a fault); the port's engines give
    the JAX engines' tokens, plain and speculative, and the same draft and
    accepted counts."""
    from megatron_llm_tpu.generation import DraftModel as JaxDraft
    from megatron_llm_tpu.generation.speculative import (
        extend_params_identity as jax_extend,
    )

    wide = dict(CFG, hidden_size=1024, num_attention_heads=8,
                num_attention_heads_kv=8, ffn_hidden_size=1024,
                vocab_size=32000, seq_length=512,
                max_position_embeddings=512)
    jd = jax_make_config("llama2", **dict(wide, num_layers=2))
    jt = jax_make_config("llama2", **dict(wide, num_layers=4))
    jdp = jax_init(jd, jax.random.PRNGKey(1))
    jtp = jax_extend(jd, jdp, jt, jax.random.PRNGKey(0))
    pd = make_config("llama2", **dict(wide, num_layers=2))
    pt = make_config("llama2", **dict(wide, num_layers=4))
    pdp, ptp = (params_from_jax_numpy(jax.device_get(x), "cpu",
                                      torch.float32) for x in (jdp, jtp))
    rng = np.random.default_rng(0)
    jobs = [(rng.integers(1, 32000, n).tolist(), {}) for n in (100, 171)]
    kw = dict(max_slots=4, max_seq=512, kv_dtype="fp8")
    j_plain = _run(JaxEngine(jt, jtp, None, **kw), jobs, 32)
    j_eng = JaxEngine(jt, jtp, None, spec_k=4, spec_draft=JaxDraft(jd, jdp),
                      **kw)
    j_spec = _run(j_eng, jobs, 32)
    p_plain = _run(ContinuousBatchingEngine(pt, ptp, None, device="cpu",
                                            **kw), jobs, 32)
    p_eng = ContinuousBatchingEngine(pt, ptp, None, device="cpu", spec_k=4,
                                     spec_draft=(pd, pdp), **kw)
    p_spec = _run(p_eng, jobs, 32)
    # the reference parts from its plain stream here ...
    assert any(a[0] != b[0] for a, b in zip(j_plain, j_spec))
    assert j_eng.spec_accepted_tokens < j_eng.spec_draft_tokens
    # ... and the port follows it token for token
    assert [r[0] for r in p_plain] == [r[0] for r in j_plain]
    assert [r[0] for r in p_spec] == [r[0] for r in j_spec]
    assert (p_eng.spec_draft_tokens, p_eng.spec_accepted_tokens) == (
        j_eng.spec_draft_tokens, j_eng.spec_accepted_tokens)
