"""Continuous-batching engine on a prefix-cached paged KV cache (port of
``megatron_llm_tpu/generation/engine.py``, the subset the default serving
path runs).

* **Paged KV pool** (:class:`PagedKVPool`): all in-flight sequences share
  ``[L, num_pages, page_size, nkv, d]`` tensors; a sequence owns an ordered
  page list (its block table).  ``kv_dtype`` picks the storage: ``bf16``
  a plain pool in the compute dtype, ``int8`` / ``fp8`` one-byte pages
  with per-page, per-kv-head scales (``ops/kv_quant.py``), for about twice
  the pages at the same bytes.  Pages are reference-counted, so several
  sequences share the pages of a common prompt prefix.  Page 0 is the null
  page: idle rows point at it and their writes land there, never attended.

* **Prefix cache** (:class:`PrefixCache`): a host-side trie keyed on
  page-aligned token chunks.  Admission takes a ref on every matched full
  page and prefills only the uncovered suffix; a page-aligned full match
  copies the last shared page first (copy-on-write).  Pages whose refcount
  drops to zero stay cached until the free list runs dry, then LRU
  leaf-first eviction recycles them.

* **On-demand pages** under a commitment ledger: admission allocates the
  prompt-suffix pages plus the first decode page and books the worst-case
  rest, so an in-flight slot never deadlocks on the pool.

* **Ragged tick** (``generation/ragged.py``): every tick is ONE forward
  over the decode slots plus up to ``prefill_rows`` prefill-chunk rows
  packed under the policy's token budget; chunk boundaries sit on the
  absolute ``prefill_chunk`` grid, so the K/V bits a chunk writes depend
  only on (tokens, positions).  Requests that ask for prompt log-probs take
  the teacher-forced chunk path instead (:meth:`_chunk_prefill`), whose
  ``s``-row forward runs the prefill attention kernel.

* **Speculative decoding** (``spec_k > 0``, ``generation/speculative/``):
  a draft model proposes up to ``spec_k`` tokens a slot each tick and the
  target verifies them in the same ragged forward; the draft's K/V lives
  in the pool under the target's page ids, so one block table, refcount,
  commitment ledger and prefix trie govern both caches.  Greedy output is
  the non-speculative stream; sampled output has its distribution.

* **Scheduling**: decisions delegate to a
  :class:`~megatron_llm_tpu_torch.generation.scheduling.SchedulerPolicy`
  (this slice: ``fcfs``); mechanisms stay here.

Threading: ``submit`` may be called from any thread (concurrent HTTP
handlers); device work happens on whichever thread drives :meth:`step`,
the background loop (:meth:`start`) or a caller loop
(:meth:`run_until_idle`).

Options of the JAX engine outside this slice raise a ``ValueError`` that
names the later slice (:func:`check_slice_options`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from megatron_llm_tpu_torch.generation import generation as gen
from megatron_llm_tpu_torch.generation.ragged import make_ragged_tick_fn
from megatron_llm_tpu_torch.generation.scheduling import (
    SchedulerPolicy,
    SchedulerState,
    get_policy,
)
from megatron_llm_tpu_torch.generation.speculative import (
    DraftModel,
    check_draft_compat,
    resolve_draft,
)
from megatron_llm_tpu_torch.generation.tokenization import (
    detokenize_generations,
)
from megatron_llm_tpu_torch.models.language_model import (
    make_rope_cache,
    model_forward,
)
from megatron_llm_tpu_torch.ops import kv_quant
from megatron_llm_tpu_torch.ops.paged_attention import PagedState
from megatron_llm_tpu_torch.utils.device import compute_dtype, resolve_device

NULL_PAGE = 0


def _bucket_up(n: int, bucket: int = gen.BUCKET) -> int:
    return -(-n // bucket) * bucket


def check_slice_options(cfg, *, kv_dtype="bf16", ragged=True,
                        prefill_chunk=64, sched_policy="fcfs",
                        tick_pipeline_depth=0) -> None:
    """Raise a ``ValueError`` naming the later slice for every option of
    the JAX engine this slice does not run."""
    def later(what: str, slice_name: str) -> None:
        raise ValueError(f"{what} is not in this slice of the PyTorch port "
                         f"(it comes with the {slice_name} slice)")

    par = cfg.parallel
    if kv_dtype not in kv_quant.KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {kv_quant.KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    if par.tensor_model_parallel_size > 1 or \
            par.pipeline_model_parallel_size > 1:
        later("tensor/pipeline-parallel serving (--tp/--pp > 1)",
              "multi-GPU serving")
    if tick_pipeline_depth:
        later("tick_pipeline_depth > 0 (chained multi-tick dispatch)",
              "pipelined-dispatch")
    if sched_policy != "fcfs":
        later(f"sched_policy={sched_policy!r}", "scheduling-policies")
    if not ragged or not prefill_chunk:
        later("the legacy split dispatch (ragged_tick=false or "
              "prefill_chunk=0)", "legacy-engine")
    if cfg.inference.int8_weights:
        later("int8_weights (weight-only int8 decode)", "quantized-weights")


class EngineOverloaded(RuntimeError):
    """Submit-time backpressure: the request queue is at capacity.  The
    server answers a structured 503 with ``Retry-After``."""

    def __init__(self, msg: str, retry_after: float = 1.0,
                 info: Optional[dict] = None):
        super().__init__(msg)
        self.retry_after = retry_after
        self.info = info or {}


class PagedKVPool:
    """Device page pool + host refcounting allocator.

    Page states (disjoint): **free** (on the free list, refcount 0, not
    cached); **referenced** (refcount > 0, possibly also in the prefix
    cache); **cached-idle** (refcount 0 but registered in the prefix cache:
    reusable by a future match, reclaimable by ``evict_hook`` when
    ``alloc`` outruns the free list).

    ``k``/``v`` are ``[L, num_pages, page_size, nkv, d]``: plain tensors in
    the compute dtype for ``kv_dtype="bf16"``, ``kv_quant.QuantPagedKV``
    containers (one-byte values and ``[L, num_pages, nkv]`` fp32 scales)
    for ``int8`` / ``fp8``.  With ``draft_cfg`` (speculative decoding) the
    pool also holds the draft's K/V, ``draft_k``/``draft_v`` ``[L_draft,
    num_pages, page_size, nkv_draft, d_draft]``, addressed by the same page
    ids and stored the same way (the draft quantizes with the target)."""

    def __init__(self, cfg, num_pages: int, page_size: int, *, device,
                 draft_cfg=None, kv_dtype: str = "bf16"):
        def pools(c):
            m = c.model
            shape = (m.num_layers, num_pages, page_size,
                     m.num_attention_heads_kv, m.kv_channels)
            return tuple(kv_quant.make_pool(shape, kv_dtype, compute_dtype(c),
                                            device) for _ in range(2))

        self.k, self.v = pools(cfg)
        self.draft_k = self.draft_v = None
        if draft_cfg is not None:
            self.draft_k, self.draft_v = pools(draft_cfg)
        self.num_pages = num_pages
        self.page_size = page_size
        self.refcounts = np.zeros((num_pages,), np.int32)
        self.cached: Set[int] = set()
        self.evict_hook = None  # PrefixCache.evict: (n) -> freed page list
        # page 0 reserved as the null page (never allocated)
        self._free: deque = deque(range(1, num_pages))

    def caches(self):
        """The pool's caches: the target's K and V and, when speculating,
        the draft's."""
        return [t for t in (self.k, self.v, self.draft_k, self.draft_v)
                if t is not None]

    def kv_pool_bytes(self) -> int:
        """Device bytes of the KV values, target and draft caches (scales
        apart: :meth:`kv_scale_bytes`)."""
        return sum(kv_quant.pool_nbytes(t) for t in self.caches())

    def kv_scale_bytes(self) -> int:
        """Device bytes of the per-page scales (0 for plain pools)."""
        return sum(kv_quant.scale_nbytes(t) for t in self.caches())

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_evictable(self) -> int:
        return sum(1 for p in self.cached if self.refcounts[p] == 0)

    @property
    def num_available(self) -> int:
        return self.num_free + self.num_evictable

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, or None; evicts cached-idle
        pages only when the free list alone runs short."""
        if n > self.num_available:
            return None
        if n > len(self._free) and self.evict_hook is not None:
            self._free.extend(self.evict_hook(n - len(self._free)))
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            assert self.refcounts[p] == 0 and p not in self.cached
            self.refcounts[p] = 1
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert p != NULL_PAGE
            self.refcounts[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; unreferenced pages return to the
        free list unless the prefix cache still holds them."""
        for p in pages:
            assert p != NULL_PAGE, "null page is never allocated"
            self.refcounts[p] -= 1
            assert self.refcounts[p] >= 0, f"page {p} over-released"
            if self.refcounts[p] == 0 and p not in self.cached:
                self._free.append(p)


class _TrieNode:
    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.last_use = 0


class PrefixCache:
    """Host-side trie over page-aligned token chunks -> pool pages.

    Each node owns one FULL page of prompt K/V keyed by that page's token
    ids; a path from the root spells a prompt prefix.  A request that
    matches a page has matched all its ancestors, so a refcount-0 node's
    descendants are refcount-0 too and eviction proceeds leaf-first."""

    def __init__(self, pool: PagedKVPool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self.root = _TrieNode(None, NULL_PAGE, None)
        self._nodes: Dict[int, _TrieNode] = {}  # page id -> node
        self._clock = 0
        pool.evict_hook = self.evict

    def __len__(self) -> int:
        return len(self._nodes)

    def _key(self, tokens: Sequence[int], i: int) -> Tuple[int, ...]:
        ps = self.page_size
        return tuple(tokens[i * ps:(i + 1) * ps])

    def match(self, tokens: Sequence[int], max_pages: int) -> List[int]:
        """Longest cached prefix in whole pages (at most ``max_pages``);
        takes one pool ref per matched page."""
        self._clock += 1
        node, pages = self.root, []
        for i in range(max_pages):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            child.last_use = self._clock
            pages.append(child.page)
            node = child
        self.pool.incref(pages)
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_pages: int) -> int:
        """Register the first ``n_pages`` full pages of a prefilled prompt;
        an incumbent at a position wins.  Returns pages newly cached."""
        self._clock += 1
        node, added = self.root, 0
        for i in range(n_pages):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                p = pages[i]
                if p in self._nodes:  # defensive: one node per page
                    break
                child = _TrieNode(key, p, node)
                node.children[key] = child
                self._nodes[p] = child
                self.pool.cached.add(p)
                added += 1
            child.last_use = self._clock
            node = child
        return added

    def evict(self, n: int) -> List[int]:
        """Reclaim up to ``n`` cached-idle pages, least-recently-used
        leaves first."""
        freed: List[int] = []
        while len(freed) < n:
            victim = None
            for node in self._nodes.values():
                if node.children or self.pool.refcounts[node.page] != 0:
                    continue
                if victim is None or node.last_use < victim.last_use:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            del self._nodes[victim.page]
            self.pool.cached.discard(victim.page)
            freed.append(victim.page)
        return freed


@dataclasses.dataclass
class EngineRequest:
    """One in-flight generation; ``result()`` blocks until finished."""

    prompt: List[int]
    max_new_tokens: int
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    termination_id: Optional[int] = None
    use_eod_for_termination: bool = True
    stop_on_double_eol: bool = False
    stop_on_eol: bool = False
    seed: Optional[int] = None
    return_log_probs: bool = False

    # engine-filled state
    generated: List[int] = dataclasses.field(default_factory=list)
    log_probs: List[float] = dataclasses.field(default_factory=list)
    prompt_log_probs: Optional[List[float]] = None
    finished: bool = False
    error: Optional[str] = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _pages: List[int] = dataclasses.field(default_factory=list, repr=False)
    _step: int = 0  # decode ticks taken (== len(generated))
    # queued -> prefill -> decode -> finished
    _phase: str = dataclasses.field(default="queued", repr=False)
    _slot: int = dataclasses.field(default=-1, repr=False)
    _fill_pos: int = dataclasses.field(default=0, repr=False)
    _max_pages: int = dataclasses.field(default=0, repr=False)
    _t_submit: float = dataclasses.field(default=0.0, repr=False)
    _t_first: float = dataclasses.field(default=0.0, repr=False)
    # sampling seed resolved at first activation and pinned: the row's
    # draws are a function of (this seed, step) alone
    _seed: Optional[int] = dataclasses.field(default=None, repr=False)
    # speculative decoding: the acceptance EMA behind the adaptive depth
    _spec_ema: float = dataclasses.field(default=1.0, repr=False)

    def result(self, timeout: Optional[float] = None):
        """Wait for completion; returns (full token list, gen log-probs)."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error:
            raise RuntimeError(self.error)
        return list(self.prompt) + self.generated, list(self.log_probs)

    @property
    def seq_tokens(self) -> List[int]:
        return list(self.prompt) + self.generated

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from submit to first generated token."""
        if self._t_first == 0.0:
            return None
        return self._t_first - self._t_submit


class ContinuousBatchingEngine:
    """Shared-tick decode over a prefix-cached paged pool."""

    def __init__(self, cfg, params, tokenizer=None, *,
                 device=None,
                 max_slots: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 page_watermark: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 sched_policy=None,
                 prefill_budget: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 spec_draft=None,
                 spec_adaptive: Optional[bool] = None,
                 ragged: Optional[bool] = None,
                 tick_pipeline_depth: Optional[int] = None):
        inf = cfg.inference
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prefill_chunk = (prefill_chunk if prefill_chunk is not None
                              else inf.prefill_chunk)
        sched = (sched_policy if sched_policy is not None
                 else inf.sched_policy)
        self.spec_k = spec_k if spec_k is not None else inf.spec_k
        self.spec_adaptive = (spec_adaptive if spec_adaptive is not None
                              else inf.spec_adaptive)
        if self.spec_k and not self.prefill_chunk:
            raise ValueError(
                "speculative decoding requires chunked prefill "
                "(prefill_chunk > 0): draft K/V is filled through the "
                "block-table prefill path")
        check_slice_options(
            cfg,
            kv_dtype=kv_dtype if kv_dtype is not None else inf.kv_dtype,
            ragged=ragged if ragged is not None else inf.ragged_tick,
            prefill_chunk=self.prefill_chunk,
            sched_policy=(sched.name if isinstance(sched, SchedulerPolicy)
                          else sched),
            tick_pipeline_depth=(tick_pipeline_depth
                                 if tick_pipeline_depth is not None
                                 else inf.tick_pipeline_depth))
        if self.device.type == "cuda" and not cfg.training.use_flash_attn:
            raise ValueError(
                "use_flash_attn=false on a CUDA engine: the serving path "
                "always runs the paged-attention kernels on the card (the "
                "plain versions are for CPU tests and on-card reference "
                "checks)")
        leaf = params["embedding"]["word_embeddings"]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, engine device "
                             f"is {self.device}")
        self.params = params
        self.tokenizer = tokenizer
        self.max_slots = max_slots or inf.max_batch_slots
        self.page_size = page_size or inf.page_size
        self.max_seq = (max_seq or inf.engine_max_seq
                        or min(cfg.data.seq_length,
                               cfg.model.max_position_embeddings))
        if self.max_seq > cfg.model.max_position_embeddings:
            raise ValueError("max_seq exceeds max_position_embeddings")
        self.draft_cfg = self.draft_params = None
        if self.spec_k:
            self._init_draft(spec_draft if spec_draft is not None
                             else inf.spec_draft)
        if gen.BUCKET % self.page_size:
            raise ValueError("page_size must divide the 64-token bucket")
        if self.prefill_chunk % self.page_size:
            raise ValueError("prefill_chunk must be a whole number of pages")
        use_cache = (prefix_cache if prefix_cache is not None
                     else inf.prefix_cache)
        self.page_watermark = (page_watermark if page_watermark is not None
                               else inf.page_watermark)
        self.max_queue = (max_queue if max_queue is not None
                          else inf.max_queued_requests)
        self.policy = (sched if isinstance(sched, SchedulerPolicy)
                       else get_policy(sched)(aging_s=inf.sched_aging_s,
                                              preemption=False))
        budget_cap = (prefill_budget if prefill_budget is not None
                      else inf.prefill_budget)
        # prefill-row capacity of the ragged tick; the policy's token
        # budget is capped here
        self.prefill_rows = max(self.prefill_chunk, int(budget_cap or 0))
        # distinct prefilling requests packable into one tick
        self._pre_tables_cap = self.prefill_rows // self.prefill_chunk + 1
        self.pages_per_seq = -(-self.max_seq // self.page_size)
        num_pages = (num_pages or inf.kv_pool_pages
                     or self.max_slots * self.pages_per_seq + 1)
        self.kv_dtype = kv_dtype if kv_dtype is not None else inf.kv_dtype
        self.pool = PagedKVPool(cfg, num_pages, self.page_size,
                                device=self.device, draft_cfg=self.draft_cfg,
                                kv_dtype=self.kv_dtype)
        self.cache = (PrefixCache(self.pool, self.page_size)
                      if use_cache else None)
        self.rope = make_rope_cache(cfg, device=self.device)
        self.draft_rope = (make_rope_cache(self.draft_cfg, device=self.device)
                           if self.draft_cfg is not None else None)
        self._tick_fn = make_ragged_tick_fn(
            cfg, rope_cache=self.rope, draft_cfg=self.draft_cfg,
            spec_k=self.spec_k, draft_rope_cache=self.draft_rope)

        # host-side slot state + scheduler queues, guarded by _lock
        s = self.max_slots
        self._block_tables = np.zeros((s, self.pages_per_seq), np.int32)
        self._positions = np.zeros((s,), np.int32)
        self._tokens = np.zeros((s,), np.int32)
        self._temperature = np.ones((s,), np.float32)
        self._top_k = np.ones((s,), np.int32)   # idle slots decode greedy
        self._top_p = np.zeros((s,), np.float32)
        self._seeds = [0] * s
        self._steps = np.zeros((s,), np.int32)
        self._slots: List[Optional[EngineRequest]] = [None] * s
        self._queue: deque = deque()
        self._prefill_q: deque = deque()  # admitted, prompt not yet filled
        # worst-case pages admitted-but-not-yet-held; admission keeps
        # free + evictable >= committed (+ watermark)
        self._committed = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # serializes device driving (step) across caller threads
        self._drive_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._ema_tick_s: Optional[float] = None
        self._ema_retire_s: Optional[float] = None
        self._last_retire_t: Optional[float] = None

        # telemetry
        self.ticks = 0
        self.peak_active_slots = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.cow_copies = 0
        self.recent_ttft_s: deque = deque(maxlen=1024)
        self.spec_ticks = 0
        self.spec_draft_tokens = 0     # drafts proposed (sum of k_eff)
        self.spec_accepted_tokens = 0  # drafts the target accepted
        self.spec_emitted_tokens = 0   # tokens emitted by spec ticks

    def _init_draft(self, draft) -> None:
        """Resolve the draft (a ``--spec_draft`` string, a
        :class:`DraftModel` or a ``(cfg, params)`` pair) and check it
        against the target and the engine's device."""
        if draft is None:
            raise ValueError(
                "spec_k > 0 (speculative decoding) requires a draft model "
                "(spec_draft / --spec_draft)")
        if isinstance(draft, str):
            draft = resolve_draft(draft, self.cfg, device=self.device)
        elif isinstance(draft, tuple):
            draft = DraftModel(*draft)
        check_draft_compat(self.cfg, draft.cfg, max_seq=self.max_seq)
        if self.device.type == "cuda" and \
                not draft.cfg.training.use_flash_attn:
            raise ValueError(
                "a draft with use_flash_attn=false on a CUDA engine: the "
                "draft runs the paged-attention kernels on the card too")
        leaf = draft.params["embedding"]["word_embeddings"]
        if leaf.device != self.device:
            raise ValueError(f"draft params live on {leaf.device}, engine "
                             f"device is {self.device}")
        self.draft_cfg, self.draft_params = draft.cfg, draft.params

    # -- device programs ---------------------------------------------------

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def _chunk_prefill(self, tokens: np.ndarray, start: int, bt: np.ndarray,
                       targets: np.ndarray) -> torch.Tensor:
        """One teacher-forced prefill CHUNK: feed ``tokens`` ``[1, rows]`` at
        positions ``start..start+rows-1`` through the block table ``bt``
        (write K/V into the owned pages, attend over the first
        ``kv_pages`` pages) and return the log-probs of ``targets``.  A
        speculating engine runs the draft's chunk through the same table
        too, so every prefilled page carries draft K/V."""
        rows = tokens.shape[1]
        tok = self._dev(tokens)
        start_t = self._dev(np.asarray([start], np.int32))
        pos = start_t[:, None] + torch.arange(rows, device=self.device,
                                              dtype=torch.int32)[None, :]
        paged = PagedState(self._dev(bt), start_t)
        with torch.no_grad():
            out, _ = model_forward(
                self.cfg, self.params, tok, position_ids=pos,
                rope_cache=self.rope, kv_caches=(self.pool.k, self.pool.v),
                paged=paged)
            lp = gen._gather_token_log_probs(out, self._dev(targets))
            if self.spec_k:
                model_forward(
                    self.draft_cfg, self.draft_params, tok, position_ids=pos,
                    rope_cache=self.draft_rope,
                    kv_caches=(self.pool.draft_k, self.pool.draft_v),
                    paged=paged)
        return lp[0]

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: clone page ``src`` into ``dst`` in every layer,
        in the draft's cache too (the refeed tick rewrites both); a
        quantized page's scale rows go with its values."""
        with torch.no_grad():
            for pool in self.pool.caches():
                for t in (pool if kv_quant.is_quantized(pool) else (pool,)):
                    t[:, dst] = t[:, src]

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               **kw) -> EngineRequest:
        """Enqueue a generation; returns the request future.  Raises
        ``ValueError`` for requests that can never fit and
        :class:`EngineOverloaded` when the queue is at capacity."""
        prompt = [int(t) for t in prompt]
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                "Length of prompt + tokens_to_generate longer than allowed")
        req = EngineRequest(prompt=prompt, max_new_tokens=max_new_tokens, **kw)
        req._t_submit = time.monotonic()
        with self._work:
            if self.max_queue and len(self._queue) >= self.max_queue:
                raise EngineOverloaded(
                    f"request queue full ({self.max_queue} waiting)",
                    retry_after=self._drain_eta(len(self._queue)),
                    info={"queued": len(self._queue),
                          "policy": self.policy.name})
            self._queue.append(req)
            self._work.notify()
        return req

    def _drain_eta(self, depth: int) -> float:  # holds _lock
        per = (self._ema_retire_s if self._ema_retire_s is not None
               else self._ema_tick_s)
        if per is None:
            return 1.0
        return min(60.0, max(1.0, depth * per))

    def _max_pages_for(self, req: EngineRequest) -> int:
        total = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
        return -(-total // self.page_size)

    def _sched_state(self, now: float) -> SchedulerState:  # holds _lock
        return SchedulerState(
            now=now,
            ema_tick_s=self._ema_tick_s,
            ema_retire_s=self._ema_retire_s,
            free_slots=sum(r is None for r in self._slots),
            queue_depth=len(self._queue),
            can_preempt=False,
            prefill_chunk=self.prefill_chunk,
        )

    def _admit(self) -> None:
        """Move queued requests into slots while the policy and the pages
        allow.  The policy orders the candidates (fcfs: the queue head,
        nothing skips it); planning (trie match, budget check, allocation,
        slot) happens under ``_lock``, the COW page copy outside it."""
        while True:
            with self._lock:
                if not self._queue:
                    return
                state = self._sched_state(time.monotonic())
                order = self.policy.admission_order(list(self._queue), state)
                req = plan = None
                try:
                    slot = self._slots.index(None)
                except ValueError:
                    return
                for cand in order:
                    plan = self._plan_chunked(cand, slot)
                    if plan is not None:
                        req = cand
                        break
                    if self.policy.barrier_admission:
                        break  # page pressure: the head waits
                if plan is None:
                    return
                self._queue.remove(req)
            try:
                self._place_chunked(req, plan)
            except Exception as e:  # noqa: BLE001 — surface to the waiter
                self._fail(req, e)

    def _plan_chunked(self, req: EngineRequest,
                      slot: int) -> Optional[dict]:  # holds _lock
        """Match the prefix cache, check the page budget, allocate the
        suffix pages and reserve the slot; None = can't admit now."""
        ps = self.page_size
        seq = req.seq_tokens
        prompt_len = len(seq)
        max_total = self._max_pages_for(req)
        matched: List[int] = []
        if self.cache is not None and not req.return_log_probs:
            # log-prob requests recompute the whole prompt (every position's
            # logits are needed), so they take no shared pages
            matched = self.cache.match(seq, prompt_len // ps)
        covered = len(matched) * ps
        # full page-aligned match: the first tick re-feeds the last prompt
        # token and would WRITE the final shared page -> copy-on-write
        cow = bool(matched) and covered == prompt_len
        n_keep = len(matched) - (1 if cow else 0)
        fill_end = _bucket_up(prompt_len, ps)
        suffix_pages = (fill_end - covered) // ps
        held_core = n_keep + (1 if cow else 0) + suffix_pages
        extra = 1 if max_total > held_core else 0  # first decode page
        need_now = (1 if cow else 0) + suffix_pages + extra
        remaining = max_total - held_core - extra
        if (self.pool.num_available - need_now
                < self._committed + remaining + self.page_watermark):
            self.pool.release(matched)
            return None
        fresh = self.pool.alloc(need_now)
        if fresh is None:
            self.pool.release(matched)
            return None
        self._committed += remaining
        req._pages = matched + fresh
        req._max_pages = max_total
        req._fill_pos = prompt_len if cow else covered
        req._slot = slot
        self._slots[slot] = req
        self.prefix_hit_tokens += covered
        self.prefix_miss_tokens += prompt_len - covered
        return {"matched": matched, "fresh": fresh, "cow": cow,
                "n_keep": n_keep}

    def _place_chunked(self, req: EngineRequest, plan: dict) -> None:
        matched, fresh = plan["matched"], plan["fresh"]
        n_keep, cow = plan["n_keep"], plan["cow"]
        if cow:
            # device copy outside the lock (the thread driving ticks, serialized
            # with ticks by _drive_lock), then drop the shared page's ref
            self._copy_page(matched[-1], fresh[0])
        with self._lock:
            if cow:
                # block-table order: kept shared pages, the private COW
                # copy, then the first decode page
                req._pages = matched[:n_keep] + [fresh[0]] + fresh[1:]
                self.pool.release([matched[-1]])
                self.cow_copies += 1
            if req._fill_pos >= len(req.seq_tokens):
                self._activate(req, req._slot)   # fully served from cache
            else:
                req._phase = "prefill"
                self._prefill_q.append(req)

    def _activate(self, req: EngineRequest, slot: int) -> None:  # holds _lock
        """Install the slot's decode state; the next tick samples the next
        token by re-feeding the last prompt token at position len - 1
        (an identical K/V rewrite into a private page)."""
        seq = req.seq_tokens
        if req._seed is None:
            req._seed = (req.seed if req.seed is not None
                         else int.from_bytes(os.urandom(4), "little"))
        bt = np.full((self.pages_per_seq,), NULL_PAGE, np.int32)
        bt[: len(req._pages)] = req._pages
        self._block_tables[slot] = bt
        self._positions[slot] = len(seq) - 1
        self._tokens[slot] = seq[-1]
        self._temperature[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        self._seeds[slot] = req._seed
        self._steps[slot] = req._step
        req._phase = "decode"

    def _clear_slot_locked(self, slot: int) -> None:  # holds _lock
        self._slots[slot] = None
        self._block_tables[slot] = NULL_PAGE
        self._positions[slot] = 0
        self._tokens[slot] = 0
        self._top_k[slot] = 1
        self._top_p[slot] = 0.0
        self._temperature[slot] = 1.0

    def _fail(self, req: EngineRequest, e: Exception) -> None:
        with self._lock:
            self._fail_locked(req, e)

    def _fail_locked(self, req: EngineRequest,
                     e: Exception) -> None:  # holds _lock
        if 0 <= req._slot < len(self._slots) \
                and self._slots[req._slot] is req:
            self._clear_slot_locked(req._slot)
        pages, req._pages = req._pages, []
        self._committed -= max(0, req._max_pages - len(pages))
        self.pool.release(pages)
        req._phase = "finished"
        req.error = f"{type(e).__name__}: {e}"
        req.finished = True
        req._done.set()

    def _retire(self, slot: int) -> None:  # holds _lock
        req = self._slots[slot]
        self._clear_slot_locked(slot)
        pages, req._pages = req._pages, []
        # early termination returns its unneeded worst-case commitment
        self._committed -= max(0, req._max_pages - len(pages))
        self.pool.release(pages)
        req._phase = "finished"
        req.finished = True
        now = time.monotonic()
        if self._last_retire_t is not None:
            dt = now - self._last_retire_t
            self._ema_retire_s = (dt if self._ema_retire_s is None
                                  else 0.7 * self._ema_retire_s + 0.3 * dt)
        self._last_retire_t = now
        if req.ttft is not None:
            self.recent_ttft_s.append(req.ttft)
        req._done.set()

    def _stopped_by_token(self, req: EngineRequest, tok: int) -> bool:
        if req.stop_on_double_eol:
            prev = (req.generated[-2] if len(req.generated) > 1
                    else req.prompt[-1])
            return tok == gen.GPT2_DOUBLE_EOL or (
                tok == gen.GPT2_EOL and prev == gen.GPT2_EOL)
        if req.stop_on_eol:
            return tok in (gen.GPT2_EOL, gen.GPT2_DOUBLE_EOL)
        if not req.use_eod_for_termination or req.termination_id is None:
            return False
        return tok == req.termination_id

    def _apply_plain_locked(self, active, next_np, logp_np,
                            now) -> None:  # holds _lock
        """Fold one tick's sampled tokens into the slots."""
        for i in active:
            req = self._slots[i]
            tok = int(next_np[i])
            req.generated.append(tok)
            req.log_probs.append(float(logp_np[i]))
            req._step += 1
            if req._step == 1:
                req._t_first = now
            self._positions[i] += 1
            self._tokens[i] = tok
            self._steps[i] += 1
            done = (self._stopped_by_token(req, tok)
                    or len(req.generated) >= req.max_new_tokens
                    or len(req.prompt) + len(req.generated) >= self.max_seq)
            if done:
                self._retire(i)

    def _apply_spec_locked(self, active, k_eff, emit_np, lp_np, acc_np,
                           m_np, now) -> None:  # holds _lock
        """Fold one speculative tick into the slots: append each row's
        emitted block, cut at a stop token or a length limit exactly where
        non-speculative decode stops, advance the slot by the tokens kept,
        update the acceptance EMA and the spec counters, retire finished
        rows."""
        for i in active:
            req = self._slots[i]
            k_i = int(k_eff[i])
            took = 0
            done = False
            for t in range(int(m_np[i])):
                tok = int(emit_np[i, t])
                req.generated.append(tok)
                req.log_probs.append(float(lp_np[i, t]))
                took += 1
                done = (self._stopped_by_token(req, tok)
                        or len(req.generated) >= req.max_new_tokens
                        or len(req.prompt) + len(req.generated)
                        >= self.max_seq)
                if done:
                    break
            if req._step == 0:
                req._t_first = now
            req._step += took
            self._positions[i] += took
            self._tokens[i] = int(emit_np[i, took - 1])
            self._steps[i] += took
            self.spec_emitted_tokens += took
            if k_i > 0:
                a_i = int(acc_np[i])
                self.spec_draft_tokens += k_i
                self.spec_accepted_tokens += a_i
                req._spec_ema = 0.7 * req._spec_ema + 0.3 * (a_i / k_i)
            if done:
                self._retire(i)
        self.spec_ticks += 1

    def spec_stats(self) -> dict:
        """Speculative-decoding snapshot for ``/health``."""
        if not self.spec_k:
            return {"enabled": False}
        with self._lock:
            drafted = self.spec_draft_tokens
            accepted = self.spec_accepted_tokens
            emitted = self.spec_emitted_tokens
            ticks = self.spec_ticks
        return {
            "enabled": True,
            "spec_k": self.spec_k,
            "adaptive": self.spec_adaptive,
            "draft_layers": self.draft_cfg.model.num_layers,
            "draft_tokens": drafted,
            "accepted_tokens": accepted,
            "acceptance_rate": (round(accepted / drafted, 4) if drafted
                                else None),
            "emitted_tokens": emitted,
            "tokens_per_tick": round(emitted / ticks, 3) if ticks else None,
        }

    # -- chunked prefill scheduling ---------------------------------------

    def _advance_prefill(self, only_log_probs: bool = False) -> bool:
        """Run ONE teacher-forced prefill chunk for the policy's chosen
        prefilling request.  ``only_log_probs``: the ragged-mode carve-out
        — prompts that ask for log-probs need every chunk position's
        logits, so they take this ``s``-row chunk path (the prefill
        attention kernel) while everything else rides the ragged tick."""
        with self._lock:
            live = [r for r in self._prefill_q if r._phase == "prefill"]
            if len(live) != len(self._prefill_q):  # failed/cancelled
                self._prefill_q = deque(live)
            if only_log_probs:
                live = [r for r in live if r.return_log_probs]
            if not live:
                return False
            req = self.policy.prefill_order(
                live, self._sched_state(time.monotonic()))[0]
            ps = self.page_size
            chunk = self.prefill_chunk
            seq = req.seq_tokens
            prompt_len = len(seq)
            start = req._fill_pos
            fill_end = _bucket_up(prompt_len, ps)
            # chunk boundaries on the absolute prefill_chunk grid: the K/V
            # bits a chunk writes depend only on (tokens, positions)
            end = min(fill_end, (start // chunk + 1) * chunk)
            rows = end - start
            # attention horizon: every page the chunk's queries can see,
            # bucketed to 64-token multiples
            kv_pages = min(self.pages_per_seq, _bucket_up(end) // ps)
            tokens = np.zeros((1, rows), np.int32)
            n_real = min(end, prompt_len) - start
            tokens[0, :n_real] = seq[start:start + n_real]
            bt = np.full((1, kv_pages), NULL_PAGE, np.int32)
            n_bt = min(len(req._pages), kv_pages)
            bt[0, :n_bt] = req._pages[:n_bt]
            targets = np.zeros((1, rows), np.int32)
            n_lp = max(0, min(rows, prompt_len - 1 - start))
            if req.return_log_probs and n_lp:
                targets[0, :n_lp] = seq[start + 1:start + 1 + n_lp]

        try:
            lp = self._chunk_prefill(tokens, start, bt, targets)
            if req.return_log_probs:
                lp_host = lp.float().cpu().numpy()
                if req.prompt_log_probs is None:
                    req.prompt_log_probs = []
                req.prompt_log_probs.extend(float(x) for x in lp_host[:n_lp])
        except Exception as e:  # noqa: BLE001 — surface to the waiter
            self._fail(req, e)
            return True

        with self._lock:
            req._fill_pos = end
            if end >= fill_end:
                self._prefill_q.remove(req)
                if self.cache is not None:
                    # cache every page fully covered by prompt tokens the
                    # refeed tick never writes
                    self.cache.insert(seq, req._pages, (prompt_len - 1) // ps)
                self._activate(req, req._slot)
        return True

    # -- the tick ----------------------------------------------------------

    def step(self) -> int:
        """Admit what fits, run one ragged tick (decode slots + packed
        prefill rows) and retire finished requests.  Returns the number of
        slots advanced (0 = idle).  One thread drives at a time: run_until_idle
        and the background loop serialize through ``_drive_lock``."""
        self._admit()
        return self._step_ragged()

    def _prefill_budget_tokens(self) -> int:  # holds _lock
        """The policy's per-tick prefill budget in TOKENS, floored to one
        chunk so prefill always advances."""
        budget = self.policy.prefill_budget(
            [r for r in self._prefill_q if r._phase == "prefill"],
            self._sched_state(time.monotonic()))
        if not isinstance(budget, int) or budget < 0:
            raise ValueError(
                f"prefill_budget must be a non-negative int of TOKENS, "
                f"got {budget!r}")
        return max(budget, self.prefill_chunk)

    def _prepare_decode_locked(self, active) -> np.ndarray:  # holds _lock
        """On-demand paging and each slot's speculation depth for this
        tick; mutates ``active`` when a row must be failed.

        ``k_eff[i]`` is capped by ``spec_k``, the tokens the request still
        owes less one, and (adaptive mode) the acceptance EMA.  A slot
        writes positions ``pos .. pos + k_eff``, so it gets every page
        through ``(pos + k_eff) // page_size`` it doesn't own yet (the
        commitment ledger guarantees them)."""
        k_eff = np.zeros((self.max_slots,), np.int32)
        for i in list(active):
            req = self._slots[i]
            if self.spec_k:
                remaining = req.max_new_tokens - len(req.generated)
                k_i = min(self.spec_k, remaining - 1)
                if self.spec_adaptive:
                    k_i = min(k_i, max(1, int(round(
                        req._spec_ema * self.spec_k))))
                k_eff[i] = max(k_i, 0)
            pos = int(self._positions[i])
            p0 = pos // self.page_size
            p1 = (pos + int(k_eff[i])) // self.page_size
            for idx in range(p0, min(p1, self.pages_per_seq - 1) + 1):
                if self._block_tables[i][idx] != NULL_PAGE:
                    continue
                got = self.pool.alloc(1)
                if got is None:  # ledger-unreachable; fail just the row
                    self._fail_locked(req, RuntimeError(
                        "KV pool exhausted for an in-flight slot — "
                        "commitment ledger violated"))
                    active.remove(i)
                    break
                self._block_tables[i][idx] = got[0]
                req._pages.append(got[0])
                self._committed -= 1
        return k_eff

    def _plan_ragged_prefill(self):  # holds _lock
        """Pack prefill-chunk rows for this tick under the policy's token
        budget.  Chunks stay on the absolute ``prefill_chunk`` grid;
        several chunks, of one request or several, pack until the budget,
        the row capacity or the work runs out.

        Returns ``(spans, pre_tok, pre_pos, pre_tables, pre_index,
        pre_hor, lp_live)``: spans ``[(req, start, end), ...]``, the
        compressed tables (one per packed request, index ``-1`` = dead
        row), and whether log-prob prompts wait for the chunk path."""
        Rp = self.prefill_rows
        pre_tok = np.zeros((Rp,), np.int32)
        pre_pos = np.zeros((Rp,), np.int32)
        pre_tables = np.full((self._pre_tables_cap, self.pages_per_seq),
                             NULL_PAGE, np.int32)
        pre_index = np.full((Rp,), -1, np.int32)
        pre_hor = np.zeros((Rp,), np.int32)
        spans: List[Tuple[EngineRequest, int, int]] = []
        live = [r for r in self._prefill_q if r._phase == "prefill"]
        if len(live) != len(self._prefill_q):
            self._prefill_q = deque(live)
        lp_live = any(r.return_log_probs for r in live)
        live = [r for r in live if not r.return_log_probs]
        if not live:
            return (spans, pre_tok, pre_pos, pre_tables, pre_index,
                    pre_hor, lp_live)
        budget = min(self._prefill_budget_tokens(), Rp)
        order = self.policy.prefill_order(
            live, self._sched_state(time.monotonic()))
        used = 0
        n_req = 0
        ps = self.page_size
        chunk = self.prefill_chunk
        for req in order:
            if n_req >= self._pre_tables_cap:
                break
            seq = req.seq_tokens
            prompt_len = len(seq)
            fill_end = _bucket_up(prompt_len, ps)
            pos = req._fill_pos
            if pos >= fill_end or used >= budget:
                continue
            pre_tables[n_req, : len(req._pages)] = req._pages
            while pos < fill_end and used < budget:
                end = min(fill_end, (pos // chunk + 1) * chunk,
                          pos + (budget - used))
                for p in range(pos, end):
                    pre_tok[used] = seq[p] if p < prompt_len else 0
                    pre_pos[used] = p
                    pre_index[used] = n_req
                    pre_hor[used] = _bucket_up(p + 1)
                    used += 1
                spans.append((req, pos, end))
                pos = end
            n_req += 1
            if used >= budget:
                break
        return (spans, pre_tok, pre_pos, pre_tables, pre_index, pre_hor,
                lp_live)

    def _apply_ragged_prefill_locked(self, spans) -> None:  # holds _lock
        """Advance the packed requests' fill frontiers; a request whose
        bucketed prompt completed enters its full pages into the prefix
        trie (refeed page excluded) and activates into decode."""
        ps = self.page_size
        for req, start, end in spans:
            if req._phase != "prefill":
                continue
            req._fill_pos = end
            seq = req.seq_tokens
            if end >= _bucket_up(len(seq), ps):
                self._prefill_q.remove(req)
                if self.cache is not None:
                    self.cache.insert(seq, req._pages, (len(seq) - 1) // ps)
                self._activate(req, req._slot)

    def _step_ragged(self) -> int:
        """One fused ragged tick: decode slots + packed prefill-chunk rows
        in ONE forward (one attention launch per layer); log-prob prompts
        take their teacher-forced chunk first."""
        with self._lock:
            (spans, pre_tok, pre_pos, pre_tables, pre_index, pre_hor,
             lp_live) = self._plan_ragged_prefill()
        did_lp = 1 if lp_live and self._advance_prefill(
            only_log_probs=True) else 0
        with self._lock:
            active = [i for i, r in enumerate(self._slots)
                      if r is not None and r._phase == "decode"]
            k_eff = (self._prepare_decode_locked(active) if active
                     else np.zeros((self.max_slots,), np.int32))
            if not active and not spans:
                return did_lp
            self.peak_active_slots = max(self.peak_active_slots, len(active))
            host = (self._block_tables.copy(), self._positions.copy(),
                    self._tokens.copy(), list(self._seeds),
                    self._steps.copy(), self._temperature.copy(),
                    self._top_k.copy(), self._top_p.copy())
        bt, pos, toks, seeds, steps, temp, tk, tp = host
        n_pre = sum(end - start for _, start, end in spans)
        # live prefill rows bucketed to chunk multiples (dead rows past the
        # bucket are not computed)
        n_bucket = (min(self.prefill_rows,
                        _bucket_up(n_pre, self.prefill_chunk))
                    if n_pre else 0)
        t_tick = time.monotonic()
        pre_args = () if not n_bucket else (
            self._dev(pre_tok[:n_bucket]), self._dev(pre_pos[:n_bucket]),
            self._dev(pre_tables), self._dev(pre_index[:n_bucket]),
            self._dev(pre_hor[:n_bucket]))
        slots = (self._dev(bt), self._dev(pos), self._dev(toks), seeds,
                 steps, temp, tk, tp)
        pool = self.pool
        with torch.no_grad():
            if self.spec_k:
                out = self._tick_fn(
                    self.params, self.draft_params, pool.k, pool.v,
                    pool.draft_k, pool.draft_v, *slots, k_eff, *pre_args)
                emit_np, lp_np, acc_np, m_np = (t.cpu().numpy()
                                                for t in out)
            else:
                next_tok, logp = self._tick_fn(
                    self.params, pool.k, pool.v, *slots, *pre_args)
                next_np = next_tok.cpu().numpy()
                logp_np = logp.float().cpu().numpy()

        now = time.monotonic()
        with self._lock:
            dt = now - t_tick
            self._ema_tick_s = (dt if self._ema_tick_s is None
                                else 0.8 * self._ema_tick_s + 0.2 * dt)
            self.ticks += 1
            if self.spec_k:
                self._apply_spec_locked(active, k_eff, emit_np, lp_np,
                                        acc_np, m_np, now)
            else:
                self._apply_plain_locked(active, next_np, logp_np, now)
            self._apply_ragged_prefill_locked(spans)
        return len(active) + (1 if spans else 0) + did_lp

    def run_until_idle(self) -> None:
        """Drive ticks on the calling thread until queue and slots drain."""
        while True:
            with self._drive_lock:
                n = self.step()
            if n == 0:
                with self._lock:
                    if not self._queue and all(
                            r is None for r in self._slots):
                        return

    # -- background scheduler ---------------------------------------------

    def start(self) -> None:
        """Run the scheduler loop in a daemon thread (server mode)."""
        if self._thread is not None:
            return
        with self._work:
            self._stopping = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._work:
            self._stopping = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._work:
                while (not self._stopping and not self._queue
                       and all(r is None for r in self._slots)):
                    self._work.wait()
                if self._stopping:
                    break
            with self._drive_lock:
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 — fail, keep serving
                    self._fail_all(e)

    def _fail_all(self, e: Exception) -> None:
        """A tick raised: fail every admitted request (their device state
        is unknown) so their callers get an answer; the queue stays."""
        with self._lock:
            for req in [r for r in self._slots if r is not None]:
                self._fail_locked(req, e)
            self._prefill_q.clear()

    # -- server-facing API -------------------------------------------------

    def generate_and_post_process(
        self,
        prompts: Sequence[str],
        tokens_to_generate: int = 0,
        return_output_log_probs: bool = False,
        top_k_sampling: int = 0,
        top_p_sampling: float = 0.0,
        temperature: float = 1.0,
        add_BOS: bool = False,
        use_eod_token_for_early_termination: bool = True,
        stop_on_double_eol: bool = False,
        stop_on_eol: bool = False,
        random_seed: int = -1,
    ):
        """Tokenize, submit each prompt as its own request (all share
        decode ticks), wait, detokenize.  Returns ``(texts, segments,
        log_probs, tokens)``."""
        tok = self.tokenizer
        if tokens_to_generate == 0:
            raise ValueError(
                "tokens_to_generate=0 (scoring) runs the dense forward of "
                "the legacy engine, which is not in this slice of the "
                "PyTorch port (it comes with the legacy-engine slice)")
        termination_id = getattr(self.cfg.model, "eos_id", None) or tok.eod
        bos = getattr(tok, "bos_token_id", None) or getattr(tok, "bos", None)
        reqs = []
        for i, prompt in enumerate(prompts):
            ids = tok.tokenize(prompt)
            if add_BOS:
                ids = [bos if bos is not None else tok.eod] + ids
            reqs.append(self.submit(
                ids, tokens_to_generate,
                temperature=temperature, top_k=top_k_sampling,
                top_p=top_p_sampling, termination_id=termination_id,
                use_eod_for_termination=use_eod_token_for_early_termination,
                stop_on_double_eol=stop_on_double_eol,
                stop_on_eol=stop_on_eol,
                seed=None if random_seed == -1 else random_seed + i,
                return_log_probs=return_output_log_probs,
            ))
        if self._thread is None:
            self.run_until_idle()
        rows = [r.result(timeout=600) for r in reqs]

        lengths = [len(t) for t, _ in rows]
        width = max(lengths)
        tokens = np.zeros((len(rows), width), np.int32)
        for i, (t, _) in enumerate(rows):
            tokens[i, : len(t)] = t
        tokens, texts, segments = detokenize_generations(
            tok, tokens, np.asarray(lengths), True)
        if return_output_log_probs:
            log_probs = [
                (r.prompt_log_probs or []) + r.log_probs for r in reqs]
            log_probs = [
                lp[: len(seg) - 1] for lp, seg in zip(log_probs, segments)]
        else:
            log_probs = None
        return texts, segments, log_probs, tokens
