"""REST text-generation server (port of
``megatron_llm_tpu/generation/server.py``, serving slice).

Same wire contract as the JAX package: ``PUT /api`` with the reference's
request fields and validation messages, answering ``{"text", "segments",
"logprobs"}``; errors are structured JSON (``{"error": msg}``) with proper
status codes; ``GET /health`` reports liveness, the engine's occupancy
and its speculative-decoding counters (``spec``).
Handler threads enqueue into the continuous-batching engine and block on
their request's future, so concurrent requests share decode ticks.

Requests for features outside this slice (beam search, streaming, KV
handoff, ``tokens_to_generate: 0`` scoring) answer 400 with a message
naming the later slice.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from megatron_llm_tpu_torch.generation.engine import EngineOverloaded


def _validate(payload: dict):
    """Field validation with the reference's messages.  Returns
    ``(params dict, error str)``."""
    if "prompts" not in payload:
        return None, "prompts argument required"
    if "max_len" in payload:
        return None, "max_len is no longer used.  Replace with tokens_to_generate"
    if "sentences" in payload:
        return None, "sentences is no longer used.  Replace with prompts"
    prompts = payload["prompts"]
    if not isinstance(prompts, list):
        return None, "prompts is not a list of strings"
    if len(prompts) == 0:
        return None, "prompts is empty"
    if len(prompts) > 128:
        return None, "Maximum number of prompts is 128"

    p = {"prompts": prompts}

    tokens_to_generate = payload.get("tokens_to_generate", 64)
    if not isinstance(tokens_to_generate, int) or tokens_to_generate < 0:
        return None, "tokens_to_generate must be an integer greater than or equal to 0"
    p["tokens_to_generate"] = tokens_to_generate

    logprobs = payload.get("logprobs", False)
    if not isinstance(logprobs, bool):
        return None, "logprobs must be a boolean value"
    if tokens_to_generate == 0 and not logprobs:
        return None, "tokens_to_generate=0 implies logprobs should be True"
    p["logprobs"] = logprobs

    temperature = payload.get("temperature", 1.0)
    if not isinstance(temperature, (int, float)) or not 0.0 < temperature <= 100.0:
        return None, "temperature must be a positive number less than or equal to 100.0"
    p["temperature"] = float(temperature)

    top_k = payload.get("top_k", 0)
    if not isinstance(top_k, int) or not 0 <= top_k <= 1000:
        return None, ("top_k must be equal to or greater than 0 and less "
                      "than or equal to 1000")
    p["top_k"] = top_k

    top_p = payload.get("top_p", 0.0)
    if isinstance(top_p, int):
        top_p = float(top_p)
    if not isinstance(top_p, float) or not 0 <= top_p <= 1.0:
        return None, "top_p must be less than or equal to 1.0"
    if top_p > 0.0 and top_k > 0:
        return None, "cannot set both top-k and top-p samplings."
    p["top_p"] = top_p

    add_BOS = payload.get("add_BOS", False)
    if not isinstance(add_BOS, bool):
        return None, "add_BOS must be a boolean value"
    if any(len(prompt) == 0 for prompt in prompts) and not add_BOS:
        return None, "Empty prompts require add_BOS=true"
    p["add_BOS"] = add_BOS

    for flag in ("stop_on_double_eol", "stop_on_eol", "no_log"):
        val = payload.get(flag, False)
        if not isinstance(val, bool):
            return None, f"{flag} must be a boolean value"
        p[flag] = val

    random_seed = payload.get("random_seed", -1)
    if not isinstance(random_seed, int):
        return None, "random_seed must be integer"
    if random_seed < -1:
        return None, "random_seed must be a positive integer"
    p["random_seed"] = random_seed

    beam_width = payload.get("beam_width")
    if beam_width is not None:
        if not isinstance(beam_width, int) or beam_width < 1:
            return None, "beam_width must be an integer > 1"
        if len(prompts) > 1:
            return None, "When doing beam_search, batch size must be 1"
    p["beam_width"] = beam_width

    stop_token = payload.get("stop_token", 50256)
    if not isinstance(stop_token, int):
        return None, "stop_token must be an integer"
    p["stop_token"] = stop_token

    length_penalty = payload.get("length_penalty", 1.0)
    if isinstance(length_penalty, int):
        length_penalty = float(length_penalty)
    if not isinstance(length_penalty, float):
        return None, "length_penalty must be a float"
    p["length_penalty"] = length_penalty

    # scheduling control plane: priority class for the priority policy,
    # soft deadlines for the slo policy
    priority = payload.get("priority", 1)
    if not isinstance(priority, int) or not 0 <= priority <= 9:
        return None, "priority must be an integer between 0 and 9"
    p["priority"] = priority
    for field in ("ttft_deadline_ms", "tpot_deadline_ms"):
        val = payload.get(field)
        if val is not None and (not isinstance(val, (int, float))
                                or isinstance(val, bool) or val <= 0):
            return None, f"{field} must be a positive number of milliseconds"
        p[field] = None if val is None else float(val)

    stream = payload.get("stream", False)
    if not isinstance(stream, bool):
        return None, "stream must be a boolean value"
    p["stream"] = stream

    # well-formed requests for features of later slices
    if beam_width is not None:
        return None, ("beam_width (beam search) is not in this slice of the "
                      "PyTorch port (it comes with the legacy-engine slice)")
    if stream:
        return None, ("stream (token streaming) is not in this slice of the "
                      "PyTorch port (it comes with the streaming slice)")
    if payload.get("handoff_to") is not None:
        return None, ("handoff_to (disaggregated prefill) is not in this "
                      "slice of the PyTorch port (it comes with the "
                      "disaggregated-serving slice)")
    return p, None


class MegatronServer:
    """``PUT /api`` + ``GET /health`` over a continuous-batching engine."""

    def __init__(self, engine):
        self.engine = engine
        self._httpd: Optional[ThreadingHTTPServer] = None
        # replica identity: replica_id lives as long as the process, seq
        # orders /health payloads
        self.replica_id = uuid.uuid4().hex
        self._t_start = time.monotonic()
        self._health_seq = 0  # guarded by _seq_lock
        self._seq_lock = threading.Lock()

    def handle_request(self, payload):
        """Core ``PUT /api`` logic; returns ``(status_code, body dict)``."""
        if not isinstance(payload, dict):
            return 400, {"error": "request body must be a JSON object"}
        params, err = _validate(payload)
        if err:
            return 400, {"error": err}
        try:
            texts, segments, logprobs, _ = self.engine.generate_and_post_process(
                params["prompts"],
                tokens_to_generate=params["tokens_to_generate"],
                return_output_log_probs=params["logprobs"],
                top_k_sampling=params["top_k"],
                top_p_sampling=params["top_p"],
                temperature=params["temperature"],
                add_BOS=params["add_BOS"],
                stop_on_double_eol=params["stop_on_double_eol"],
                stop_on_eol=params["stop_on_eol"],
                random_seed=params["random_seed"],
            )
            return 200, {"text": texts, "segments": segments,
                         "logprobs": logprobs}
        except EngineOverloaded as eo:
            return 503, {"error": str(eo), "retry_after": eo.retry_after,
                         **eo.info}
        except ValueError as ve:
            return 400, {"error": str(ve.args[0] if ve.args else ve)}
        except Exception as e:  # an engine failure must still answer
            traceback.print_exc()
            return 500, {"error": f"internal error: {type(e).__name__}: {e}"}

    def _make_handler(server):  # noqa: N805 — `server` is the enclosing object
        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body, headers=None):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_PUT(self):
                if self.path.rstrip("/") != "/api":
                    return self._send(404, {"error": "not found"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return self._send(400, {"error": "invalid JSON"})
                try:
                    code, body = server.handle_request(payload)
                except Exception as e:  # last resort: still a JSON answer
                    code, body = 500, {
                        "error": f"internal error: {type(e).__name__}: {e}"}
                headers = {}
                if code == 503 and "retry_after" in body:
                    headers["Retry-After"] = str(max(1, int(body["retry_after"])))
                return self._send(code, body, headers)

            def do_GET(self):
                if self.path.partition("?")[0].rstrip("/") == "/health":
                    return self._send(200, server.health())
                return self._send(404, {"error": "not found"})

            def log_message(self, fmt, *args):  # quiet by default
                pass

        return Handler

    def health(self) -> dict:
        """Liveness, replica identity and engine occupancy."""
        with self._seq_lock:
            self._health_seq += 1
            seq = self._health_seq
        eng = self.engine
        info = {
            "status": "ok",
            "batching": True,
            "role": "unified",
            "replica_id": self.replica_id,
            "seq": seq,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "device": str(eng.device),
        }
        with eng._lock:
            cache = eng.cache
            info.update(
                active_slots=sum(r is not None for r in eng._slots),
                peak_active_slots=eng.peak_active_slots,
                max_slots=eng.max_slots,
                queued=len(eng._queue),
                prefilling=sum(r is not None and r._phase == "prefill"
                               for r in eng._slots),
                free_pages=eng.pool.num_free,
                total_pages=eng.pool.num_pages - 1,
                pages_cached=len(cache) if cache is not None else 0,
                available_pages=eng.pool.num_available,
                prefix_hit_tokens=eng.prefix_hit_tokens,
                prefix_miss_tokens=eng.prefix_miss_tokens,
                ticks=eng.ticks,
                page_size=eng.page_size,
                kv_dtype=eng.kv_dtype,
                kv_pool_bytes=eng.pool.kv_pool_bytes(),
                kv_scale_bytes=eng.pool.kv_scale_bytes(),
            )
        # speculative decoding: depth cap, acceptance rate, tokens a tick
        info["spec"] = eng.spec_stats()
        return info

    # ---- lifecycle ------------------------------------------------------

    def bind(self, host: str = "0.0.0.0", port: int = 5000) -> int:
        """Bind the listening socket and return the bound port (``port=0``
        lets the OS pick a free one).  Call :meth:`serve` afterwards."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        return self._httpd.server_address[1]

    def serve(self):
        """Serve on the socket from :meth:`bind` (blocking)."""
        if self._httpd is None:
            raise RuntimeError("call bind() first")
        self.engine.start()
        self._httpd.serve_forever()

    def start_background(self, host: str = "127.0.0.1", port: int = 5000):
        """Serve from a daemon thread; returns the bound port."""
        bound = self.bind(host, port)
        self.engine.start()
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return bound

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.engine.stop()
