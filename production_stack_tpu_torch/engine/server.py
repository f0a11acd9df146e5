"""OpenAI-compatible HTTP server for the PyTorch engine.

Ports the completions surface of production_stack_tpu/engine/server.py
onto the standard library (``http.server.ThreadingHTTPServer``), since the
machines this package targets need not have ``aiohttp``. Each request is
handled on its own thread; the engine steps on the AsyncEngine's thread.

Generation: ``POST /v1/completions`` and ``POST /v1/chat/completions``
(JSON, or SSE ending in ``data: [DONE]`` with ``"stream": true``;
``guided_regex`` or ``guided_json`` constrain the output, and ``model`` may
name a loaded LoRA adapter), ``POST /v1/load_lora_adapter`` and ``POST
/v1/unload_lora_adapter`` (``{"lora_name", "lora_path"}``, the reference
LoraAdapter operator's calls), ``GET /v1/models`` (the model and each
adapter).

What the router and the fleet read: ``GET /health``; ``GET /ready`` (503
``warming`` while the launch warmup runs, ``draining``, ``stalled`` when
the step watchdog sees no progress); ``POST /drain`` (new ``/v1/*`` POSTs
get 503 + ``Retry-After``, in-flight streams finish under
``--drain-deadline``, stragglers are then aborted; SIGTERM drains, then
exits); ``GET /metrics`` (the reference's ``vllm:*`` families, written by
hand: engine/metrics.py); ``POST /kv/lookup`` (with the host tier's
``matched_tokens_host``); ``POST /tokenize`` and ``/detokenize``; ``GET
/debug/perf`` (the perf accountant, the ``kv_transfer`` and ``kv_tier``
blocks); ``GET /debug/canary`` (golden records of the pinned probes);
``POST /debug/profile`` (a ``torch.profiler`` Chrome trace as tar.gz).
These handlers read host state only: none waits on the card or on a step.

The KV plane (``--role prefill|decode``; engine/kv_transfer.py frames, the
reference's wire format): ``POST /kv/export`` returns blocks' KV, whole or,
with ``"stream": true``, as chunked layer-group frames; ``POST /kv/recv``
lands a pushed transfer (a chunked body this module decodes itself) into
free pool blocks. A completion's ``kv_transfer_params`` drives both of the
router's flows: with ``do_remote_decode`` the prefill hop answers with
``remote_block_ids`` and, given ``push_url`` and ``transfer_id``, first
pushes its blocks to that decode engine; the decode hop splices a landed
push by its ``transfer_id`` (no re-prefill) or pulls ``remote_block_ids``
from ``remote_host`` into its prefix cache before admission, and falls back
to a plain prefill when neither is there. ``--kv-host-cache-bytes`` and
``--remote-kv-url`` put the host and remote tiers behind the pool
(engine/kv_offload.py).

Response bodies have the JAX server's shape, so the same router can front
either engine. ``guided_choice`` and ``echo`` (which need prompt scoring),
the tenant plane, the perf ledger, ``/debug/memory`` and the other
``/debug/*`` routes are not ported yet.

Run: ``python -m production_stack_tpu_torch.engine.server --model
llama-3-8b --port 18077`` (``--device cpu`` for the plain path,
``--attention-impl bucketed`` for the bucketed prefill path,
``--speculative-ngram 4`` for n-gram speculative decoding on the ragged
path, ``--skip-warmup`` to serve at once).
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import io
import json
import logging
import os
import signal
import tarfile
import tempfile
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from production_stack_tpu_torch import __version__
from production_stack_tpu_torch.canary_golden import (
    DEFAULT_PROBES,
    record_from_response,
)
from production_stack_tpu_torch.engine.async_engine import AsyncEngine
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    PerfConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.engine import GrammarBankFull, LLMEngine
from production_stack_tpu_torch.engine.grammar import (
    compile_regex,
    schema_to_regex,
)
from production_stack_tpu_torch.engine.kv_transfer import (
    FrameDigestError,
    consume_frames,
    default_group,
    nbytes_of,
    produce_frames,
    push_kv,
    read_frame,
    tensor_bytes,
)
from production_stack_tpu_torch.engine.lifecycle import StepWatchdog
from production_stack_tpu_torch.engine.lora import LoraManager
from production_stack_tpu_torch.engine.metrics import CONTENT_TYPE, ServerMetrics
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGPROBS,
    SamplingParams,
    make_token_controls,
)
from production_stack_tpu_torch.engine.scheduler import SchedulerQueueFull

_log = logging.getLogger(__name__)

MAX_CHOICES = 128  # OpenAI caps n at 128; batched prompts share the cap
ENGINE_CAPABILITIES = ("chat", "completions")


class BadRequest(ValueError):
    """A request the server answers with 400."""


def _parse_logit_bias(raw) -> Optional[dict]:
    if not raw:
        return None
    if not isinstance(raw, dict):
        raise ValueError("logit_bias must be a map of token id -> bias")
    return {int(k): float(v) for k, v in raw.items()}


def _sampling_from_body(body: dict) -> SamplingParams:
    stop = body.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    seed = body.get("seed")
    if seed is not None:
        seed = int(seed) & 0xFFFFFFFF  # seeds are uint32
    n = body.get("n")
    return SamplingParams(
        max_tokens=int(body.get("max_tokens") or 16),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", -1)),
        seed=seed,
        stop=tuple(stop),
        stop_token_ids=tuple(body.get("stop_token_ids") or ()),
        ignore_eos=bool(body.get("ignore_eos", False)),
        n=int(n) if n is not None else 1,
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        logit_bias=_parse_logit_bias(body.get("logit_bias")),
        allowed_token_ids=tuple(body.get("allowed_token_ids") or ()),
    )


def _parse_logprobs(body: dict, chat: bool) -> Optional[int]:
    """OpenAI logprobs knobs -> the engine's top-N count, or None.
    chat: ``logprobs: true`` (+ ``top_logprobs``); completions:
    ``logprobs: <int>``."""
    if chat:
        if not body.get("logprobs"):
            return None
        top = body.get("top_logprobs")
        top = int(top) if top is not None else 0
        if not 0 <= top <= MAX_LOGPROBS:
            raise ValueError(f"top_logprobs must be in [0, {MAX_LOGPROBS}]")
        return top
    raw = body.get("logprobs")
    if raw is None or raw is False:
        return None
    if raw is True:
        raise ValueError(
            "completions logprobs must be an integer count; the boolean "
            "form belongs to /v1/chat/completions"
        )
    n = int(raw)
    if not 0 <= n <= MAX_LOGPROBS:
        raise ValueError(f"logprobs must be in [0, {MAX_LOGPROBS}]")
    return n


def _fmt_chat_logprobs(tk, token_ids: list, lps: list, n_top: int) -> dict:
    content = []
    for t, (lp, top) in zip(token_ids, lps):
        s = tk.decode([t])
        content.append({
            "token": s, "logprob": lp, "bytes": list(s.encode()),
            "top_logprobs": [
                {"token": tk.decode([tid]), "logprob": v,
                 "bytes": list(tk.decode([tid]).encode())}
                for tid, v in top[:n_top]
            ],
        })
    return {"content": content}


def _fmt_completion_logprobs(tk, token_ids: list, lps: list, n_top: int,
                             offset0: int = 0) -> dict:
    tokens, tlps, tops, offsets = [], [], [], []
    off = offset0
    for t, (lp, top) in zip(token_ids, lps):
        s = tk.decode([t])
        tokens.append(s)
        tlps.append(lp)
        offsets.append(off)
        off += len(s)
        if n_top and top:
            d: dict = {}
            for tid, v in top[:n_top]:
                d.setdefault(tk.decode([tid]), v)
            tops.append(d)
        else:
            tops.append(None)
    return {"tokens": tokens, "token_logprobs": tlps, "top_logprobs": tops,
            "text_offset": offsets}


def _tokens_covering(tk, token_ids: list, text_len: int) -> int:
    """Smallest token prefix whose decode covers ``text_len`` chars."""
    if text_len <= 0 or not token_ids:
        return 0
    if len(tk.decode(token_ids)) < text_len:
        return len(token_ids)
    lo, hi = 1, len(token_ids)
    while lo < hi:
        mid = (lo + hi) // 2
        if len(tk.decode(token_ids[:mid])) >= text_len:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _check_stop_str(text: str, sampling: SamplingParams) -> Optional[str]:
    """The text cut at the earliest stop string, or None."""
    cut = None
    for s in sampling.stop:
        idx = text.find(s)
        if idx >= 0 and (cut is None or idx < cut):
            cut = idx
    return None if cut is None else text[:cut]


def _error(message: str, kind: str = "invalid_request_error") -> dict:
    return {"error": {"message": message, "type": kind}}


class _ChunkedReader:
    """``readinto`` over an HTTP/1.1 chunked request body (the stdlib
    handler does not decode one): a pushed KV transfer arrives so."""

    def __init__(self, rfile):
        self.rfile = rfile
        self.left = 0  # bytes left in the current chunk
        self.done = False

    def readinto(self, buf) -> int:
        if self.done:
            return 0
        if self.left == 0:
            line = self.rfile.readline(1024)
            if not line:
                raise EOFError("connection closed inside a chunked body")
            self.left = int(line.split(b";")[0].strip() or b"0", 16)
            if self.left == 0:
                while self.rfile.readline(1024) not in (b"\r\n", b"\n",
                                                        b""):
                    pass  # trailers
                self.done = True
                return 0
        n = self.rfile.readinto(memoryview(buf)[:min(len(buf), self.left)])
        if not n:
            raise EOFError("connection closed inside a chunked body")
        self.left -= n
        if self.left == 0:
            self.rfile.readline(1024)  # the chunk's CRLF
        return n

    def drain(self) -> None:
        """Read to the end of the body, so an early answer reaches a
        sender that is still writing."""
        scratch = bytearray(1 << 20)
        while self.readinto(scratch):
            pass


class _LengthReader:
    """``readinto`` over a Content-Length request body."""

    def __init__(self, rfile, length: int):
        self.rfile = rfile
        self.left = length

    def readinto(self, buf) -> int:
        if self.left <= 0:
            return 0
        n = self.rfile.readinto(memoryview(buf)[:min(len(buf), self.left)])
        self.left -= n or 0
        return n

    def drain(self) -> None:
        scratch = bytearray(1 << 20)
        while self.readinto(scratch):
            pass


@dataclasses.dataclass
class _Admission:
    """An admitted generation request: its choices' streams, and what its
    ``kv_transfer_params`` asked of the KV plane."""

    streams: list
    rids: list
    rid: str
    sampling: SamplingParams
    n_prompt: int
    prompt_ids: list
    produce_kv: bool = False  # answer with remote_block_ids
    push: Optional[dict] = None  # push_url + transfer_id: blocks pinned
    imported_tokens: int = 0  # tokens a pull landed before admission


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's default backlog of 5 resets connections when a burst
    # (a router fanning out a wave, a client opening one connection per
    # row) arrives faster than the accept loop runs
    request_queue_size = 1024
    daemon_threads = True


class EngineServer:
    """The engine, its thread and the HTTP front end.

    Lifecycle, as the reference's: WARMING (``warmup_on_start``: the
    engine runs its warmup on the engine thread while ``/ready`` answers
    503) -> SERVING -> DRAINING (``POST /drain`` or SIGTERM: ``/ready``
    503, new generation requests 503 + ``Retry-After``, in-flight requests
    finish under ``drain_deadline``, stragglers are then aborted). A step
    watchdog (``watchdog_stall_seconds`` > 0) turns ``/ready`` to 503
    while no step completes with work queued."""

    def __init__(self, config: EngineConfig, engine: Optional[LLMEngine] = None,
                 device="cuda", served_model_name: Optional[str] = None,
                 warmup_on_start: bool = False,
                 overload_retry_after: float = 1.0,
                 drain_deadline: float = 30.0,
                 watchdog_stall_seconds: float = 0.0):
        self.config = config
        self.engine = engine if engine is not None else LLMEngine(
            config, device=device)
        self.async_engine = AsyncEngine(self.engine)
        self.lora = LoraManager(self.engine)
        self.model_name = served_model_name or config.model.name
        self.start_time = time.time()
        self._httpd: Optional[_HTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self.metrics = ServerMetrics(self.engine, self.model_name)
        self.async_engine.step_observer = self.metrics.observe_step
        self.async_engine.finish_observer = self._observe_finished
        # the Retry-After seconds of a 503 while draining and of a 429
        self.overload_retry_after = overload_retry_after
        self.warmup_on_start = warmup_on_start
        self.warming = False
        self.warmup_seconds = 0.0
        self._warmup_t0: Optional[float] = None
        self.drain_deadline = drain_deadline
        self.draining = False
        self.drain_reason: Optional[str] = None
        self._drain_t0: Optional[float] = None
        self._drain_done = threading.Event()
        self._drain_rejected = 0
        self._drain_aborted = 0
        # generation requests past the drain gate and not yet answered
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._profiling = threading.Lock()
        self.watchdog = StepWatchdog(self.async_engine,
                                     watchdog_stall_seconds)
        self.metrics.register_lifecycle(self._lifecycle_snapshot)
        # pushed transfers landing or landed on this (decode) engine, by
        # transfer id: {blocks, layers_done, meta, created, ready}
        self._kv_transfers: dict[str, dict] = {}
        self._kv_lock = threading.Lock()

    def _observe_finished(self, out) -> None:
        """Engine thread: a finished request's stamps into the latency
        histograms."""
        if out.arrival_time is None or out.finish_time is None:
            return  # an abort delivered to a waiting stream carries none
        self.metrics.observe_request(out.arrival_time, out.first_token_time,
                                     out.finish_time, out.num_output_tokens)
        self.metrics.observe_stages(out)

    # -- lifecycle -----------------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the engine thread (and the warmup, when asked for) and
        bind the HTTP socket; returns the bound port (a free one for port
        0). ``/ready`` answers 503 ``warming`` from here until the warmup
        ends."""
        self.async_engine.start()
        self.watchdog.start()
        if self.warmup_on_start:
            self.warming = True
            self._warmup_t0 = time.monotonic()
            threading.Thread(target=self._run_warmup, daemon=True,
                             name="warmup").start()
        self._httpd = _HTTPServer((host, port), self._handler_class())
        return self._httpd.server_address[1]

    def _run_warmup(self) -> None:
        assert self._warmup_t0 is not None
        try:
            self.async_engine.run_on_engine(lambda eng: eng.warmup())
        except Exception:
            _log.exception("engine warmup failed")
        finally:
            self.warmup_seconds = time.monotonic() - self._warmup_t0
            self.warming = False
        _log.info("engine warmup (all shape variants) done in %.1fs",
                  self.warmup_seconds)

    def begin_drain(self, reason: str) -> bool:
        """Flip SERVING -> DRAINING (idempotent; False when already
        draining) and start the drain watcher."""
        if self.draining:
            return False
        self.draining = True
        self.drain_reason = reason
        self._drain_t0 = time.monotonic()
        _log.warning("drain started (%s): %d in-flight request(s), "
                     "deadline %.1fs", reason, self._inflight,
                     self.drain_deadline)
        threading.Thread(target=self._drain_watch, daemon=True,
                         name="drain").start()
        return True

    def _drain_watch(self) -> None:
        """Let in-flight work finish under the drain deadline, then abort
        the stragglers (their KV blocks are freed)."""
        assert self._drain_t0 is not None
        deadline = self._drain_t0 + self.drain_deadline
        try:
            while time.monotonic() < deadline:
                if not self._inflight and not self.engine.has_unfinished():
                    _log.warning("drain complete in %.2fs: no in-flight "
                                 "work", time.monotonic() - self._drain_t0)
                    return
                time.sleep(0.05)
            rids = self.engine.live_request_ids()
            for rid in rids:
                self.async_engine.abort(rid)
            self._drain_aborted += len(rids)
            if rids:
                _log.warning("drain deadline (%.1fs) expired: aborted %d "
                             "straggler sequence(s)", self.drain_deadline,
                             len(rids))
        finally:
            self._drain_done.set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until a started drain has finished or aborted its
        in-flight work."""
        return self._drain_done.wait(timeout)

    def _lifecycle_snapshot(self) -> dict:
        """Scrape-time source of the drain / watchdog / warmup families."""
        return {
            "draining": self.draining,
            "drain_rejected_total": self._drain_rejected,
            "drain_aborted_total": self._drain_aborted,
            "watchdog_stalled": self.watchdog.stalled,
            "watchdog_stalls_total": self.watchdog.stalls_total,
            "warming": self.warming,
            "warmup_seconds": self.warmup_seconds,
        }

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a background thread; returns the bound port."""
        bound = self.bind(host, port)
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http")
        self._serve_thread.start()
        return bound

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop_serving(self) -> None:
        """End ``serve_forever`` (from any thread but the one running
        it)."""
        if self._httpd is not None:
            self._httpd.shutdown()

    def shutdown(self) -> None:
        if self._httpd is not None:
            if self._serve_thread is not None:
                self._httpd.shutdown()
                self._serve_thread.join(10)
                self._serve_thread = None
            self._httpd.server_close()
            self._httpd = None
        self.watchdog.stop()
        self.async_engine.stop()
        self.engine.shutdown_tiers()

    # -- routes --------------------------------------------------------------
    def models(self) -> dict:
        cards = [{
            "id": self.model_name,
            "object": "model",
            "created": int(self.start_time),
            "owned_by": "production-stack-tpu",
            "root": self.model_name,
            "parent": None,
            "max_model_len": self.config.model.max_model_len,
            "capabilities": list(ENGINE_CAPABILITIES),
            "role": self.config.role,
        }]
        for name in self.lora.list_adapters():
            cards.append({
                "id": name,
                "object": "model",
                "created": int(self.start_time),
                "owned_by": "production-stack-tpu",
                "root": self.model_name,
                "parent": self.model_name,
            })
        return {"object": "list", "data": cards}

    def ready(self) -> tuple[int, dict]:
        """Readiness, distinct from /health liveness: 503 while DRAINING,
        while the launch warmup runs, and while the step watchdog sees a
        wedged engine."""
        if self.draining:
            remaining = 0.0
            if self._drain_t0 is not None:
                remaining = max(0.0, self._drain_t0 + self.drain_deadline
                                - time.monotonic())
            return 503, {"status": "draining", "reason": self.drain_reason,
                         "inflight": self._inflight,
                         "deadline_remaining": round(remaining, 3)}
        if self.warming:
            elapsed = 0.0
            if self._warmup_t0 is not None:
                elapsed = time.monotonic() - self._warmup_t0
            return 503, {"status": "warming",
                         "warming_for": round(elapsed, 3)}
        if self.watchdog.stalled:
            return 503, {"status": "stalled",
                         "stalled_for": round(self.watchdog.progress_age(),
                                              3)}
        return 200, {"status": "ready"}

    def drain(self, body: dict) -> tuple[int, dict]:
        """Begin draining (idempotent). A preStop hook POSTs here so new
        work stops before SIGTERM; the SIGTERM path owns process exit."""
        started = self.begin_drain("api")
        return 200, {"status": "draining", "already_draining": not started,
                     "deadline": self.drain_deadline,
                     "inflight": self._inflight}

    def tokenize(self, body: dict) -> tuple[int, dict]:
        text = body.get("prompt") or body.get("text") or ""
        ids = self.engine.tokenizer.encode(
            text, add_bos=bool(body.get("add_special_tokens", True)))
        return 200, {"tokens": ids, "count": len(ids),
                     "max_model_len": self.config.model.max_model_len}

    def detokenize(self, body: dict) -> tuple[int, dict]:
        return 200, {"prompt": self.engine.tokenizer.decode(
            body.get("tokens") or [])}

    def kv_lookup(self, body: dict) -> tuple[int, dict]:
        """KV-aware routing: how many tokens of this prompt would hit the
        prefix cache now, from the allocator's content-hash table, and,
        with a host tier, how many more it could continue the match with
        (``matched_tokens_host``; a router weights those below a pool hit
        and far above a prefill).

        The walk starts at the base model's chain root (``HASH_SEED``):
        the router sends only ``{"prompt"}`` (or ``{"tokens"}``), never an
        adapter. This port roots each LoRA adapter's chain at its own
        ``kv_cache.adapter_root``, so blocks computed under an adapter are
        invisible here, by design: they could never serve a base-model
        request."""
        if "tokens" in body:
            ids = list(body["tokens"])
        else:
            ids = self.engine.tokenizer.encode(body.get("prompt") or "")
        _, matched = self.engine.scheduler.allocator.match_prefix(ids)
        out = {"matched_tokens": matched, "total_tokens": len(ids)}
        host_kv = self.engine.host_kv
        if host_kv is not None:
            bs = self.config.cache.block_size
            out["matched_tokens_host"] = bs * host_kv.probe_extension(
                ids, matched // bs)
        return 200, out

    def debug_perf(self) -> tuple[int, dict]:
        """The perf accountant's snapshot (engine/perf_accounting.py):
        windowed MFU and HBM-bandwidth utilization, phase throughput,
        device memory, the compile-event log and the cost model, with the
        speculative-decoding picture."""
        perf = self.engine.perf
        with self._kv_lock:
            pending = len(self._kv_transfers)
        kv_block = {"role": self.config.role,
                    "pending_transfers": pending,
                    "transfers": self.metrics.transfer_snapshot()}
        tier_block = None
        if self.engine.host_kv is not None or self.engine.remote_kv is not None:
            tier_block = self.engine.tier_stats()
        if perf is None:
            return 200, {"enabled": False, "kv_transfer": kv_block,
                         "kv_tier": tier_block}
        snap = perf.snapshot()
        snap["kv_transfer"] = kv_block
        snap["kv_tier"] = tier_block
        eng = self.engine
        drafted, steps = eng.spec_drafted, eng.spec_steps
        snap["speculative"] = {
            "enabled": eng._spec is not None,
            "draft_tokens": drafted,
            "accepted_tokens": eng.spec_accepted,
            "acceptance_rate": eng.spec_accepted / drafted if drafted
            else 0.0,
            "tokens_per_step": eng.spec_step_tokens / steps if steps
            else 0.0,
        }
        return 200, snap

    def debug_canary(self, query: dict) -> tuple[int, dict]:
        """Golden records of the pinned probes (canary_golden.py): each
        probe goes through the normal admission, greedy with logprobs on,
        and its response becomes a record. ``?tolerance=`` stamps the
        records' L-infinity band."""
        try:
            tolerance = float(query.get("tolerance", ["0.0"])[0])
        except ValueError:
            return 400, _error("tolerance must be a float")
        tk = self.engine.tokenizer
        records, errors = [], []
        for probe in DEFAULT_PROBES:
            rid = f"canary-{probe.id}-{uuid.uuid4().hex[:8]}"
            sampling = SamplingParams(max_tokens=probe.max_tokens,
                                      temperature=0.0, logprobs=probe.top_k)
            try:
                stream, = self.async_engine.admit_batch(
                    [(rid, tk.encode(probe.prompt), sampling,
                      self.lora.slot_of(self.model_name))])
                token_ids: list[int] = []
                lps: list = []
                for out in stream:
                    token_ids.extend(out.new_token_ids)
                    lps.extend(out.new_logprobs or ())
            except Exception as e:  # a sick engine still answers
                errors.append({"probe": probe.id, "error": str(e)})
                continue
            payload = {"choices": [{
                "text": tk.decode(token_ids),
                "logprobs": _fmt_completion_logprobs(
                    tk, token_ids, lps, probe.top_k),
            }]}
            try:
                rec = record_from_response(
                    self.model_name, probe, payload, tolerance=tolerance,
                    source=f"engine:{self.model_name}", created=time.time())
            except ValueError as e:
                errors.append({"probe": probe.id, "error": str(e)})
                continue
            records.append(rec.to_dict())
        return 200, {"model": self.model_name, "records": records,
                     "errors": errors}

    def profile(self, body: dict):
        """A ``torch.profiler`` trace of ``duration_ms`` of serving (CUDA
        activity included on the card), as a tar.gz of its Chrome trace;
        409 while another capture runs. The profiler is stopped on every
        exit path. Returns (status, JSON) or (200, tar.gz bytes)."""
        import torch

        duration_ms = min(int(body.get("duration_ms") or 2000), 60_000)
        if not self._profiling.acquire(blocking=False):
            return 409, _error("a profile capture is already running",
                               "conflict")
        try:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.engine.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            try:
                time.sleep(duration_ms / 1000.0)
            finally:
                prof.stop()
            with tempfile.TemporaryDirectory(prefix="torchprof-") as tmp:
                prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
                buf = io.BytesIO()
                with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                    tar.add(tmp, arcname="trace")
            return 200, buf.getvalue()
        except Exception as e:
            return 500, _error(f"profile capture failed: {e}",
                               "server_error")
        finally:
            self._profiling.release()

    def load_lora(self, body: dict) -> tuple[int, dict]:
        name, path = body.get("lora_name"), body.get("lora_path")
        if not name or not path:
            return 400, _error("lora_name and lora_path required")
        try:
            self.async_engine.run_on_engine(
                lambda eng: self.lora.load(name, path))
        except Exception as e:  # a bad adapter is the caller's error
            return 400, _error(str(e))
        return 200, {"status": "loaded", "lora_name": name}

    def unload_lora(self, body: dict) -> tuple[int, dict]:
        name = body.get("lora_name")
        if not self.async_engine.run_on_engine(
                lambda eng: self.lora.unload(name)):
            return 404, _error(f"adapter {name!r} not loaded", "not_found")
        return 200, {"status": "unloaded", "lora_name": name}

    def guided_sampling(self, body: dict,
                        sampling: SamplingParams) -> SamplingParams:
        """``sampling`` with the request's grammar, validated now (a 400
        before admission, not a failure mid-stream)."""
        g_re = body.get("guided_regex")
        g_js = body.get("guided_json")
        if g_re is None and g_js is None:
            return sampling
        if g_re is not None and g_js is not None:
            raise BadRequest("guided_regex and guided_json are mutually "
                             "exclusive")
        if body.get("guided_choice") is not None:
            raise BadRequest("guided_choice cannot combine with other "
                             "guidance")
        if g_re is not None and not isinstance(g_re, str):
            raise BadRequest("guided_regex must be a string")
        try:
            pat = g_re if g_re is not None else schema_to_regex(g_js)
            compile_regex(pat, max_states=self.config.max_grammar_states)
        except (ValueError, IndexError, KeyError, TypeError) as e:
            # RegexError is a ValueError; the other types keep any parser
            # edge case a 400
            raise BadRequest(f"invalid guided grammar: {e}") from None
        return dataclasses.replace(sampling, guided_regex=g_re,
                                   guided_json=g_js)

    def render_chat(self, messages: list[dict]) -> str:
        tk = self.engine.tokenizer
        if hasattr(tk, "tk") and getattr(tk.tk, "chat_template", None):
            return tk.tk.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        parts = [f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}"
                 for m in messages]
        return "\n".join(parts) + "\n<|assistant|>\n"

    def prompts_of(self, body: dict, chat: bool) -> list:
        """The request's prompts: one rendered chat, or the completions
        forms str | [str, ...] | [int, ...] | [[int, ...], ...]."""
        if chat:
            if "messages" not in body:
                raise BadRequest("'messages' is required")
            return [self.render_chat(body["messages"])]
        prompt = body.get("prompt")
        if prompt is None:
            raise BadRequest("'prompt' is required")

        def is_token_list(p):
            return (isinstance(p, list) and p
                    and all(isinstance(t, int) for t in p))

        if isinstance(prompt, str) or is_token_list(prompt):
            return [prompt]
        if (isinstance(prompt, list) and prompt
                and all(isinstance(p, str) or is_token_list(p)
                        for p in prompt)):
            return prompt
        raise BadRequest("invalid 'prompt': expected string, token list, or "
                         "batch thereof")

    def admit(self, body: dict, chat: bool) -> _Admission:
        """Validate a generation request, run what its
        ``kv_transfer_params`` ask for before admission (splice a landed
        push, or pull blocks into the prefix cache) and admit its
        choices."""
        prompts = self.prompts_of(body, chat)
        try:
            sampling = _sampling_from_body(body)
            lp_n = _parse_logprobs(body, chat)
            if lp_n is not None:
                sampling = dataclasses.replace(sampling, logprobs=lp_n)
            make_token_controls(sampling, self.config.model.vocab_size)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"invalid sampling parameter: {e}") from None
        sampling = self.guided_sampling(body, sampling)
        for key in ("guided_choice", "echo"):
            if body.get(key):
                raise BadRequest(f"{key!r} is not supported by this engine")
        if sampling.n < 1 or sampling.n * len(prompts) > MAX_CHOICES:
            raise BadRequest(
                f"n x prompt batch size must be in [1, {MAX_CHOICES}]")
        tk = self.engine.tokenizer
        prompt_ids_list = [tk.encode(p) if isinstance(p, str) else list(p)
                           for p in prompts]
        for ids in prompt_ids_list:
            if len(ids) > self.config.model.max_model_len - 1:
                raise BadRequest("prompt too long")
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex}"
        adapter_slot = self.lora.slot_of(body.get("model", self.model_name))
        n = sampling.n
        nchoices = len(prompt_ids_list) * n
        kv = body.get("kv_transfer_params") or {}
        if kv and (nchoices != 1 or not isinstance(kv, dict)):
            raise BadRequest("kv_transfer_params requires n=1 and a single "
                             "prompt")
        imported = 0
        if kv.get("transfer_id") and not kv.get("do_remote_decode"):
            # the decode hop of a pushed transfer: splice it in; when it is
            # not attachable, the pull or a plain prefill serves the body
            spliced = self._try_attach_spliced(kv["transfer_id"], sampling,
                                               rid, adapter_slot)
            if spliced is not None:
                stream, n_prompt = spliced
                return _Admission([stream], [rid], rid, sampling, n_prompt,
                                  prompt_ids_list[0])
        if kv.get("remote_block_ids"):
            imported = self._maybe_import_kv(kv, prompt_ids_list[0],
                                             adapter_slot)
        produce_kv = bool(kv.get("do_remote_decode"))
        push = None
        if (produce_kv and kv.get("push_url") and kv.get("transfer_id")
                and not body.get("stream")):
            push = {"push_url": kv["push_url"],
                    "transfer_id": str(kv["transfer_id"])}
        reqs, rids = [], []
        for pi, ids in enumerate(prompt_ids_list):
            for j in range(n):
                idx = pi * n + j
                crid = rid if nchoices == 1 else f"{rid}-{idx}"
                choice_sampling = sampling
                if sampling.seed is not None and nchoices > 1:
                    # seeded n > 1 still yields distinct choices
                    choice_sampling = dataclasses.replace(
                        sampling, seed=(sampling.seed + idx) & 0xFFFFFFFF)
                reqs.append((crid, ids, choice_sampling, adapter_slot,
                             push is not None))
                rids.append(crid)
        try:
            streams = self.async_engine.admit_batch(reqs)
        except (SchedulerQueueFull, GrammarBankFull):
            raise
        except ValueError as e:
            raise BadRequest(str(e)) from None
        n_prompt = sum(len(p) for p in prompt_ids_list)
        return _Admission(streams, rids, rid, sampling, n_prompt,
                          prompt_ids_list[0], produce_kv, push, imported)

    def collect(self, stream, sampling) -> tuple:
        """Drain one choice: (text, n_kept, finish_reason, cached, ids,
        lps, the blocks it held at finish or None)."""
        tk = self.engine.tokenizer
        token_ids: list[int] = []
        lps: list = []
        finish_reason = None
        cached = 0
        blocks = None
        for out in stream:
            token_ids.extend(out.new_token_ids)
            if out.new_logprobs:
                lps.extend(out.new_logprobs)
            cached = out.num_cached_tokens
            if out.block_ids is not None:
                blocks = out.block_ids
            finish_reason = out.finish_reason or finish_reason
            stopped = _check_stop_str(tk.decode(token_ids), sampling)
            if stopped is not None:
                self.async_engine.abort(stream.request_id)
                n_kept = _tokens_covering(tk, token_ids, len(stopped))
                return (stopped, n_kept, "stop", cached, token_ids[:n_kept],
                        lps[:n_kept], blocks)
        return (tk.decode(token_ids), len(token_ids), finish_reason, cached,
                token_ids, lps, blocks)

    def full_response(self, adm: _Admission, model, chat) -> dict:
        tk = self.engine.tokenizer
        sampling = adm.sampling
        results = []
        try:
            for s in adm.streams:
                results.append(self.collect(s, sampling))
        finally:
            blocks = results[0][6] if results else None
            if adm.push is not None and blocks is None:
                adm.push = None  # never finished: nothing was pinned
        if adm.push is not None:
            # the producer of a pushed P->D transfer: its blocks were
            # pinned at finish; stream them to the decode engine, then
            # let them go (the pull fields below stay the fallback)
            ids = results[0][4]
            try:
                pushed = bool(ids) and self._push_kv_blocks(
                    adm.push["push_url"], adm.push["transfer_id"], blocks,
                    adm.prompt_ids, ids[0])
            finally:
                self.async_engine.run_on_engine(
                    lambda eng: eng.scheduler.allocator.free_blocks(blocks))
        n = max(1, int(sampling.n))
        cached = sum(
            max((r[3] for r in results[pi * n:(pi + 1) * n]), default=0)
            for pi in range(len(results) // n)
        )
        n_completion = sum(r[1] for r in results)
        want_lp = sampling.logprobs is not None
        choices = []
        for idx, (text, _n, finish_reason, _c, ids, lps, _b) in enumerate(
                results):
            if chat:
                choice = {"index": idx,
                          "message": {"role": "assistant", "content": text},
                          "finish_reason": finish_reason or "stop"}
                if want_lp:
                    choice["logprobs"] = _fmt_chat_logprobs(
                        tk, ids, lps, sampling.logprobs)
            else:
                choice = {"index": idx, "text": text,
                          "finish_reason": finish_reason or "stop",
                          "logprobs": (_fmt_completion_logprobs(
                              tk, ids, lps, sampling.logprobs)
                              if want_lp else None)}
            choices.append(choice)
        payload = {
            "id": adm.rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": choices,
            "usage": {
                "prompt_tokens": adm.n_prompt,
                "completion_tokens": n_completion,
                "total_tokens": adm.n_prompt + n_completion,
                "prompt_tokens_details": {"cached_tokens": cached},
            },
        }
        final_blocks = results[0][6] if results else None
        if adm.produce_kv and final_blocks:
            # the producer's block handles (the router fills remote_host)
            payload["kv_transfer_params"] = {
                "do_remote_prefill": True,
                "remote_engine_id": self.model_name,
                "remote_block_ids": final_blocks,
                "remote_host": None,
                "remote_port": None,
            }
            if adm.push is not None:
                payload["kv_transfer_params"]["transfer_id"] = \
                    adm.push["transfer_id"]
                payload["kv_transfer_params"]["pushed"] = pushed
        return payload

    # -- the KV plane (P->D disaggregation; engine/kv_transfer.py) ----------
    def _kv_shape(self, n_blocks: int) -> tuple:
        m = self.config.model
        return (m.num_layers, n_blocks, self.config.cache.block_size,
                2 * m.num_kv_heads, m.head_dim)

    def kv_export(self, body: dict, handler) -> None:
        """``POST /kv/export {"blocks", "stream"}``: the blocks' KV (L, n,
        bs, 2KH, D), whole, or as chunked layer-group frames whose gathers
        overlap the send. A streamed export pins the blocks for its length:
        serving steps run between its gathers."""
        num_blocks = self.engine.runner.num_blocks
        blocks = body.get("blocks")
        if (not isinstance(blocks, list) or not blocks
                or not all(isinstance(b, int) and 0 <= b < num_blocks
                           for b in blocks)):
            handler._send_json(_error("invalid block ids"), 400)
            return
        dtype = self.config.model.dtype
        if not body.get("stream"):
            data = self.async_engine.run_on_engine(
                lambda eng: eng.export_kv(blocks))
            raw = tensor_bytes(data)
            handler.send_response(200)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header("Content-Length", str(len(raw)))
            handler.send_header("X-KV-Shape", ",".join(map(str, data.shape)))
            handler.send_header("X-KV-Dtype", dtype)
            handler.end_headers()
            handler.wfile.write(raw)
            return
        L = self.config.model.num_layers
        try:
            group = max(1, min(int(body.get("group_layers")
                                   or default_group(L)), L))
        except (TypeError, ValueError):
            handler._send_json(_error("group_layers must be an integer"),
                               400)
            return
        try:
            self.async_engine.run_on_engine(
                lambda eng: eng.scheduler.allocator.pin_blocks(blocks))
        except ValueError as e:  # a free block: nothing cached to export
            handler._send_json(_error(str(e), "conflict"), 409)
            return
        t0 = time.monotonic()
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.send_header("X-KV-Shape",
                                ",".join(map(str, self._kv_shape(len(blocks)))))
            handler.send_header("X-KV-Dtype", dtype)
            handler.send_header("X-KV-Group-Layers", str(group))
            handler.end_headers()
            for fr in produce_frames(self.async_engine.run_on_engine, blocks,
                                     L, group, self.config.kv_transfer_window):
                handler._write_chunk(fr)
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            handler.close_connection = True
            return
        finally:
            self.async_engine.run_on_engine(
                lambda eng: eng.scheduler.allocator.free_blocks(blocks))
        self.metrics.observe_transfer(
            "export", nbytes_of(self._kv_shape(len(blocks)), dtype),
            time.monotonic() - t0)

    def _maybe_import_kv(self, kv: dict, prompt_ids: list[int],
                         adapter_slot: int) -> int:
        """The decode hop's pull: stream the producer's full blocks from
        ``remote_host``'s ``/kv/export`` into pool blocks and commit them
        as prefix-cache content on the request's chain, so admission
        computes only the prompt's tail. Best-effort: on a failure the
        blocks go back and the prefill computes everything. Returns the
        tokens landed."""
        host, blocks = kv.get("remote_host"), kv.get("remote_block_ids")
        if not host or not blocks:
            return 0
        root = self.engine.runner.lora_roots[adapter_slot]
        local = None
        try:
            got = self.async_engine.run_on_engine(
                lambda eng: eng.begin_kv_import(list(prompt_ids),
                                                len(blocks)))
            if got is None:
                return 0
            local, n_full = got
            t0 = time.monotonic()
            u = urllib.parse.urlsplit(host)
            conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                              timeout=120)
            try:
                conn.request("POST", "/kv/export", json.dumps(
                    {"blocks": [int(b) for b in blocks[:n_full]],
                     "stream": True}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    raise RuntimeError(f"export HTTP {resp.status}")
                shape = tuple(int(x) for x in
                              resp.headers["X-KV-Shape"].split(","))
                dtype = resp.headers["X-KV-Dtype"]
                if shape[2:] != self._kv_shape(0)[2:] or shape[0] != \
                        self.config.model.num_layers:
                    raise ValueError(f"KV shape {shape} does not fit this "
                                     "engine's pool")
                consume_frames(resp, self.async_engine.run_on_engine, local,
                               shape, dtype,
                               int(resp.headers["X-KV-Group-Layers"]))
                resp.read()  # the chunked body's end
            finally:
                conn.close()
            cached = self.async_engine.run_on_engine(
                lambda eng: eng.finish_kv_import(list(prompt_ids), local,
                                                 root))
            local = None  # committed
            self.metrics.observe_transfer("import", nbytes_of(shape, dtype),
                                          time.monotonic() - t0)
            return cached
        except Exception as e:  # best-effort: the prefill recomputes
            _log.warning("kv import from %s failed: %s", host, e)
            if local is not None:
                self.async_engine.run_on_engine(
                    lambda eng: eng.abort_kv_import(local))
            return 0

    def _sweep_kv_transfers(self) -> None:
        """Free the blocks of pushed transfers whose decode hop never came
        within ``kv_transfer_ttl`` (a router that died between the push
        and the continuation): a leaked transfer never pins pages for
        good. Runs on every /kv/recv and attach."""
        now = time.monotonic()
        expired = []
        with self._kv_lock:
            for tid, st in list(self._kv_transfers.items()):
                if now - st["created"] > self.config.kv_transfer_ttl:
                    expired.append((tid, self._kv_transfers.pop(tid)))
        for tid, st in expired:
            _log.warning("kv transfer %s expired unattached; freeing %d "
                         "blocks", tid, len(st["blocks"]))
            self.async_engine.run_on_engine(
                lambda eng, b=st["blocks"]:
                eng.scheduler.allocator.free_blocks(b))

    def kv_recv(self, headers, body) -> tuple[int, dict]:
        """``POST /kv/recv``: land a pushed transfer (a JSON meta prologue
        frame, then CRC-tailed layer-group frames) in free pool blocks. The
        decode hop attaches them by ``transfer_id``. A bad CRC or a dropped
        connection answers 409 ``{"resume_layer": n}``: the producer
        resends only the groups that did not land. 503 when the pool
        cannot hold the transfer."""
        self._sweep_kv_transfers()
        tid = headers.get("X-KV-Transfer-Id") or ""
        try:
            shape = tuple(int(x) for x in headers["X-KV-Shape"].split(","))
            dtype = headers["X-KV-Dtype"]
            group = max(1, int(headers["X-KV-Group-Layers"]))
            start_layer = int(headers.get("X-KV-Start-Layer") or 0)
            nbytes_of(shape, dtype)
        except (KeyError, ValueError, AttributeError):
            return 400, _error("missing or invalid X-KV-* headers")
        if not tid or len(shape) != 5:
            return 400, _error("X-KV-Transfer-Id and a 5-dim X-KV-Shape are "
                               "required")
        want = self._kv_shape(shape[1])
        if shape[0] != want[0] or shape[2:] != want[2:]:
            return 400, _error(f"KV shape {shape} does not fit this "
                               f"engine's pool {want}")
        with self._kv_lock:
            state = self._kv_transfers.get(tid)
        resume_at = state["layers_done"] if state else 0
        try:
            payload = read_frame(body)
            if payload is None:
                raise ValueError("no meta frame")
            meta = json.loads(bytes(payload))
        except (FrameDigestError, EOFError, ValueError):
            return 409, {"resume_layer": resume_at}
        if state is None:
            if start_layer != 0:
                # a resume of a transfer this engine never saw (or swept)
                return 409, {"resume_layer": 0}
            blocks = self.async_engine.run_on_engine(
                lambda eng: eng.begin_kv_receive(int(shape[1])))
            if blocks is None:
                return 503, _error("KV pool cannot hold the transfer right "
                                   "now", "service_unavailable_error")
            state = {"blocks": blocks, "layers_done": 0, "meta": meta,
                     "created": time.monotonic(), "ready": False}
            with self._kv_lock:
                self._kv_transfers[tid] = state
        elif start_layer != state["layers_done"]:
            # the producer's progress disagrees with ours: re-anchor it
            return 409, {"resume_layer": state["layers_done"]}

        def on_group(lo: int, n: int) -> None:
            state["layers_done"] = lo + n

        t0 = time.monotonic()
        try:
            landed = consume_frames(body, self.async_engine.run_on_engine,
                                    state["blocks"], shape, dtype, group,
                                    start_layer=start_layer,
                                    on_group=on_group)
        except (FrameDigestError, EOFError, ValueError, OSError):
            # the groups that landed stay for the retry (the TTL sweep
            # reclaims them if none comes)
            return 409, {"resume_layer": state["layers_done"]}
        state["ready"] = True
        self.metrics.observe_transfer(
            "recv", landed * nbytes_of(shape[1:], dtype),
            time.monotonic() - t0)
        return 200, {"ok": True, "transfer_id": tid, "layers": shape[0]}

    def _push_kv_blocks(self, push_url: str, transfer_id: str, blocks: list,
                        prompt_ids: list, first_token: int) -> bool:
        """The producer's side of the pushed flow: stream the finished
        prefill's blocks (pinned at its finish) to the decode engine's
        /kv/recv. Best-effort: on a failure the decode hop pulls or
        prefills."""
        cfg = self.config
        shape = self._kv_shape(len(blocks))
        meta = {"transfer_id": transfer_id,
                "prompt_token_ids": [int(t) for t in prompt_ids],
                "first_token": int(first_token)}
        t0 = time.monotonic()
        try:
            push_kv(push_url, self.async_engine.run_on_engine, blocks, shape,
                    cfg.model.dtype, meta,
                    group=cfg.kv_transfer_group_layers or None,
                    window=cfg.kv_transfer_window,
                    retries=cfg.kv_transfer_retries,
                    timeout=cfg.kv_transfer_ttl)
        except Exception as e:
            _log.warning("kv push %s -> %s failed: %s", transfer_id,
                         push_url, e)
            return False
        self.metrics.observe_transfer("push",
                                      nbytes_of(shape, cfg.model.dtype),
                                      time.monotonic() - t0)
        return True

    def _try_attach_spliced(self, tid: str, sampling: SamplingParams,
                            rid: str, adapter_slot: int):
        """Attach a landed push as a decode row; (stream, prompt tokens)
        or None when it is not attachable (unknown, still landing, swept,
        a guided request, no decode slot). The continuation's
        ``max_tokens`` excludes the first token the router already relayed,
        but the spliced sequence holds that token as its first output and
        the length stop counts it, so it runs with max_tokens + 1."""
        self._sweep_kv_transfers()
        if sampling.guided_regex is not None or sampling.guided_json is not None:
            return None  # grammar state is built by a normal admission
        with self._kv_lock:
            state = self._kv_transfers.get(tid)
            if state is None or not state["ready"]:
                return None
            del self._kv_transfers[tid]  # claimed: the sweep cannot free it
        meta = state["meta"]
        try:
            stream = self.async_engine.attach_spliced(
                rid, meta["prompt_token_ids"], meta["first_token"],
                dataclasses.replace(sampling,
                                    max_tokens=sampling.max_tokens + 1),
                state["blocks"], adapter_slot=adapter_slot)
        except (SchedulerQueueFull, ValueError, KeyError) as e:
            _log.warning("kv transfer %s attach failed (%s); prefilling",
                         tid, e)
            with self._kv_lock:
                self._kv_transfers[tid] = state
            return None
        return stream, len(meta["prompt_token_ids"]) + 1

    def stream_events(self, streams, rid, model, chat, sampling, n_prompt,
                      include_usage: bool):
        """SSE payloads (dicts) of a streamed response, choice by choice,
        ending with the optional usage chunk. The caller writes ``data:
        [DONE]`` after them."""
        tk = self.engine.tokenizer
        obj = "chat.completion.chunk" if chat else "text_completion"
        created = int(time.time())
        want_lp = sampling.logprobs is not None
        # a stop string can span chunks: hold back enough trailing chars
        holdback = max((len(s) for s in sampling.stop), default=1) - 1
        if chat:
            for idx in range(len(streams)):
                yield {"id": rid, "object": obj, "created": created,
                       "model": model,
                       "choices": [{"index": idx,
                                    "delta": {"role": "assistant"},
                                    "finish_reason": None}]}
        n_out = 0
        for idx, stream in enumerate(streams):
            token_ids: list[int] = []
            all_lps: list = []
            lp_emitted = sent_len = n_kept = 0
            finish_reason = None
            for out in stream:
                token_ids.extend(out.new_token_ids)
                if out.new_logprobs:
                    all_lps.extend(out.new_logprobs)
                text = tk.decode(token_ids)
                stopped = _check_stop_str(text, sampling)
                if stopped is not None:
                    self.async_engine.abort(stream.request_id)
                    text = stopped
                    finish_reason = "stop"
                    n_kept = _tokens_covering(tk, token_ids, len(stopped))
                else:
                    n_kept = len(token_ids)
                done = out.finished or finish_reason is not None
                limit = (len(text) if done or not holdback
                         else max(sent_len, len(text) - holdback))
                delta = text[sent_len:limit]
                sent_len = limit
                if delta or done:
                    fr = finish_reason or out.finish_reason
                    chunk_lp = None
                    if want_lp:
                        # entries for tokens whose text is fully sent
                        m = _tokens_covering(tk, token_ids, sent_len)
                        if m and len(tk.decode(token_ids[:m])) > sent_len:
                            m -= 1
                        hi = min(n_kept, len(all_lps), m)
                        if lp_emitted < hi:
                            span = token_ids[lp_emitted:hi]
                            span_lps = all_lps[lp_emitted:hi]
                            if chat:
                                chunk_lp = _fmt_chat_logprobs(
                                    tk, span, span_lps, sampling.logprobs)
                            else:
                                chunk_lp = _fmt_completion_logprobs(
                                    tk, span, span_lps, sampling.logprobs,
                                    offset0=len(tk.decode(
                                        token_ids[:lp_emitted])))
                            lp_emitted = hi
                    if chat:
                        choice = {"index": idx,
                                  "delta": {"content": delta} if delta else {},
                                  "finish_reason": fr if done else None}
                        if want_lp:
                            choice["logprobs"] = chunk_lp
                    else:
                        choice = {"index": idx, "text": delta,
                                  "logprobs": chunk_lp,
                                  "finish_reason": fr if done else None}
                    yield {"id": rid, "object": obj, "created": created,
                           "model": model, "choices": [choice]}
                if finish_reason is not None:
                    break
            n_out += n_kept
        if include_usage:
            yield {"id": rid, "object": obj, "created": created,
                   "model": model, "choices": [],
                   "usage": {"prompt_tokens": n_prompt,
                             "completion_tokens": n_out,
                             "total_tokens": n_prompt + n_out}}

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = f"production-stack-tpu-torch/{__version__}"

            def log_message(self, fmt, *args):  # route to logging
                _log.debug("%s " + fmt, self.address_string(), *args)

            def _send_json(self, payload: dict, status: int = 200,
                           headers: Optional[dict] = None) -> None:
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _write_chunk(self, data: bytes) -> None:
                # three writes: a KV frame is too large to copy into one
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")
                self.wfile.flush()

            def _send_bytes(self, data: bytes, content_type: str,
                            status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (http.server API)
                url = urllib.parse.urlsplit(self.path)
                if url.path == "/health":
                    self._send_json({"status": "healthy"})
                elif url.path == "/ready":
                    status, payload = server.ready()
                    self._send_json(payload, status)
                elif url.path == "/v1/models":
                    self._send_json(server.models())
                elif url.path == "/version":
                    self._send_json({"version": __version__})
                elif url.path == "/metrics":
                    self._send_bytes(server.metrics.generate(), CONTENT_TYPE)
                elif url.path == "/debug/perf":
                    status, payload = server.debug_perf()
                    self._send_json(payload, status)
                elif url.path == "/debug/canary":
                    status, payload = server.debug_canary(
                        urllib.parse.parse_qs(url.query))
                    self._send_json(payload, status)
                else:
                    self._send_json(_error("not found", "not_found"), 404)

            def do_POST(self):  # noqa: N802 (http.server API)
                routes = {"/v1/load_lora_adapter": server.load_lora,
                          "/v1/unload_lora_adapter": server.unload_lora,
                          "/drain": server.drain,
                          "/tokenize": server.tokenize,
                          "/detokenize": server.detokenize,
                          "/kv/lookup": server.kv_lookup,
                          "/debug/profile": server.profile}
                path = urllib.parse.urlsplit(self.path).path
                if path == "/kv/recv":
                    self._kv_recv()
                    return
                generate = path in ("/v1/completions", "/v1/chat/completions")
                if (not generate and path not in routes
                        and path != "/kv/export"):
                    self._send_json(_error("not found", "not_found"), 404)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if server.draining and path.startswith("/v1/"):
                    # live streams keep running; infra routes stay up
                    server._drain_rejected += 1
                    self._send_json(
                        _error("engine is draining; no new requests are "
                               "admitted", "service_unavailable_error"), 503,
                        {"Retry-After": f"{server.overload_retry_after:g}"})
                    return
                try:
                    body = json.loads(raw or (b"{}" if path in routes
                                              else b"null"))
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError:
                    self._send_json(_error("invalid JSON body"), 400)
                    return
                if path == "/kv/export":
                    server.kv_export(body, self)
                    return
                if not generate:
                    status, payload = routes[path](body)
                    if isinstance(payload, bytes):
                        self._send_bytes(payload, "application/gzip", status)
                    else:
                        self._send_json(payload, status)
                    return
                with server._inflight_lock:
                    server._inflight += 1
                try:
                    self._generate(body, path == "/v1/chat/completions")
                finally:
                    with server._inflight_lock:
                        server._inflight -= 1

            def _kv_recv(self) -> None:
                if "chunked" in (self.headers.get("Transfer-Encoding")
                                 or "").lower():
                    body = _ChunkedReader(self.rfile)
                else:
                    body = _LengthReader(
                        self.rfile, int(self.headers.get("Content-Length")
                                        or 0))
                status, payload = server.kv_recv(self.headers, body)
                # read the body to its end (a landed stream's last chunk;
                # a refused body's rest, so the answer reaches a sender
                # still writing it) before answering on this connection
                try:
                    body.drain()
                except (EOFError, OSError, ValueError):
                    self.close_connection = True
                self._send_json(payload, status)

            def _generate(self, body: dict, chat: bool) -> None:
                retry_after = {"Retry-After":
                               f"{server.overload_retry_after:g}"}
                try:
                    adm = server.admit(body, chat)
                except BadRequest as e:
                    self._send_json(_error(str(e)), 400)
                    return
                except SchedulerQueueFull as e:
                    self._send_json(_error(str(e), "rate_limit_error"), 429,
                                    retry_after)
                    return
                except GrammarBankFull:
                    self._send_json(_error(
                        "all guided-decoding grammar slots are in use; retry "
                        "when in-flight guided requests finish",
                        "rate_limit_error"), 429, retry_after)
                    return
                model = body.get("model", server.model_name)
                xrid = self.headers.get("x-request-id") or adm.rid
                try:
                    if body.get("stream"):
                        so = body.get("stream_options")
                        so = so if isinstance(so, dict) else {}
                        self._stream(adm.streams, adm.rid, model, chat,
                                     adm.sampling, adm.n_prompt,
                                     bool(so.get("include_usage")), xrid)
                    else:
                        payload = server.full_response(adm, model, chat)
                        self._send_json(payload,
                                        headers={"X-Request-Id": xrid})
                finally:
                    for r in adm.rids:  # a no-op for finished requests
                        server.async_engine.abort(r)

            def _stream(self, streams, rid, model, chat, sampling, n_prompt,
                        include_usage, xrid) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Request-Id", xrid)
                self.end_headers()
                try:
                    for payload in server.stream_events(
                            streams, rid, model, chat, sampling, n_prompt,
                            include_usage):
                        self._write_chunk(
                            f"data: {json.dumps(payload)}\n\n".encode())
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                    return
                except RuntimeError as e:  # an engine step failed
                    self._write_chunk(
                        f"data: {json.dumps(_error(str(e), 'server_error'))}"
                        "\n\n".encode())
                self._write_chunk(b"data: [DONE]\n\n")
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

        return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="tiny-llama",
                   help="model preset name (engine/config.py MODEL_PRESETS) "
                        "or a local HF checkpoint directory (config.json "
                        "and *.safetensors)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--max-num-seqs", type=int, default=None)
    p.add_argument("--prefill-batch", type=int, default=None,
                   help="prefill chunks batched per dispatch (bucketed)")
    p.add_argument("--max-num-batched-tokens", type=int, default=None)
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated token buckets, e.g. 128,512,2048 "
                        "(bucketed)")
    p.add_argument("--attention-impl", default=None,
                   choices=["auto", "ragged", "bucketed"],
                   help="attention dispatch shape: 'ragged' packs prefill "
                        "chunks and decode rows into one token-budget "
                        "stream per step (K2), 'bucketed' runs prefill "
                        "chunks padded to --prefill-buckets, up to "
                        "--prefill-batch a step (K4), and decode in steps "
                        "of their own; 'auto' is ragged")
    p.add_argument("--num-scheduler-steps", type=int, default=None,
                   help="decode iterations per decode dispatch")
    p.add_argument("--block-size", type=int, default=None)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--quantization", default=None, choices=["int8"],
                   help="int8: per-channel int8 weights, quantized when "
                        "they are made or loaded; products below 512 "
                        "tokens run W8A8 (cuBLAS int8 GEMM), larger ones "
                        "W8A16 (PSTPU_QUANT_A16_THRESHOLD)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--speculative-ngram", type=int, default=0,
                   help="n-gram (prompt-lookup) speculative decoding: "
                        "propose up to this many draft tokens a step from "
                        "the sequence's own history and verify them inside "
                        "the ragged step (vLLM --speculative-config ngram). "
                        "Per sequence: greedy rows speculate, sampled or "
                        "penalised rows in the same step decode normally; "
                        "an acceptance EWMA adapts the width. 0 = off; "
                        "ragged path only")
    p.add_argument("--speculative-ngram-max", type=int, default=3,
                   help="longest tail n-gram matched against the history")
    p.add_argument("--speculative-ngram-min", type=int, default=1,
                   help="shortest tail n-gram matched against the history "
                        "(the proposer tries max..min, longest first)")
    p.add_argument("--speculative-window", type=int, default=4096,
                   help="trailing history tokens the n-gram proposer "
                        "searches for a recurrence")
    p.add_argument("--skip-warmup", action="store_true",
                   help="serve at once, without first running every step "
                        "signature (GET /ready answers 503 \"warming\" "
                        "while the warmup runs)")
    p.add_argument("--overload-retry-after", type=float, default=1.0,
                   help="Retry-After seconds advertised on overload 429s "
                        "and on the 503s of a draining engine")
    p.add_argument("--drain-deadline", type=float, default=30.0,
                   help="graceful-drain budget (seconds): on SIGTERM or "
                        "POST /drain, in-flight sequences get this long "
                        "to finish before stragglers are aborted (KV "
                        "blocks freed) and the process exits; readiness "
                        "(GET /ready) answers 503 for the whole window "
                        "while /health stays truthful")
    p.add_argument("--watchdog-stall-seconds", type=float, default=0.0,
                   help="stuck-step watchdog: flip readiness (GET /ready) "
                        "to 503 when no scheduler step completes for this "
                        "many seconds while work is queued. 0 = disabled")
    p.add_argument("--no-perf-accounting", dest="perf_accounting",
                   action="store_false", default=True,
                   help="disable live goodput accounting (MFU / HBM "
                        "bandwidth gauges, compile-event tracking, "
                        "GET /debug/perf — engine/perf_accounting.py)")
    p.add_argument("--perf-window", type=float, default=60.0,
                   help="sliding window (seconds) the utilization gauges "
                        "are computed over")
    p.add_argument("--perf-peak-tflops", type=float, default=0.0,
                   help="the card's peak TFLOP/s for MFU; 0 = the H100 SXM "
                        "data sheet's dense bf16 (989)")
    p.add_argument("--perf-peak-hbm-gbps", type=float, default=0.0,
                   help="the card's peak HBM GB/s; 0 = the H100 SXM data "
                        "sheet's (3350)")
    p.add_argument("--perf-peak-ici-gbps", type=float, default=0.0,
                   help="per-card interconnect GB/s for the collective "
                        "roofline; 0 = the H100 SXM data sheet's NVLink, "
                        "per direction (450)")
    p.add_argument("--host-offload-blocks", type=int, default=0,
                   help="host-DRAM KV tier capacity in blocks (0 = off; "
                        "prefer --kv-host-cache-bytes)")
    p.add_argument("--kv-host-cache-bytes", type=int, default=0,
                   help="host-DRAM KV tier capacity in bytes (overrides "
                        "--host-offload-blocks when both are set)")
    p.add_argument("--kv-prefetch-workers", type=int, default=0,
                   help="threads of the tier prefix-prefetch pipeline "
                        "(0 = the config default, 2)")
    p.add_argument("--remote-kv-url", default=None,
                   help="shared remote KV server URL "
                        "(python -m production_stack_tpu_torch.kv_server)")
    p.add_argument("--role", default="unified",
                   choices=["unified", "prefill", "decode"],
                   help="role in a disaggregated deployment: 'prefill' "
                        "runs prompts to their first token and pushes the "
                        "KV to a decode engine (POST {decode}/kv/recv), "
                        "'decode' takes pushed transfers and splices them "
                        "in decode-ready, 'unified' (default) does both. "
                        "Advisory for routing: every role serves the whole "
                        "OpenAI surface")
    p.add_argument("--kv-transfer-group-layers", type=int, default=0,
                   help="layers a KV-transfer frame; 0 = half the stack")
    p.add_argument("--kv-transfer-window", type=int, default=2,
                   help="producer-side layer-group gathers in flight ahead "
                        "of the frame being sent")
    p.add_argument("--kv-transfer-retries", type=int, default=3,
                   help="attempts a push; a digest mismatch resumes from "
                        "the first layer group that did not land")
    p.add_argument("--kv-transfer-ttl", type=float, default=120.0,
                   help="seconds a received, unattached transfer may hold "
                        "KV blocks before the sweep frees them")
    return p


def config_from_args(args) -> EngineConfig:
    overrides = {}
    if args.max_model_len is not None:
        overrides["max_model_len"] = args.max_model_len
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    if args.quantization:
        overrides["quant"] = args.quantization
    cache = CacheConfig(host_offload_blocks=args.host_offload_blocks,
                        kv_host_cache_bytes=args.kv_host_cache_bytes,
                        remote_kv_url=args.remote_kv_url or None)
    if args.kv_prefetch_workers:
        cache.kv_prefetch_workers = args.kv_prefetch_workers
    if args.block_size is not None:
        cache.block_size = args.block_size
    if args.num_blocks is not None:
        cache.num_blocks = args.num_blocks
    sched = SchedulerConfig()
    if args.max_num_seqs is not None:
        sched.max_num_seqs = args.max_num_seqs
    if args.max_num_batched_tokens is not None:
        sched.max_num_batched_tokens = args.max_num_batched_tokens
    if args.num_scheduler_steps is not None:
        sched.multi_step = args.num_scheduler_steps
    if args.prefill_batch:
        sched.prefill_batch = args.prefill_batch
    if args.prefill_buckets:
        sched.prefill_buckets = tuple(
            int(x) for x in args.prefill_buckets.split(","))
    if args.attention_impl:
        overrides["attention_impl"] = args.attention_impl
    if args.speculative_ngram:
        sched.spec_ngram_k = args.speculative_ngram
        sched.spec_ngram_max = args.speculative_ngram_max
        sched.spec_ngram_min = args.speculative_ngram_min
        sched.spec_window = args.speculative_window
    perf = PerfConfig(enabled=args.perf_accounting)
    if args.perf_window:
        perf.window = args.perf_window
    if args.perf_peak_tflops:
        perf.peak_tflops = args.perf_peak_tflops
    if args.perf_peak_hbm_gbps:
        perf.peak_hbm_gbps = args.perf_peak_hbm_gbps
    if args.perf_peak_ici_gbps:
        perf.peak_ici_gbps = args.perf_peak_ici_gbps
    return EngineConfig.for_model(
        args.model, cache=cache, scheduler=sched, seed=args.seed, perf=perf,
        role=args.role,
        kv_transfer_group_layers=args.kv_transfer_group_layers,
        kv_transfer_window=args.kv_transfer_window,
        kv_transfer_retries=args.kv_transfer_retries,
        kv_transfer_ttl=args.kv_transfer_ttl, **overrides)


def server_from_args(args) -> EngineServer:
    """The server ``main`` runs for parsed command-line ``args``, not yet
    bound: the warmup starts at ``bind`` unless ``--skip-warmup``."""
    return EngineServer(config_from_args(args), device=args.device,
                        served_model_name=args.served_model_name,
                        warmup_on_start=not args.skip_warmup,
                        overload_retry_after=args.overload_retry_after,
                        drain_deadline=args.drain_deadline,
                        watchdog_stall_seconds=args.watchdog_stall_seconds)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    server = server_from_args(args)
    port = server.bind(args.host, args.port)
    _log.info("serving %s on %s:%d (device %s, %d KV blocks)",
              server.model_name, args.host, port, server.engine.device,
              server.engine.runner.num_blocks)

    def _exit_when_drained():
        server.wait_drained()
        time.sleep(0.1)  # a beat for handlers to deliver their last bytes
        server.stop_serving()

    def _term(signum, frame):
        # SIGTERM drains: in-flight requests finish under --drain-deadline
        # (a drain already started by POST /drain is joined), then the
        # server stops and the process exits 0
        server.begin_drain("sigterm")
        threading.Thread(target=_exit_when_drained, daemon=True,
                         name="exit-when-drained").start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
