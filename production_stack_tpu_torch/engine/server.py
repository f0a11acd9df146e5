"""OpenAI-compatible HTTP server for the PyTorch engine.

Ports the completions surface of production_stack_tpu/engine/server.py
onto the standard library (``http.server.ThreadingHTTPServer``), since the
machines this package targets need not have ``aiohttp``. Each request is
handled on its own thread; the engine steps on the AsyncEngine's thread.

Routes: ``POST /v1/completions`` and ``POST /v1/chat/completions`` (JSON,
or SSE ending in ``data: [DONE]`` with ``"stream": true``; ``guided_regex``
or ``guided_json`` constrain the output, and ``model`` may name a loaded
LoRA adapter), ``POST /v1/load_lora_adapter`` and ``POST
/v1/unload_lora_adapter`` (``{"lora_name", "lora_path"}``, the reference
LoraAdapter operator's calls), ``GET /v1/models`` (the model and each
adapter) and ``GET /health``. Response bodies have the JAX server's shape,
so the same router can front either engine. ``guided_choice`` and
``echo`` (which need prompt scoring), ``/metrics`` and ``/debug/*`` are
not ported yet.

Run: ``python -m production_stack_tpu_torch.engine.server --model
llama-3-8b --port 18077`` (``--device cpu`` for the plain path,
``--attention-impl bucketed`` for the bucketed prefill path,
``--speculative-ngram 4`` for n-gram speculative decoding on the ragged
path).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from production_stack_tpu_torch import __version__
from production_stack_tpu_torch.engine.async_engine import AsyncEngine
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.engine import GrammarBankFull, LLMEngine
from production_stack_tpu_torch.engine.grammar import (
    compile_regex,
    schema_to_regex,
)
from production_stack_tpu_torch.engine.lora import LoraManager
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


class EngineServer:
    """The engine, its thread and the HTTP front end."""

    def __init__(self, config: EngineConfig, engine: Optional[LLMEngine] = None,
                 device="cuda", served_model_name: Optional[str] = None):
        self.config = config
        self.engine = engine if engine is not None else LLMEngine(
            config, device=device)
        self.async_engine = AsyncEngine(self.engine)
        self.lora = LoraManager(self.engine)
        self.model_name = served_model_name or config.model.name
        self.start_time = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the engine thread and bind the HTTP socket; returns the
        bound port (a free one for port 0)."""
        self.async_engine.start()
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        return self._httpd.server_address[1]

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a background thread; returns the bound port."""
        bound = self.bind(host, port)
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http")
        self._serve_thread.start()
        return bound

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        if self._httpd is not None:
            if self._serve_thread is not None:
                self._httpd.shutdown()
                self._serve_thread.join(10)
                self._serve_thread = None
            self._httpd.server_close()
            self._httpd = None
        self.async_engine.stop()

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
            "role": "unified",
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

    def admit(self, body: dict, chat: bool):
        """Validate a generation request and admit its choices. Returns
        (streams, rids, rid, sampling, n_prompt)."""
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
        for key in ("guided_choice", "echo", "kv_transfer_params"):
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
                reqs.append((crid, ids, choice_sampling, adapter_slot))
                rids.append(crid)
        try:
            streams = self.async_engine.admit_batch(reqs)
        except (SchedulerQueueFull, GrammarBankFull):
            raise
        except ValueError as e:
            raise BadRequest(str(e)) from None
        n_prompt = sum(len(p) for p in prompt_ids_list)
        return streams, rids, rid, sampling, n_prompt

    def collect(self, stream, sampling) -> tuple:
        """Drain one choice: (text, n_kept, finish_reason, cached, ids,
        lps)."""
        tk = self.engine.tokenizer
        token_ids: list[int] = []
        lps: list = []
        finish_reason = None
        cached = 0
        for out in stream:
            token_ids.extend(out.new_token_ids)
            if out.new_logprobs:
                lps.extend(out.new_logprobs)
            cached = out.num_cached_tokens
            finish_reason = out.finish_reason or finish_reason
            stopped = _check_stop_str(tk.decode(token_ids), sampling)
            if stopped is not None:
                self.async_engine.abort(stream.request_id)
                n_kept = _tokens_covering(tk, token_ids, len(stopped))
                return (stopped, n_kept, "stop", cached, token_ids[:n_kept],
                        lps[:n_kept])
        return (tk.decode(token_ids), len(token_ids), finish_reason, cached,
                token_ids, lps)

    def full_response(self, streams, rid, model, chat, sampling,
                      n_prompt) -> dict:
        tk = self.engine.tokenizer
        results = [self.collect(s, sampling) for s in streams]
        n = max(1, int(sampling.n))
        cached = sum(
            max((r[3] for r in results[pi * n:(pi + 1) * n]), default=0)
            for pi in range(len(results) // n)
        )
        n_completion = sum(r[1] for r in results)
        want_lp = sampling.logprobs is not None
        choices = []
        for idx, (text, _n, finish_reason, _c, ids, lps) in enumerate(results):
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
        return {
            "id": rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": choices,
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_completion,
                "total_tokens": n_prompt + n_completion,
                "prompt_tokens_details": {"cached_tokens": cached},
            },
        }

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
                self.wfile.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                self.wfile.flush()

            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/health":
                    self._send_json({"status": "healthy"})
                elif self.path == "/v1/models":
                    self._send_json(server.models())
                elif self.path == "/version":
                    self._send_json({"version": __version__})
                else:
                    self._send_json(_error("not found", "not_found"), 404)

            def do_POST(self):  # noqa: N802 (http.server API)
                lora_routes = {"/v1/load_lora_adapter": server.load_lora,
                               "/v1/unload_lora_adapter": server.unload_lora}
                if self.path not in ("/v1/completions",
                                     "/v1/chat/completions", *lora_routes):
                    self._send_json(_error("not found", "not_found"), 404)
                    return
                chat = self.path == "/v1/chat/completions"
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(length) or b"null")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError:
                    self._send_json(_error("invalid JSON body"), 400)
                    return
                if self.path in lora_routes:
                    status, payload = lora_routes[self.path](body)
                    self._send_json(payload, status)
                    return
                try:
                    streams, rids, rid, sampling, n_prompt = server.admit(
                        body, chat)
                except BadRequest as e:
                    self._send_json(_error(str(e)), 400)
                    return
                except SchedulerQueueFull as e:
                    self._send_json(_error(str(e), "rate_limit_error"), 429,
                                    {"Retry-After": "1"})
                    return
                except GrammarBankFull:
                    self._send_json(_error(
                        "all guided-decoding grammar slots are in use; retry "
                        "when in-flight guided requests finish",
                        "rate_limit_error"), 429, {"Retry-After": "1"})
                    return
                model = body.get("model", server.model_name)
                xrid = self.headers.get("x-request-id") or rid
                try:
                    if body.get("stream"):
                        so = body.get("stream_options")
                        so = so if isinstance(so, dict) else {}
                        self._stream(streams, rid, model, chat, sampling,
                                     n_prompt, bool(so.get("include_usage")),
                                     xrid)
                    else:
                        payload = server.full_response(
                            streams, rid, model, chat, sampling, n_prompt)
                        self._send_json(payload,
                                        headers={"X-Request-Id": xrid})
                finally:
                    for r in rids:  # a no-op for finished requests
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
                   help="model preset name (engine/config.py MODEL_PRESETS)")
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
    return p


def config_from_args(args) -> EngineConfig:
    overrides = {}
    if args.max_model_len is not None:
        overrides["max_model_len"] = args.max_model_len
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    cache = CacheConfig()
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
    return EngineConfig.for_model(args.model, cache=cache, scheduler=sched,
                                  seed=args.seed, **overrides)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    server = EngineServer(config, device=args.device,
                          served_model_name=args.served_model_name)
    port = server.bind(args.host, args.port)
    _log.info("serving %s on %s:%d (device %s, %d KV blocks)",
              server.model_name, args.host, port, server.engine.device,
              server.engine.runner.num_blocks)

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
