"""HTTP server for the Whisper transcription engine, on the standard
library.

Ports production_stack_tpu/engine/whisper_server.py (aiohttp and
prometheus_client there; the card's machine has neither) onto
``http.server.ThreadingHTTPServer``: each request is handled on its own
thread, and the runner's admission semaphore and per-chunk device lock
order the device work. ``python -m production_stack_tpu_torch.engine.server
--model whisper-large-v3-class`` serves it.

Endpoints: ``POST /v1/audio/transcriptions`` and ``/v1/audio/translations``
(multipart form: file, model, language, prompt, response_format,
temperature, stream, timestamp_granularities[]), plus the router contract
surface (``/health``, ``/version``, ``/v1/models`` advertising the
``audio.*`` capabilities, ``/metrics``). Text-generation endpoints answer
404; the router's capability filter answers 501 before them.

Response formats are the reference's: ``json``, ``text``,
``verbose_json``, ``srt``, ``vtt``, with its bodies. The segment formats
decode in timestamp mode: the model emits ``<|t.tt|>`` boundary tokens,
parsed into one cue or segment each (``timestamp_granularities`` other
than ``segment`` are refused). Every 400 is decided before an SSE stream
starts. A stream sends deltas of the cumulative decode, holding back a
trailing U+FFFD; a client that goes away mid-stream (a failed write, or a
closed socket seen between chunks) counts as an abort, and the decode is
closed so its admission slot comes back.

One field is the port's own: ``max_tokens`` (a positive integer) caps the
decoded tokens, as the runner's ``max_tokens`` does; the reference's server
ignores it. Without it the bodies are the reference's.
"""

from __future__ import annotations

import json
import logging
import re
import select
import socket
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Optional

from production_stack_tpu_torch import __version__
from production_stack_tpu_torch.engine.audio import AudioError, wav_to_features
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.metrics import (
    CONTENT_TYPE,
    Family,
    Histogram,
)
from production_stack_tpu_torch.engine.server import _HTTPServer, _error
from production_stack_tpu_torch.engine.whisper_runner import WhisperRunner

_log = logging.getLogger(__name__)

WHISPER_CAPABILITIES = ("audio.transcriptions", "audio.translations")
RESPONSE_FORMATS = ("json", "text", "verbose_json", "srt", "vtt")
# the reference's aiohttp client_max_size
MAX_BODY_BYTES = 256 * 1024 * 1024
# prometheus_client's default histogram buckets, the reference's
BUCKETS_LATENCY = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0)
_PARAM = re.compile(r';\s*([\w*]+)\s*=\s*("(?:[^"\\]|\\.)*"|[^;]*)')


def _fmt_timestamp(seconds: float, sep: str) -> str:
    # integer-millisecond arithmetic: float truncation would render
    # 1.14 as ",139" instead of ",140"
    ms_total = round(seconds * 1000)
    h, rem = divmod(ms_total, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def _params(header: str) -> dict[str, str]:
    """The ``; key=value`` parameters of a header value, unquoted."""
    out = {}
    for key, value in _PARAM.findall(header):
        value = value.strip()
        if value.startswith('"') and value.endswith('"') and len(value) > 1:
            value = re.sub(r"\\(.)", r"\1", value[1:-1])
        out[key.lower()] = value
    return out


def parse_form(body: bytes, content_type: str
               ) -> tuple[list[tuple[str, str]], dict[str, tuple[str, bytes]]]:
    """A multipart/form-data body -> (text fields as (name, value) in
    order, file parts by name as (filename, bytes)). Parts with a
    ``filename`` are files and every other part is a text field, as
    aiohttp reads them, so a file part never stands in for a text field
    of its name; the first file of a name wins. Any other body has no
    parts (a request then lacks its ``file``)."""
    if content_type.split(";")[0].strip().lower() != "multipart/form-data":
        return [], {}
    boundary = _params(content_type).get("boundary")
    if not boundary:
        raise AudioError("multipart body without a boundary")
    fields: list[tuple[str, str]] = []
    files: dict[str, tuple[str, bytes]] = {}
    # each delimiter is CRLF "--" boundary; the first follows the body's
    # start, so one CRLF is put in front
    parts = (b"\r\n" + body).split(b"\r\n--" + boundary.encode())
    for part in parts[1:]:
        if part.startswith(b"--"):  # the close delimiter
            break
        head, sep, value = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        disposition = ""
        for line in head.decode("utf-8", "replace").split("\r\n"):
            name, _, v = line.partition(":")
            if name.strip().lower() == "content-disposition":
                disposition = v
        params = _params(disposition)
        if "name" not in params:
            continue
        if "filename" in params:
            files.setdefault(params["name"], (params["filename"], value))
        else:
            fields.append((params["name"],
                           value.decode("utf-8", errors="replace")))
    return fields, files


class _ClientGone(Exception):
    """The client closed its connection mid-stream."""


def _client_gone(sock: socket.socket) -> bool:
    """True when the peer has closed: the socket reads as ready and a
    peek returns no bytes (a pipelined request would return some)."""
    try:
        ready, _, _ = select.select([sock], [], [], 0)
        return bool(ready) and sock.recv(1, socket.MSG_PEEK) == b""
    except OSError:
        return True


class WhisperServer:
    """The runner and its HTTP front end."""

    def __init__(self, config: EngineConfig,
                 runner: Optional[WhisperRunner] = None, device="cuda",
                 served_model_name: Optional[str] = None,
                 rank_devices: Optional[list] = None,
                 backend: Optional[str] = None):
        """``rank_devices`` and ``backend`` place the tensor-parallel ranks
        of a runner this server makes (``WhisperRunner``); ``shutdown``
        stops them. A ``runner`` given is the caller's to close."""
        self.config = config
        self.model_name = served_model_name or config.model.name
        self._owns_runner = runner is None
        self.runner = runner or WhisperRunner(
            config, device=device, rank_devices=rank_devices,
            backend=backend)
        self.start_time = time.time()
        self._httpd: Optional[_HTTPServer] = None
        self._serve_thread = None
        # the reference's four families, written by hand; handler threads
        # count under the lock
        self._lock = threading.Lock()
        self._requests: dict[tuple[str, str], int] = {}
        self._aborted: dict[str, int] = {}
        self._audio_seconds = 0.0
        self.latency = Histogram("pstpu_transcription_latency_seconds",
                                 "end-to-end transcription latency",
                                 BUCKETS_LATENCY)

    # -- lifecycle -----------------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind the HTTP socket; returns the bound port (a free one for
        port 0)."""
        self._httpd = _HTTPServer((host, port), self._handler_class())
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

    def stop_serving(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()

    def shutdown(self) -> None:
        """Stop serving, and the tensor-parallel ranks of a runner this
        server made."""
        try:
            if self._httpd is not None:
                if self._serve_thread is not None:
                    self._httpd.shutdown()
                    self._serve_thread.join(10)
                    self._serve_thread = None
                self._httpd.server_close()
                self._httpd = None
        finally:
            if self._owns_runner:
                self.runner.close()

    # -- router-contract surface ---------------------------------------------
    def models(self) -> dict:
        return {"object": "list", "data": [{
            "id": self.model_name,
            "object": "model",
            "created": int(self.start_time),
            "owned_by": "production-stack-tpu",
            "root": self.model_name,
            "parent": None,
            "max_model_len": self.config.model.max_model_len,
            "capabilities": list(WHISPER_CAPABILITIES),
        }]}

    def metrics(self) -> bytes:
        with self._lock:
            counts = sorted(self._requests.items())
            aborts = sorted(self._aborted.items())
            seconds = self._audio_seconds
        requests = Family("pstpu_transcription_requests", "counter",
                          "transcription requests", ["endpoint", "status"])
        for labels, n in counts:
            requests.add(labels, n)
        audio = Family("pstpu_transcription_audio_seconds", "counter",
                       "seconds of audio transcribed").add((), seconds)
        latency = Family(self.latency.name, "histogram", self.latency.doc)
        self.latency.add_samples(latency, ())
        aborted = Family("pstpu_transcription_aborted_requests", "counter",
                         "streams aborted before completion (client "
                         "disconnect)", ["endpoint"])
        for endpoint, n in aborts:
            aborted.add((endpoint,), n)
        return "".join(f.render() for f in (requests, audio, latency,
                                            aborted)).encode()

    def _count(self, endpoint: str, status: str) -> None:
        with self._lock:
            key = (endpoint, status)
            self._requests[key] = self._requests.get(key, 0) + 1

    def _served(self, endpoint: str, duration: float, t0: float) -> None:
        self._count(endpoint, "200")
        with self._lock:
            self._audio_seconds += duration
        self.latency.observe(time.monotonic() - t0)

    def _abort(self, endpoint: str) -> None:
        with self._lock:
            self._aborted[endpoint] = self._aborted.get(endpoint, 0) + 1

    # -- audio endpoints -----------------------------------------------------
    def parse_request(self, body: bytes, content_type: str, task: str):
        """The form's options and features; raises AudioError (a 400)
        for every fault a request can have, before any device work."""
        fields, files = parse_form(body, content_type)
        form: dict[str, str] = {}
        for k, v in fields:
            form.setdefault(k, v)
        if "file" not in files:
            raise AudioError("missing 'file' form field")
        language = form.get("language") or None
        prompt = form.get("prompt") or None
        response_format = form.get("response_format") or "json"
        if response_format not in RESPONSE_FORMATS:
            raise AudioError(
                f"unsupported response_format {response_format!r}")
        try:
            temperature = float(form.get("temperature") or 0.0)
        except ValueError:
            raise AudioError("temperature must be a float") from None
        max_tokens = None
        if form.get("max_tokens"):
            try:
                max_tokens = int(form["max_tokens"])
            except ValueError:
                max_tokens = 0
            if max_tokens < 1:
                raise AudioError("max_tokens must be a positive integer")
        stream = str(form.get("stream") or "").lower() in ("true", "1")
        granularities = [v for k, v in fields
                         if k.startswith("timestamp_granularities")]
        if granularities and set(granularities) - {"segment"}:
            raise AudioError(
                "unsupported timestamp_granularities "
                f"{sorted(set(granularities) - {'segment'})}; "
                "supported: segment")
        # srt/vtt NEED segment boundaries, and verbose_json defaults to
        # them too (OpenAI defaults timestamp_granularities to
        # ['segment']). Streaming emits plain text only, so timestamp
        # tokens would just burn decode budget there.
        ts_mode = (response_format in ("srt", "vtt", "verbose_json")
                   and not stream)
        features, duration = wav_to_features(
            files["file"][1], self.config.model.num_mel_bins,
            self.runner.chunk_frames)
        # a bad language or an oversized prompt must 400 HERE: once the
        # SSE stream has started a late AudioError can only kill it
        self.runner.validate_request(language, task, prompt)
        kw = dict(language=language, task=task, prompt=prompt,
                  temperature=temperature, max_tokens=max_tokens,
                  seed=uuid.uuid4().int & 0x7FFFFFFF, timestamps=ts_mode)
        return features, duration, response_format, stream, kw

    def stream_pieces(self, gen, write, sock) -> None:
        """SSE: deltas of the CUMULATIVE decode, holding back a trailing
        replacement char (a multi-byte character whose tokens straddle a
        chunk boundary would otherwise stream as U+FFFD the non-streaming
        path does not have); raises _ClientGone when the client left."""
        tk, strip = self.runner.tokenizer, self.runner.strip_timestamps
        all_toks: list[int] = []
        emitted = 0
        for piece in gen:
            if _client_gone(sock):
                raise _ClientGone
            all_toks.extend(piece)
            safe = tk.decode(strip(all_toks)).rstrip("�")
            if len(safe) > emitted:
                write(b"data: " + json.dumps({"text": safe[emitted:]})
                      .encode() + b"\n\n")
                emitted = len(safe)
        full = tk.decode(strip(all_toks))
        if len(full) > emitted:  # flush a genuinely unmappable tail
            write(b"data: " + json.dumps({"text": full[emitted:]}).encode()
                  + b"\n\n")
        write(b"data: [DONE]\n\n")

    def render(self, tokens: list[int], info: dict, duration: float,
               response_format: str, task: str, kw: dict
               ) -> tuple[bytes, str]:
        """(body, content type) of a finished transcription."""
        runner = self.runner
        text = runner.tokenizer.decode(runner.strip_timestamps(tokens))
        if kw["timestamps"]:
            segments = runner.segments_from_tokens(
                tokens, duration, logprobs=info.get("logprobs"))
        else:  # one segment spanning the clip
            lps = info.get("logprobs") or []
            segments = [{"start": 0.0, "end": duration, "tokens": tokens,
                         "text": text,
                         "avg_logprob": round(
                             sum(lps) / max(len(lps), 1), 4)}]
        plain = "text/plain; charset=utf-8"
        if response_format == "text":
            return text.encode(), plain
        if response_format == "srt":
            body = "".join(
                f"{i + 1}\n{_fmt_timestamp(s['start'], ',')} --> "
                f"{_fmt_timestamp(s['end'], ',')}\n{s['text']}\n\n"
                for i, s in enumerate(segments))
            return body.encode(), plain
        if response_format == "vtt":
            body = "WEBVTT\n\n" + "".join(
                f"{_fmt_timestamp(s['start'], '.')} --> "
                f"{_fmt_timestamp(s['end'], '.')}\n{s['text']}\n\n"
                for s in segments)
            return body.encode(), plain
        if response_format == "verbose_json":
            payload = {
                "task": "transcribe" if task == "transcribe" else "translate",
                "language": info.get("language", kw["language"]),
                "duration": duration,
                "text": text,
                "segments": [{
                    "id": i, "seek": 0, "start": s["start"],
                    "end": s["end"], "text": s["text"],
                    "tokens": s["tokens"], "temperature": kw["temperature"],
                    "no_speech_prob": info.get("no_speech_prob", 0.0),
                    "avg_logprob": s.get("avg_logprob", 0.0),
                    "compression_ratio": s.get("compression_ratio", 1.0),
                } for i, s in enumerate(segments)],
            }
        else:
            payload = {"text": text}
        return json.dumps(payload).encode(), "application/json; charset=utf-8"

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = f"production-stack-tpu-torch/{__version__}"

            def log_message(self, fmt, *args):  # route to logging
                _log.debug("%s " + fmt, self.address_string(), *args)

            def _send(self, data: bytes, content_type: str,
                      status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, payload: dict, status: int = 200) -> None:
                self._send(json.dumps(payload).encode(),
                           "application/json; charset=utf-8", status)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = urllib.parse.urlsplit(self.path).path
                if path == "/health":
                    self._send_json({"status": "healthy"})
                elif path == "/version":
                    self._send_json({"version": __version__})
                elif path == "/v1/models":
                    self._send_json(server.models())
                elif path == "/metrics":
                    self._send(server.metrics(), CONTENT_TYPE)
                else:
                    self._send_json(_error("not found", "not_found"), 404)

            def do_POST(self):  # noqa: N802 (http.server API)
                path = urllib.parse.urlsplit(self.path).path
                tasks = {"/v1/audio/transcriptions": "transcribe",
                         "/v1/audio/translations": "translate"}
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    length = -1
                if not 0 <= length <= MAX_BODY_BYTES:
                    # the body is not read: the connection ends here
                    self.close_connection = True
                    self._send_json(_error(
                        f"request body of {length} bytes: the limit is "
                        f"{MAX_BODY_BYTES}"), 413 if length > 0 else 400)
                    return
                body = self.rfile.read(length)
                if path not in tasks:
                    self._send_json(_error("not found", "not_found"), 404)
                    return
                self._audio(tasks[path], body)

            def _audio(self, task: str, body: bytes) -> None:
                endpoint = f"audio.{task}"
                t0 = time.monotonic()
                try:
                    features, duration, fmt, stream, kw = \
                        server.parse_request(
                            body, self.headers.get("Content-Type", ""),
                            task)
                except AudioError as e:
                    server._count(endpoint, "400")
                    self._send_json(_error(str(e)), 400)
                    return
                info: dict = {}  # receives the used/detected language
                if stream:
                    self._stream(endpoint, features, duration, kw, info, t0)
                    return
                try:
                    tokens = server.runner.transcribe(features, info=info,
                                                      **kw)
                except AudioError as e:
                    server._count(endpoint, "400")
                    self._send_json(_error(str(e)), 400)
                    return
                except Exception as e:  # a 500, as aiohttp answers one
                    _log.exception("transcription failed")
                    self._send_json(_error(f"{type(e).__name__}: {e}",
                                           "internal_error"), 500)
                    return
                server._served(endpoint, duration, t0)
                data, ctype = server.render(tokens, info, duration, fmt,
                                            task, kw)
                self._send(data, ctype)

            def _stream(self, endpoint, features, duration, kw, info,
                        t0) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write(data: bytes) -> None:
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data
                                     + b"\r\n")
                    self.wfile.flush()

                gen = server.runner.transcribe_stream(features, info=info,
                                                      **kw)
                gone = False
                try:
                    server.stream_pieces(gen, write, self.connection)
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                    server._served(endpoint, duration, t0)
                except (_ClientGone, ConnectionError):
                    # the client went away: no more bytes to it
                    gone = self.close_connection = True
                finally:
                    # a suspended generator holds the runner's admission
                    # slot and the request's K/V; close() runs its finally
                    gen.close()
                if gone:  # counted once its slot is back
                    server._abort(endpoint)

        return Handler

