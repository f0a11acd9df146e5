"""The port's Whisper server against the JAX package's, on the CPU.

A JAX ``WhisperServer`` (aiohttp, its seed-0 tiny-whisper runner) and the
port's (``ThreadingHTTPServer``, the same weights through
``params_from_jax``, ``device="cpu"``) get the same multipart bytes. Every
response format's body equals the reference's (floats within 1e-4: the
two frameworks sum in different orders; there are no random ids in these
bodies), SSE streams carry the same text, the 400s carry the same
messages, and ``/metrics`` has the reference's families and samples.
Then what only the port has: its multipart parser's edge cases, the
``max_tokens`` field, a client disconnect counted as an abort with its
admission slot returned, and the command line (``--model tiny-whisper
--device cpu``; ``--device cuda`` raises without a card).
"""

import asyncio
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.whisper_runner import WhisperRunner as JaxRunner
from production_stack_tpu.engine.whisper_server import (
    WhisperServer as JaxServer,
)
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import whisper_runner as TWR
from production_stack_tpu_torch.engine.server import (
    build_parser,
    server_from_args,
)
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.engine.whisper_server import (
    WhisperServer,
    parse_form,
)
from _torch_whisper import make_wav

torch.set_num_threads(2)

FLOAT_TOL = 1e-4
BOUNDARY = "pstpuBoundary7"
CTYPE = f"multipart/form-data; boundary={BOUNDARY}"


def encode_form(fields=(), files=(), boundary=BOUNDARY) -> bytes:
    """A multipart/form-data body: text ``fields`` (name, value) and
    ``files`` (name, filename, bytes), in order."""
    out = b""
    for name, value in fields:
        out += (f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="{name}"\r\n\r\n').encode() + value.encode() + b"\r\n"
    for name, filename, data in files:
        out += (f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="{name}"; filename="{filename}"\r\n'
                'Content-Type: audio/wav\r\n\r\n').encode() + data + b"\r\n"
    return out + f"--{boundary}--\r\n".encode()


WAV = make_wav(seconds=0.5, rate=8000)


def form(wav=WAV, **fields) -> bytes:
    return encode_form([("model", "tiny-whisper"), *fields.items()],
                       [("file", "a.wav", wav)] if wav is not None else [])


TRANSCRIBE = "/v1/audio/transcriptions"
TRANSLATE = "/v1/audio/translations"
# name -> (path, body); every case goes to both servers
CASES = {
    "json": (TRANSCRIBE, form(language="en")),
    "text": (TRANSCRIBE, form(language="en", response_format="text")),
    "verbose_json": (TRANSCRIBE, form(language="en",
                                      response_format="verbose_json")),
    "srt": (TRANSCRIBE, form(language="en", response_format="srt")),
    "vtt": (TRANSCRIBE, form(language="en", response_format="vtt")),
    "translate-json": (TRANSLATE, form(language="en")),
    "translate-verbose": (TRANSLATE, form(
        language="en", response_format="verbose_json",
        **{"timestamp_granularities[]": "segment"})),
    "detect-verbose": (TRANSCRIBE, form(response_format="verbose_json")),
    "prompt-srt": (TRANSCRIBE, form(language="en", prompt="hello context",
                                    response_format="srt")),
    "stereo-44k-text": (TRANSCRIBE, form(
        wav=make_wav(seconds=0.7, rate=44100, channels=2, kind="noise",
                     seed=3), language="en", response_format="text")),
    "temperature-zero": (TRANSCRIBE, form(language="en", temperature="0")),
    "sse": (TRANSCRIBE, form(language="en", stream="true")),
    "sse-detect": (TRANSLATE, form(stream="1")),
    # the 400s
    "missing-file": (TRANSCRIBE, form(wav=None, language="en")),
    "file-as-text": (TRANSCRIBE, encode_form([("file", "not a file")])),
    "not-wav": (TRANSCRIBE, encode_form([], [("file", "x.mp3",
                                              b"not audio")])),
    "bad-format": (TRANSCRIBE, form(response_format="yaml")),
    "bad-language": (TRANSCRIBE, form(language="klingon")),
    "bad-language-sse": (TRANSCRIBE, form(language="klingon",
                                          stream="true")),
    "word-granularity": (TRANSCRIBE, form(
        response_format="verbose_json",
        **{"timestamp_granularities[]": "word"})),
    "bad-temperature": (TRANSCRIBE, form(temperature="hot")),
}


def _post(base: str, path: str, body: bytes, ctype: str = CTYPE):
    """(status, content type, body bytes) of a POST to the port."""
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": ctype})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _get(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.read()


@pytest.fixture(scope="module")
def servers():
    """(the reference's responses to every case and its /metrics after
    them, the port's server URL, the port's server)."""
    jr = JaxRunner(jcfg.EngineConfig.for_model("tiny-whisper"))
    jconf = jcfg.EngineConfig.for_model("tiny-whisper")
    np_params = jax.tree.map(np.asarray, jax.device_get(jr.params))
    tconf = tcfg.EngineConfig.for_model("tiny-whisper")
    tr = TWR.WhisperRunner(tconf, device="cpu",
                           params=params_from_jax(np_params, tconf.model,
                                                  "cpu"))

    async def reference():
        from aiohttp.test_utils import TestClient, TestServer

        out = {}
        app = JaxServer(jconf, runner=jr).build_app()
        async with TestClient(TestServer(app)) as client:
            for name, (path, body) in CASES.items():
                r = await client.post(path, data=body,
                                      headers={"Content-Type": CTYPE})
                out[name] = (r.status, r.headers.get("Content-Type"),
                             await r.read())
            r = await client.get("/metrics")
            out["/metrics"] = await r.text()
        return out

    ref = asyncio.run(reference())
    server = WhisperServer(tconf, runner=tr)
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    port = {name: _post(base, path, body)
            for name, (path, body) in CASES.items()}
    yield ref, port, base, server
    server.shutdown()


def _close(a, b, path=""):
    """JSON values equal, floats within FLOAT_TOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= FLOAT_TOL, (path, a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _sse_text(body: bytes) -> tuple[str, list]:
    events = [ln[len("data: "):] for ln in body.decode().split("\n")
              if ln.startswith("data: ")]
    return "".join(json.loads(e)["text"] for e in events[:-1]), events


@pytest.mark.parametrize("case", list(CASES))
def test_body_equals_reference(servers, case):
    ref, port, _, _ = servers
    (rs, rt, rb), (ps, pt, pb) = ref[case], port[case]
    assert ps == rs, (case, pb)
    assert pt.split(";")[0] == rt.split(";")[0]
    if case.startswith("sse") and ps == 200:
        (rtext, revents), (ptext, pevents) = _sse_text(rb), _sse_text(pb)
        assert ptext == rtext and pevents[-1] == revents[-1] == "[DONE]"
    elif rt.startswith("application/json"):
        _close(json.loads(rb), json.loads(pb))
    else:
        assert pb == rb


def test_metrics_families_equal_reference(servers):
    ref, _, base, server = servers
    _, body = _get(base, "/metrics")

    def samples(text):
        fams = {f.name: f for f in text_string_to_metric_families(text)
                if not f.name.endswith("_created")}
        return fams, {(s.name, tuple(sorted(s.labels.items()))): s.value
                      for f in fams.values() for s in f.samples
                      if not s.name.endswith("_created")}

    rf, rs = samples(ref["/metrics"])
    # the port's server has served the same cases, and this module's
    # other tests may have added more: compare after the cases only
    pf, ps = samples(body.decode())
    assert {n: f.type for n, f in pf.items()} == \
        {n: f.type for n, f in rf.items()}
    assert set(pf) == {"pstpu_transcription_requests",
                       "pstpu_transcription_audio_seconds",
                       "pstpu_transcription_latency_seconds",
                       "pstpu_transcription_aborted_requests"}
    for key, value in rs.items():
        name = key[0]
        if name.startswith("pstpu_transcription_latency_seconds") and \
                name != "pstpu_transcription_latency_seconds_count":
            continue  # wall times differ
        assert ps[key] >= value if name.endswith("_count") else \
            ps[key] == pytest.approx(value), key


def test_router_surface(servers):
    _, _, base, _ = servers
    assert json.loads(_get(base, "/health")[1]) == {"status": "healthy"}
    assert "version" in json.loads(_get(base, "/version")[1])
    card = json.loads(_get(base, "/v1/models")[1])["data"][0]
    assert card["id"] == "tiny-whisper" and card["max_model_len"] == 32
    assert card["capabilities"] == ["audio.transcriptions",
                                    "audio.translations"]
    for path in ("/v1/completions", "/v1/chat/completions"):
        status, _, _ = _post(base, path, b'{"prompt": "hi"}',
                             "application/json")
        assert status == 404


def test_max_tokens_field_caps_the_decode(servers):
    _, _, base, _ = servers
    status, _, body = _post(base, TRANSCRIBE, form(
        language="en", response_format="verbose_json", max_tokens="3"))
    assert status == 200
    out = json.loads(body)
    assert sum(len(s["tokens"]) for s in out["segments"]) <= 3
    for bad in ("0", "-2", "many"):
        status, _, body = _post(base, TRANSCRIBE, form(max_tokens=bad,
                                                       stream="true"))
        assert status == 400 and b"max_tokens" in body


@pytest.mark.parametrize("raw,ctype,want_fields,want_files", [
    # a FILE named "model" must not clobber the model field
    (b'--XB\r\nContent-Disposition: form-data; name="file"; '
     b'filename="model"\r\n\r\n\x00\x01binary\r\n'
     b'--XB\r\nContent-Disposition: form-data; name="model"\r\n\r\n'
     b'whisper-small\r\n--XB--\r\n',
     'multipart/form-data; boundary="XB"',
     [("model", "whisper-small")], {"file": ("model", b"\x00\x01binary")}),
    # a trailing dash in a value survives
    (b'--XB\r\nContent-Disposition: form-data; name="model"\r\n\r\n'
     b'my-lora-\r\n--XB--\r\n', "multipart/form-data; boundary=XB",
     [("model", "my-lora-")], {}),
    # a part named like a field in its filename only is a file of its name
    (b'--XB\r\nContent-Disposition: form-data; name="audio"; '
     b'filename="language"\r\n\r\nxyz\r\n--XB\r\nContent-Disposition: '
     b'form-data; name="language"\r\n\r\nde\r\n--XB--\r\n',
     "multipart/form-data; charset=utf-8; boundary=XB",
     [("language", "de")], {"audio": ("language", b"xyz")}),
    # repeated fields keep their order; CRLF inside a file survives
    (b'--XB\r\nContent-Disposition: form-data; name="t[]"\r\n\r\nsegment'
     b'\r\n--XB\r\nContent-Disposition: form-data; name="t[]"\r\n\r\nword'
     b'\r\n--XB\r\ncontent-disposition: form-data; name="file"; '
     b'filename="a"\r\n\r\nx\r\n\r\ny--XBz\r\n--XB--\r\n',
     "multipart/form-data; boundary=XB",
     [("t[]", "segment"), ("t[]", "word")],
     {"file": ("a", b"x\r\n\r\ny--XBz")}),
    (b"language=en&prompt=a+b&stream=", "application/x-www-form-urlencoded",
     [], {}),
    (b'{"language": "en"}', "application/json", [], {}),
], ids=["file-named-model", "trailing-dash", "filename-is-a-field-name",
        "repeats-and-crlf", "urlencoded", "json"])
def test_parse_form_edge_cases(raw, ctype, want_fields, want_files):
    fields, files = parse_form(raw, ctype)
    assert fields == want_fields and files == want_files


def test_multipart_without_boundary_is_a_400(servers):
    _, _, base, _ = servers
    status, _, body = _post(base, TRANSCRIBE, form(), "multipart/form-data")
    assert status == 400 and b"boundary" in body


@pytest.mark.parametrize("length,status", [("-5", 400), ("many", 400),
                                           (str(2**28 + 1), 413)])
def test_bad_content_length_is_refused_unread(servers, length, status):
    """A negative, malformed or oversized Content-Length is answered at
    once (the reference's limit is aiohttp's client_max_size, 256 MiB);
    the body is never read."""
    _, _, base, _ = servers
    port = int(base.rsplit(":", 1)[1])
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall((f"POST {TRANSCRIBE} HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Type: {CTYPE}\r\n"
                      f"Content-Length: {length}\r\n\r\n").encode())
        head = sock.recv(4096)
    assert head.startswith(f"HTTP/1.1 {status}".encode()), head[:60]


def test_disconnect_counts_an_abort_and_returns_the_slot(monkeypatch):
    """A client that closes its SSE stream mid-decode is seen at the next
    chunk, before the decode runs on: it is counted under
    ``pstpu_transcription_aborted_requests`` and its admission slot comes
    back, so with one slot a request after it completes."""
    monkeypatch.setattr(TWR, "DECODE_CHUNK", 2)  # many chunks a clip
    conf = tcfg.EngineConfig.for_model(
        "tiny-whisper", scheduler=tcfg.SchedulerConfig(max_num_seqs=1))
    server = WhisperServer(conf, device="cpu")
    # the first chunk waits until the client has left, so the stream
    # cannot end first on a busy host; a later chunk of the aborted
    # stream would stall (no text is written to fail on meanwhile)
    left, released = threading.Event(), threading.Event()
    chunk = server.runner._chunk
    calls = []

    def chunk_after_close(*args):
        calls.append(args)
        if len(calls) == 1:
            left.wait(30)
            time.sleep(0.05)  # the FIN reaches the server's socket
        else:
            released.wait(30)
        return chunk(*args)

    server.runner._chunk = chunk_after_close
    port = server.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        body = form(language="en", stream="true")
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        sock.sendall((f"POST {TRANSCRIBE} HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Type: {CTYPE}\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        head = b""
        while b"\r\n\r\n" not in head:
            head += sock.recv(4096)
        assert head.startswith(b"HTTP/1.1 200")
        sock.close()  # the stream has started: leave
        left.set()
        deadline = time.monotonic() + 20
        aborted = 0.0
        while time.monotonic() < deadline and not aborted:
            text = _get(base, "/metrics")[1].decode()
            m = re.search(r'pstpu_transcription_aborted_requests_total'
                          r'\{endpoint="audio.transcribe"\} (\S+)', text)
            aborted = float(m.group(1)) if m else 0.0
            time.sleep(0.05)
        assert aborted == 1.0 and len(calls) == 1
        released.set()
        status, _, out = _post(base, TRANSCRIBE, form(language="en"))
        assert status == 200 and "text" in json.loads(out)
    finally:
        released.set()
        server.shutdown()


def test_command_line_serves_whisper_on_the_cpu():
    args = build_parser().parse_args(["--model", "tiny-whisper", "--device",
                                      "cpu", "--max-num-seqs", "2"])
    server = server_from_args(args)
    assert isinstance(server, WhisperServer)
    assert server.runner.device.type == "cpu"
    assert server.runner.admit._initial_value == 2


def test_command_line_refuses_a_missing_card_and_int8():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        server_from_args(build_parser().parse_args(
            ["--model", "tiny-whisper"]))
    with pytest.raises(ValueError, match="not served for Whisper"):
        server_from_args(build_parser().parse_args(
            ["--model", "tiny-whisper", "--device", "cpu",
             "--quantization", "int8"]))


def test_main_serves_and_stops_on_sigterm():
    """``python -m production_stack_tpu_torch.engine.server --model
    tiny-whisper --device cpu`` serves the audio routes and exits 0 on
    SIGTERM."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "tiny-whisper", "--device", "cpu", "--host",
         "127.0.0.1", "--port", str(port)], cwd=root,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                _get(base, "/health")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        status, _, body = _post(base, TRANSLATE, form(language="en",
                                                      response_format="text"))
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert b"(whisper)" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
