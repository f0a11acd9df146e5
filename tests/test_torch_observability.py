"""The port's observability plane against the JAX package's, on the CPU:
the flight recorder, request records over HTTP, W3C tracing, the
accountants' anomaly hooks, the durable perf ledger, ``--config`` and the
command line, and the unchanged router in front of a port engine.

- ``FlightRecorder``: the same calls on both give equal ``stats()`` and
  equal snapshots, times apart.
- Request records: a JAX server (aiohttp, its own event loop thread) and
  the port's server on one tiny-llama weight set serve the same
  completions and chat requests (buffered and streamed, n = 2, an expired
  and a mid-generation deadline, a bad parameter); their
  ``/debug/requests`` records have equal key sets, outcomes, statuses,
  ``client_request_id``, token counts and trace ids, and ordered
  timelines; ``x-request-id`` is echoed on buffered and error answers. A
  client that leaves a stream leaves a ``client_disconnect`` record.
- Tracing: without a ``traceparent`` both records' ``trace_id`` is None;
  with one, both carry the same id (the propagated one where the
  OpenTelemetry API is installed, else None).
- Anomaly hooks on both accountants: an unexpected recompile fires once
  with its event, a drift episode fires ``costmodel_drift`` exactly once
  (a second excursion is a new episode), band 0 fires nothing; the port's
  ``poll_hbm`` fires ``hbm_pressure`` at its threshold.
- The perf ledger: ``marks_from_engine_stats`` of the port's engine equals
  the reference's of the JAX engine after the same requests, for the
  CPU-stable marks; the port's ledger file reads through the reference's
  ``read_records``, ``group_by_cohort``, ``last_known_good`` and
  ``tools/perfdiff.py``.
- ``--config``: the reference's cases for ``parse_with_yaml_config``, on
  the port's parser. Each observability flag the helm chart can pass
  parses with the port's ``build_parser``, with the reference's default.
- The router: its ``GET /debug/requests`` joins the port engine's record
  by ``x-request-id``; an incident fan-out leaves a bundle on the port
  engine whose ``detail.incident`` is the incident's id.
"""

import asyncio
import json
import pathlib
import re
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from _torch_parity import drain, engine_configs, jax_engine, port_engine, \
    tiny_weights
from production_stack_tpu import flight_recorder as jax_fr
from production_stack_tpu import perf_ledger as jax_pl
from production_stack_tpu.engine import diagnostics as jax_diag
from production_stack_tpu.engine import perf_accounting as jperf
from production_stack_tpu.engine import server as jax_server_mod
from production_stack_tpu.engine.config import ModelConfig as JModelConfig
from production_stack_tpu.engine.server import EngineServer as JaxServer
from production_stack_tpu_torch import flight_recorder as port_fr
from production_stack_tpu_torch import perf_ledger as port_pl
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import diagnostics as port_diag
from production_stack_tpu_torch.engine import perf_accounting as tperf
from production_stack_tpu_torch.engine import server as port_server_mod
from production_stack_tpu_torch.engine import tracing as port_tracing
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.yaml_args import parse_with_yaml_config

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GREEDY = {"temperature": 0, "ignore_eos": True}
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"


# -- the flight recorder -------------------------------------------------------

def _times_apart(rec: dict) -> dict:
    out = {k: v for k, v in rec.items() if k != "received_unix"}
    out["timeline"] = sorted(rec["timeline"])
    return out


@pytest.mark.parametrize("size", [1, 3, 8])
def test_flight_recorders_agree(size):
    """The same begin/stamp/finish calls on both recorders: equal stats,
    equal snapshots (whole and limited) but for their times."""
    got = []
    for mod in (jax_fr, port_fr):
        fr = mod.FlightRecorder(size)
        for i in range(5):
            rec = fr.begin(request_id=f"r{i}", outcome=None, n=i)
            fr.stamp(rec, "admitted")
            if i % 2:
                fr.stamp(rec, "first_token", at=123.0 + i)
            fr.finish(rec, outcome="completed", status=200)
        got.append((fr.stats(), [_times_apart(r) for r in fr.snapshot()],
                    [_times_apart(r) for r in fr.snapshot(limit=2)],
                    fr.snapshot(limit=-1)))
    assert got[0] == got[1]
    stats, snap, _, none = got[1]
    assert stats == {"size": size, "recorded": min(size, 5), "total": 5,
                     "dropped": max(0, 5 - size)}
    assert [r["request_id"] for r in snap] == \
        [f"r{i}" for i in range(4, 4 - min(size, 5), -1)]
    assert none == []


# -- request records over HTTP -------------------------------------------------

class _Pair:
    """A JAX server and a port server on one weight set and options."""

    def __init__(self, weights, tmp):
        from aiohttp.test_utils import TestServer

        jconf, tconf = engine_configs(
            "ragged", block_size=4, num_blocks=512, max_num_batched_tokens=64,
            prefill_buckets=(32, 64, 128), max_num_seqs=4)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.jax = JaxServer(jconf, engine=jax_engine(weights, jconf),
                             flight_recorder_size=64,
                             diagnostics=jax_diag.DiagnosticsConfig(
                                 dir=str(tmp / "jax")))
        self.jts = self._on(self._start(TestServer, self.jax.build_app()))
        self.port = EngineServer(tconf, engine=port_engine(weights, tconf),
                                 flight_recorder_size=64,
                                 diagnostics=port_diag.DiagnosticsConfig(
                                     dir=str(tmp / "port")))
        self.urls = (f"http://127.0.0.1:{self.jts.port}",
                     f"http://127.0.0.1:{self.port.start('127.0.0.1', 0)}")

    @staticmethod
    async def _start(test_server, app):
        ts = test_server(app)
        await ts.start_server()
        return ts

    def _on(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(300)

    def close(self):
        self.port.shutdown()
        self._on(self.jts.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = _Pair(tiny_weights(), tmp_path_factory.mktemp("obs"))
    yield p
    p.close()


def call(url, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def records(url, **query):
    q = "&".join(f"{k}={v}" for k, v in query.items())
    status, _, text = call(url, "/debug/requests" + (f"?{q}" if q else ""))
    assert status == 200
    return json.loads(text)


CHAT = [{"role": "user", "content": "tell me"}]
# (x-request-id, path, body, extra headers, expected status)
REQUESTS = [
    ("obs-plain", "/v1/completions",
     {"prompt": "hello", "max_tokens": 5, **GREEDY}, {}, 200),
    ("obs-n2", "/v1/completions",
     {"prompt": [5, 6, 7, 8], "max_tokens": 4, "n": 2, **GREEDY}, {}, 200),
    ("obs-batch", "/v1/completions",
     {"prompt": ["one", "two"], "max_tokens": 3, **GREEDY}, {}, 200),
    ("obs-chat", "/v1/chat/completions",
     {"messages": CHAT, "max_tokens": 6, **GREEDY}, {}, 200),
    ("obs-chat-stream", "/v1/chat/completions",
     {"messages": CHAT, "max_tokens": 5, "stream": True,
      "stream_options": {"include_usage": True}, **GREEDY}, {}, 200),
    ("obs-stream", "/v1/completions",
     {"prompt": "streamed", "max_tokens": 7, "stream": True, **GREEDY},
     {}, 200),
    ("obs-expired", "/v1/completions",
     {"prompt": "late", "max_tokens": 4}, {"x-request-deadline": "1"}, 504),
    ("obs-bad", "/v1/completions",
     {"prompt": "bad", "max_tokens": 4, "temperature": "hot"}, {}, 400),
]


@pytest.fixture(scope="module")
def served(pair):
    """Both servers' answers to REQUESTS and to two mid-generation
    deadlines, then both servers' records."""
    answers = {}
    for url in pair.urls:
        for xrid, path, body, headers, want in REQUESTS:
            status, hdrs, text = call(url, path, body,
                                      {"x-request-id": xrid, **headers})
            assert status == want, (url, xrid, text)
            answers[(url, xrid)] = (hdrs, text)
        for stream in (False, True):
            status, _, _ = call(url, "/v1/completions", {
                "prompt": "hello", "max_tokens": 400, "stream": stream,
                **GREEDY}, {"x-request-id": f"obs-deadline-{stream}",
                            "x-request-deadline": f"{time.time() + 0.4:.3f}"})
            assert status == (200 if stream else 504)
        status, _, _ = call(url, "/v1/completions",
                            {"prompt": "anonymous", "max_tokens": 2})
        assert status == 200
    # the JAX server finishes a stream's record once its handler returns,
    # a moment after the client has read the stream's end
    deadline = time.monotonic() + 30
    while any(records(u)["recorder"]["total"] < len(REQUESTS) + 3
              for u in pair.urls):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return answers, [records(u) for u in pair.urls]


def _by_client_id(doc, named_only=False):
    """Records by client request id; ``named_only`` drops those that had
    no x-request-id (their own random id stands in)."""
    return {r["client_request_id"]: r for r in doc["requests"]
            if not (named_only and r["client_request_id"] == r["request_id"])}


def _usage_tokens(text: str, stream: bool) -> tuple:
    if stream:
        events = [json.loads(b[len("data: "):])
                  for b in text.strip().split("\n\n")
                  if b.startswith("data: {")]
        usage = [e["usage"] for e in events if e.get("usage")]
        return (usage[-1]["prompt_tokens"], usage[-1]["completion_tokens"]) \
            if usage else None
    body = json.loads(text)
    return body["usage"]["prompt_tokens"], body["usage"]["completion_tokens"]


def test_records_equal_across_servers(served):
    _, (jdoc, pdoc) = served
    jrec, prec = _by_client_id(jdoc, True), _by_client_id(pdoc, True)
    want = {x for x, *_ in REQUESTS} | {"obs-deadline-False",
                                        "obs-deadline-True"}
    assert want <= set(prec) and set(prec) == set(jrec)
    for xrid in sorted(prec):
        j, p = jrec[xrid], prec[xrid]
        assert set(p) == set(j), xrid
        for key in ("outcome", "status", "client_request_id", "endpoint",
                    "model", "tenant", "streaming", "num_prompt_tokens",
                    "num_output_tokens", "trace_id", "attempts"):
            assert p[key] == j[key], (xrid, key, p[key], j[key])
        assert list(p["timeline"]) == list(j["timeline"]), xrid
    assert set(jdoc["recorder"]) == set(pdoc["recorder"])
    assert pdoc["recorder"]["total"] == jdoc["recorder"]["total"] \
        == len(REQUESTS) + 3


def test_record_outcomes_and_timelines(served, pair):
    answers, (_, pdoc) = served
    prec = _by_client_id(pdoc)
    outcomes = {x: prec[x]["outcome"] for x in prec}
    assert outcomes["obs-plain"] == outcomes["obs-chat-stream"] == "completed"
    assert (outcomes["obs-expired"], prec["obs-expired"]["status"]) == \
        ("deadline_exceeded", 504)
    assert (outcomes["obs-bad"], prec["obs-bad"]["status"]) == \
        ("rejected", 400)
    # a stream that timed out in-band committed 200
    assert (outcomes["obs-deadline-True"],
            prec["obs-deadline-True"]["status"]) == ("deadline_exceeded", 200)
    assert (outcomes["obs-deadline-False"],
            prec["obs-deadline-False"]["status"]) == ("deadline_exceeded", 504)
    order = ("received", "admitted", "first_token", "last_token", "finished")
    for xrid, _, body, _, want in REQUESTS:
        rec = prec[xrid]
        stamps = [rec["timeline"][k] for k in order if k in rec["timeline"]]
        assert stamps == sorted(stamps), xrid
        if want != 200:
            continue
        assert list(rec["timeline"]) == list(order), xrid
        n_choices = int(body.get("n", 1))
        usage = _usage_tokens(answers[(pair.urls[1], xrid)][1],
                              bool(body.get("stream")))
        if usage is not None:
            # the record sums over choices; usage counts a prompt once
            assert rec["num_prompt_tokens"] == usage[0] * n_choices, xrid
            assert rec["num_output_tokens"] == usage[1], xrid
    # newest first, and a request without x-request-id is its own id
    newest = pdoc["requests"][0]
    assert newest["client_request_id"] == newest["request_id"]
    assert newest["request_id"].startswith("cmpl-")


def test_request_id_is_echoed(served, pair):
    answers, _ = served
    for url in pair.urls:
        for xrid, *_ in REQUESTS:
            hdrs, _ = answers[(url, xrid)]
            assert hdrs.get("X-Request-Id") == xrid, (url, xrid)


def test_limit_bounds_the_answer(served, pair):
    for url in pair.urls:
        doc = records(url, limit=2)
        assert len(doc["requests"]) == 2
        assert doc["requests"] == records(url)["requests"][:2]


def _post_lowercase(url, path, body, headers):
    """A POST whose header names go out as given: a router injects
    ``traceparent`` in lower case, where urllib would capitalize it."""
    import http.client

    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    data = json.dumps(body).encode()
    conn.putrequest("POST", path)
    for k, v in {"content-type": "application/json",
                 "content-length": str(len(data)), **headers}.items():
        conn.putheader(k, v)
    conn.endheaders(data)
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


def test_trace_ids_agree(pair):
    """No traceparent: trace_id None on both; with one, both carry the
    propagated trace id where the OpenTelemetry API is installed."""
    expect = TRACE_ID if port_tracing.is_enabled() else None
    for header, want in ((None, None), (TRACEPARENT, expect)):
        xrid = f"obs-trace-{header is not None}"
        for url in pair.urls:
            headers = {"x-request-id": xrid}
            if header:
                headers["traceparent"] = header
            status = _post_lowercase(url, "/v1/completions", {
                "prompt": "traced", "max_tokens": 2, **GREEDY}, headers)
            assert status == 200
            assert _by_client_id(records(url))[xrid]["trace_id"] == want


def test_client_disconnect_is_recorded(pair):
    """A client that closes a stream mid-generation leaves one record with
    outcome client_disconnect; its choices are aborted."""
    url = pair.urls[1]
    host, port = url[len("http://"):].split(":")
    body = json.dumps({"prompt": "leave", "max_tokens": 400, "stream": True,
                       **GREEDY}).encode()
    sock = socket.create_connection((host, int(port)), timeout=30)
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 b"x-request-id: obs-leaver\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    assert b"200" in sock.recv(4096)  # headers and a first chunk or two
    # an abortive close: the server's next write fails at once
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
    sock.close()
    deadline = time.monotonic() + 30
    while "obs-leaver" not in _by_client_id(records(url)):
        assert time.monotonic() < deadline
        time.sleep(0.05)
    rec = _by_client_id(records(url))["obs-leaver"]
    assert rec["outcome"] == "client_disconnect" and rec["status"] == 200
    assert rec["num_output_tokens"] == 0  # aborted, never finished
    while pair.port.engine.has_unfinished():
        assert time.monotonic() < deadline
        time.sleep(0.05)


# -- the accountants' anomaly hooks ------------------------------------------

def _accountant(mod, cfg_mod):
    acct = mod.PerfAccountant(cfg_mod.ModelConfig.from_pretrained(
        "tiny-llama"), param_count=1000, param_bytes=2000, window=30.0,
        peak_tflops=100.0, peak_hbm_gbps=1000.0, peak_ici_gbps=50.0)
    fired = []
    acct.anomaly_hook = lambda name, detail: fired.append((name, detail))
    return acct, fired


ACCOUNTANTS = pytest.mark.parametrize(
    "mod, cfg_mod", [(jperf, types.SimpleNamespace(ModelConfig=JModelConfig)),
                     (tperf, tcfg)], ids=["jax", "port"])


def _decode(acct, n, t, seconds):
    for _ in range(n):
        acct.record_decode(8, 1, 800, ts=t, seconds=seconds)
        t += 0.2
    return t


@ACCOUNTANTS
def test_unexpected_recompile_fires_once_steady(mod, cfg_mod):
    acct, fired = _accountant(mod, cfg_mod)
    acct.on_compile("decode", "b8", 0.5)
    assert fired == []
    acct.mark_steady()
    acct.on_compile("decode", "b16", 1.25)
    (name, detail), = fired
    assert name == "unexpected_recompile"
    assert (detail["kind"], detail["bucket"], detail["unexpected"],
            detail["seconds"]) == ("decode", "b16", True, 1.25)


@ACCOUNTANTS
def test_drift_episode_fires_exactly_once(mod, cfg_mod):
    """The reference's drill, with the excursion driven through the
    measured seconds the engine passes in: one anomaly an episode, none
    on the way back, a second excursion a new episode."""
    acct, fired = _accountant(mod, cfg_mod)
    acct.costmodel_drift_band = 4.0
    acct.costmodel_min_events = 4
    acct.mark_steady()
    t = _decode(acct, 8, time.time(), 0.01)
    t = _decode(acct, 40, t, 0.5)
    assert [n for n, _ in fired] == ["costmodel_drift"]
    detail = fired[0][1]
    assert detail["phase"] == "decode" and detail["relative"] > 4.0
    assert detail["band"] == 4.0
    cm = acct.stats_fields()["costmodel"]
    assert cm["episodes"] == 1 and cm["out_of_band"] == ["decode"]
    t = _decode(acct, 400, t, 0.01)
    assert acct.stats_fields()["costmodel"]["out_of_band"] == []
    assert len(fired) == 1
    _decode(acct, 40, t, 0.5)
    assert [n for n, _ in fired] == ["costmodel_drift"] * 2
    assert acct.stats_fields()["costmodel"]["episodes"] == 2


@ACCOUNTANTS
def test_drift_band_zero_fires_nothing(mod, cfg_mod):
    acct, fired = _accountant(mod, cfg_mod)
    acct.mark_steady()
    t = _decode(acct, 8, time.time(), 0.01)
    _decode(acct, 20, t, 10.0)
    cm = acct.stats_fields()["costmodel"]
    assert fired == [] and cm["episodes"] == 0 and cm["baseline"] == {}
    assert cm["measured_seconds"]["decode"] > 0


def test_drift_details_agree():
    """The same script gives the same costmodel_drift details on both
    accountants (the time stamp apart)."""
    details = []
    for mod, cfg_mod in ((jperf, types.SimpleNamespace(
            ModelConfig=JModelConfig)), (tperf, tcfg)):
        acct, fired = _accountant(mod, cfg_mod)
        acct.costmodel_drift_band = 3.0
        acct.costmodel_min_events = 4
        acct.mark_steady()
        t = _decode(acct, 8, 1000.0, 0.01)
        _decode(acct, 40, t, 0.3)
        details.append([(n, {k: v for k, v in d.items() if k != "ts"})
                        for n, d in fired])
    assert details[0] == details[1] and details[1]


def test_port_hbm_pressure_fires_at_threshold(monkeypatch):
    """poll_hbm reads allocated / total from torch's allocator and fires
    hbm_pressure at hbm_threshold (the card's counters stood in for)."""
    acct, fired = _accountant(tperf, tcfg)
    acct.device = types.SimpleNamespace(type="cuda")
    used = {"n": 80}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": used["n"],
        "allocated_bytes.all.peak": 95})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (5, 100))
    acct.hbm_threshold = 0.92
    acct.poll_hbm(now=10.0)
    assert fired == [] and acct._hbm == {"used": 80, "total": 100,
                                         "peak": 95}
    used["n"] = 93
    acct.poll_hbm(now=20.0)
    (name, detail), = fired
    assert name == "hbm_pressure"
    assert detail == {"used_bytes": 93, "total_bytes": 100, "fraction": 0.93,
                      "threshold": 0.92}
    acct.hbm_threshold = 0.0  # off
    acct.poll_hbm(now=30.0)
    assert len(fired) == 1


# -- the perf ledger -----------------------------------------------------------

STABLE_MARKS = ("prompt_tokens_total", "generation_tokens_total",
                "ragged_dispatches_total", "ragged_live_tokens_total",
                "dispatches_total", "unexpected_recompiles")


@pytest.fixture(scope="module")
def engine_marks():
    weights = tiny_weights()
    jconf, tconf = engine_configs("ragged", max_num_seqs=4,
                                  max_num_batched_tokens=32)
    jeng, teng = jax_engine(weights, jconf), port_engine(weights, tconf)
    sp = SamplingParams(temperature=0.0, max_tokens=9, ignore_eos=True)
    reqs = [("a", list(range(1, 40)), sp), ("b", [7, 8, 9, 10], sp),
            ("c", list(range(3, 20)), sp)]
    assert drain(jeng, reqs)[0] == drain(teng, reqs)[0]
    return (jax_pl.marks_from_engine_stats(jeng.stats()),
            port_pl.marks_from_engine_stats(teng.stats()))


def test_engine_marks_equal(engine_marks):
    jm, pm = engine_marks
    for key in STABLE_MARKS:
        assert pm[key] == jm[key], key
    assert pm["ragged_stream_utilization"] == pytest.approx(
        jm["ragged_stream_utilization"], rel=1e-12)
    assert pm["generation_tokens_total"] == 27
    assert set(pm) == set(jm)


def test_port_ledger_reads_through_the_reference(tmp_path, engine_marks):
    _, marks = engine_marks
    fp = port_pl.fingerprint(
        model="tiny-llama", attention_impl="ragged", dtype="float32",
        platform="cpu", extra={"framework": "torch",
                               "torch_version": torch.__version__})
    assert fp["jax_version"] == "" and fp["framework"] == "torch"
    assert port_pl.fingerprint_id(fp) == jax_pl.fingerprint_id(fp)
    path = str(tmp_path / "perf.jsonl")
    ledger = port_pl.PerfLedger(path)
    for i, reason in enumerate(("interval", "interval", "drain")):
        assert ledger.append_engine_snapshot(100.0 + i, fp, marks,
                                             reason=reason)
    with open(path, "a") as f:
        f.write("{not json\n")
    recs, skipped = jax_pl.read_records(path)
    assert skipped == 1 and [r["reason"] for r in recs] == \
        ["interval", "interval", "drain"]
    assert recs == port_pl.read_records(path)[0]
    fpid = port_pl.fingerprint_id(fp)
    assert list(jax_pl.group_by_cohort(recs)) == [fpid]
    assert jax_pl.last_known_good(recs, fpid)["ts"] == 102.0
    # the JAX engine's cohort never mixes with the port's
    jfp = jax_pl.fingerprint(model="tiny-llama", attention_impl="ragged",
                             dtype="float32", platform="cpu")
    assert jax_pl.fingerprint_id(jfp) != fpid

    import tools.perfdiff as perfdiff

    doc = perfdiff.diff(path, path)
    assert doc["cohorts_compared"] == [fpid] and not doc["regression"]
    assert perfdiff.main([path, path]) == 0


def test_server_journals_interval_and_drain(tmp_path):
    """The server's ledger thread journals every interval and begin_drain
    once more; the records carry the port's fingerprint and
    /debug/perf's perf_ledger block."""
    args = port_server_mod.build_parser().parse_args([
        "--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
        "--num-blocks", "256", "--perf-ledger-path",
        str(tmp_path / "perf.jsonl"), "--perf-ledger-interval", "0.5",
        "--diagnostics-dir", str(tmp_path / "diag")])
    server = port_server_mod.server_from_args(args)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        status, _, _ = call(url, "/v1/completions", {
            "prompt": "ledger", "max_tokens": 3, **GREEDY})
        assert status == 200
        deadline = time.monotonic() + 30
        while server.perf_ledger.records_written < 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        block = json.loads(call(url, "/debug/perf")[2])["perf_ledger"]
        assert block["enabled"] and block["interval"] == 0.5
        assert call(url, "/drain", {})[0] == 200
    finally:
        server.shutdown()
    recs, skipped = port_pl.read_records(str(tmp_path / "perf.jsonl"))
    assert skipped == 0 and recs[-1]["reason"] == "drain"
    assert {r["reason"] for r in recs[:-1]} == {"interval"}
    fp = recs[-1]["fingerprint"]
    assert (fp["platform"], fp["chip"], fp["framework"], fp["jax_version"],
            fp["model"]) == ("cpu", "", "torch", "", "tiny-llama")
    assert recs[-1]["marks"]["generation_tokens_total"] == 3


# -- --config and the command line -------------------------------------------

def test_yaml_config_file(tmp_path):
    """The reference's --config cases, on the port's parser."""
    parser = port_server_mod.build_parser
    cfg = tmp_path / "engine.yaml"
    cfg.write_text("model: tiny-llama\nmax-num-seqs: 16\nskip-warmup: true\n"
                   "quantization: int8\n")
    args = parse_with_yaml_config(parser(), ["--config", str(cfg)])
    assert args.model == "tiny-llama" and args.max_num_seqs == 16
    assert args.skip_warmup is True and args.quantization == "int8"
    args = parse_with_yaml_config(
        parser(), ["--config", str(cfg), "--max-num-seqs", "4"])
    assert args.max_num_seqs == 4
    bad = tmp_path / "bad.yaml"
    bad.write_text("quantization: int4\n")  # not a valid choice
    with pytest.raises(SystemExit):
        parse_with_yaml_config(parser(), ["--config", str(bad)])
    nul = tmp_path / "null.yaml"
    nul.write_text("model:\nmax-num-seqs: 16\n")
    args = parse_with_yaml_config(parser(), ["--config", str(nul)])
    assert args.model != "None" and args.max_num_seqs == 16


@pytest.mark.parametrize("text", [
    "no-such-flag: 1\n", "skip-warmup: 3\n", "- a list\n"],
    ids=["unknown", "bool", "not-a-mapping"])
def test_yaml_config_refusals(tmp_path, text):
    """Unknown keys, a non-boolean store_true value and a non-mapping
    document fail as the reference's do (exit 2)."""
    path = tmp_path / "c.yaml"
    path.write_text(text)
    for build in (port_server_mod.build_parser,
                  jax_server_mod.build_parser):
        from production_stack_tpu.yaml_args import (
            parse_with_yaml_config as jax_parse,
        )

        for parse in (parse_with_yaml_config, jax_parse):
            with pytest.raises(SystemExit) as e:
                parse(build(), ["--config", str(path)])
            assert e.value.code == 2


def test_no_config_needs_no_yaml(monkeypatch):
    """Without --config the YAML module is never imported."""
    import builtins

    real = builtins.__import__

    def guard(name, *a, **kw):
        assert name != "yaml", "yaml imported without --config"
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", guard)
    args = parse_with_yaml_config(port_server_mod.build_parser(),
                                  ["--model", "tiny-llama"])
    assert args.model == "tiny-llama"


def _helm_flags() -> list:
    """The observability flags the engine's helm template can pass."""
    text = (ROOT / "helm/templates/deployment-engine.yaml").read_text()
    return sorted({f for f in re.findall(r'- "(--[a-z-]+)"', text)
                   if f.startswith(("--otel", "--flight-recorder",
                                    "--diagnostics", "--no-diagnostics",
                                    "--perf-ledger", "--costmodel"))})


HELM_FLAGS = _helm_flags()
SAMPLE = {"--otel-endpoint": "http://collector:4317",
          "--otel-service-name": "engine-a", "--flight-recorder-size": "64",
          "--diagnostics-dir": "/var/diag",
          "--diagnostics-max-bundles": "4",
          "--diagnostics-max-bytes": "1048576",
          "--diagnostics-cooldown": "5", "--diagnostics-profile-seconds": "0",
          "--diagnostics-hbm-threshold": "0.95",
          "--perf-ledger-path": "/var/perf.jsonl",
          "--perf-ledger-max-bytes": "65536",
          "--perf-ledger-interval": "15", "--costmodel-drift-band": "3"}


def test_helm_passes_every_observability_flag():
    assert set(HELM_FLAGS) == set(SAMPLE) | {"--otel-secure",
                                             "--no-diagnostics"}


@pytest.mark.parametrize("flag", HELM_FLAGS)
def test_helm_flag_parses_like_the_reference(flag):
    argv = [flag] + ([SAMPLE[flag]] if flag in SAMPLE else [])
    port = port_server_mod.build_parser()
    ref = jax_server_mod.build_parser()
    got, want = port.parse_args(argv), ref.parse_args(argv)
    dest = next(a.dest for a in port._actions if flag in a.option_strings)
    assert getattr(got, dest) == getattr(want, dest)
    assert port.get_default(dest) == ref.get_default(dest)


def test_flags_reach_the_server(tmp_path):
    args = port_server_mod.build_parser().parse_args([
        "--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
        "--num-blocks", "64", "--flight-recorder-size", "7",
        "--diagnostics-dir", str(tmp_path / "d"),
        "--diagnostics-max-bundles", "3", "--diagnostics-cooldown", "9",
        "--diagnostics-profile-seconds", "0.25",
        "--diagnostics-hbm-threshold", "0.5", "--costmodel-drift-band", "3",
        "--perf-ledger-path", str(tmp_path / "p.jsonl"),
        "--perf-ledger-max-bytes", "65536", "--perf-ledger-interval", "15"])
    server = port_server_mod.server_from_args(args)
    try:
        cfg = server.diagnostics.config
        assert (cfg.dir, cfg.max_bundles, cfg.cooldown, cfg.profile_seconds,
                cfg.hbm_threshold) == (str(tmp_path / "d"), 3, 9.0, 0.25,
                                       0.5)
        perf = server.engine.perf
        assert perf.hbm_threshold == 0.5
        assert perf.anomaly_hook == server.diagnostics.trigger
        assert perf.costmodel_drift_band == 3.0
        assert server.flight_recorder.size == 7
        assert (server.config.perf_ledger_interval,
                server.perf_ledger.max_bytes) == (15.0, 65536)
    finally:
        server.shutdown()
    off = port_server_mod.build_parser().parse_args([
        "--device", "cpu", "--no-diagnostics", "--num-blocks", "64"])
    server = port_server_mod.server_from_args(off)
    try:
        assert server.diagnostics.config.enabled is False
        assert server.engine.perf.anomaly_hook is None
        assert server.perf_ledger is None
    finally:
        server.shutdown()


# -- the unchanged router in front of a port engine --------------------------

@pytest.fixture(scope="module")
def port_url(tmp_path_factory):
    cfg = tcfg.EngineConfig.for_model(
        "tiny-llama", cache=tcfg.CacheConfig(block_size=4, num_blocks=512),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=4,
                                       max_num_batched_tokens=64))
    server = EngineServer(cfg, device="cpu", diagnostics=(
        port_diag.DiagnosticsConfig(
            dir=str(tmp_path_factory.mktemp("router-diag")),
            cooldown=0.0)))
    yield server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    server.shutdown()


def _router(url, extra=()):
    from production_stack_tpu.router.app import RouterApp, build_parser

    return RouterApp(build_parser().parse_args([
        "--service-discovery", "static", "--static-backends", url,
        "--static-models", "tiny-llama", *extra]))


def test_router_joins_engine_records(port_url, tmp_path):
    _, url = port_url

    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(_router(url, [
            "--diagnostics-dir", str(tmp_path / "router")]).build_app()))
        await client.start_server()
        try:
            r = await client.post("/v1/completions", json={
                "model": "tiny-llama", "prompt": "joined", "max_tokens": 3,
                **GREEDY}, headers={"x-request-id": "obs-joined"})
            assert r.status == 200
            assert r.headers.get("x-request-id") == "obs-joined"
            # the router records a request once its handler has returned,
            # which may be after the client has the answer
            for _ in range(200):
                doc = await (await client.get("/debug/requests")).json()
                if doc["router"]["requests"]:
                    break
                await asyncio.sleep(0.05)
            return doc
        finally:
            await client.close()

    doc = asyncio.run(main())
    router_ids = {r["request_id"] for r in doc["router"]["requests"]}
    engine = doc["engines"][url]
    joined = [r for r in engine["requests"]
              if r["client_request_id"] in router_ids]
    assert [r["client_request_id"] for r in joined] == ["obs-joined"]
    assert joined[0]["outcome"] == "completed"
    assert joined[0]["num_output_tokens"] == 3


def test_router_incident_fanout_captures_on_the_port(port_url, tmp_path):
    server, url = port_url

    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        from production_stack_tpu.router.incidents import (
            current_incident_manager,
        )

        client = TestClient(TestServer(_router(url, [
            "--diagnostics-dir", str(tmp_path / "router")]).build_app()))
        await client.start_server()
        try:
            im = current_incident_manager()
            inc = im.open_incident("burn_rate_page",
                                   "slo_page:tiny-llama:ttft_p95",
                                   window={"model": "tiny-llama"},
                                   implicated=[url])
            deadline = time.monotonic() + 30
            while url not in inc.engine_bundles:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.05)
            return inc.id, inc.engine_bundles[url]
        finally:
            await client.close()

    inc_id, bundle_id = asyncio.run(main())
    assert not bundle_id.startswith("error"), bundle_id
    assert bundle_id.endswith("incident_burn_rate_page")
    path = server.diagnostics.bundle_path(bundle_id)
    with open(pathlib.Path(path) / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["detail"]["incident"] == inc_id
    assert manifest["errors"] == {}


CHART_TEMPLATES = ("deployment-engine.yaml",
                   "statefulset-engine-multihost.yaml")
# the init container's download flags, another program's
NOT_ENGINE_FLAGS = {"--dest", "--uri"}


def _engine_flags(template: str) -> list:
    """Every flag the template's engine container can pass."""
    text = (ROOT / "helm/templates" / template).read_text()
    return sorted(set(re.findall(r'- "(--[a-z0-9-]+)"', text))
                  - NOT_ENGINE_FLAGS)


CHART_FLAGS = [(t, f) for t in CHART_TEMPLATES for f in _engine_flags(t)]


def _sample(action) -> list:
    """A value the chart could give ``action``'s flag."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(list(action.choices)[-1])]
    if action.type is int:
        return ["2"]
    if action.type is float:
        return ["0.5"]
    return ["sample"]


def test_chart_flags_cover_the_parallel_sizes():
    """The templates pass the parallel sizes the port once refused."""
    flags = {f for _, f in CHART_FLAGS}
    assert {"--tensor-parallel-size", "--data-parallel-size",
            "--pipeline-parallel-size"} <= flags


@pytest.mark.parametrize("template,flag", CHART_FLAGS)
def test_chart_engine_flag_parses_like_the_reference(template, flag):
    """Each flag an engine template passes parses in the port's parser
    to the reference's dest, value and default."""
    ref = jax_server_mod.build_parser()
    port = port_server_mod.build_parser()
    want = next(a for a in ref._actions if flag in a.option_strings)
    got = next(a for a in port._actions if flag in a.option_strings)
    argv = [flag] + _sample(want)
    assert got.dest == want.dest
    assert (getattr(port.parse_args(argv), got.dest)
            == getattr(ref.parse_args(argv), want.dest))
    assert port.get_default(got.dest) == ref.get_default(want.dest)
