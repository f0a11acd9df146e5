"""The port's resilience, overload and tenant planes against the JAX
server's, over HTTP, on the CPU.

Both servers serve tiny-llama (float32) on one weight set with the same
options, as in ``test_torch_api_surface.py``: the JAX server as an aiohttp
test server on an event loop of its own thread, the port's on its threads.
Each check sends the same requests to both and holds the answers equal
(bodies but for ``id`` and ``created``, floats within 1e-4):

- ``x-request-deadline``: an expired one is a 504 ``timeout_error``
  before admission, a malformed one is no deadline; one that expires
  mid-generation is a 504, or, streamed, data events, the in-band error and
  ``[DONE]``; either way ``vllm:aborted_seqs_total`` rises by one and
  ``vllm:kv_blocks_free`` is back at its value from before the request.
- ``--max-queue-len``: the 429 past the bound, its body, and a
  ``Retry-After`` taken from ``Scheduler.retry_after_hint`` with
  ``--overload-retry-after`` as the floor.
- ``/debug/faults``: 404 unarmed; armed, ``error_rate=1`` gives the same
  500 body while ``/health`` and ``/metrics`` answer; a seeded
  ``error_rate=0.5,seed=7`` gives the same 20 statuses; ``?off=1``.
- The brownout: stage 2 clamps ``max_tokens``; stage 3 answers 429 to the
  over-weight tenant's new request, passes a pushed P->D continuation and
  the light tenant's; ``/debug/overload`` and ``/debug/tenants`` agree.
- The command line: each new flag's default and parsed value are the
  reference's; the flags reach the config and the brownout controller;
  a bad ``--tenant-weights`` exits with the reference's message.
"""

import asyncio
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from _torch_parity import engine_configs, jax_engine, port_engine, tiny_weights
from production_stack_tpu.engine.overload import (
    BrownoutConfig as JaxBrownoutConfig,
    BrownoutController as JaxBrownout,
    PressureSignals as JaxSignals,
)
from production_stack_tpu.engine.server import EngineServer as JaxServer
from production_stack_tpu_torch.engine.overload import (
    BrownoutConfig,
    BrownoutController,
    PressureSignals,
)
from production_stack_tpu_torch.engine.server import EngineServer

torch.set_num_threads(2)

FLOAT_TOL = 1e-4
VOLATILE = {"id", "created"}
FLOOR = 1.5
BROWNOUT = dict(enabled=True, interval=3600.0, up_evals=1, calm_evals=1,
                max_tokens_clamp=5)
WEIGHTS = {"heavy": 1, "light": 4}


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


class _Pair:
    """A JAX server and a port server on one weight set and options;
    ``faults`` arms fault injection on both (the JAX server reads it from
    FAULT_INJECTION when it builds its app, the port from its argument)."""

    def __init__(self, weights, faults=None, brownout=False, **sched):
        from aiohttp.test_utils import TestServer

        jconf, tconf = engine_configs(
            "ragged", block_size=4, num_blocks=512, max_num_batched_tokens=64,
            prefill_buckets=(32, 64, 128), **sched)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.jax = JaxServer(
            jconf, engine=jax_engine(weights, jconf),
            overload_retry_after=FLOOR,
            brownout=(JaxBrownout(JaxBrownoutConfig(**BROWNOUT))
                      if brownout else None))
        if faults is not None:
            os.environ["FAULT_INJECTION"] = faults
        try:
            app = self.jax.build_app()
        finally:
            os.environ.pop("FAULT_INJECTION", None)
        self.jts = self._on(self._start(TestServer, app))
        self.port = EngineServer(
            tconf, engine=port_engine(weights, tconf),
            overload_retry_after=FLOOR, fault_injection=faults,
            brownout=(BrownoutController(BrownoutConfig(**BROWNOUT))
                      if brownout else None))
        self.urls = (f"http://127.0.0.1:{self.jts.port}",
                     f"http://127.0.0.1:{self.port.start('127.0.0.1', 0)}")

    @staticmethod
    async def _start(test_server, app):
        ts = test_server(app)
        await ts.start_server()
        return ts

    def _on(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(300)

    def on_jax_engine(self, fn):
        return self._on(self.jax.async_engine.run_on_engine(fn))

    def close(self):
        self.port.shutdown()
        self._on(self.jts.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture(scope="module")
def pair(weights):
    p = _Pair(weights, faults="", max_num_seqs=2, max_queue_len=1)
    yield p
    p.close()


@pytest.fixture(scope="module")
def brown(weights):
    p = _Pair(weights, brownout=True, max_num_seqs=4, max_queue_len=16,
              tenant_weights=dict(WEIGHTS))
    yield p
    p.close()


def call(url, path, body=None, headers=None):
    """(status, headers, text) of a request; an HTTP error status is
    returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def sse(text: str) -> list:
    out = []
    for block in text.strip().split("\n\n"):
        raw = block[len("data: "):]
        out.append(raw if raw == "[DONE]" else json.loads(raw))
    return out


def same(a, b, where="$"):
    """a == b but for VOLATILE keys and floats within FLOAT_TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict), where
        assert set(a) - VOLATILE == set(b) - VOLATILE, (where, a, b)
        for k in a:
            if k not in VOLATILE:
                same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a,
                                                                   b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= FLOAT_TOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


def both(p, path, body=None, headers=None):
    """Both servers' answers to one request, held equal; returns the
    port's (status, headers, parsed body)."""
    (js, _, jt), (ps, ph, pt) = (call(u, path, body, headers)
                                 for u in p.urls)
    assert js == ps, (path, body, jt, pt)
    if (body or {}).get("stream") and js == 200:
        want, got = sse(jt), sse(pt)
    else:
        want, got = json.loads(jt), json.loads(pt)
    same(want, got)
    return ps, ph, got


def metric(url, name):
    text = call(url, "/metrics")[2]
    m = re.search(rf"^{re.escape(name)}{{[^}}]*}} (\S+)$", text, re.M)
    return float(m.group(1))


def counts(url):
    return (metric(url, "vllm:aborted_seqs_total"),
            metric(url, "vllm:kv_blocks_free"))


GREEDY = {"temperature": 0, "ignore_eos": True}


# -- deadlines ----------------------------------------------------------------

@pytest.mark.parametrize("path, body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 4}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "max_tokens": 4, "stream": True}),
])
def test_expired_deadline_is_504_before_admission(pair, path, body):
    before = [counts(u) for u in pair.urls]
    status, _, out = both(pair, path, dict(body, **GREEDY), {
        "x-request-deadline": f"{time.time() - 1:.3f}"})
    assert status == 504
    assert out == {"error": {"message": "x-request-deadline already expired",
                             "type": "timeout_error"}}
    assert [counts(u) for u in pair.urls] == before


@pytest.mark.parametrize("value", ["garbage", "", "1e400x"])
def test_malformed_deadline_means_none(pair, value):
    status, _, out = both(pair, "/v1/completions", {
        "prompt": "hello", "max_tokens": 4, **GREEDY},
        {"x-request-deadline": value})
    assert status == 200 and out["usage"]["completion_tokens"] == 4


def test_future_deadline_is_met(pair):
    status, _, out = both(pair, "/v1/completions", {
        "prompt": "hello", "max_tokens": 3, **GREEDY},
        {"x-request-deadline": f"{time.time() + 300:.3f}"})
    assert status == 200 and out["usage"]["completion_tokens"] == 3


@pytest.mark.parametrize("stream", [False, True])
def test_deadline_mid_generation_aborts_and_frees(pair, stream):
    body = {"prompt": "hello", "max_tokens": 400, "stream": stream,
            **GREEDY}
    for url in pair.urls:  # the port's last
        aborted, free = counts(url)
        t0 = time.time()
        status, _, text = call(url, "/v1/completions", body, {
            "x-request-deadline": f"{t0 + 0.4:.3f}"})
        waited = time.time() - t0
        err = {"error": {"message": "request deadline exceeded",
                         "type": "timeout_error"}}
        if stream:
            events = sse(text)
            assert status == 200 and events[-1] == "[DONE]", url
            assert events[-2] == err, url
            assert all("choices" in e for e in events[:-2]), url
        else:
            assert status == 504 and json.loads(text) == err, url
        assert 0.3 < waited < 30, url
        # the JAX server posts its abort to the engine thread: give it a
        # moment; the port aborts before it answers
        settle = time.monotonic() + 10
        while counts(url) != (aborted + 1, free) and \
                time.monotonic() < settle:
            time.sleep(0.02)
        assert counts(url) == (aborted + 1, free), url
    assert counts(pair.urls[1]) == (aborted + 1, free)


# -- the queue bound and Retry-After ------------------------------------------

def test_queue_bound_429_and_retry_after(pair, monkeypatch):
    # the servers sleep, so admitted requests wait in the queue: the first
    # fills the bound of 1, the next gets the 429
    both(pair, "/sleep?level=1", {})
    first = {}

    def fire(i, url):
        first[i] = call(url, "/v1/completions", {
            "prompt": "queued", "max_tokens": 2, **GREEDY})

    threads = [threading.Thread(target=fire, args=(i, u))
               for i, u in enumerate(pair.urls)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 30
        while (pair.port.engine.scheduler.num_waiting < 1
               or pair.jax.engine.scheduler.num_waiting < 1):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        status, headers, out = both(pair, "/v1/completions", {
            "prompt": "over", "max_tokens": 2})
        assert status == 429
        assert out["error"]["type"] == "rate_limit_error"
        assert float(headers["Retry-After"]) >= FLOOR
        # the header is the scheduler's hint, floored at the flag
        asked = []
        for srv in (pair.jax, pair.port):
            monkeypatch.setattr(
                srv.engine.scheduler, "retry_after_hint",
                lambda floor=1.0, **kw: asked.append(floor) or 7.25)
        (js, jh, _), (ps, ph, _) = (call(u, "/v1/completions", {
            "prompt": "over", "max_tokens": 2}) for u in pair.urls)
        assert js == ps == 429
        assert jh["Retry-After"] == ph["Retry-After"] == "7.25"
        assert asked == [FLOOR, FLOOR]
    finally:
        monkeypatch.undo()
        both(pair, "/wake_up", {})
        for t in threads:
            t.join(60)
    assert first[0][0] == first[1][0] == 200
    same(json.loads(first[0][2]), json.loads(first[1][2]))


# -- fault injection ----------------------------------------------------------

def test_faults_route_is_404_unarmed(brown):
    for url in brown.urls:
        assert call(url, "/debug/faults?error_rate=1", {})[0] == 404
    assert brown.port._faults_armed is False


def test_faults_error_rate_and_off(pair):
    status, _, out = both(pair, "/debug/faults?error_rate=1", {})
    assert status == 200 and out["active"] and out["error_rate"] == 1.0
    try:
        status, _, out = both(pair, "/v1/completions", {
            "prompt": "x", "max_tokens": 2})
        assert status == 500
        assert out == {"error": {"message": "injected fault",
                                 "type": "fault_injection"}}
        for url in pair.urls:
            assert call(url, "/health")[0] == 200
            assert call(url, "/metrics")[0] == 200
            assert call(url, "/v1/models")[0] == 200
    finally:
        status, _, out = both(pair, "/debug/faults?off=1", {})
    assert status == 200 and out == {"active": False}
    assert both(pair, "/v1/completions", {
        "prompt": "x", "max_tokens": 2, **GREEDY})[0] == 200


def test_seeded_faults_give_the_same_statuses(pair):
    both(pair, "/debug/faults?error_rate=0.5&seed=7", {})
    try:
        seqs = []
        for url in pair.urls:
            seqs.append([call(url, "/v1/completions", {
                "prompt": "x", "max_tokens": 1, **GREEDY})[0]
                for _ in range(20)])
    finally:
        both(pair, "/debug/faults?off=1", {})
    assert seqs[0] == seqs[1]
    assert set(seqs[0]) == {200, 500}


@pytest.mark.parametrize("query", ["off=2", "bogus=1", "error_rate=3",
                                   "error_rate"])
def test_bad_fault_queries_are_400(pair, query):
    status, _, out = both(pair, f"/debug/faults?{query}", {})
    assert status == 400 and "message" in out["error"]


def test_stall_delays_the_first_byte(pair):
    both(pair, "/debug/faults?stall_ms=300", {})
    try:
        for url in pair.urls:
            t0 = time.monotonic()
            assert call(url, "/v1/completions", {
                "prompt": "x", "max_tokens": 1})[0] == 200
            assert time.monotonic() - t0 >= 0.3, url
    finally:
        both(pair, "/debug/faults?off=1", {})


# -- brownout, tenants --------------------------------------------------------

def _heat(p, stage):
    """Walk both controllers to ``stage`` on the same virtual clock, then
    apply it on each engine thread (the evaluation thread itself sleeps:
    its interval is an hour)."""
    for i in range(stage):
        p.jax.brownout.evaluate(JaxSignals(queue_fraction=1.0), 100.0 + i)
        p.port.brownout.evaluate(PressureSignals(queue_fraction=1.0),
                                 100.0 + i)
    p.on_jax_engine(p.jax._apply_brownout)
    p.port.async_engine.run_on_engine(p.port._apply_brownout)


def _calm(p):
    for i in range(4):
        p.jax.brownout.evaluate(JaxSignals(), 200.0 + i)
        p.port.brownout.evaluate(PressureSignals(), 200.0 + i)
    p.on_jax_engine(p.jax._apply_brownout)
    p.port.async_engine.run_on_engine(p.port._apply_brownout)


def test_brownout_stage2_clamps_max_tokens(brown):
    _heat(brown, 2)
    try:
        status, _, out = both(brown, "/v1/completions", {
            "prompt": "clamp me", "max_tokens": 200, **GREEDY},
            {"x-tenant-id": "light"})
        assert status == 200 and out["usage"]["completion_tokens"] == 5
        _, _, snap = both(brown, "/debug/overload")
        assert snap["brownout"]["stage"] == 2
        assert snap["brownout"]["sheds"]["max_tokens"] == 1
    finally:
        _calm(brown)
    assert both(brown, "/debug/overload")[2]["brownout"]["stage"] == 0


def test_brownout_stage3_sheds_the_overweight_tenant(brown):
    both(brown, "/sleep?level=1", {})
    answers: dict = {}
    threads = []

    def fire(key, url, tenant, body=None):
        answers[key] = call(url, "/v1/completions", body or {
            "prompt": f"load {tenant}", "max_tokens": 3, **GREEDY},
            {"x-tenant-id": tenant})

    try:
        # queued while asleep: heavy 3, light 1 (weights heavy 1, light 4)
        for i, url in enumerate(brown.urls):
            for j, tenant in enumerate(["heavy", "heavy", "heavy", "light"]):
                threads.append(threading.Thread(
                    target=fire, args=((i, j), url, tenant)))
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while (brown.port.engine.scheduler.num_waiting < 4
               or brown.jax.engine.scheduler.num_waiting < 4):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        _heat(brown, 3)
        _, _, snap = both(brown, "/debug/overload")
        assert snap["brownout"]["stage"] == 3
        assert snap["shed_tenants"] == ["heavy"]
        status, headers, out = both(brown, "/v1/completions", {
            "prompt": "more", "max_tokens": 3}, {"x-tenant-id": "heavy"})
        assert status == 429 and "over its fair share" in \
            out["error"]["message"]
        assert float(headers["Retry-After"]) >= FLOOR
        # a pushed continuation of the heavy tenant and a light request
        # pass (admitted now, answered after wake_up)
        cont = {"prompt": "continued", "max_tokens": 3, **GREEDY,
                "kv_transfer_params": {"transfer_id": "t-unknown"}}
        for i, url in enumerate(brown.urls):
            for key, tenant, body in (("cont", "heavy", cont),
                                      ("light", "light", None)):
                t = threading.Thread(target=fire,
                                     args=((i, key), url, tenant, body))
                threads.append(t)
                t.start()
        while (brown.port.engine.scheduler.num_waiting < 6
               or brown.jax.engine.scheduler.num_waiting < 6):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        _, _, tenants = both_tenants(brown)
        assert "heavy" not in tenants["tenants"]  # queued: nothing billed
    finally:
        _calm(brown)
        both(brown, "/wake_up", {})
        for t in threads:
            t.join(60)
    for key in [0, 1, 2, 3, "cont", "light"]:
        (js, _, jt), (ps, _, pt) = answers[(0, key)], answers[(1, key)]
        assert js == ps == 200, key
        same(json.loads(jt), json.loads(pt))
    _, _, snap = both(brown, "/debug/overload")
    assert snap["brownout"]["sheds"]["tenant"] == 1
    assert snap["brownout"]["stage"] == 0 and snap["shed_tenants"] == []


def both_tenants(p):
    """Both servers' /debug/tenants: the same tenants, token counts,
    requests and KV blocks (chip-seconds and queue time are wall clock)."""
    docs = [json.loads(call(u, "/debug/tenants")[2]) for u in p.urls]
    want, got = docs
    assert set(got) == set(want)
    assert set(got["tenants"]) == set(want["tenants"])
    for t, row in want["tenants"].items():
        mine = got["tenants"][t]
        assert set(mine) == set(row), t
        for key in ("prefill_tokens", "decode_tokens", "requests",
                    "kv_blocks"):
            assert mine[key] == row[key], (t, key)
    for key in ("enabled", "top_k", "tracked", "model"):
        assert got[key] == want[key], key
    rows = got["tenants"].values()
    assert sum(r["chip_seconds"] for r in rows) == pytest.approx(
        got["dispatch_seconds_total"], rel=1e-9)
    return 200, None, got


def test_debug_tenants_and_overload_agree(brown):
    for tenant, n in (("alpha", 2), ("beta", 1)):
        for _ in range(n):
            assert both(brown, "/v1/completions", {
                "prompt": f"from {tenant}", "max_tokens": 4, **GREEDY},
                {"x-tenant-id": tenant})[0] == 200
    assert both(brown, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 2,
        "user": "gamma", **GREEDY})[0] == 200
    _, _, doc = both_tenants(brown)
    assert {"alpha", "beta", "gamma"} <= set(doc["tenants"])
    assert doc["tenants"]["alpha"]["requests"] == 2
    # a 4-token answer is a prefill's first token and 3 decode tokens
    assert doc["tenants"]["alpha"]["decode_tokens"] == 2 * 3
    _, _, snap = both(brown, "/debug/overload")
    assert set(snap) == {"brownout", "shed_tenants", "fair_share"}
    assert snap["fair_share"] == {"enabled": False, "deficits": {},
                                  "admit_pass": {}}


# -- the command line -----------------------------------------------------------

FLAGS = [
    ("fault_injection", ["--fault-injection", "error_rate=0.5,seed=7"]),
    ("max_queue_len", ["--max-queue-len", "4"]),
    ("overload_retry_after", ["--overload-retry-after", "2.5"]),
    ("fair_share", ["--fair-share"]),
    ("tenant_weights", ["--tenant-weights", '{"a": 3}']),
    ("brownout", ["--brownout"]),
    ("brownout_interval", ["--brownout-interval", "0.25"]),
    ("brownout_queue_high", ["--brownout-queue-high", "0.05"]),
    ("brownout_hbm_high", ["--brownout-hbm-high", "0.8"]),
    ("brownout_up_evals", ["--brownout-up-evals", "1"]),
    ("brownout_calm_evals", ["--brownout-calm-evals", "2"]),
    ("brownout_max_tokens_clamp", ["--brownout-max-tokens-clamp", "16"]),
    ("tenant_metering", ["--no-tenant-metering"]),
    ("tenant_top_k", ["--tenant-top-k", "3"]),
    ("tenant_ledger_path", ["--tenant-ledger-path", "/tmp/x.jsonl"]),
    ("tenant_ledger_max_bytes", ["--tenant-ledger-max-bytes", "4096"]),
]


@pytest.mark.parametrize("dest, argv", FLAGS, ids=[f[0] for f in FLAGS])
def test_flags_match_reference(dest, argv):
    from production_stack_tpu.engine.server import build_parser as jparser
    from production_stack_tpu_torch.engine.server import build_parser

    for extra in ([], argv):
        want = getattr(jparser().parse_args(extra), dest)
        got = getattr(build_parser().parse_args(extra), dest)
        assert got == want, (dest, extra)


def test_flags_reach_the_config_and_the_server(tmp_path):
    from production_stack_tpu_torch.engine.server import (
        brownout_from_args,
        build_parser,
        config_from_args,
    )

    args = build_parser().parse_args(
        ["--max-queue-len", "4", "--fair-share", "--tenant-weights",
         '{"heavy": 1, "light": 4}', "--no-tenant-metering",
         "--tenant-top-k", "3", "--tenant-ledger-path",
         str(tmp_path / "u.jsonl"), "--tenant-ledger-max-bytes", "8192",
         "--brownout", "--brownout-interval", "0.25",
         "--brownout-max-tokens-clamp", "16"])
    cfg = config_from_args(args)
    assert cfg.scheduler.max_queue_len == 4 and cfg.scheduler.fair_share
    assert cfg.scheduler.tenant_weight("light") == 4.0
    assert cfg.scheduler.tenant_weight("other") == 1.0
    assert (cfg.tenant_metering, cfg.tenant_top_k, cfg.tenant_ledger_max_bytes
            ) == (False, 3, 8192)
    ctl = brownout_from_args(args)
    assert ctl.config.enabled and ctl.config.interval == 0.25
    assert ctl.config.max_tokens_clamp == 16
    assert brownout_from_args(build_parser().parse_args([])) is None


@pytest.mark.parametrize("weights", ["{bad", "[1, 2]"])
def test_bad_tenant_weights_exit_as_the_reference(weights):
    from production_stack_tpu.engine.server import (
        build_parser as jparser,
        config_from_args as jconfig,
    )
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        config_from_args,
    )

    with pytest.raises(SystemExit) as want:
        jconfig(jparser().parse_args(["--tenant-weights", weights]))
    with pytest.raises(SystemExit) as got:
        config_from_args(build_parser().parse_args(
            ["--tenant-weights", weights]))
    assert str(got.value) == str(want.value)


def test_usage_ledger_records_match_reference(brown, tmp_path):
    from production_stack_tpu.tenancy import UsageLedger as JaxLedger
    from production_stack_tpu_torch.tenancy import UsageLedger

    paths = (tmp_path / "jax.jsonl", tmp_path / "port.jsonl")
    brown.jax.usage_ledger = JaxLedger(str(paths[0]))
    brown.port.usage_ledger = UsageLedger(str(paths[1]))
    try:
        for i, tenant in enumerate(["ledger-a", "ledger-b"]):
            assert both(brown, "/v1/completions", {
                "prompt": f"bill me {i}", "max_tokens": 3, **GREEDY},
                {"x-tenant-id": tenant, "x-request-id": f"client-{i}"}
            )[0] == 200
        docs = [json.loads(call(u, "/debug/tenants")[2])["ledger"]
                for u in brown.urls]
    finally:
        brown.jax.usage_ledger = brown.port.usage_ledger = None
    want, got = ([json.loads(line) for line in p.read_text().splitlines()]
                 for p in paths)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for key in ("tenant", "model", "client_request_id", "prompt_tokens",
                    "output_tokens", "cached_tokens", "finish_reason"):
            assert g[key] == w[key], key
        assert g["chip_seconds"] > 0 and g["request_id"].startswith("cmpl-")
    assert [g["tenant"] for g in got] == ["ledger-a", "ledger-b"]
    for d in docs:
        d.pop("path")
    assert docs[0] == docs[1]
