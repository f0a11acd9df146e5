"""The surface the router and the fleet read, on the port's server
(tiny-llama, ``device="cpu"``), against the JAX package where it has an
answer to compare with.

- ``/ready`` answers 503 ``warming`` while the launch warmup runs, then
  200; ``vllm:engine_warming`` goes 1 -> 0.
- ``POST /drain``: ``/ready`` 503 ``draining``, new ``/v1/*`` POSTs 503
  with ``Retry-After``, the in-flight stream finishes with every token.
- SIGTERM on a server process with a stream in flight: the stream
  finishes, then the process exits 0 (as ``tests/test_server_lifecycle.py``
  holds the JAX server to).
- ``/tokenize`` and ``/detokenize`` give the JAX tokenizer's answers;
  ``/kv/lookup`` gives the JAX allocator's ``match_prefix`` on the same
  history; an adapter's blocks stay invisible to it.
- ``/debug/canary`` records match the JAX engine's for the same probes
  under ``canary_golden.compare`` at tolerance 1e-4.
- ``/debug/profile`` returns a gzip'd trace, and 409 while another runs.
- ``/debug/perf``'s keys are a subset of the reference's.
"""

import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tarfile
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from _torch_parity import engine_configs, http_json, jax_engine, \
    port_engine, tiny_weights
from production_stack_tpu import canary_golden as jcanary
from production_stack_tpu.engine import perf_accounting as jperf
from production_stack_tpu.engine.config import ModelConfig as JaxModelConfig
from production_stack_tpu.engine.sampling import SamplingParams as JaxSP
from production_stack_tpu.engine.server import (
    _fmt_completion_logprobs as jax_fmt_logprobs,
)
from production_stack_tpu.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch import canary_golden as tcanary
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import EngineServer
from test_torch_lora import make_adapter_dir

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def _server(weights, **kw):
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=64)
    server = EngineServer(tconf, engine=port_engine(weights, tconf), **kw)
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def _raw(url, body=None):
    """(status, headers, bytes) of a GET, or a POST of ``body``."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _metric(url, name):
    text = _raw(f"{url}/metrics")[2].decode()
    line, = [ln for ln in text.splitlines() if ln.startswith(name + "{")]
    return float(line.rsplit(" ", 1)[1])


class _Stream(threading.Thread):
    """A streamed completion read on its own thread: ``started`` is set at
    the first event; ``tokens`` is the usage count of the finished
    stream."""

    def __init__(self, url, max_tokens):
        super().__init__(daemon=True)
        self.url, self.max_tokens = url, max_tokens
        self.started = threading.Event()
        self.tokens, self.done, self.error = None, False, None

    def run(self):
        body = {"prompt": "drain me", "max_tokens": self.max_tokens,
                "temperature": 0, "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}
        req = urllib.request.Request(
            f"{self.url}/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                for raw in r:
                    line = raw.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    self.started.set()
                    if line == "data: [DONE]":
                        self.done = True
                        break
                    ev = json.loads(line[len("data: "):])
                    if ev.get("usage"):
                        self.tokens = ev["usage"]["completion_tokens"]
        except Exception as e:  # the test asserts on it
            self.error = e
        finally:
            self.started.set()


def test_ready_goes_from_warming_to_ready(weights):
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=64)
    eng = port_engine(weights, tconf)
    gate = threading.Event()
    warmup = eng.warmup

    def gated_warmup():
        gate.wait(30)
        warmup()

    eng.warmup = gated_warmup
    server = EngineServer(tconf, engine=eng, warmup_on_start=True)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        status, body = http_json(f"{url}/ready")
        assert status == 503 and body["status"] == "warming"
        assert _metric(url, "vllm:engine_warming") == 1.0
        assert http_json(f"{url}/health")[0] == 200
        gate.set()
        deadline = time.monotonic() + 60
        while (http_json(f"{url}/ready")[0] != 200
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert http_json(f"{url}/ready") == (200, {"status": "ready"})
        assert _metric(url, "vllm:engine_warming") == 0.0
        assert _metric(url, "vllm:engine_warmup_seconds") > 0
        perf = http_json(f"{url}/debug/perf")[1]
        assert perf["compile"]["steady"]
        assert perf["compile"]["unexpected_recompiles"] == 0
    finally:
        gate.set()
        server.shutdown()


def test_drain_flow(weights):
    server, url = _server(weights, drain_deadline=60.0,
                          overload_retry_after=2.5)
    step = server.engine.step

    def slow_step():  # keep the stream in flight while the test drains
        time.sleep(0.01)
        return step()

    server.engine.step = slow_step
    try:
        stream = _Stream(url, 120)
        stream.start()
        assert stream.started.wait(60) and stream.error is None
        status, out = http_json(f"{url}/drain", {})
        assert status == 200 and out["already_draining"] is False
        assert out["inflight"] == 1
        status, body = http_json(f"{url}/ready")
        assert status == 503 and body["status"] == "draining"
        status, headers, _ = _raw(f"{url}/v1/completions",
                                  {"prompt": "late", "max_tokens": 2})
        assert status == 503 and headers["Retry-After"] == "2.5"
        assert http_json(f"{url}/drain", {})[1]["already_draining"] is True
        assert http_json(f"{url}/tokenize", {"prompt": "x"})[0] == 200
        stream.join(60)
        assert stream.done and stream.tokens == 120
        assert server.wait_drained(10)
        assert _metric(url, "vllm:drain_state") == 1.0
        assert _metric(url, "vllm:drain_rejected_requests_total") >= 1
        assert _metric(url, "vllm:drain_aborted_seqs_total") == 0
    finally:
        server.shutdown()


def test_drain_deadline_aborts_stragglers(weights):
    server, url = _server(weights, drain_deadline=0.3)
    step = server.engine.step

    def slow_step():
        time.sleep(0.02)
        return step()

    server.engine.step = slow_step
    free = server.engine.scheduler.num_free_blocks
    try:
        stream = _Stream(url, 400)
        stream.start()
        assert stream.started.wait(60)
        server.begin_drain("test")
        assert server.wait_drained(30)
        stream.join(30)
        assert stream.done and stream.tokens < 400  # cut at the deadline
        assert _metric(url, "vllm:drain_aborted_seqs_total") == 1
        assert server.engine.scheduler.num_free_blocks == free
    finally:
        server.shutdown()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_sigterm_drains_the_stream_then_exits(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "tiny-llama", "--device", "cpu", "--port", str(port),
         "--host", "127.0.0.1", "--skip-warmup", "--num-blocks", "256",
         "--max-num-seqs", "4", "--max-num-batched-tokens", "64"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                if http_json(f"{url}/health")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "server never came up"
            time.sleep(0.2)
        stream = _Stream(url, 480)
        stream.start()
        assert stream.started.wait(60) and stream.error is None
        assert not stream.done
        proc.send_signal(signal.SIGTERM)
        stream.join(120)
        assert stream.done and stream.tokens == 480, stream.error
        assert proc.wait(timeout=60) == 0
        assert "drain started (sigterm)" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_tokenize_detokenize_match_reference(weights):
    tk = get_tokenizer(None)
    server, url = _server(weights)
    try:
        for text in ("hello world", "", "naïve — ☃ 漢字", "a\nb\tc"):
            for add in (True, False):
                status, out = http_json(f"{url}/tokenize", {
                    "prompt": text, "add_special_tokens": add})
                ids = tk.encode(text, add_bos=add)
                assert status == 200 and out["tokens"] == ids
                assert out["count"] == len(ids)
                assert out["max_model_len"] == 512
                assert http_json(f"{url}/detokenize", {"tokens": ids})[1] \
                    == {"prompt": tk.decode(ids)}
        assert http_json(f"{url}/tokenize", {"text": "hi"})[1]["tokens"] \
            == tk.encode("hi")
    finally:
        server.shutdown()


def test_kv_lookup_matches_reference_allocator(weights):
    jconf, tconf = engine_configs("ragged", max_num_seqs=4,
                                  max_num_batched_tokens=64)
    jeng = jax_engine(weights, jconf)
    server = EngineServer(tconf, engine=port_engine(weights, tconf))
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    tk = get_tokenizer(None)
    served = ["the quick brown fox jumps over the lazy dog",
              "a prompt that is served once and then looked up again"]
    try:
        for i, text in enumerate(served):
            body = {"prompt": text, "max_tokens": 6, "temperature": 0,
                    "ignore_eos": True}
            assert http_json(f"{url}/v1/completions", body)[0] == 200
            jeng.add_request(f"j{i}", prompt_token_ids=tk.encode(text),
                             sampling=JaxSP(temperature=0.0, max_tokens=6,
                                            ignore_eos=True))
            while jeng.has_unfinished():
                jeng.step()
        probes = served + [served[0][:20], served[1] + " and more",
                           "never served at all"]
        matched = []
        for text in probes:
            ids = tk.encode(text)
            status, out = http_json(f"{url}/kv/lookup", {"prompt": text})
            want = jeng.scheduler.allocator.match_prefix(ids)[1]
            assert status == 200 and out == {"matched_tokens": want,
                                             "total_tokens": len(ids)}
            assert http_json(f"{url}/kv/lookup", {"tokens": ids})[1] == out
            matched.append(want)
        assert matched[0] == len(tk.encode(served[0])) // 4 * 4
        assert matched[-1] == 0
    finally:
        server.shutdown()


def test_adapter_blocks_invisible_to_kv_lookup(weights, tmp_path):
    server, url = _server(weights)
    adapter = make_adapter_dir(str(tmp_path), server.config.model, seed=3)
    text = "a prompt served under an adapter first"
    n_full = len(get_tokenizer(None).encode(text)) // 4 * 4
    body = {"prompt": text, "max_tokens": 4, "temperature": 0,
            "ignore_eos": True}
    try:
        assert http_json(f"{url}/v1/load_lora_adapter", {
            "lora_name": "ad", "lora_path": adapter})[0] == 200
        assert http_json(f"{url}/v1/completions",
                         dict(body, model="ad"))[0] == 200
        lookup = http_json(f"{url}/kv/lookup", {"prompt": text})[1]
        assert lookup["matched_tokens"] == 0  # the adapter's chain
        assert http_json(f"{url}/v1/completions", body)[0] == 200
        lookup = http_json(f"{url}/kv/lookup", {"prompt": text})[1]
        assert lookup["matched_tokens"] == n_full  # the base model's
    finally:
        server.shutdown()


def _jax_records(weights):
    """The JAX engine's golden records of the pinned probes, built as its
    server's /debug/canary builds them."""
    jconf, _ = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=64)
    jeng = jax_engine(weights, jconf)
    tk = jeng.tokenizer
    records = {}
    for probe in jcanary.DEFAULT_PROBES:
        jeng.add_request(probe.id, prompt_token_ids=tk.encode(probe.prompt),
                         sampling=JaxSP(max_tokens=probe.max_tokens,
                                        temperature=0.0,
                                        logprobs=probe.top_k))
        ids, lps = [], []
        while jeng.has_unfinished():
            for out in jeng.step():
                ids.extend(out.new_token_ids)
                lps.extend(out.new_logprobs or ())
        payload = {"choices": [{"logprobs": jax_fmt_logprobs(
            tk, ids, lps, probe.top_k)}]}
        records[probe.id] = jcanary.record_from_response(
            "tiny-llama", probe, payload, tolerance=1e-4)
    return records


def test_canary_records_match_reference(weights):
    assert [dataclasses.astuple(p) for p in tcanary.DEFAULT_PROBES] == \
        [dataclasses.astuple(p) for p in jcanary.DEFAULT_PROBES]
    want = _jax_records(weights)
    server, url = _server(weights)
    try:
        status, out = http_json(f"{url}/debug/canary?tolerance=0.25")
        assert status == 200 and out["errors"] == []
        assert http_json(f"{url}/debug/canary?tolerance=x")[0] == 400
    finally:
        server.shutdown()
    assert [r["probe"] for r in out["records"]] == list(want)
    for raw in out["records"]:
        got = tcanary.GoldenRecord.from_dict(raw)
        assert got.tolerance == 0.25 and got.model == "tiny-llama"
        ref = want[got.probe]
        assert jcanary.compare(ref, got.tokens, got.fingerprint).ok
        port_ref = tcanary.GoldenRecord.from_dict(ref.to_dict())
        verdict = tcanary.compare(port_ref, got.tokens, got.fingerprint)
        assert verdict.ok and verdict.linf <= 1e-4, verdict
        # a record the reference reads back whole
        assert jcanary.GoldenRecord.from_dict(got.to_dict()) == \
            jcanary.GoldenRecord.from_dict(raw)


def test_profile_returns_gzip_and_refuses_overlap(weights):
    server, url = _server(weights)
    first = {}
    try:
        t = threading.Thread(target=lambda: first.update(
            out=_raw(f"{url}/debug/profile", {"duration_ms": 1500})))
        t.start()
        deadline = time.monotonic() + 10
        while (not server._profiling.locked()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        status, _, body = _raw(f"{url}/debug/profile", {"duration_ms": 10})
        assert status == 409, body
        assert http_json(f"{url}/v1/completions", {
            "prompt": "traced", "max_tokens": 4})[0] == 200
        t.join(60)
        status, headers, body = first["out"]
        assert status == 200 and headers["Content-Type"] == "application/gzip"
        assert body[:2] == b"\x1f\x8b"
        with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
            trace = tar.extractfile("trace/trace.json").read()
        assert "traceEvents" in json.loads(trace)
        assert not server._profiling.locked()
        assert _raw(f"{url}/debug/profile", {"duration_ms": 10})[0] == 200
    finally:
        server.shutdown()


def test_debug_perf_keys_are_the_reference_s(weights):
    ref = jperf.PerfAccountant(JaxModelConfig.from_pretrained("tiny-llama"),
                               param_count=1, param_bytes=1).snapshot()
    # the blocks the reference's route adds beside the snapshot, and the
    # port's tensor-parallel ranks (the reference's mesh has no processes)
    ref_keys = set(ref) | {"speculative", "kv_transfer", "kv_tier",
                           "tenants", "perf_ledger", "ranks"}
    server, url = _server(weights)
    try:
        assert http_json(f"{url}/v1/completions", {
            "prompt": "perf", "max_tokens": 3})[0] == 200
        status, snap = http_json(f"{url}/debug/perf")
    finally:
        server.shutdown()
    assert status == 200 and set(snap) <= ref_keys
    assert set(ref) <= set(snap)
    for key in ("compile", "costmodel", "rooflines", "peaks", "totals"):
        assert set(snap[key]) == set(ref[key]), key
    assert set(snap["speculative"]) == {
        "enabled", "draft_tokens", "accepted_tokens", "acceptance_rate",
        "tokens_per_step"}
    # the H100 SXM data-sheet peaks by default
    assert snap["peaks"]["flops"] == 989e12
    assert snap["peaks"]["hbm_bytes_per_s"] == 3350e9
    assert snap["peaks"]["ici_bytes_per_s"] == 450e9
    assert snap["totals"]["dispatches"] > 0
    assert snap["model"]["param_count"] == sum(
        t.numel() for t in _params(weights))


def _params(weights):
    tree = weights[2]
    return [t for v in tree.values()
            for t in (v.values() if isinstance(v, dict) else [v])]


def test_busy_engine_lets_admission_and_abort_in(weights):
    """A busy engine steps back to back; a thread admitting or aborting
    gets in between two steps, not after the engine runs out of work
    (the engine lock is handed over fairly)."""
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=64)
    server = EngineServer(tconf, engine=port_engine(weights, tconf))
    step = server.engine.step

    def slow_step():
        time.sleep(0.01)
        return step()

    server.engine.step = slow_step
    ae = server.async_engine
    ae.start()
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=400, ignore_eos=True)
        first, = ae.admit_batch([("busy", [1, 2, 3], sp)])
        next(iter(first))  # the engine is stepping
        t0 = time.monotonic()
        ae.admit_batch([("late", [4, 5, 6], sp)])
        ae.abort("busy")
        ae.abort("late")
        assert time.monotonic() - t0 < 1.0  # 400 steps take > 4 s
        assert not server.engine.has_unfinished()
    finally:
        server.shutdown()
