"""The port's anomaly-triggered diagnostic bundles against the JAX
package's, on the CPU.

- The reference's ``DiagnosticsManager`` unit cases (capture, tar round
  trip, cooldown and force, single flight, retention by count then bytes,
  traversal refusal, a collector's error recorded, restart reindex, note,
  disabled) run against both managers, each case parametrised over the two
  classes.
- Engine drills on the port's CPU server over HTTP, beside the JAX
  server's: a forced recompile after warmup, a watchdog stall and its
  recovery, and the capture endpoint with retention leave the same
  triggers, the same bundle files (the memory snapshot apart: the port
  takes one only on the card) and ``manifest["errors"] == {}``.
- The port's own edges: ``/debug/memory`` answers 500 on a CPU engine,
  the capture endpoint 400 when diagnostics are off and 409 while a
  capture runs, and a bundle's profiler trace is skipped (and the skip
  recorded) while ``/debug/profile`` holds the profiler or another
  profiler is enabled in the process; the trace starts and stops on the
  engine thread, and a step that holds the engine past the wait leaves a
  bundle without a trace, its manifest saying why.
"""

import asyncio
import io
import json
import os
import tarfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from production_stack_tpu.engine import diagnostics as jax_diag
from production_stack_tpu_torch.engine import diagnostics as port_diag
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.server import EngineServer

torch.set_num_threads(2)

MODULES = pytest.mark.parametrize("mod", [jax_diag, port_diag],
                                  ids=["jax", "port"])
# the bundle files both engines write on the CPU; each also writes its
# memory snapshot where it can (the JAX engine's pprof; the port's pickle
# only on the card)
ENGINE_FILES = {"manifest.json", "perf.json", "lifecycle.json",
                "flight_recorder.json", "scheduler.json",
                "compile_events.json"}


def manager(mod, tmp_path, **kw):
    cfg = dict(dir=str(tmp_path / "diag"), cooldown=0.0)
    cfg.update(kw)
    return mod.DiagnosticsManager(
        mod.DiagnosticsConfig(**cfg), tier="engine",
        collectors={"state.json": lambda: {"ok": True}})


# -- DiagnosticsManager unit cases, on both classes ---------------------------

@MODULES
def test_sync_capture_writes_indexed_bundle(mod, tmp_path):
    mgr = manager(mod, tmp_path)
    bundle_id = mgr.trigger("unexpected_recompile",
                            {"kind": "decode", "bucket": "b128"}, sync=True)
    assert bundle_id and bundle_id.endswith("unexpected_recompile")
    idx = mgr.index()
    assert idx["enabled"] and idx["tier"] == "engine"
    (row,) = idx["bundles"]
    assert row["id"] == bundle_id and row["trigger"] == "unexpected_recompile"
    assert row["bytes"] > 0 and row["detail"]["bucket"] == "b128"
    path = mgr.bundle_path(bundle_id)
    with open(os.path.join(path, "manifest.json")) as f:
        mani = json.load(f)
    assert mani["files"] == ["state.json"] and mani["errors"] == {}
    with open(os.path.join(path, "state.json")) as f:
        assert json.load(f) == {"ok": True}
    (event,) = idx["events"]
    assert event["captured"] and event["bundle"] == bundle_id


@MODULES
def test_tar_download_roundtrip(mod, tmp_path):
    mgr = manager(mod, tmp_path)
    bundle_id = mgr.trigger("manual", sync=True)
    with tarfile.open(fileobj=io.BytesIO(mgr.tar_bundle(bundle_id)),
                      mode="r:gz") as tar:
        names = tar.getnames()
    assert f"{bundle_id}/manifest.json" in names
    assert f"{bundle_id}/state.json" in names


@MODULES
def test_cooldown_drops_and_force_bypasses(mod, tmp_path):
    mgr = manager(mod, tmp_path, cooldown=3600.0)
    first = mgr.trigger("hbm_pressure", sync=True)
    assert first is not None
    assert mgr.trigger("hbm_pressure", sync=True) is None
    # another trigger has a cooldown clock of its own
    assert mgr.trigger("watchdog_stall", sync=True) is not None
    forced = mgr.trigger("hbm_pressure", force=True, sync=True)
    assert forced is not None and forced != first
    stats = mgr.stats()
    assert stats["dropped_total"] == {"hbm_pressure": 1}
    assert stats["bundles_total"] == {"hbm_pressure": 2, "watchdog_stall": 1}
    dropped = [e for e in mgr.index()["events"] if e.get("dropped")]
    assert dropped and dropped[0]["dropped"] == "cooldown"


@MODULES
def test_single_flight_drops_overlapping_trigger(mod, tmp_path):
    gate, entered = threading.Event(), threading.Event()

    def slow_collector():
        entered.set()
        gate.wait(5.0)
        return {"slow": True}

    mgr = mod.DiagnosticsManager(
        mod.DiagnosticsConfig(dir=str(tmp_path / "diag"), cooldown=0.0),
        collectors={"slow.json": slow_collector})
    first = mgr.trigger("watchdog_stall")
    assert first is not None and entered.wait(5.0)
    assert mgr.trigger("watchdog_stall") is None
    assert mgr.trigger("hbm_pressure") is None
    gate.set()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not mgr.index()["bundles"]:
        time.sleep(0.01)
    assert [b["id"] for b in mgr.index()["bundles"]] == [first]
    assert mgr.stats()["dropped_total"] == {"watchdog_stall": 1,
                                            "hbm_pressure": 1}


@MODULES
def test_retention_bounds_count_then_bytes(mod, tmp_path):
    mgr = manager(mod, tmp_path, max_bundles=3)
    ids = [mgr.trigger("manual", {"n": i}, force=True, sync=True)
           for i in range(6)]
    assert sorted(b["id"] for b in mgr.index()["bundles"]) == sorted(ids[-3:])
    for victim in ids[:3]:
        assert mgr.bundle_path(victim) is None
        assert not os.path.isdir(os.path.join(mgr.dir, victim))
    big = mod.DiagnosticsManager(
        mod.DiagnosticsConfig(dir=str(tmp_path / "big"), cooldown=0.0,
                              max_bundles=100, max_bytes=8 * 1024),
        collectors={"blob.bin": lambda: b"x" * 6 * 1024})
    for _ in range(4):
        big.trigger("manual", force=True, sync=True)
    remaining = big.index()["bundles"]
    assert 1 <= len(remaining) <= 2
    assert sum(b["bytes"] for b in remaining[1:]) <= 8 * 1024


@MODULES
def test_bundle_path_refuses_traversal(mod, tmp_path):
    mgr = manager(mod, tmp_path)
    mgr.trigger("manual", sync=True)
    assert mgr.bundle_path("../../etc/passwd") is None
    assert mgr.bundle_path(".hidden") is None
    assert mgr.tar_bundle("..") is None
    assert mgr.tar_bundle("no-such-bundle") is None


@MODULES
def test_collector_error_is_recorded_not_fatal(mod, tmp_path):
    def boom():
        raise RuntimeError("collector died")

    mgr = mod.DiagnosticsManager(
        mod.DiagnosticsConfig(dir=str(tmp_path / "diag"), cooldown=0.0),
        collectors={"good.json": lambda: {"ok": 1}, "bad.json": boom})
    bundle_id = mgr.trigger("manual", sync=True)
    with open(os.path.join(mgr.bundle_path(bundle_id),
                           "manifest.json")) as f:
        mani = json.load(f)
    assert mani["files"] == ["good.json"]
    assert "RuntimeError" in mani["errors"]["bad.json"]


@MODULES
def test_restart_reindexes_existing_bundles(mod, tmp_path):
    first = manager(mod, tmp_path)
    bundle_id = first.trigger("drain_deadline_abort", sync=True)
    reborn = mod.DiagnosticsManager(
        mod.DiagnosticsConfig(dir=first.dir, cooldown=0.0))
    assert [b["id"] for b in reborn.index()["bundles"]] == [bundle_id]
    assert reborn.tar_bundle(bundle_id) is not None


@MODULES
def test_note_records_event_without_bundle(mod, tmp_path):
    mgr = manager(mod, tmp_path)
    mgr.note("watchdog_recovered", {"stalls_total": 1})
    idx = mgr.index()
    assert idx["bundles"] == []
    (event,) = idx["events"]
    assert event["trigger"] == "watchdog_recovered"
    assert event["captured"] is False


@MODULES
def test_disabled_manager_never_captures(mod, tmp_path):
    mgr = mod.DiagnosticsManager(
        mod.DiagnosticsConfig(enabled=False, dir=str(tmp_path / "off")))
    assert mgr.trigger("manual", sync=True) is None
    assert not os.path.isdir(str(tmp_path / "off"))


def test_both_managers_index_the_same_capture(tmp_path):
    """The same triggers in the same order give the same index, times and
    paths apart."""
    def run(mod):
        mgr = manager(mod, tmp_path / mod.__name__, max_bundles=2,
                      cooldown=3600.0)
        for trig, force in (("manual", False), ("manual", False),
                            ("hbm_pressure", False), ("manual", True)):
            mgr.trigger(trig, {"t": trig}, force=force, sync=True)
        mgr.note("watchdog_recovered")
        idx = mgr.index()
        rows = [{k: v for k, v in b.items()
                 if k not in ("id", "ts", "bytes", "capture_seconds")}
                for b in idx["bundles"]]
        events = [{k: v for k, v in e.items() if k not in ("ts", "bundle")}
                  for e in idx["events"]]
        return (rows, events, idx["bundles_total"], idx["dropped_total"],
                idx["retention"])

    assert run(port_diag) == run(jax_diag)


# -- engine drills over HTTP ---------------------------------------------------

def port_server(tmp_path, diag=None, **server_kw):
    cfg = EngineConfig.for_model(
        "tiny-llama", cache=CacheConfig(block_size=4, num_blocks=512),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64))
    diag = diag or {}
    diag.setdefault("dir", str(tmp_path / "port-diag"))
    diag.setdefault("cooldown", 0.0)
    diag.setdefault("profile_seconds", 0.0)
    diag.setdefault("max_bundles", 2)
    server = EngineServer(cfg, device="cpu",
                          diagnostics=port_diag.DiagnosticsConfig(**diag),
                          **server_kw)
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def jax_server(tmp_path, **server_kw):
    from production_stack_tpu.engine.config import (
        CacheConfig as JCache,
        EngineConfig as JConfig,
        ModelConfig as JModel,
        SchedulerConfig as JSched,
    )
    from production_stack_tpu.engine.server import EngineServer as JServer
    from production_stack_tpu.parallel.mesh import MeshConfig

    cfg = JConfig(
        model=JModel.from_pretrained("tiny-llama"),
        cache=JCache(block_size=4, num_blocks=512),
        scheduler=JSched(max_num_seqs=4, max_num_batched_tokens=64,
                         prefill_buckets=(32, 64)),
        mesh=MeshConfig(data=1, tensor=1))
    server_kw.setdefault("diagnostics", jax_diag.DiagnosticsConfig(
        dir=str(tmp_path / "jax-diag"), cooldown=0.0, profile_seconds=0.0,
        max_bundles=2))
    return JServer(cfg, **server_kw)


def run_jax(server, body):
    """Run ``body(get, post)`` against the JAX server's aiohttp app; get
    and post return (status, headers, bytes)."""
    from aiohttp.test_utils import TestClient, TestServer

    async def main():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()

        async def get(path):
            r = await client.get(path)
            return r.status, dict(r.headers), await r.read()

        async def post(path, payload):
            r = await client.post(path, json=payload)
            return r.status, dict(r.headers), await r.read()

        try:
            return await body(get, post)
        finally:
            await client.close()

    return asyncio.run(main())


def http(url, path, body=None):
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def wait_bundle(get_index, trigger, deadline=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        rows = [b for b in get_index()["bundles"] if b["trigger"] == trigger]
        if rows:
            return rows[0]
        time.sleep(0.05)
    raise AssertionError(f"no {trigger!r} bundle within {deadline}s")


def bundle_files(data: bytes, bundle_id: str) -> tuple:
    """(file names, manifest, scheduler.json, compile_events.json)."""
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        names = {n[len(bundle_id) + 1:] for n in tar.getnames()
                 if n != bundle_id}

        def load(name):
            return json.load(tar.extractfile(f"{bundle_id}/{name}"))

        return names, load("manifest.json"), load("scheduler.json"), \
            load("compile_events.json")


def _recompile_drill_port(tmp_path):
    server, url = port_server(tmp_path)
    try:
        perf = server.engine.perf
        perf.mark_steady()
        # the leaked shape: a signature the warmup never ran
        perf.on_compile("decode", "bs8", 1.25)
        row = wait_bundle(lambda: json.loads(http(
            url, "/debug/diagnostics")[2]), "unexpected_recompile")
        status, headers, data = http(url, f"/debug/diagnostics/{row['id']}")
        assert status == 200
        assert ".tar.gz" in headers["Content-Disposition"]
        missing = http(url, "/debug/diagnostics/missing-bundle")
        return row, bundle_files(data, row["id"]), missing
    finally:
        server.shutdown()


def _recompile_drill_jax(tmp_path):
    server = jax_server(tmp_path)

    async def body(get, post):
        perf = server.engine.perf
        perf.mark_steady()
        perf.on_compile("decode", "bs8", 1.25)
        for _ in range(200):
            idx = json.loads((await get("/debug/diagnostics"))[2])
            rows = [b for b in idx["bundles"]
                    if b["trigger"] == "unexpected_recompile"]
            if rows:
                break
            await asyncio.sleep(0.05)
        row = rows[0]
        status, headers, data = await get(f"/debug/diagnostics/{row['id']}")
        assert status == 200
        return row, bundle_files(data, row["id"]), \
            await get("/debug/diagnostics/missing-bundle")

    return run_jax(server, body)


def test_forced_recompile_drill_leaves_downloadable_bundle(tmp_path):
    """After warmup a fresh compile signature is the unexpected-recompile
    signal: both engines leave an indexed, downloadable bundle with the
    same files, every collector succeeding, the tuple-keyed compile counts
    stringified and the triggering event in the compile tail; a missing
    bundle is a 404 in the same shape."""
    port, jax = _recompile_drill_port(tmp_path), _recompile_drill_jax(tmp_path)
    for row, (names, manifest, sched, tail), missing in (port, jax):
        assert row["detail"]["unexpected"] is True
        assert row["detail"]["bucket"] == "bs8"
        assert ENGINE_FILES <= names
        assert manifest["errors"] == {}
        assert "decode:bs8" in sched["perf"]["compile_counts"]
        assert any(e["bucket"] == "bs8" and e["unexpected"] for e in tail)
        assert missing[0] == 404
    assert port[1][0] - {"memory.pickle"} == jax[1][0] - {"memory.pprof"}
    assert "memory.pickle" not in port[1][0]  # a CPU engine takes none
    assert json.loads(port[2][2]) == json.loads(jax[2][2])
    assert {k: v for k, v in port[0]["detail"].items() if k != "ts"} == \
        {k: v for k, v in jax[0]["detail"].items() if k != "ts"}


def _stall(watchdog):
    """Drive the watchdog with a synthetic clock: a stall, then progress.
    Returns the stub engine it watched."""
    stub = SimpleNamespace(step_count=7, paused=False,
                           engine=SimpleNamespace(has_unfinished=lambda: True))
    watchdog.async_engine = stub
    assert watchdog.check(100.0) is False     # first look: the baseline
    assert watchdog.check(106.0) is True      # 6 s without a step: stall
    return stub


def test_watchdog_stall_drill_captures_then_notes_recovery(tmp_path):
    """The stall captures a bundle; the recovery only notes an event, on
    both engines."""
    def index(url):
        return json.loads(http(url, "/debug/diagnostics")[2])

    server, url = port_server(tmp_path, watchdog_stall_seconds=5.0)
    try:
        stub = _stall(server.watchdog)
        row = wait_bundle(lambda: index(url), "watchdog_stall")
        assert row["detail"]["stalls_total"] == 1
        stub.step_count = 8
        assert server.watchdog.check(107.0) is False
        idx = index(url)
        port_events = [(e["trigger"], e["captured"]) for e in idx["events"]]
        assert [b["trigger"] for b in idx["bundles"]] == ["watchdog_stall"]
    finally:
        server.shutdown()
    jserver = jax_server(tmp_path, watchdog_stall_seconds=5.0)

    async def body(get, post):
        jstub = _stall(jserver.watchdog)
        for _ in range(200):
            idx = json.loads((await get("/debug/diagnostics"))[2])
            if idx["bundles"]:
                break
            await asyncio.sleep(0.05)
        jstub.step_count = 8
        assert jserver.watchdog.check(107.0) is False
        return json.loads((await get("/debug/diagnostics"))[2])

    jidx = run_jax(jserver, body)
    assert port_events == [(e["trigger"], e["captured"])
                           for e in jidx["events"]]
    assert port_events == [("watchdog_stall", True),
                           ("watchdog_recovered", False)]


def test_capture_endpoint_and_retention_over_http(tmp_path):
    """POST /debug/diagnostics/capture answers once the bundle is on
    disk; the archive stays at max_bundles; both engines alike."""
    server, url = port_server(tmp_path)
    try:
        ids = []
        for i in range(4):
            status, _, data = http(url, "/debug/diagnostics/capture", {
                "trigger": "manual", "incident": f"inc-{i}",
                "detail": {"n": i}})
            body = json.loads(data)
            assert status == 200 and body["captured"] is True
            assert server.diagnostics.bundle_path(body["bundle"])
            ids.append(body["bundle"])
        idx = json.loads(http(url, "/debug/diagnostics")[2])
        assert sorted(b["id"] for b in idx["bundles"]) == sorted(ids[-2:])
        port_details = [b["detail"] for b in idx["bundles"]]
        with tarfile.open(fileobj=io.BytesIO(http(
                url, f"/debug/diagnostics/{ids[-1]}")[2]), mode="r:gz") as t:
            manifest = json.load(t.extractfile(f"{ids[-1]}/manifest.json"))
        assert manifest["errors"] == {}
        assert manifest["detail"] == {"n": 3, "incident": "inc-3"}
    finally:
        server.shutdown()
    jserver = jax_server(tmp_path)

    async def body(get, post):
        for i in range(4):
            status, _, _ = await post("/debug/diagnostics/capture", {
                "trigger": "manual", "incident": f"inc-{i}",
                "detail": {"n": i}})
            assert status == 200
        return json.loads((await get("/debug/diagnostics"))[2])

    jidx = run_jax(jserver, body)
    assert port_details == [b["detail"] for b in jidx["bundles"]]
    assert port_details[0]["incident"] == "inc-3"


def test_memory_route_answers_500_on_a_cpu_engine(tmp_path):
    server, url = port_server(tmp_path)
    try:
        status, headers, data = http(url, "/debug/memory")
        assert status == 500
        assert "CPU" in json.loads(data)["error"]["message"]
    finally:
        server.shutdown()


def test_capture_endpoint_refusals(tmp_path):
    """400 with diagnostics off, 409 while another capture holds the
    single-flight gate: the reference's bodies."""
    server, url = port_server(tmp_path, diag={"enabled": False})
    try:
        status, _, data = http(url, "/debug/diagnostics/capture", {})
        assert (status, json.loads(data)) == (
            400, {"captured": False, "reason": "diagnostics disabled"})
        assert json.loads(http(url, "/debug/diagnostics")[2])["enabled"] \
            is False
    finally:
        server.shutdown()
    server, url = port_server(tmp_path)
    try:
        assert server.diagnostics._capture_lock.acquire(blocking=False)
        try:
            status, _, data = http(url, "/debug/diagnostics/capture", {})
        finally:
            server.diagnostics._capture_lock.release()
        assert (status, json.loads(data)) == (
            409, {"captured": False, "reason": "a capture is in flight"})
    finally:
        server.shutdown()


@pytest.mark.parametrize("busy", ["debug_profile", "process_profiler"])
def test_bundle_trace_skips_a_busy_profiler(tmp_path, busy):
    """A bundle's profiler trace yields to /debug/profile's capture and to
    a profiler already enabled in the process: the bundle is captured and
    its manifest records the skipped trace. With the profiler free the
    trace lands."""
    server, url = port_server(tmp_path, diag={"profile_seconds": 0.05})
    try:
        if busy == "debug_profile":
            assert server._profiling.acquire(blocking=False)
            try:
                bid = server.diagnostics.trigger("manual", sync=True)
            finally:
                server._profiling.release()
        else:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                bid = server.diagnostics.trigger("manual", sync=True)
        with open(os.path.join(server.diagnostics.bundle_path(bid),
                               "manifest.json")) as f:
            manifest = json.load(f)
        assert set(manifest["errors"]) == {"trace"}
        assert "trace/" not in manifest["files"]
        bid = server.diagnostics.trigger("manual", force=True, sync=True)
        path = server.diagnostics.bundle_path(bid)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["errors"] == {} and "trace/" in manifest["files"]
        with open(os.path.join(path, "trace", "trace.json")) as f:
            assert "traceEvents" in json.load(f)
        # /debug/profile still works after the bundle's trace
        status, _, _ = http(url, "/debug/profile", {"duration_ms": 10})
        assert status == 200
    finally:
        server.shutdown()


def test_bundle_trace_starts_and_stops_on_the_engine_thread(tmp_path):
    """The profiler's state is the thread's that started it: a bundle's
    trace starts and stops on the engine thread, between steps, while
    requests run, and the capture thread only sleeps and exports."""
    server, url = port_server(tmp_path, diag={"profile_seconds": 0.05})
    seen = []
    real = server._profiler

    class Recording:
        def __init__(self):
            self.prof = real()

        def start(self):
            seen.append(("start", threading.current_thread().name))
            self.prof.start()

        def stop(self):
            seen.append(("stop", threading.current_thread().name))
            self.prof.stop()

        def export_chrome_trace(self, path):
            seen.append(("export", threading.current_thread().name))
            self.prof.export_chrome_trace(path)

    server._profiler = Recording
    body = {"model": "tiny-llama", "prompt": [1, 2, 3, 4], "max_tokens": 24,
            "temperature": 0.0, "ignore_eos": True}
    try:
        with ThreadPoolExecutor(3) as ex:
            answers = [ex.submit(http, url, "/v1/completions", body)
                       for _ in range(2)]
            bid = server.diagnostics.trigger("manual", sync=True)
            assert [a.result()[0] for a in answers] == [200, 200]
        with open(os.path.join(server.diagnostics.bundle_path(bid),
                               "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["errors"] == {} and "trace/" in manifest["files"]
        assert seen[:2] == [("start", "engine-loop"), ("stop", "engine-loop")]
        assert seen[2][0] == "export" and seen[2][1] != "engine-loop"
        assert set(server.last_trace) == {"start_s", "traced_s", "stop_s",
                                          "export_s"}
        assert not torch.autograd.profiler._is_profiler_enabled
        # the process's first profiler start was paid at bind, not here
        assert server.profiler_warmup_seconds is not None
    finally:
        server.shutdown()


def test_wedged_step_skips_the_trace_and_records_why(tmp_path, monkeypatch):
    """A step that holds the engine past the wait (a watchdog stall's
    case) never starts a profiler: the bundle is captured without its
    trace, and the manifest says why."""
    from production_stack_tpu_torch.engine import server as server_mod

    monkeypatch.setattr(server_mod, "ENGINE_WAIT_SECONDS", 0.2)
    server, _ = port_server(tmp_path, diag={"profile_seconds": 0.05})
    try:
        with server.async_engine._cv:  # a step that does not end
            with ThreadPoolExecutor(1) as ex:
                bid = ex.submit(server.diagnostics.trigger, "watchdog_stall",
                                None, True, True).result(30)
        with open(os.path.join(server.diagnostics.bundle_path(bid),
                               "manifest.json")) as f:
            manifest = json.load(f)
        assert set(manifest["errors"]) == {"trace"}
        assert manifest["errors"]["trace"].startswith("TimeoutError")
        assert "trace/" not in manifest["files"]
        assert not torch.autograd.profiler._is_profiler_enabled
    finally:
        server.shutdown()
