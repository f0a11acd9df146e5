"""The port's step watchdog against the JAX package's, on the CPU.

``StepWatchdog.check`` on a synthetic clock goes through the same
transitions as the reference's (stall only while the step counter is
frozen with work queued; idle and paused engines are healthy; progress
recovers), with the same stall count, progress age and hook calls. Then
the port's server with ``watchdog_stall_seconds`` turns ``/ready`` to 503
``stalled`` while a step hangs, and back to 200 when it ends.
"""

import threading
import time

import pytest
import torch

from _torch_parity import engine_configs, http_json, port_engine, \
    tiny_weights
from production_stack_tpu.engine.lifecycle import StepWatchdog as JaxWatchdog
from production_stack_tpu_torch.engine.lifecycle import StepWatchdog
from production_stack_tpu_torch.engine.server import EngineServer

torch.set_num_threads(2)


class _Eng:
    def __init__(self):
        self.unfinished = True

    def has_unfinished(self):
        return self.unfinished


class _AE:
    def __init__(self):
        self.step_count = 0
        self.paused = False
        self.engine = _Eng()


# (clock, step_count, unfinished, paused) the detector is checked at
SCRIPT = [
    (0.0, 0, True, False), (4.0, 0, True, False), (6.0, 0, True, False),
    (6.5, 0, True, False), (7.0, 1, True, False), (9.0, 1, True, False),
    (12.5, 1, True, False), (13.0, 1, False, False), (100.0, 1, False, False),
    (101.0, 1, True, False), (107.0, 1, True, True), (120.0, 1, True, False),
    (126.0, 1, True, False), (126.1, 2, True, False), (200.0, 2, True, False),
]


def _run(cls):
    ae = _AE()
    wd = cls(ae, stall_seconds=5.0)
    hooks = []
    wd.on_stall = lambda d: hooks.append(("stall", d["stalls_total"]))
    wd.on_recover = lambda d: hooks.append(("recover", d["stalls_total"]))
    trace = []
    for now, step, unfinished, paused in SCRIPT:
        ae.step_count, ae.paused = step, paused
        ae.engine.unfinished = unfinished
        trace.append((wd.check(now), wd.stalls_total, wd.progress_age(now)))
    return trace, hooks, wd


def test_watchdog_transitions_match_reference():
    want, want_hooks, ref = _run(JaxWatchdog)
    got, got_hooks, wd = _run(StepWatchdog)
    assert got == want
    assert got_hooks == want_hooks
    assert [s for s, _, _ in got].count(True) >= 3
    assert wd.stalls_total == ref.stalls_total == 4
    assert wd.enabled and wd.interval == ref.interval
    for stall in (0.0, 0.1, 2.0, 40.0):
        assert (StepWatchdog(_AE(), stall).interval
                == JaxWatchdog(_AE(), stall).interval)
        assert StepWatchdog(_AE(), stall).enabled == (stall > 0)


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def test_server_readiness_follows_a_stalled_step(weights):
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=64)
    eng = port_engine(weights, tconf)
    gate = threading.Event()
    step = eng.step

    def wedged_step():
        gate.wait(30)  # a step that hangs until the test lets it go
        return step()

    eng.step = wedged_step
    server = EngineServer(tconf, engine=eng, watchdog_stall_seconds=0.3)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        assert http_json(f"{url}/ready") == (200, {"status": "ready"})
        reply = {}
        t = threading.Thread(target=lambda: reply.update(out=http_json(
            f"{url}/v1/completions", {"prompt": "stall", "max_tokens": 3,
                                      "temperature": 0,
                                      "ignore_eos": True})))
        t.start()
        deadline = time.monotonic() + 10
        while (http_json(f"{url}/ready")[0] == 200
               and time.monotonic() < deadline):
            time.sleep(0.05)
        status, body = http_json(f"{url}/ready")
        assert status == 503 and body["status"] == "stalled"
        assert http_json(f"{url}/health")[0] == 200  # alive
        assert server.metrics.generate().decode().count(
            'vllm:watchdog_stalled{model_name="tiny-llama"} 1.0') == 1
        gate.set()
        t.join(30)
        assert reply["out"][0] == 200
        while (http_json(f"{url}/ready")[0] != 200
               and time.monotonic() < deadline + 10):
            time.sleep(0.05)
        assert http_json(f"{url}/ready") == (200, {"status": "ready"})
        assert server.watchdog.stalls_total == 1
    finally:
        gate.set()
        server.shutdown()
