"""Fault injection for resilience drills, on the standard library.

A copy of production_stack_tpu/testing/faults.py: ``FaultSpec`` and
``FaultState`` as they are there, and ``inject_faults``, a
standard-library hook in place of the reference's aiohttp middleware. The
port's HTTP handler calls it before routing a ``POST /v1/*`` and carries
out its verdict. The hook rolls the same way as the middleware: the added
latency, then one roll of the state's seeded ``random.Random`` for error
then drop, then the stall, the hang, and last an independent roll for the
stream abort, so a seeded spec gives the same sequence of statuses.

Spec string (flag ``--fault-injection`` or env ``FAULT_INJECTION``;
the flag wins when both are set):

    error_rate=0.3,latency_ms=250,drop_rate=0.05,stall_ms=500,seed=7

  error_rate   probability a request returns 500 before reaching the engine
  latency_ms   added latency per request (before any error/drop decision)
  drop_rate    probability the connection is closed before any response
               byte (a connect-class failure: abrupt reset instead of a
               clean 500 — exercises the client-error failover branch)
  stall_ms     first-byte stall: requests that SURVIVE the error/drop roll
               sleep this long before reaching the handler, modelling a
               sick-but-responding backend (drives the router's latency
               outlier ejection; distinct from latency_ms, which applies
               before the roll and so also delays the injected errors)
  stream_abort_rate      probability the connection is torn down
               ``stream_abort_after_ms`` after the handler starts — the
               client sees valid response bytes, then a mid-stream
               truncation (second independent roll; exercises both the
               router's stream-abort accounting and the engine's
               disconnect-abort KV cleanup)
  stream_abort_after_ms  delay before the mid-stream teardown (default 50)
  hang_after_ms          the handler is admitted, then the request NEVER
               progresses (sleeps forever after this delay): models a
               wedged device dispatch — the pod still answers /health 200
               while every request stalls. Drives the stuck-step watchdog
               and outlier-ejection paths without a real stuck step
  logit_noise_scale      NUMERIC fault: perturb every reported logprob by
               a deterministic pseudo-noise of this magnitude while
               leaving the generated tokens alone — a silent numeric
               drift (wrong fusion, sharding fallback) that every
               availability gauge misses. Drives the correctness
               canary's fingerprint (L-infinity) detection. Applied
               where a fake engine makes its response, not by this
               hook: the fault lives in the payload, not the transport
  wrong_token_at_step    NUMERIC fault: swap the generated token at this
               0-based step for a different one — a greedy-identity
               break (the canary's ``kind="token"`` failure). -1 (the
               default) disables it; applied where a fake engine makes
               its response, like logit_noise_scale
  seed         deterministic PRNG seed (omit for nondeterministic)

error_rate + drop_rate must not exceed 1 (they partition one roll);
stream_abort_rate rolls independently.

Faults apply to POST /v1/* only: health, metrics, and discovery endpoints
stay truthful, mirroring a sick-but-alive backend — the hardest failure
mode for a router (a dead pod is easy; a flaky one must be failed over
per request).
"""

from __future__ import annotations

import dataclasses
import random
import socket
import threading
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    error_rate: float = 0.0
    latency_ms: float = 0.0
    drop_rate: float = 0.0
    stall_ms: float = 0.0
    stream_abort_rate: float = 0.0
    stream_abort_after_ms: float = 50.0
    hang_after_ms: float = 0.0
    logit_noise_scale: float = 0.0
    wrong_token_at_step: int = -1
    seed: Optional[int] = None

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        kwargs = {}
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            key, _, value = item.partition("=")
            key = key.strip()
            if key not in ("error_rate", "latency_ms", "drop_rate",
                           "stall_ms", "stream_abort_rate",
                           "stream_abort_after_ms", "hang_after_ms",
                           "logit_noise_scale", "wrong_token_at_step",
                           "seed"):
                raise ValueError(f"unknown fault key {key!r}")
            kwargs[key] = (int(value)
                           if key in ("seed", "wrong_token_at_step")
                           else float(value))
        spec_obj = cls(**kwargs)
        if not 0 <= spec_obj.error_rate <= 1 or not 0 <= spec_obj.drop_rate <= 1:
            raise ValueError("rates must be in [0, 1]")
        if not 0 <= spec_obj.stream_abort_rate <= 1:
            raise ValueError("rates must be in [0, 1]")
        if spec_obj.error_rate + spec_obj.drop_rate > 1:
            raise ValueError("error_rate + drop_rate must not exceed 1 "
                             "(they partition one roll)")
        if spec_obj.latency_ms < 0 or spec_obj.stall_ms < 0 \
                or spec_obj.stream_abort_after_ms < 0 \
                or spec_obj.hang_after_ms < 0:
            raise ValueError("latency_ms/stall_ms/stream_abort_after_ms/"
                             "hang_after_ms must be >= 0")
        if spec_obj.logit_noise_scale < 0:
            raise ValueError("logit_noise_scale must be >= 0")
        if spec_obj.wrong_token_at_step < -1:
            raise ValueError("wrong_token_at_step must be >= 0, or -1 "
                             "to disable")
        return spec_obj

    @property
    def active(self) -> bool:
        return bool(self.error_rate or self.latency_ms or self.drop_rate
                    or self.stall_ms or self.stream_abort_rate
                    or self.hang_after_ms or self.logit_noise_scale
                    or self.wrong_token_at_step >= 0)


class FaultState:
    """Mutable holder so faults can be flipped on a LIVE engine (the
    server's POST /debug/faults) — a drill shouldn't need a pod restart."""

    def __init__(self, spec: Optional[FaultSpec] = None):
        self.set(spec)

    def set(self, spec: Optional[FaultSpec]) -> None:
        self.spec = spec if spec is not None and spec.active else None
        self.rng = random.Random(spec.seed if spec is not None else None)
        # monotonic stamp of the first request currently wedged by
        # hang_after_ms (None once faults change): lets a fake engine's
        # watchdog emulation flip readiness off the same signal a real
        # engine's StepWatchdog derives from its step counter
        self.last_hang_t: Optional[float] = None


PASS = "pass"  # hand the request to its route
ERROR = "error"  # answer 500 with ERROR_BODY
DROP = "drop"  # close the connection before any response byte

ERROR_BODY = {"error": {"message": "injected fault",
                        "type": "fault_injection"}}


def _close(connection) -> None:
    """Tear a connection down under its handler (the stream abort)."""
    try:
        connection.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def inject_faults(state: FaultState, method: str, path: str,
                  connection=None, stop: Optional[threading.Event] = None):
    """Roll ``state``'s faults for one request; returns ``(verdict,
    timer)``. ``verdict`` is PASS, ERROR or DROP; ``timer``, when not
    None, is a started timer that tears ``connection`` down
    ``stream_abort_after_ms`` from now, which the caller cancels once its
    route has answered. Only ``POST /v1/*`` is faulted. The sleeps and the
    hang wait on ``stop``, so a server shutting down is never held by an
    injected fault: a hung request is dropped when ``stop`` is set."""
    spec = state.spec
    rng = state.rng
    if spec is None or method != "POST" or not path.startswith("/v1/"):
        return PASS, None
    stop = stop if stop is not None else threading.Event()
    if spec.latency_ms:
        stop.wait(spec.latency_ms / 1000.0)
    roll = rng.random()
    if roll < spec.error_rate:
        return ERROR, None
    if roll < spec.error_rate + spec.drop_rate:
        # an abrupt reset before any response byte: the client sees a
        # connection error, not a clean 500
        return DROP, None
    if spec.stall_ms:
        # first-byte stall after the roll: only surviving requests pay it,
        # so the backend looks slow but correct
        stop.wait(spec.stall_ms / 1000.0)
    if spec.hang_after_ms:
        # admitted, then wedged: the request never progresses and never
        # errors, like a stuck device dispatch seen from the router
        stop.wait(spec.hang_after_ms / 1000.0)
        if state.last_hang_t is None:
            state.last_hang_t = time.monotonic()
        stop.wait()
        return DROP, None
    if spec.stream_abort_rate and rng.random() < spec.stream_abort_rate:
        # mid-stream truncation: the route starts answering, then the
        # connection is torn down under it
        if connection is None:
            return PASS, None
        timer = threading.Timer(spec.stream_abort_after_ms / 1000.0,
                                _close, (connection,))
        timer.daemon = True
        timer.start()
        return PASS, timer
    return PASS, None
