"""Fleet-lifecycle detectors for an engine: the stuck-step watchdog.

A copy of production_stack_tpu/engine/lifecycle.py. The drain state
machine lives on ``EngineServer`` (it needs the in-flight request table);
this module holds the piece that must NOT share a thread with the engine.

A wedged kernel launch blocks the engine thread *inside*
``engine.step()`` — the server keeps answering ``/health`` 200 while every
request stalls. The watchdog therefore runs on its own daemon thread and
watches ``AsyncEngine.step_count``: when no step completes for
``stall_seconds`` while work is queued, it flips ``stalled`` and the
server's readiness endpoint (``GET /ready``) answers 503 so the router
ejects the engine within one probe interval, while ``/health`` keeps the
process alive for debugging.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from production_stack_tpu_torch.engine.async_engine import AsyncEngine

_log = logging.getLogger("engine.lifecycle")


class StepWatchdog:
    """Detects a wedged engine: no scheduler-step progress while work is
    pending.

    All reads (``step_count``, scheduler queue emptiness) are plain
    attribute/collection reads under the GIL — safe from this thread even
    while the engine thread is blocked mid-dispatch. ``check()`` is the
    whole detector, factored out so tests can drive it with a synthetic
    clock instead of sleeping through real stall windows.
    """

    def __init__(self, async_engine: "AsyncEngine", stall_seconds: float,
                 interval: Optional[float] = None):
        self.async_engine = async_engine
        self.stall_seconds = stall_seconds
        # poll a few times per stall window so detection lags the stall by
        # at most ~stall/4, never slower than 1 s
        self.interval = (interval if interval is not None
                         else max(0.05, min(1.0, stall_seconds / 4.0)))
        self.stalled = False
        self.stalls_total = 0
        # anomaly subscription (engine/diagnostics.py): called with a
        # detail dict at the stall / recovery transitions, from the
        # watchdog thread — subscribers must return fast
        self.on_stall: Optional[Callable[[dict], None]] = None
        self.on_recover: Optional[Callable[[dict], None]] = None
        self._last_step = -1
        self._last_progress = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.stall_seconds > 0

    def start(self) -> None:
        if not self.enabled or (self._thread is not None
                                and self._thread.is_alive()):
            return
        self._stop.clear()
        self._last_progress = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name="step-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.check(time.monotonic())

    def check(self, now: float) -> bool:
        """One detector evaluation; returns the stalled state after it.

        Progress = the step counter moved, OR there is nothing to do (an
        idle engine is healthy, not stalled), OR the engine is deliberately
        paused (sleep mode)."""
        eng = self.async_engine
        step = eng.step_count
        busy = (not eng.paused) and eng.engine.has_unfinished()
        if step != self._last_step or not busy:
            self._last_step = step
            self._last_progress = now
            if self.stalled:
                self.stalled = False
                _log.warning(
                    "step watchdog: engine recovered after %d stall "
                    "episode(s) — readiness restored", self.stalls_total,
                )
                if self.on_recover is not None:
                    self.on_recover({"stalls_total": self.stalls_total,
                                     "step": step})
        elif (not self.stalled
              and now - self._last_progress >= self.stall_seconds):
            self.stalled = True
            self.stalls_total += 1
            if self.on_stall is not None:
                self.on_stall({"stalls_total": self.stalls_total,
                               "stall_seconds": now - self._last_progress,
                               "step": step})
            _log.error(
                "step watchdog: no scheduler-step progress for %.1fs with "
                "work queued — flipping readiness to 503 so the router "
                "ejects this pod (/health stays 200: the process is alive "
                "for debugging)", now - self._last_progress,
            )
        return self.stalled

    def progress_age(self, now: Optional[float] = None) -> float:
        """Seconds since the detector last saw progress (or idleness)."""
        return (now if now is not None else time.monotonic()) \
            - self._last_progress
