"""Anomaly-triggered diagnostic bundles, a copy of
production_stack_tpu/engine/diagnostics.py.

The engine raises bug signals (an unexpected recompile, a watchdog stall,
a drain-deadline abort, device-memory pressure, a cost-model drift
episode), but when one fires the evidence (a profiler trace, the flight
recorder's timelines, the perf and KV snapshots) is gone unless an
operator was already reading ``/debug/*`` on the right pod.
``DiagnosticsManager`` closes that gap: subscribed to those signals, it
captures a *bundle* (a directory of JSON snapshots plus optional binary
artifacts: on the port's engine a short ``torch.profiler`` trace and a
``torch.cuda.memory._snapshot()`` pickle) into a bounded, size-capped
on-disk archive, indexed at ``GET /debug/diagnostics`` with a tar.gz
download a bundle.

Serving-path guarantees, by construction:

* **async** — ``trigger()`` never captures inline; it spawns a daemon
  thread and returns at once, so it is safe to call from the engine
  thread, the watchdog thread or a handler thread.
* **single-flight** — one capture at a time; overlapping triggers are
  counted as dropped, never queued.
* **time-bounded** — the only slow artifact (the profiler trace) runs for
  a capped, configured duration inside the capture thread; every
  collector is best-effort (its error is recorded in the manifest instead
  of failing the bundle).
* **bounded on disk** — after every capture the archive is trimmed to
  ``max_bundles`` / ``max_bytes``, oldest first.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tarfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

_EVENT_TAIL = 64  # anomaly events kept for the /debug/diagnostics index

_log = logging.getLogger(__name__)


@dataclass
class DiagnosticsConfig:
    """The archive's knobs (helm: ``engineConfig.diagnostics*``)."""

    enabled: bool = True
    dir: str = ""               # "" → <tmpdir>/pstpu-diagnostics-<pid>
    max_bundles: int = 16       # count retention cap
    max_bytes: int = 256 * 1024 * 1024   # size retention cap
    cooldown: float = 60.0      # per-trigger seconds between captures
    profile_seconds: float = 0.0  # profiler trace length; 0 = no trace
    hbm_threshold: float = 0.92   # device-memory pressure trigger fraction

    def resolved_dir(self) -> str:
        if self.dir:
            return self.dir
        import tempfile

        return os.path.join(tempfile.gettempdir(),
                            f"pstpu-diagnostics-{os.getpid()}")


@dataclass
class _Bundle:
    id: str
    trigger: str
    tier: str
    ts: float
    path: str
    bytes: int = 0
    capture_seconds: float = 0.0
    detail: dict = field(default_factory=dict)

    def row(self) -> dict:
        return {"id": self.id, "trigger": self.trigger, "tier": self.tier,
                "ts": self.ts, "bytes": self.bytes,
                "capture_seconds": round(self.capture_seconds, 4),
                "detail": self.detail}


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class DiagnosticsManager:
    """Captures anomaly-triggered diagnostic bundles into a bounded
    on-disk archive.  Thread-safe; every entry point returns fast."""

    def __init__(self, config: DiagnosticsConfig, tier: str = "engine",
                 collectors: Optional[Dict[str, Callable[[], Any]]] = None,
                 profile_fn: Optional[Callable[[str], bool]] = None,
                 on_bundle: Optional[Callable[["_Bundle"], None]] = None,
                 clock: Callable[[], float] = time.time):
        self.config = config
        self.tier = tier
        self.collectors: Dict[str, Callable[[], Any]] = dict(collectors or {})
        self.profile_fn = profile_fn
        self.on_bundle = on_bundle
        self.clock = clock
        self.dir = config.resolved_dir()
        self._lock = threading.Lock()          # index / counters
        self._capture_lock = threading.Lock()  # single-flight gate
        self._seq = 0
        self._last_capture: Dict[str, float] = {}   # trigger → ts
        self._bundles: list[_Bundle] = []
        self.events: deque = deque(maxlen=_EVENT_TAIL)
        # the source of the vllm:diagnostic_* families (engine/metrics.py
        # reads stats() at scrape time)
        self.bundles_total: Dict[str, int] = {}
        self.dropped_total: Dict[str, int] = {}
        self.capture_seconds_sum = 0.0
        self.capture_seconds_count = 0
        if config.enabled:
            os.makedirs(self.dir, exist_ok=True)
            self._load_existing()

    # -- archive bootstrap ---------------------------------------------------
    def _load_existing(self) -> None:
        """Re-index bundles a previous process left behind (same dir), so
        restart never orphans evidence below the retention caps."""
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return
        for name in names:
            path = os.path.join(self.dir, name)
            manifest = os.path.join(path, "manifest.json")
            if not os.path.isfile(manifest):
                continue
            try:
                with open(manifest) as f:
                    m = json.load(f)
                self._bundles.append(_Bundle(
                    id=m["id"], trigger=m.get("trigger", "?"),
                    tier=m.get("tier", self.tier), ts=m.get("ts", 0.0),
                    path=path, bytes=_dir_bytes(path),
                    capture_seconds=m.get("capture_seconds", 0.0),
                    detail=m.get("detail", {})))
            except Exception:
                _log.debug("skipping unreadable bundle manifest under %s",
                           path, exc_info=True)
                continue

    # -- event log (no capture) ----------------------------------------------
    def note(self, trigger: str, detail: Optional[dict] = None) -> None:
        """Record an anomaly event in the index without capturing a
        bundle (e.g. watchdog recovery: the evidence was captured at the
        stall; the recovery is just a timestamped fact)."""
        with self._lock:
            self.events.append({"trigger": trigger, "ts": self.clock(),
                                "captured": False,
                                "detail": detail or {}})

    # -- trigger → async capture ---------------------------------------------
    def trigger(self, trigger: str, detail: Optional[dict] = None,
                force: bool = False,
                sync: bool = False) -> Optional[str]:
        """Request a bundle capture. Returns the bundle id, or None when
        the capture was skipped (disabled / cooldown / one already in
        flight).  ``force`` bypasses the per-trigger cooldown (used by
        correlated incident fan-out, which must not be rate-limited away
        from its incident).  ``sync`` blocks until the capture finishes —
        tests and the HTTP capture endpoint's executor use it; signal
        paths never do."""
        if not self.config.enabled:
            return None
        now = self.clock()
        with self._lock:
            last = self._last_capture.get(trigger, 0.0)
            if not force and now - last < self.config.cooldown:
                self.dropped_total[trigger] = \
                    self.dropped_total.get(trigger, 0) + 1
                self.events.append({"trigger": trigger, "ts": now,
                                    "captured": False,
                                    "dropped": "cooldown",
                                    "detail": detail or {}})
                return None
        if not self._capture_lock.acquire(blocking=False):
            # single-flight: a capture is running; drop, never queue
            with self._lock:
                self.dropped_total[trigger] = \
                    self.dropped_total.get(trigger, 0) + 1
                self.events.append({"trigger": trigger, "ts": now,
                                    "captured": False,
                                    "dropped": "in_flight",
                                    "detail": detail or {}})
            return None
        with self._lock:
            self._seq += 1
            self._last_capture[trigger] = now
            bundle_id = f"{int(now * 1000):013d}-{self._seq:04d}-{trigger}"
            self.events.append({"trigger": trigger, "ts": now,
                                "captured": True, "bundle": bundle_id,
                                "detail": detail or {}})
        if sync:
            try:
                self._capture(bundle_id, trigger, detail or {}, now)
            finally:
                self._capture_lock.release()
        else:
            def _run() -> None:
                try:
                    self._capture(bundle_id, trigger, detail or {}, now)
                finally:
                    self._capture_lock.release()

            threading.Thread(target=_run, daemon=True,
                             name=f"diag-capture-{trigger}").start()
        return bundle_id

    # -- capture (runs on the capture thread) --------------------------------
    def _capture(self, bundle_id: str, trigger: str, detail: dict,
                 ts: float) -> None:
        t0 = time.monotonic()
        path = os.path.join(self.dir, bundle_id)
        os.makedirs(path, exist_ok=True)
        errors: Dict[str, str] = {}
        files: list[str] = []
        for name, fn in list(self.collectors.items()):
            try:
                self._write(path, name, fn())
                files.append(name)
            except Exception as e:  # best-effort: record, keep going
                errors[name] = f"{type(e).__name__}: {e}"
        if self.profile_fn is not None and self.config.profile_seconds > 0:
            trace_dir = os.path.join(path, "trace")
            try:
                if self.profile_fn(trace_dir):
                    files.append("trace/")
                else:
                    errors["trace"] = "profiler busy (a /debug/profile " \
                                      "capture is running)"
            except Exception as e:
                errors["trace"] = f"{type(e).__name__}: {e}"
        capture_seconds = time.monotonic() - t0
        manifest = {
            "id": bundle_id, "trigger": trigger, "tier": self.tier,
            "ts": ts, "detail": detail, "files": sorted(files),
            "errors": errors,
            "capture_seconds": round(capture_seconds, 4),
        }
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        bundle = _Bundle(id=bundle_id, trigger=trigger, tier=self.tier,
                         ts=ts, path=path, bytes=_dir_bytes(path),
                         capture_seconds=capture_seconds, detail=detail)
        with self._lock:
            self._bundles.append(bundle)
            self.bundles_total[trigger] = \
                self.bundles_total.get(trigger, 0) + 1
            self.capture_seconds_sum += capture_seconds
            self.capture_seconds_count += 1
            evicted = self._plan_retention_locked()
        for old in evicted:
            shutil.rmtree(old.path, ignore_errors=True)
        if self.on_bundle is not None:
            try:
                self.on_bundle(bundle)
            except Exception:
                _log.debug("on_bundle hook failed for %s", bundle.id,
                           exc_info=True)

    @staticmethod
    def _write(path: str, name: str, value: Any) -> None:
        dest = os.path.join(path, name)
        if isinstance(value, bytes):
            with open(dest, "wb") as f:
                f.write(value)
        elif isinstance(value, str):
            with open(dest, "w") as f:
                f.write(value)
        else:
            with open(dest, "w") as f:
                json.dump(value, f, indent=1, default=str)

    def _plan_retention_locked(self) -> list[_Bundle]:
        """Oldest-first eviction down to the count and byte caps; returns
        the evicted bundles (deleted outside the lock)."""
        evicted: list[_Bundle] = []
        self._bundles.sort(key=lambda b: b.id)
        while len(self._bundles) > max(self.config.max_bundles, 1):
            evicted.append(self._bundles.pop(0))
        total = sum(b.bytes for b in self._bundles)
        while len(self._bundles) > 1 and total > self.config.max_bytes:
            old = self._bundles.pop(0)
            total -= old.bytes
            evicted.append(old)
        return evicted

    # -- index / download ----------------------------------------------------
    def index(self) -> dict:
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "tier": self.tier,
                "dir": self.dir,
                "retention": {"max_bundles": self.config.max_bundles,
                              "max_bytes": self.config.max_bytes,
                              "cooldown_seconds": self.config.cooldown},
                "bundles": [b.row() for b in
                            sorted(self._bundles, key=lambda b: b.id,
                                   reverse=True)],
                "bundles_total": dict(self.bundles_total),
                "dropped_total": dict(self.dropped_total),
                "events": list(self.events),
            }

    def bundle_path(self, bundle_id: str) -> Optional[str]:
        if os.sep in bundle_id or bundle_id.startswith("."):
            return None  # never a path traversal
        with self._lock:
            for b in self._bundles:
                if b.id == bundle_id:
                    return b.path
        return None

    def tar_bundle(self, bundle_id: str) -> Optional[bytes]:
        """tar.gz of one bundle (blocking)."""
        import io

        path = self.bundle_path(bundle_id)
        if path is None or not os.path.isdir(path):
            return None
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            tar.add(path, arcname=bundle_id)
        return buf.getvalue()

    # -- metrics source ------------------------------------------------------
    def stats(self) -> dict:
        """Scrape-time source for the vllm:diagnostic_* families."""
        with self._lock:
            return {
                "bundles_total": dict(self.bundles_total),
                "dropped_total": dict(self.dropped_total),
                "capture_seconds_sum": self.capture_seconds_sum,
                "capture_seconds_count": self.capture_seconds_count,
            }
