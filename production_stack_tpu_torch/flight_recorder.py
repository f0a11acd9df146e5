"""Flight recorder: a bounded in-memory ring of per-request timelines, so
a slow or failed request can be reconstructed after the fact without a
tracing backend. A copy of production_stack_tpu/flight_recorder.py: the
engine's server keeps one, and records are joined across tiers by the
propagated x-request-id (the router keeps its own).

A record is a plain dict. The producer calls begin() when the request
arrives, fills the dict in as stages complete (timeline stamps, token
counts), and finish() freezes it into the ring. Only finished records are
served from GET /debug/requests: an open dict stays private to its request
handler and the engine thread that merges its stamps.

The port's handlers are threads, and the engine thread merges stamps into
open records, so the lock below is what keeps append and snapshot
consistent.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_SIZE = 256


class FlightRecorder:
    def __init__(self, size: int = DEFAULT_SIZE):
        self.size = max(1, int(size))
        self._ring: deque = deque(maxlen=self.size)  # guarded-by: _lock
        # the critical sections are pure in-memory deque operations
        self._lock = threading.Lock()
        self._dropped = 0  # guarded-by: _lock
        self._total = 0  # guarded-by: _lock

    def begin(self, **fields: Any) -> Dict[str, Any]:
        """Open a record. Not yet visible in snapshot()."""
        rec: Dict[str, Any] = {
            "received_unix": time.time(),
            "timeline": {"received": time.monotonic()},
            "attempts": [],
        }
        rec.update(fields)
        return rec

    def stamp(self, rec: Dict[str, Any], stage: str,
              at: Optional[float] = None) -> None:
        rec["timeline"][stage] = time.monotonic() if at is None else at

    def finish(self, rec: Dict[str, Any], **fields: Any) -> Dict[str, Any]:
        """Freeze the record into the ring; call once per record."""
        rec.update(fields)
        rec["timeline"].setdefault("finished", time.monotonic())
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(rec)
            self._total += 1
        return rec

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Finished records, newest first."""
        with self._lock:
            records = list(self._ring)
        records.reverse()
        if limit is not None:
            records = records[: max(0, int(limit))]
        return records

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": self.size, "recorded": len(self._ring),
                    "total": self._total, "dropped": self._dropped}
