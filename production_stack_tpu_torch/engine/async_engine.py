"""Threaded facade over the synchronous LLMEngine.

Ports production_stack_tpu/engine/async_engine.py to threads: one engine
thread owns the device and steps the engine whenever it has work; HTTP
handler threads admit requests and read their outputs from per-request
``queue.Queue`` streams. A ``threading.Condition`` guards the engine, so
admission and abort happen between steps, never during one. Control-plane
work that touches device state (loading a LoRA adapter) runs on the engine
thread itself, between steps (``run_on_engine``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import queue
import threading
from typing import Callable, Iterator, Optional

from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import RequestOutput

_log = logging.getLogger(__name__)


class EngineStepError(RuntimeError):
    """Delivered on a request's stream when an engine step failed while
    the request was in flight."""


class RequestStream:
    """Outputs of one request, in order, until the finished one."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._q: queue.Queue = queue.Queue()

    def put(self, item) -> None:
        self._q.put(item)

    def __iter__(self) -> Iterator[RequestOutput]:
        while True:
            item = self._q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
            if item.finished:
                return


class AsyncEngine:
    def __init__(self, engine: LLMEngine):
        self.engine = engine
        self._cv = threading.Condition()
        self._streams: dict[str, RequestStream] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # (fn, future) pairs the engine thread runs before its next step
        self._calls: collections.deque = collections.deque()
        self.step_count = 0
        # (arrival, first_token, finish, output tokens) monotonic stamps of
        # recently finished requests: the time-to-first-token record
        self.finished: collections.deque = collections.deque(maxlen=4096)

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-loop")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
            while self._calls:
                _, fut = self._calls.popleft()
                fut.set_exception(RuntimeError("the engine was stopped"))
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("engine thread did not stop")
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (self._running and not self._calls
                       and not self.engine.has_unfinished()):
                    self._cv.wait()
                if not self._running:
                    return
                while self._calls:
                    fn, fut = self._calls.popleft()
                    try:
                        fut.set_result(fn(self.engine))
                    except Exception as e:  # the caller gets the error
                        fut.set_exception(e)
                if not self.engine.has_unfinished():
                    continue
                try:
                    outputs = self.engine.step()
                except Exception as e:  # the loop must outlive a bad step
                    _log.exception("engine.step failed")
                    self._fail_all(EngineStepError(f"engine step failed: {e}"))
                    continue
                self.step_count += 1
                for out in outputs:
                    if out.finished:
                        self.finished.append(
                            (out.arrival_time, out.first_token_time,
                             out.finish_time, out.num_output_tokens))
                    stream = self._streams.get(out.request_id)
                    if stream is None:
                        continue
                    stream.put(out)
                    if out.finished:
                        del self._streams[out.request_id]

    def _fail_all(self, err: Exception) -> None:
        for rid, stream in list(self._streams.items()):
            self.engine.abort_request(rid)
            stream.put(err)
        self._streams.clear()

    def run_on_engine(self, fn: Callable):
        """Run ``fn(engine)`` on the engine thread between steps; return
        its result, or raise its error, to the caller. Without a running
        engine thread it runs here, under the engine's lock."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cv:
            if not self._running:
                return fn(self.engine)
            self._calls.append((fn, fut))
            self._cv.notify_all()
        return fut.result()

    def admit_batch(
        self, reqs: list[tuple]
    ) -> list[RequestStream]:
        """Admit every (request_id, prompt_token_ids, sampling[,
        adapter_slot]) or none: if one is refused, the ones already added
        are aborted and the error is raised to the caller before it
        answers."""
        with self._cv:
            added: list[str] = []
            try:
                for rid, prompt_ids, sampling, *rest in reqs:
                    self.engine.add_request(rid, prompt_token_ids=prompt_ids,
                                            sampling=sampling,
                                            adapter_slot=(rest[0] if rest
                                                          else 0))
                    added.append(rid)
            except Exception:
                for rid in added:
                    self.engine.abort_request(rid)
                raise
            streams = []
            for rid in added:
                stream = RequestStream(rid)
                self._streams[rid] = stream
                streams.append(stream)
            self._cv.notify_all()
            return streams

    def abort(self, request_id: str) -> None:
        with self._cv:
            self._streams.pop(request_id, None)
            self.engine.abort_request(request_id)
