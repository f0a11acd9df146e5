"""Threaded facade over the synchronous LLMEngine.

Ports production_stack_tpu/engine/async_engine.py to threads: one engine
thread owns the device and steps the engine whenever it has work; HTTP
handler threads admit requests and read their outputs from per-request
``queue.Queue`` streams. A ``threading.Condition`` guards the engine, so
admission and abort happen between steps, never during one. The lock is
handed over fairly: the engine thread waits between steps while another
thread is waiting to enter (``_entry``), or a busy engine would re-take it
at once, step after step, and starve admission and abort. Control-plane
work that touches device state (loading a LoRA adapter, a KV transfer's
gathers and scatters) runs on the engine thread itself, between steps
(``run_on_engine``); ``attach_spliced`` enters a pushed P->D transfer as a
decode row.

Two hooks feed the server's histograms from the engine thread:
``step_observer(seconds)`` after each step (the scheduler-step duration)
and ``finish_observer(output)`` with each finished request's output, whose
arrival, admission, first-token and finish stamps the latency histograms
read.

Sleep mode (``sleep``, ``wake_up``, ``is_sleeping``): while ``paused`` the
engine thread runs control-plane calls but no step, so a request admitted
while asleep waits for ``wake_up``, as in the reference.

A request carries its tenant into the engine (the sixth field of an
``admit_batch`` tuple, ``attach_spliced``'s ``tenant``). A stream given a
``deadline`` (epoch seconds, the router's ``x-request-deadline``) raises
``DeadlineExceeded`` from its iterator once the deadline passes with no
output waiting: the reference's ``asyncio.wait_for`` as a timed wait on
the stream's queue. The caller then aborts the request (``abort``), which
frees its KV blocks.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import queue
import threading
import time
from typing import Callable, Iterator, Optional

from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import RequestOutput

_log = logging.getLogger(__name__)


class EngineStepError(RuntimeError):
    """Delivered on a request's stream when an engine step failed while
    the request was in flight."""


class DeadlineExceeded(Exception):
    """A request's deadline passed before it finished (or, raised by the
    server, before it was admitted)."""


class RequestStream:
    """Outputs of one request, in order, until the finished one. With a
    ``deadline`` (epoch seconds) the iterator raises DeadlineExceeded
    once it passes with no output waiting."""

    def __init__(self, request_id: str, deadline: Optional[float] = None):
        self.request_id = request_id
        self.deadline = deadline
        self._q: queue.Queue = queue.Queue()

    def put(self, item) -> None:
        self._q.put(item)

    def _get(self):
        if self.deadline is None:
            return self._q.get()
        try:
            return self._q.get(timeout=max(self.deadline - time.time(), 0.0))
        except queue.Empty:
            raise DeadlineExceeded("request deadline exceeded") from None

    def __iter__(self) -> Iterator[RequestOutput]:
        while True:
            item = self._get()
            if isinstance(item, BaseException):
                raise item
            yield item
            if item.finished:
                return


class AsyncEngine:
    def __init__(self, engine: LLMEngine):
        self.engine = engine
        self._cv = threading.Condition()
        # threads other than the engine's waiting to take self._cv
        self._entering = 0
        self._entering_lock = threading.Lock()
        self._streams: dict[str, RequestStream] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # (fn, future) pairs the engine thread runs before its next step
        self._calls: collections.deque = collections.deque()
        self.step_count = 0
        # sleep mode: no step runs while set; the watchdog
        # (engine/lifecycle.py) counts a paused engine as progressing
        self.paused = False
        # called on the engine thread with each step's wall seconds, and
        # with each finished request's RequestOutput
        self.step_observer: Optional[Callable[[float], None]] = None
        self.finish_observer: Optional[Callable[[RequestOutput], None]] = None
        # (arrival, first_token, finish, output tokens) monotonic stamps of
        # recently finished requests: the time-to-first-token record
        self.finished: collections.deque = collections.deque(maxlen=4096)

    @contextlib.contextmanager
    def _entry(self):
        """Take the engine lock from a thread other than the engine's; the
        engine thread lets it in before its next step."""
        with self._entering_lock:
            self._entering += 1
        try:
            self._cv.acquire()
        finally:
            with self._entering_lock:
                self._entering -= 1
        try:
            yield
        finally:
            self._cv.release()

    def start(self) -> None:
        with self._entry():
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-loop")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        with self._entry():
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
            while self._entering:  # a caller waits to get between steps
                time.sleep(0.0001)
            with self._cv:
                while (self._running and not self._calls
                       and (self.paused
                            or not self.engine.has_unfinished())):
                    self._cv.wait()
                if not self._running:
                    return
                while self._calls:
                    fn, fut = self._calls.popleft()
                    try:
                        fut.set_result(fn(self.engine))
                    except Exception as e:  # the caller gets the error
                        fut.set_exception(e)
                if self.paused or not self.engine.has_unfinished():
                    continue
                t_step = time.monotonic()
                try:
                    outputs = self.engine.step()
                except Exception as e:  # the loop must outlive a bad step
                    _log.exception("engine.step failed")
                    self._fail_all(EngineStepError(f"engine step failed: {e}"))
                    continue
                self.step_count += 1
                self._observe(self.step_observer, time.monotonic() - t_step)
                for out in outputs:
                    if out.finished:
                        self.finished.append(
                            (out.arrival_time, out.first_token_time,
                             out.finish_time, out.num_output_tokens))
                        self._observe(self.finish_observer, out)
                    stream = self._streams.get(out.request_id)
                    if stream is None:
                        continue
                    stream.put(out)
                    if out.finished:
                        del self._streams[out.request_id]

    @staticmethod
    def _observe(hook, arg) -> None:
        if hook is None:
            return
        try:
            hook(arg)
        except Exception:  # an observer never stops the engine
            _log.debug("engine observer hook failed", exc_info=True)

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
        with self._entry():
            if not self._running:
                return fn(self.engine)
            self._calls.append((fn, fut))
            self._cv.notify_all()
        return fut.result()

    def admit_batch(
        self, reqs: list[tuple]
    ) -> list[RequestStream]:
        """Admit every (request_id, prompt_token_ids, sampling[,
        adapter_slot[, pin_on_finish[, tenant]]]) or none: if one is
        refused, the ones already added are aborted and the error is raised
        to the caller before it answers."""
        with self._entry():
            added: list[str] = []
            try:
                for rid, prompt_ids, sampling, *rest in reqs:
                    self.engine.add_request(
                        rid, prompt_token_ids=prompt_ids, sampling=sampling,
                        adapter_slot=rest[0] if rest else 0,
                        pin_on_finish=len(rest) > 1 and bool(rest[1]),
                        tenant=rest[2] if len(rest) > 2 else "anonymous")
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

    def attach_spliced(self, request_id: str, prompt_token_ids: list[int],
                       first_token: int, sampling, blocks: list[int],
                       adapter_slot: int = 0,
                       tenant: str = "anonymous") -> RequestStream:
        """Splice a landed P->D transfer in as a decode row
        (``LLMEngine.splice_request``) and return its stream. On failure
        (no decode slot, bad lengths) nothing is registered, the error is
        raised and the caller still owns ``blocks``."""
        with self._entry():
            self.engine.splice_request(request_id, prompt_token_ids,
                                       first_token, sampling, blocks,
                                       adapter_slot=adapter_slot,
                                       tenant=tenant)
            stream = RequestStream(request_id)
            self._streams[request_id] = stream
            self._cv.notify_all()
            return stream

    # -- sleep mode ----------------------------------------------------------
    def sleep(self, level: int = 1) -> None:
        """Stop stepping, then drop the pool (and at level 2 the weights)
        on the engine thread. With unfinished requests the engine refuses:
        stepping resumes and the RuntimeError is raised (the reference's
        server un-pauses the same way)."""
        self.paused = True
        try:
            self.run_on_engine(lambda eng: eng.sleep_mode(level))
        except RuntimeError:
            self._resume()
            raise

    def wake_up(self) -> None:
        self.run_on_engine(lambda eng: eng.wake_mode())
        self._resume()

    def _resume(self) -> None:
        with self._entry():
            self.paused = False
            self._cv.notify_all()

    @property
    def is_sleeping(self) -> bool:
        return self.paused

    def abort(self, request_id: str) -> None:
        """Abort a request between steps. A consumer still reading its
        stream gets a last, finished output (reason ``abort``) rather than
        waiting forever."""
        with self._entry():
            stream = self._streams.pop(request_id, None)
            if self.engine.abort_request(request_id) and stream is not None:
                stream.put(RequestOutput(
                    request_id=request_id, new_token_ids=[], finished=True,
                    finish_reason="abort", num_prompt_tokens=0,
                    num_output_tokens=0))
