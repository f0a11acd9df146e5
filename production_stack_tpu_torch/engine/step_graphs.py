"""The decode step's CUDA graphs: static inputs, their host staging, the
graph cache and deferred fetches.

No single module of production_stack_tpu matches this one: it plays the
part of jit's executable cache for the reference's compiled decode program
(production_stack_tpu/engine/model_runner.py ``_decode_multi``, one
executable a static-flag variant), on the card.

- ``StaticInputs``: every input of the decode step in one device byte
  buffer at a fixed address, each field a typed view of it. A step's host
  arrays go up through one pinned staging buffer and one copy (the eager
  step made ~15 pageable uploads, which a graph cannot capture). The
  staging buffer comes from PyTorch's pinned-memory cache each step, and
  the cache hands it out again only once the copy that read it has run
  (``copy_`` records that), so the host may stage step n + 1 while step
  n's copy is still queued.
- ``DecodeGraphs``: one CUDA graph a key (the model runner's
  ``DecodeKey``), captured on a side stream after one eager warm-up there
  (cuBLAS's workspace for that stream and the kernels' shared-memory
  opt-ins are made outside the capture), into one memory pool that every
  decode graph shares; its outputs are static tensors of that pool. A
  capture records launches without making them, so the kernels' launch
  counters (ops/_build.py) are set back after it, and each replay adds the
  launches the capture recorded. ``drop_all`` releases every graph and the
  pool (sleep mode, before the KV pool, the weights or cuBLAS's workspaces
  go) and returns the keys that were held.
- ``Deferred``: device results copied into pinned host memory behind an
  event, read when the host needs them: the chained decode's fetch one
  dispatch later, and the blocking fetch as one wait for every output.

A capture or a replay that fails raises: nothing here falls back to the
eager step.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from production_stack_tpu_torch.ops import _build

# field offsets in the staging and device buffers
ALIGN = 64
# the side stream every decode graph is warmed up and captured on: one a
# process, since cuBLAS keeps a workspace for each stream it has run on
# until the workspaces are cleared (sleep mode), and an engine made after
# another would otherwise leave one more behind
_capture_stream: Optional[torch.cuda.Stream] = None
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}


class StaticInputs:
    """Named inputs at fixed device addresses, filled from the host in one
    copy a step. ``fields`` is ``[(name, numpy dtype, shape), ...]``;
    ``views[name]`` is the field's device tensor. ``empty`` maps a field to
    the value it holds in a batch without live rows (0 where not named)."""

    def __init__(self, fields, device, empty: Optional[dict] = None):
        self.device = torch.device(device)
        self.layout = []
        off = 0
        for name, dtype, shape in fields:
            dt = np.dtype(dtype)
            n = int(np.prod(shape)) * dt.itemsize
            self.layout.append((name, dt, tuple(shape), off, n))
            off += -(-n // ALIGN) * ALIGN
        self.nbytes = off
        self.empty = dict(empty or {})
        self.buf = torch.zeros(off, dtype=torch.uint8, device=self.device)
        self.views = {
            name: self.buf[o:o + n].view(_TORCH_DTYPES[dt]).view(shape)
            for name, dt, shape, o, n in self.layout}

    def stage(self, values: dict) -> None:
        """Write every field's host value into a staging buffer and copy it
        up in one transfer, queued on the current stream."""
        host = torch.empty(self.nbytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        raw = host.numpy()
        for name, dt, shape, o, n in self.layout:
            raw[o:o + n].view(dt).reshape(shape)[...] = values[name]
        self.buf.copy_(host, non_blocking=True)

    def clear(self) -> None:
        """Every row inactive: the state a graph is captured from, so the
        warm-up run before a capture writes no KV and counts no token."""
        self.buf.zero_()
        for name, value in self.empty.items():
            self.views[name].fill_(value)


class GraphEntry:
    """One captured graph, its static outputs and the kernel launches one
    replay makes."""

    def __init__(self, graph, outputs, launches: dict):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for counter, n in self.launches.items():
            counter.n += n


class DecodeGraphs:
    """The graph cache: ``capture``, ``replay`` through the entry,
    ``drop_all``. ``capture`` is a stand-in for CUDA's capture that a test
    may inject (``stand_in(warm, record) -> (graph, outputs)``, where
    ``warm()`` runs the step eagerly and ``record()`` runs it under the
    capture); the model runner never passes one."""

    def __init__(self, capture: Optional[Callable] = None):
        self.entries: dict = {}
        self._capture = capture if capture is not None else self._cuda_capture
        self._pool = None
        self.captures = 0
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        return len(self.entries)

    def _cuda_capture(self, warm: Callable, record: Callable):
        global _capture_stream
        if _capture_stream is None:
            _capture_stream = torch.cuda.Stream()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = _capture_stream
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            warm()
            # thread_local: the server's other threads (scrapes, memory
            # polls) may call the CUDA runtime while the engine captures
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                outputs = record()
            finally:
                graph.capture_end()
        current.wait_stream(stream)
        return graph, outputs

    def capture(self, key, body: Callable) -> GraphEntry:
        """Capture ``body()`` (which returns its output tensors) as the
        graph of ``key``."""
        counts: dict = {}

        def record():
            counts.update(_build.launch_counts())
            return body()

        t0 = time.perf_counter()
        graph, outputs = self._capture(body, record)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        entry = GraphEntry(graph, outputs, _build.restore_counts(counts))
        self.entries[key] = entry
        return entry

    def drop_all(self) -> list:
        """Release every graph and the pool they share; returns the keys
        that were held."""
        keys = list(self.entries)
        self.entries = {}
        self._pool = None
        return keys


class Deferred:
    """Copies of device tensors on their way to host memory: pinned
    buffers filled on the current stream behind an event (on the CPU,
    clones). ``result()`` waits for the copies and returns numpy arrays."""

    def __init__(self, tensors):
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]
            self.event = None

    def result(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]
