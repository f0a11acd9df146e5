"""Layer-group streamed KV transfer between engines (P->D disaggregation).

Ports production_stack_tpu/engine/kv_transfer.py. The wire format is the
reference's, byte for byte, so a JAX engine and this package's engine can
feed each other:

- HTTP headers: ``X-KV-Shape`` (the full ``L,n,bs,2KH,D``), ``X-KV-Dtype``
  (``bfloat16``, ``float16`` or ``float32``), ``X-KV-Group-Layers``; a push
  adds ``X-KV-Transfer-Id`` and ``X-KV-Start-Layer``. This package adds
  ``X-KV-Head-Groups`` (below);
- a chunked body of frames ``[8-byte little-endian payload length]
  [payload][4-byte little-endian CRC32 of the payload]``, one a layer
  group in layer order; a zero length (``END_FRAME``, no CRC) ends it. A
  push's body starts with one more frame, a JSON prologue (transfer id,
  prompt token ids, first token).

A bad CRC raises :class:`FrameDigestError` at the first layer of its group;
the producer resumes from there (``start_layer``) and never resends an
earlier group. A bfloat16 payload is the pool's raw 2-byte words, which
this module maps to ``torch.bfloat16`` itself: numpy has no bfloat16
without ``ml_dtypes``.

The 2KH rows of a block are the reference's pool layout, grouped by
shard: ``combine_kv(k, v, g)`` with g the tensor-parallel size where KV
heads shard and 1 where they are replicated. So one model's bytes differ
between engines of different tensor-parallel sizes at the same shape. The
reference names no grouping and imports another engine's bytes as its
own heads; a producer here names its grouping in ``X-KV-Head-Groups``
(and a remote slab in its meta's ``head_groups``), and a consumer whose
grouping differs refuses the bytes (``head_groups_of``). A missing header
is read as the consumer's own, which is what a JAX producer sends.

This package's server runs on threads, so the three functions that the
reference writes for asyncio are written here for blocking IO:
:func:`produce_frames` is a generator that keeps up to ``window`` layer
group gathers in flight ahead of the frame being sent;
:func:`consume_frames` reads frames from a file-like body; :func:`push_kv`
posts a chunked body with ``http.client``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import http.client
import json
import struct
import urllib.parse
import zlib
from typing import Callable, Iterator, Optional

import torch

FRAME_HEADER = struct.Struct("<Q")
FRAME_CRC = struct.Struct("<I")

# producer-side gathers in flight: two keep one gather behind the send of
# the previous frame without queueing unbounded device-to-host copies when
# the network is the slow leg
DEFAULT_WINDOW = 2

WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32}

# the KV head grouping of a transfer's bytes (module docstring)
HEAD_GROUPS_HEADER = "X-KV-Head-Groups"
HEAD_GROUPS_META = "head_groups"


def head_groups_of(headers, own: int) -> int:
    """The KV head grouping ``headers`` name; ``own`` when they name
    none (a JAX producer)."""
    return int(headers.get(HEAD_GROUPS_HEADER) or own)


class FrameDigestError(ValueError):
    """A frame's CRC32 did not match its payload. ``layer`` is the first
    layer of the corrupt group: the producer resumes from there."""

    def __init__(self, layer: int, msg: str = ""):
        super().__init__(msg or f"KV frame CRC mismatch at layer {layer}")
        self.layer = layer


def default_group(num_layers: int) -> int:
    """Half the stack: two frames keep the gather, send and scatter
    overlapped at the cost of one extra frame."""
    return max(num_layers // 2, 1)


def layer_groups(num_layers: int, group: int, start: int = 0):
    """(lo, n) layer groups covering [start, num_layers). ``start`` sits on
    a group boundary (it comes from an earlier run of the same grouping)."""
    lo = start
    while lo < num_layers:
        yield lo, min(group, num_layers - lo)
        lo += group


def frame(payload) -> bytes:
    """One frame, with a single copy of ``payload`` (any bytes-like)."""
    return b"".join((FRAME_HEADER.pack(len(payload)), payload,
                     FRAME_CRC.pack(zlib.crc32(payload))))


END_FRAME = FRAME_HEADER.pack(0)


def wire_dtype(name: str) -> torch.dtype:
    try:
        return WIRE_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported KV wire dtype {name!r}") from None


def tensor_bytes(t: torch.Tensor) -> memoryview:
    """A host tensor's raw bytes (bf16 as its 2-byte words), no copy."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


def tensor_from_bytes(buf, dtype: str, shape) -> torch.Tensor:
    """The inverse of :func:`tensor_bytes` over a writable buffer."""
    dt = wire_dtype(dtype)
    raw = torch.frombuffer(buf, dtype=torch.int16 if dt == torch.bfloat16
                           else dt)
    return raw.view(dt).reshape(tuple(int(x) for x in shape))


def nbytes_of(shape, dtype: str) -> int:
    n = torch.empty((), dtype=wire_dtype(dtype)).element_size()
    for d in shape:
        n *= int(d)
    return n


def read_exactly(body, n: int) -> bytearray:
    """``n`` bytes of a file-like ``body`` (``readinto``); EOFError when the
    stream ends first."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = body.readinto(view[got:])
        if not k:
            raise EOFError(f"stream ended after {got} of {n} bytes")
        got += k
    return buf


def read_frame(body) -> Optional[bytearray]:
    """One frame's payload, None at the end frame; FrameDigestError(-1) on
    a bad CRC (the caller knows the layer)."""
    (nbytes,) = FRAME_HEADER.unpack(read_exactly(body, FRAME_HEADER.size))
    if nbytes == 0:
        return None
    payload = read_exactly(body, nbytes)
    (crc,) = FRAME_CRC.unpack(read_exactly(body, FRAME_CRC.size))
    if zlib.crc32(payload) != crc:
        raise FrameDigestError(-1)
    return payload


def produce_frames(run_on_engine: Callable, blocks: list[int],
                   num_layers: int, group: Optional[int] = None,
                   window: int = DEFAULT_WINDOW,
                   start_layer: int = 0) -> Iterator[bytes]:
    """Length-prefixed, CRC-tailed layer-group frames, then END_FRAME.

    Up to ``window`` gathers (``run_on_engine`` calls of
    ``runner.export_blocks_range``) run on a helper thread ahead of the
    frame being consumed. ``start_layer`` resumes a partial transfer:
    groups below it are never gathered."""
    group = group or default_group(num_layers)
    window = max(1, window)
    groups = list(layer_groups(num_layers, group, start_layer))

    def fetch(lo: int, n: int) -> torch.Tensor:
        return run_on_engine(
            lambda eng: eng.runner.export_blocks_range(blocks, lo, n))

    with concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="kv-gather") as pool:
        pending: collections.deque = collections.deque()
        idx = 0
        try:
            while idx < len(groups) and len(pending) < window:
                pending.append(pool.submit(fetch, *groups[idx]))
                idx += 1
            while pending:
                data = pending.popleft().result()
                if idx < len(groups):  # the next gather overlaps this send
                    pending.append(pool.submit(fetch, *groups[idx]))
                    idx += 1
                yield frame(tensor_bytes(data))
        finally:
            for fut in pending:
                fut.cancel()
    yield END_FRAME


def consume_frames(body, run_on_engine: Callable, local_blocks: list[int],
                   shape: tuple, dtype: str, group: int,
                   start_layer: int = 0, on_group=None) -> int:
    """Read frames from the file-like ``body`` and scatter each group into
    ``local_blocks``; the scatter of group i (on the engine thread) runs
    while group i + 1 is read. ``on_group(lo, n)`` fires once a group's
    scatter has landed. Returns the layers landed. Raises
    FrameDigestError at a bad group's first layer (the groups before it
    have landed) and ValueError on a short stream."""
    L = shape[0]
    pending = None
    lo = start_layer

    def settle() -> None:
        nonlocal pending
        if pending is not None:
            fut, span = pending
            pending = None
            fut.result()
            if on_group:
                on_group(*span)

    with concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="kv-scatter") as pool:
        try:
            while True:
                try:
                    payload = read_frame(body)
                except FrameDigestError:
                    settle()
                    raise FrameDigestError(lo) from None
                if payload is None:
                    break
                n = min(group, L - lo)
                data = tensor_from_bytes(payload, dtype, (n, *shape[1:]))
                settle()

                def scatter(eng, data=data, this_lo=lo):
                    eng.import_kv_range(local_blocks, this_lo, data)

                pending = (pool.submit(run_on_engine, scatter), (lo, n))
                lo += n
            settle()
        finally:
            if pending is not None:  # an error above: let the scatter end
                concurrent.futures.wait([pending[0]])
    if lo != L:
        raise ValueError(f"short KV stream: got {lo}/{L} layers")
    return lo - start_layer


def _post_chunked(url: str, path: str, headers: dict, chunks,
                  timeout: float) -> tuple[int, bytes]:
    """POST an iterable of byte chunks as a chunked body; (status, body)."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                      timeout=timeout)
    try:
        conn.putrequest("POST", (u.path.rstrip("/") or "") + path)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.putheader("Content-Type", "application/octet-stream")
        conn.endheaders()
        try:
            for chunk in chunks:
                if chunk:
                    conn.send(f"{len(chunk):x}\r\n".encode())
                    conn.send(chunk)
                    conn.send(b"\r\n")
            conn.send(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the receiver answered early (a 409): read its answer
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def push_kv(url: str, run_on_engine: Callable, blocks: list[int],
            shape: tuple, dtype: str, meta: dict,
            group: Optional[int] = None, window: int = DEFAULT_WINDOW,
            retries: int = 3, timeout: float = 120.0,
            head_groups: int = 1) -> dict:
    """Stream this engine's KV for ``blocks`` to ``POST {url}/kv/recv``.

    ``meta`` rides as a JSON prologue frame, ``head_groups`` as
    ``X-KV-Head-Groups``. On a 409 ``{"resume_layer": n}`` (a bad CRC or a
    dropped connection on the receiver) the push resumes from layer n; a
    connection error retries from 0 (the receiver re-anchors with a 409).
    Any other answer but 200 (a receiver of another head grouping
    refuses with 422) raises at once. After ``retries`` failed attempts it
    raises. Returns the receiver's final JSON."""
    L = shape[0]
    group = group or default_group(L)
    meta_payload = json.dumps(meta).encode()
    start = 0
    last_err: Optional[Exception] = None
    for _ in range(max(1, retries)):
        def body(start=start):
            yield frame(meta_payload)
            yield from produce_frames(run_on_engine, blocks, L, group=group,
                                      window=window, start_layer=start)

        headers = {
            "X-KV-Transfer-Id": str(meta.get("transfer_id", "")),
            "X-KV-Shape": ",".join(str(int(x)) for x in shape),
            "X-KV-Dtype": dtype,
            "X-KV-Group-Layers": str(group),
            "X-KV-Start-Layer": str(start),
            HEAD_GROUPS_HEADER: str(head_groups),
        }
        try:
            status, text = _post_chunked(url, "/kv/recv", headers, body(),
                                         timeout)
        except (OSError, http.client.HTTPException) as e:
            last_err = e
            start = 0  # the receiver's state is unknown; it re-anchors
            continue
        if status == 200:
            return json.loads(text)
        if status == 409:
            start = int(json.loads(text).get("resume_layer", 0))
            last_err = RuntimeError(f"kv push digest retry from layer {start}")
            continue
        raise RuntimeError(f"kv push to {url} failed: HTTP {status} "
                           f"{text[:200]!r}")
    raise last_err or RuntimeError("kv push failed")
