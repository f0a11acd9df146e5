"""Tensor-, sequence- and expert-parallel ranks: the leader mirrors every
device-touching runner call to its followers, which replay it on their
shard (under sequence parallelism, on their whole copy).

The reference's design (production_stack_tpu/engine/multihost.py
``MirroredRunner``, ``FollowerReplayer``, ``follower_loop``), moved onto a
torch.distributed process group. Serving is asymmetric: only rank 0 runs
the server, the engine and the scheduler. Its runner is a
``MirroredRunner``: each call in ``MIRRORED_METHODS`` is sent, with its
host-side arguments, over the control group (parallel/distributed.py)
before it runs locally; every other rank runs ``follower_loop``, which
replays the calls in the order they were sent. The model's collectives
inside each call then pair up across the ranks, and every rank samples
from the same gathered logits with the same seeds, so they agree.

Two transports carry the calls. **Spawned ranks** (``start_ranks``)
talk over the control group, gloo over the loopback address among
processes this one started. **Multi-host ranks** (``lead_ranks``,
``follow_leader``: processes started on their own, one a rank, joined
through a coordinator, parallel/distributed.py ``join_world``) talk over
the reference's authenticated step-plan channel (``LeaderBroadcaster``,
``connect_leader``), since anyone who reaches a cross-host port could
otherwise have their bytes unpickled. Its contract is the reference's:

- The follower opens with HELLO and a fresh nonce under the shared secret
  (``PSTPU_CONTROL_SECRET``; nothing starts without one,
  ``control_secret``); the leader answers with its own nonce, and both
  derive a per-session key from the two (``_session_key``); the follower
  proves it derived the key with a CONFIRM frame under it, so a recorded
  HELLO replayed at a fresh leader is refused.
- Every later frame is HMAC-SHA256'd under the session key, carries a
  sequence number each side checks to rise (a replayed or reordered frame
  ends the channel), and is deserialized by a restricted unpickler that
  admits numpy arrays and scalars, builtin containers and ``TokenFsm``,
  never a torch rebuild function: a tensor argument goes as numpy and the
  follower rebuilds it (``_wire``/``_unwire``).
- A frame's length header, which arrives before its MAC is checked, is
  capped (``_MAX_FRAME``, ``PSTPU_CONTROL_MAX_FRAME``; ``_MAX_HELLO``
  during the handshake).

The port adds to the reference's handshake what a follower started on its
own needs: after CONFIRM the follower names its process id (its first
frame to the leader), and the leader sends it the leader's float32 math
and thread count (``follower_settings``), which a spawned follower gets
as arguments. The followers' answers (``follower_reports``, ``gather``)
are frames to the leader under the same key with sequence numbers of their
own; an adapter's shares ride each follower's own copy of the
``register_lora`` call frame. KV shares keep to the device group as plain
tensors. A multi-host group has no control group at all, so no pickling
collective can run in it (parallel/distributed.py). A follower leaves when
the channel closes; the leader raises ``RankLost`` at its next call once a
follower's socket has closed.

The list is the reference's ``MIRRORED_METHODS`` with ``ragged_step``
(which the reference's list lacks) and the port's warmup
(``warm_decode_graphs``) added. It leaves out the calls ``MirroredRunner``
defines itself, which move data between the ranks besides the call:

- ``register_lora``: the leader cuts every rank's share of the adapter
  (``lora.adapter_share``) and sends each follower only its own over the
  control group (``RankGroup.scatter``), with the whole adapter's
  prefix-cache root; the whole of a rank-16 adapter on llama-3-8b is
  168 MB in float32.
- The KV plane's exports (``export_blocks``, ``export_blocks_range``,
  ``export_slabs``) and imports (``import_blocks``,
  ``import_blocks_range``, ``import_slabs``), the reference's mirrored
  ``export_blocks*``/``import_blocks*``. A rank holds only its KV heads,
  so a whole block exists on no rank: an export sends the call, gathers
  rank 0's heads on its device, and gathers the followers' shares onto it
  (``RankGroup.gather_kv``); the join (``shardings.join_kv_shares``) is
  the reference's pool layout at this tp, the one its ``export_kv``
  returns, and rank 0 copies it to the host once. An import checks the
  whole's shape, cuts it on rank 0's device (``split_kv_share``), sends
  the call and scatters the shares (``RankGroup.scatter_kv``), so each
  follower receives only its own. The shares ride the device group: on
  cards of their own under NCCL they cross NVLink, device to device, and
  only rank 0 touches host memory; the control group would stage every
  follower's share through its host and a TCP socket. Their bytes count
  in ``RankGroup.wire`` under ops of their own (``KV_OPS``), which the
  perf accountant never bills to a dispatch. A follower never holds host
  slabs, so none stays pinned.

**The grid** (``start_ranks(..., grid)``, parallel/distributed.py
``Grid``): every mesh of the stage, seq, expert and tensor axes is one
call, its processes by global rank ``((stage * SEQ + seq) * EXP +
expert) * T + tensor``. Every call goes to every follower, and each
process runs it on what it holds:

- a **tensor** rank its shard of the weights and a pool of its KV heads;
- a **seq** rank the whole model (of its tensor rank and stage) and a
  whole pool of its own; ``prefill_ring`` is the one call whose work the
  seq ranks divide, over the ring's exchange
  (parallel/ring_attention.py). Beside stages the seq ranks run no ring,
  as the reference's staged runner has no ``seq_parallel``: each seq
  rank is a whole pipeline of its own and computes every call, which
  replicates it as GSPMD replicates an axis nothing is cut over;
- an **expert** rank its share of every MoE layer's experts and the rest
  of the model whole (of its tensor rank and stage); the MoE blocks sum
  their combine over the expert view inside each call;
- a **stage** its stage's layers (engine/pp_runner.py
  ``StageRankRunner``), the residual stream relayed over the stage view.

An adapter share goes to each process by its tensor rank (and expert
rank, which cuts nothing of an adapter), cut to its stage's layers.
Without stages an export joins the tensor shares of the tensor group of
rank 0 (its own blocks at tensor size 1, where no call is sent; the
other seq and expert ranks take the call and move nothing), and an import
sends each process its tensor share over the device group of them all,
every seq and expert rank the same shares. With stages a process holds
its stage's layers of its tensor rank's KV heads, so the parts of an
export or import differ in shape by stage: they move point to point over
the device group of them all (``RankGroup.send_kv``/``recv_kv``, counted
under ``KV_OPS``), rank 0 joining each stage's tensor shares (those of
seq and expert rank 0) and the stages along the layer axis, or cutting
the whole the same way for every process. A Whisper model beyond tensor
ranks raises at start (``refusal``), and multi-host groups reach neither
stages nor expert ranks (``check_group``).

Agreement is checked, not assumed: each rank folds the tokens every call
sampled into a running digest, the leader sends its digest with each
call, and a follower whose digest differs logs the fault at once and
keeps the call it first diverged at; ``MirroredRunner.follower_reports``
gathers every rank's digest, call count, divergence and the kernel
launches it made inside the ranks' calls (``Launched``: rank 0's process
may have launched kernels, or had its counters reset, outside them), and
``MirroredRunner.gather`` every rank's answer to a read-only runner call
(its KV blocks, say). Both run between runner calls, on the thread that
makes them. The calls that move data besides the call fold
nothing into the digest and count as no call, on any rank. Chained
decode dispatches pass the previous dispatch's device-resident tokens
(``tokens_dev``); those cannot be sent, so a sentinel goes instead and
each follower uses its own copy from its replay of that dispatch, as in
the reference.

Whisper's ranks (engine/whisper_runner.py) mirror ``WHISPER_METHODS``:
the encode of a request's clip, its SOT logits, its decoder prefill, a
chunk of its decode and its ``free``. A request's device state stays on
each rank in that runner's table, under a handle the leader numbers, and
only host values cross the control group: the clip's features (a
``(n_mels, 3000)`` float32 array, 1.5 MB at 128 mels) with its encode,
token lists with the rest. A chunk's tokens fold into the digest, and
each rank's report names the handles it still holds.

Spawned followers are started with the ``spawn`` method, as daemons of
the leader: they exit on the leader's ``_shutdown`` (``close``), are ended
with the leader's interpreter, and, if the leader is killed, leave within
a second through a parent-pid watch.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import hmac
import io
import logging
import multiprocessing
import os
import pickle
import select
import socket
import statistics
import struct
import threading
import time
from typing import Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.kv_cache import adapter_root
from production_stack_tpu_torch.engine.lora import adapter_share, layer_share
from production_stack_tpu_torch.engine.weights import stage_layers
from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel.mesh import (
    AXIS_EXPERT,
    AXIS_SEQ,
    AXIS_STAGE,
    AXIS_TENSOR,
)
from production_stack_tpu_torch.parallel.shardings import (
    join_kv_shares,
    split_kv_share,
)

logger = logging.getLogger(__name__)

MIRRORED_METHODS = (
    "prefill", "ragged_step", "decode_multi", "set_count_row",
    "register_grammar", "drop_kv", "restore_kv", "drop_params",
    "restore_params", "pooled_embed", "sequence_logprobs", "prompt_logprobs",
    "warm_decode_graphs", "unregister_lora", "prefill_ring",
)
# Whisper's runner (engine/whisper_runner.py): a request's calls by handle
WHISPER_METHODS = ("encode_request", "sot_request", "prefill_request",
                   "chunk_request", "free")
# the KV plane's calls: the runner's device-side gather or scatter each
# rank runs on its own heads (engine/model_runner.py)
KV_GATHERS = {"export_blocks_range": "gather_blocks",
              "export_slabs": "gather_slabs"}
KV_SCATTERS = {"import_blocks_range": "scatter_blocks",
               "import_slabs": "scatter_slabs"}
# sentinel for a device-resident arg the follower reconstructs locally
_CHAINED_NEXT_TOK = "__pstpu_chained_next_tok__"
# seconds a follower is given to leave after the leader's _shutdown
JOIN_SECONDS = 10.0


class RankLost(RuntimeError):
    """A follower rank's process has exited: the ranks can serve no more
    (never a best-effort miss)."""


# -- the authenticated step-plan channel (multi-host; module docstring) ----
# The reference's constants, messages and frame layout: a length header,
# the payload's HMAC-SHA256, the payload.
_LEN = struct.Struct("!Q")
_MAC_BYTES = 32  # HMAC-SHA256
_HELLO = b"pstpu-multihost-v2"
_NONCE_BYTES = 16
# the length header arrives before authentication, so an unauthenticated
# peer must not make us buffer unbounded data; step plans are KBs, an
# adapter's share tens of MB
_MAX_FRAME = int(os.environ.get("PSTPU_CONTROL_MAX_FRAME",
                                str(256 * 1024 * 1024)))
_MAX_HELLO = 1024  # pre-auth handshake frames are tiny
# the third handshake frame, MAC'd under the derived session key: proves
# the follower derived it (knows the secret and saw this session's nonces)
_CONFIRM = b"pstpu-mh-confirm"
# a follower retries the leader's port this long before it fails
CONNECT_SECONDS = 300.0
# marks a tensor argument sent as numpy (``_wire``)
_TENSOR = "__pstpu_tensor__"
# calls of each method the leader's send statistics keep
SENT_KEPT = 1024
# values of each weight tensor ``weights_fingerprint`` reads at most
FINGERPRINT_SAMPLES = 4096


def control_secret() -> bytes:
    """The shared control-plane secret (``PSTPU_CONTROL_SECRET``).

    Raises when unset: an unauthenticated step-plan channel would hand
    arbitrary deserialization to any peer that can reach the port."""
    s = os.environ.get("PSTPU_CONTROL_SECRET", "")
    if not s:
        raise ValueError(
            "multi-host serving needs PSTPU_CONTROL_SECRET (shared "
            "control-plane secret; the chart injects it from a Kubernetes "
            "Secret, helm/templates/secrets.yaml)")
    return s.encode()


class _RestrictedUnpickler(pickle.Unpickler):
    """Admit only the types the channel's frames carry."""

    _ALLOWED = {
        ("builtins", "tuple"), ("builtins", "list"), ("builtins", "dict"),
        ("builtins", "set"), ("builtins", "frozenset"),
        ("builtins", "bytes"), ("builtins", "bytearray"),
        ("builtins", "str"), ("builtins", "int"), ("builtins", "float"),
        ("builtins", "bool"), ("builtins", "complex"),
        ("builtins", "slice"), ("builtins", "NoneType"),
        ("numpy", "ndarray"), ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.numeric", "_frombuffer"),
        ("production_stack_tpu_torch.engine.grammar", "TokenFsm"),
    }

    def find_class(self, module, name):
        # an explicit allowlist only: a module-wide numpy or torch wildcard
        # would admit callables (np.load(allow_pickle=True), torch's
        # rebuild functions) and reopen the door this class closes
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"step-plan payload requested forbidden type {module}.{name}")


def _session_key(secret: bytes, follower_nonce: bytes,
                 leader_nonce: bytes) -> bytes:
    """The per-session frame-MAC key. Both sides contribute a nonce, so
    frames recorded in one session authenticate in no other, in either
    direction."""
    return hmac.new(secret, b"pstpu-mh-skey|" + follower_nonce +
                    leader_nonce, hashlib.sha256).digest()


def _dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=5)


def _loads(data: bytes):
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _send_frame(sock: socket.socket, payload: bytes, secret: bytes) -> None:
    mac = hmac.new(secret, payload, hashlib.sha256).digest()
    sock.sendall(_LEN.pack(len(payload)) + mac + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            return None
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def _recv_frame(sock: socket.socket, secret: bytes,
                max_len: int = _MAX_FRAME) -> Optional[bytes]:
    """The next frame's payload, None when the peer closed the channel;
    raises on a length over ``max_len`` (before reading further) and on a
    MAC that fails."""
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > max_len:
        raise ConnectionError(
            f"control-plane frame of {n} bytes exceeds the {max_len}-byte "
            "cap (unauthenticated length header: refusing to buffer)")
    mac = _recv_exact(sock, _MAC_BYTES)
    if mac is None:
        return None
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    want = hmac.new(secret, payload, hashlib.sha256).digest()
    if not hmac.compare_digest(mac, want):
        raise ConnectionError("control-plane frame failed HMAC check")
    return payload


def _wire(args: tuple, kwargs: dict) -> tuple:
    """A call's tensor arguments (at the top level or inside a tuple or
    list argument) as numpy, marked with their dtype and whether they were
    on a device (``_host``); the restricted unpickler admits no torch
    type."""

    def one(x):
        if isinstance(x, torch.Tensor):
            return (_TENSOR, str(x.dtype).replace("torch.", ""),
                    x.device.type != "cpu", _host(x))
        if isinstance(x, (tuple, list)):
            return type(x)(one(v) for v in x)
        return x

    return (tuple(one(a) for a in args),
            {k: one(v) for k, v in kwargs.items()})


def _unwire(args: tuple, kwargs: dict, device) -> tuple:
    """``_wire`` undone on a follower: each marked array a tensor of its
    dtype, on ``device`` where the leader's was on a device."""

    def one(x):
        if (isinstance(x, tuple) and len(x) == 4
                and isinstance(x[0], str) and x[0] == _TENSOR):
            t = torch.from_numpy(np.asarray(x[3])).to(getattr(torch, x[1]))
            return t.to(device) if x[2] else t
        if isinstance(x, (tuple, list)):
            return type(x)(one(v) for v in x)
        return x

    return (tuple(one(a) for a in args),
            {k: one(v) for k, v in kwargs.items()})


def follower_settings() -> dict:
    """What a follower started on its own takes from the leader right
    after the handshake: the float32 math (``float32_math``) and the
    thread count, without which the ranks compute their replicated parts
    differently."""
    return {"math": float32_math(), "threads": torch.get_num_threads()}


def weights_fingerprint(params) -> Optional[str]:
    """A digest of a parameter dict (nested dicts of tensors): each
    leaf's name, dtype, shape and a strided sample of at most
    ``FINGERPRINT_SAMPLES`` of its values, bit for bit. None where no
    dict is given: each process then seeds or loads the weights its
    config names. The leader holds each follower's to its own
    (``LeaderBroadcaster.wait_for_followers``), so processes handed
    different weights refuse to start."""
    if params is None:
        return None
    h = hashlib.sha256()

    def walk(tree, prefix):
        for k in sorted(tree):
            v, name = tree[k], f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + "/")
            elif not torch.is_tensor(v):
                h.update(f"{name}|{v!r}|".encode())
            else:
                h.update(f"{name}|{v.dtype}|{tuple(v.shape)}|".encode())
                flat = v.detach().reshape(-1)
                flat = flat[::max(1, flat.numel() // FINGERPRINT_SAMPLES)]
                h.update(flat.contiguous().cpu().view(torch.uint8)
                         .numpy().tobytes())

    walk(params, "")
    return h.hexdigest()


def apply_settings(settings: dict) -> None:
    torch.set_num_threads(int(settings["threads"]))
    set_float32_math(settings["math"])


@dataclasses.dataclass
class _Peer:
    """A follower's end of the channel on the leader: its socket, its
    session key, its process id and pid, its weights' fingerprint
    (``weights_fingerprint``), the last sequence number of its answers."""

    sock: socket.socket
    key: bytes
    process_id: int
    pid: int
    weights: Optional[str] = None
    last_up: int = 0


class LeaderBroadcaster:
    """The leader's channel (the reference's): accepts one authenticated
    connection a follower, then sends the step plans, each with a sequence
    number, and reads the followers' answers. ``settings`` go to each
    follower right after its handshake (default ``follower_settings()``);
    ``weights`` is the leader's ``weights_fingerprint``, which each
    follower's must equal."""

    def __init__(self, port: int, num_followers: int,
                 secret: Optional[bytes] = None,
                 bind_host: Optional[str] = None,
                 accept_timeout: float = 300.0,
                 settings: Optional[dict] = None,
                 weights: Optional[str] = None):
        self.secret = secret if secret is not None else control_secret()
        self.num_followers = num_followers
        self.weights = weights
        self.settings = (settings if settings is not None
                         else follower_settings())
        bind = (bind_host if bind_host is not None
                else os.environ.get("PSTPU_CONTROL_BIND", "0.0.0.0"))
        self.server = socket.create_server((bind, port), backlog=16)
        self.server.settimeout(accept_timeout)
        # process id -> _Peer; written by wait_for_followers, read by the
        # engine thread's calls, both under the lock
        self.peers: dict[int, _Peer] = {}
        self.lock = threading.RLock()
        self.seq = 0  # guarded-by: lock
        # each method's last SENT_KEPT calls: payload bytes (one
        # follower's copy) and host seconds to send the call to all
        self.frame_bytes: dict[str, collections.deque] = {}
        self.send_seconds: dict[str, collections.deque] = {}

    @property
    def pids(self) -> list:
        """The followers' pids, by process id."""
        return [self.peers[i].pid for i in sorted(self.peers)]

    def _handshake(self, conn: socket.socket, addr) -> Optional[_Peer]:
        """The reference's HELLO / nonce / CONFIRM, then the follower's
        process id; None (after a warning) for a peer refused."""
        try:
            conn.settimeout(30.0)
            hello = _recv_frame(conn, self.secret, max_len=_MAX_HELLO)
            if (hello is None
                    or len(hello) != len(_HELLO) + _NONCE_BYTES
                    or not hmac.compare_digest(hello[:len(_HELLO)],
                                               _HELLO)):
                logger.warning("rejecting connection from %s: bad hello",
                               addr)
                return None
            f_nonce = hello[len(_HELLO):]
            l_nonce = os.urandom(_NONCE_BYTES)
            key = _session_key(self.secret, f_nonce, l_nonce)
            _send_frame(conn, l_nonce, self.secret)
            # the confirm verifies under the session key only if the peer
            # derived it: a replayed HELLO cannot
            if _recv_frame(conn, key, max_len=_MAX_HELLO) != _CONFIRM:
                logger.warning("rejecting connection from %s: bad session "
                               "confirm (replayed HELLO?)", addr)
                return None
            joined = _recv_frame(conn, key, max_len=_MAX_HELLO)
            up, who = _loads(joined) if joined is not None else (0, {})
            pid = who.get("process_id") if isinstance(who, dict) else None
            if (up != 1 or not isinstance(pid, int)
                    or not 1 <= pid <= self.num_followers
                    or pid in self.peers):
                logger.warning("rejecting connection from %s: process id "
                               "%r (want one of 1..%d not yet joined)",
                               addr, pid, self.num_followers)
                return None
        except (OSError, pickle.UnpicklingError, ValueError,
                TypeError) as e:
            logger.warning("rejecting connection from %s: %s", addr, e)
            return None
        conn.settimeout(None)
        return _Peer(conn, key, pid, int(who.get("pid", 0)),
                     weights=who.get("weights"), last_up=1)

    def wait_for_followers(self) -> None:
        """Accept followers until ``num_followers`` have joined, refusing
        any that fail the handshake; each joined follower gets the
        settings at once. A follower that authenticates with weights
        other than the leader's (``weights_fingerprint``) raises
        ValueError: the group would serve different models."""
        while len(self.peers) < self.num_followers:
            conn, addr = self.server.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = self._handshake(conn, addr)
            if peer is None:
                conn.close()
                continue
            if peer.weights != self.weights:
                conn.close()
                raise ValueError(
                    f"process {peer.process_id} was given other weights "
                    f"than the leader (fingerprint {peer.weights} against "
                    f"{self.weights}): every process of a multi-host group "
                    "must load the same weights, the same params dict on "
                    "each or none (each then seeds or loads what its "
                    "config names)")
            with self.lock:
                self.seq += 1
                _send_frame(conn, _dumps((self.seq, "_settings", (),
                                          self.settings, "")), peer.key)
                self.peers[peer.process_id] = peer
            logger.info("follower %d (pid %d) connected from %s (%d/%d)",
                        peer.process_id, peer.pid, addr, len(self.peers),
                        self.num_followers)

    def _send(self, peer: _Peer, payload: bytes) -> None:
        try:
            _send_frame(peer.sock, payload, peer.key)
        except OSError as e:
            raise RankLost(f"follower {peer.process_id} (pid {peer.pid}): "
                           f"the channel closed ({e})") from e

    def _sent(self, method: str, nbytes: int, t0: float) -> None:
        for book, x in ((self.frame_bytes, nbytes),
                        (self.send_seconds, time.perf_counter() - t0)):
            book.setdefault(method, collections.deque(
                maxlen=SENT_KEPT)).append(x)

    def broadcast(self, method: str, args: tuple, kwargs: dict,
                  digest: str = "") -> None:
        """The reference's step-plan broadcast: one frame, every
        follower."""
        with self.lock:
            t0 = time.perf_counter()
            self.seq += 1
            payload = _dumps((self.seq, method, args, kwargs, digest))
            for i in sorted(self.peers):
                self._send(self.peers[i], payload)
            self._sent(method, len(payload), t0)

    def send_call(self, call: tuple, shares: Optional[list] = None) -> None:
        """A ``MirroredRunner`` call ``(n, method, args, kwargs, digest)``
        under this channel's next sequence number; with ``shares``, each
        follower's copy carries its own (``kwargs["share"]``) and no other
        rank's."""
        _, method, args, kwargs, digest = call
        args, kwargs = _wire(args, kwargs)
        if shares is None:
            self.broadcast(method, args, kwargs, digest)
            return
        with self.lock:
            t0 = time.perf_counter()
            self.seq += 1
            for i in sorted(self.peers):
                payload = _dumps((self.seq, method, args,
                                  dict(kwargs, share=shares[i]), digest))
                self._send(self.peers[i], payload)
            self._sent(method, len(payload), t0)

    def stats(self) -> dict:
        """Each method's calls sent (of the last ``SENT_KEPT``), median
        payload bytes and median host microseconds to send one."""
        with self.lock:
            return {m: {"frames": len(b),
                        "median_bytes": statistics.median(b),
                        "median_send_us": 1e6 * statistics.median(
                            self.send_seconds[m])}
                    for m, b in self.frame_bytes.items()}

    def gather(self, obj) -> list:
        """``obj`` then every follower's next answer, by process id."""
        out = [obj]
        with self.lock:
            for i in sorted(self.peers):
                peer = self.peers[i]
                try:
                    payload = _recv_frame(peer.sock, peer.key)
                except OSError as e:
                    if type(e) is ConnectionError:
                        raise  # the channel's own faults: MAC, cap
                    raise RankLost(f"follower {i} (pid {peer.pid}): "
                                   f"{e}") from e
                if payload is None:
                    raise RankLost(f"follower {i} (pid {peer.pid}) closed "
                                   "the channel")
                up, body = _loads(payload)
                if up <= peer.last_up:
                    raise ConnectionError(
                        f"follower {i}'s answer replayed or reordered "
                        f"(seq {up} after {peer.last_up})")
                peer.last_up = up
                out.append(body)
        return out

    def check_alive(self) -> None:
        """Raise ``RankLost`` if a follower's socket has closed: a
        follower sends nothing unasked, so a readable socket between calls
        is a closed one (or a protocol fault)."""
        with self.lock:
            socks = {p.sock: p for p in self.peers.values()}
        if not socks:
            return
        ready, _, _ = select.select(list(socks), [], [], 0)
        for sock in ready:
            peer = socks[sock]
            try:
                got = sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
            except BlockingIOError:
                continue
            except OSError as e:
                got = b""
                logger.info("follower %d: %s", peer.process_id, e)
            if not got:
                raise RankLost(f"follower {peer.process_id} (pid "
                               f"{peer.pid}) closed the channel")
            raise ConnectionError(f"follower {peer.process_id} sent a "
                                  "frame unasked")

    def close(self) -> None:
        """``_shutdown`` to every follower still there, then the sockets
        closed."""
        try:
            self.broadcast("_shutdown", (), {})
        except Exception:
            logger.debug("shutdown broadcast to followers failed",
                         exc_info=True)
        with self.lock:
            for peer in self.peers.values():
                try:
                    peer.sock.close()
                except OSError:
                    logger.debug("follower socket close failed",
                                 exc_info=True)
        self.server.close()


class FollowerChannel:
    """A follower's end of the channel: the leader's frames in order (a
    sequence number that does not rise ends it), and answers to the
    leader under the session key with sequence numbers of their own."""

    def __init__(self, sock: socket.socket, key: bytes):
        self.sock = sock
        self.key = key
        self.last_seq = 0
        self.up_seq = 0

    def recv(self) -> Optional[tuple]:
        """The leader's next frame ``(seq, method, args, kwargs,
        digest)``; None when the leader closed the channel."""
        payload = _recv_frame(self.sock, self.key)
        if payload is None:
            return None
        frame = _loads(payload)
        if frame[0] <= self.last_seq:
            raise ConnectionError(
                f"control-plane frame replayed or reordered "
                f"(seq {frame[0]} after {self.last_seq})")
        self.last_seq = frame[0]
        return frame

    def reply(self, obj) -> None:
        self.up_seq += 1
        _send_frame(self.sock, _dumps((self.up_seq, obj)), self.key)

    def close(self) -> None:
        self.sock.close()


def connect_leader(leader_host: str, control_port: int, process_id: int,
                   secret: Optional[bytes] = None,
                   connect_timeout: float = CONNECT_SECONDS,
                   weights: Optional[str] = None) -> tuple:
    """Reach the leader's channel (retrying its port for
    ``connect_timeout`` seconds, as the reference's ``follower_loop``
    does), run the handshake, name this process and its weights
    (``weights_fingerprint``), and take the leader's settings. Returns
    (the ``FollowerChannel``, the settings). A refused handshake raises:
    a follower never falls back to serving alone."""
    secret = secret if secret is not None else control_secret()
    deadline = time.monotonic() + connect_timeout
    while True:
        try:
            sock = socket.create_connection((leader_host, control_port),
                                            timeout=5.0)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise TimeoutError(f"could not reach the leader at "
                                   f"{leader_host}:{control_port}")
            time.sleep(0.5)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        f_nonce = os.urandom(_NONCE_BYTES)
        sock.settimeout(30.0)
        _send_frame(sock, _HELLO + f_nonce, secret)
        l_nonce = _recv_frame(sock, secret, max_len=_MAX_HELLO)
        if l_nonce is None or len(l_nonce) != _NONCE_BYTES:
            raise ConnectionError("the leader's handshake returned no "
                                  "session nonce (wrong secret?)")
        key = _session_key(secret, f_nonce, l_nonce)
        _send_frame(sock, _CONFIRM, key)
        channel = FollowerChannel(sock, key)
        channel.reply({"process_id": process_id, "pid": os.getpid(),
                       "weights": weights})
        frame = channel.recv()
        if frame is None or frame[1] != "_settings":
            raise ConnectionError("the leader refused this follower (no "
                                  "settings after the handshake: its "
                                  "process id or weights?)")
    except BaseException:
        sock.close()
        raise
    sock.settimeout(None)
    logger.info("process %d connected to the leader at %s:%d", process_id,
                leader_host, control_port)
    return channel, frame[3]


def sampled_tokens(method: str, result) -> Optional[np.ndarray]:
    """The tokens a runner call sampled, flattened (None for calls that
    sample none): a ragged step's samples and verify columns, a prefill's
    first tokens, a decode dispatch's (K, S) samples, a Whisper chunk's
    tokens."""
    if method == "chunk_request":
        return np.asarray(result[0], np.int64)
    if method in ("ragged_step", "prefill", "prefill_ring"):
        # (sampled[, verify], tok_lp, top_ids, top_lps); a staged
        # runner's prefill returns (sampled,)
        toks = result[:len(result) - 3] if len(result) > 3 else result
        return np.concatenate([t.cpu().numpy().ravel() for t in toks])
    if method == "decode_multi":
        if isinstance(result, tuple) and hasattr(result[0], "result"):
            return np.asarray(result[0].result()[0]).ravel()  # fetch=False
        got = result[0] if isinstance(result, tuple) else result
        return np.asarray(got).ravel()
    return None


class _Digest:
    """A running digest of every token a rank's calls sampled."""

    def __init__(self):
        self.h = hashlib.blake2b(digest_size=16)
        self.calls = 0

    def fold(self, method: str, result) -> None:
        self.calls += 1
        toks = sampled_tokens(method, result)
        if toks is not None:
            self.h.update(method.encode())
            self.h.update(np.ascontiguousarray(toks, np.int64).tobytes())

    def hex(self) -> str:
        return self.h.hexdigest()


def _host(x):
    """A tensor as numpy (bf16 widened to float32, exactly: numpy has no
    bfloat16)."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def live_handles(runner) -> Optional[list]:
    """The request handles whose device state a Whisper runner holds (None
    for the text engine's runner, which holds none)."""
    fn = getattr(runner, "live_handles", None)
    return None if fn is None else fn()


def kernel_launches() -> dict:
    """This process's launches of each kernel so far (``_build.COUNTERS``:
    a wrapper counts where it launches its kernel)."""
    from production_stack_tpu_torch.ops import _build

    return {c.name.split()[0]: c.n for c in _build.COUNTERS}


def place(ranks) -> dict:
    """A process's index on each axis above 1 of its grid (``{"tensor":
    r}`` at tensor parallelism alone; none where ``ranks`` names no
    axis)."""
    views = ((axis, getattr(ranks, axis, None))
             for axis in ("stage", "seq", "expert", "tensor"))
    return {axis: view.rank for axis, view in views if view is not None}


class Launched:
    """The kernel launches a rank made inside the ranks' calls: what each
    call added to the process's counters (``kernel_launches``), summed.
    Launches outside the calls (an earlier engine in the same process)
    and a reset of the counters between calls stay out of a report, so
    rank 0's launches compare with a follower's, which starts at 0."""

    def __init__(self):
        self.n: dict = {}

    @contextlib.contextmanager
    def counting(self):
        before = kernel_launches()
        try:
            yield
        finally:
            for k, n in kernel_launches().items():
                self.n[k] = self.n.get(k, 0) + n - before.get(k, 0)

    def counts(self) -> dict:
        return {k: self.n.get(k, 0) for k in kernel_launches()}


class MirroredRunner:
    """Rank 0's runner: send the call, then run it locally.

    The send precedes the local call so the followers start as soon as the
    leader does; the transport keeps the leader's program order: the
    control group for spawned ranks (``procs``, their processes), the
    authenticated ``channel`` for multi-host ranks. Other attributes pass
    through to the local runner. ``close`` stops the followers and leaves
    the group."""

    def __init__(self, inner, ranks, procs: list,
                 channel: Optional[LeaderBroadcaster] = None):
        self._inner = inner
        self.ranks = ranks
        self.procs = procs
        self.channel = channel
        self._digest = _Digest()
        self._pending = None  # (method, result) not yet folded
        self._launched = Launched()
        self._seq = 0
        self._lock = threading.RLock()
        self._closed = False
        for name in MIRRORED_METHODS + WHISPER_METHODS:
            if hasattr(inner, name):
                setattr(self, name, self._make_mirror(name))

    def _make_mirror(self, name: str):
        def mirrored(*args, **kwargs):
            self._send(name, args, kwargs)
            # looked up at call time: the compile tracker wraps the local
            # runner's step methods after this runner is made
            with self._launched.counting():
                result = getattr(self._inner, name)(*args, **kwargs)
            self._pending = (name, result)
            return result

        mirrored.__name__ = name
        return mirrored

    def _fold(self) -> None:
        if self._pending is not None:
            self._digest.fold(*self._pending)
            self._pending = None

    @property
    def follower_pids(self) -> list:
        """The followers' pids, by global rank."""
        if self.channel is not None:
            return self.channel.pids
        return [p.pid for p in self.procs]

    def _check_alive(self) -> None:
        if self.channel is not None:
            self.channel.check_alive()
            return
        for r, p in enumerate(self.procs, start=1):
            if not p.is_alive():
                raise RankLost(
                    f"tensor-parallel rank {r} (pid {p.pid}) exited with "
                    f"code {p.exitcode}")

    def _send(self, method: str, args: tuple, kwargs: dict,
              shares: Optional[list] = None) -> None:
        """Send a call; ``shares`` (one a rank) give each follower its own
        entry besides it."""
        if self._closed:
            raise RuntimeError("the tensor-parallel ranks are closed")
        with self._lock:
            self._check_alive()
            self._fold()
            if method == "decode_multi" and isinstance(
                    kwargs.get("tokens_dev"), torch.Tensor):
                kwargs = dict(kwargs, tokens_dev=_CHAINED_NEXT_TOK)
            self._seq += 1
            call = (self._seq, method, args, kwargs, self._digest.hex())
            if self.channel is not None:
                self.channel.send_call(call, shares)
                return
            self.ranks.broadcast(call)
            if shares is not None:
                self.ranks.scatter(shares)

    def _gather(self, obj) -> list:
        """``obj`` and every follower's answer, in rank order."""
        if self.channel is not None:
            return self.channel.gather(obj)
        return self.ranks.gather(obj)

    def register_lora(self, slot: int, bank_np: dict) -> None:
        """``ModelRunner.register_lora`` on every rank, each follower sent
        only its share of the adapter (module docstring)."""
        cfg, size = self._inner.cfg, self.ranks.size
        root = adapter_root(bank_np)
        shares = [adapter_share(bank_np, self.ranks.shard_of(cfg, r), cfg)
                  for r in range(size)]
        grid = self.ranks.grid
        if grid.stage > 1:
            # each process holds its stage's layers of its tensor share
            shares = [layer_share(sh, stage_layers(
                cfg, (grid.coords(g)[AXIS_STAGE], grid.stage)))
                for g, sh in enumerate(shares)]
        with self._lock:
            self._send("register_lora", (slot,), {"root": root}, shares)
            with self._launched.counting():
                self._inner.put_lora(slot, shares[0], root)

    # -- the KV plane (module docstring) -----------------------------------
    def _moved(self, fn):
        """``fn()``, a transfer between the ranks; a follower that left
        meanwhile is named, never hidden behind the group's error."""
        try:
            return fn()
        except Exception:
            self._check_alive()
            raise

    def _check_blocks(self, block_ids: list) -> None:
        """Raise before a KV call is sent, not on every rank after it:
        a follower whose replay raises leaves the group."""
        n = self._inner.num_blocks
        if not all(0 <= b < n for b in block_ids):
            raise ValueError(f"KV block ids outside the pool's {n}")

    def _export(self, method: str, args: tuple) -> torch.Tensor:
        """The whole of a KV gather on rank 0's device: its own blocks at
        tensor size 1 without stages, where every process holds them
        whole; its tensor group's shares joined otherwise."""
        self._check_blocks(args[0])
        if self.ranks.stage is not None:
            return self._export_stages(method, args)
        tp = self.ranks.tensor
        if tp is None:
            return getattr(self._inner, KV_GATHERS[method])(*args)
        with self._lock:
            self._send(method, args, {})
            with self._launched.counting():
                mine = getattr(self._inner, KV_GATHERS[method])(*args)
            shares = self._moved(lambda: tp.gather_kv(mine))
        return join_kv_shares(shares, self._inner.cfg, tp.size)

    def _export_stages(self, method: str, args: tuple) -> torch.Tensor:
        """The whole of a KV gather on a grid with stages: each
        process's part (its stage's layers of the range, its tensor rank's
        heads) sent to rank 0, each stage's tensor shares joined, the
        stages joined along the layer axis (slabs are block-major, (n, L,
        ...), layer groups layer-major, (n_layers, n, ...))."""
        inner, world = self._inner, self.ranks
        T, S = world.tensor_size, world.stage.size
        ax, layer_lo, n_layers = ((1, 0, inner.cfg.num_layers)
                                  if method == "export_slabs"
                                  else (0, args[1], args[2]))
        rows, dtype = tuple(inner.kv.shape[2:]), inner.kv.dtype
        n = len(args[0])
        with self._lock:
            self._send(method, args, {})
            with self._launched.counting():
                mine = getattr(inner, KV_GATHERS[method])(*args)

            def join() -> torch.Tensor:
                stages = []
                for s in range(S):
                    cut = inner.stage_cut(layer_lo, n_layers, s)
                    if cut is None:
                        continue
                    shape = ((n, cut[1], *rows) if ax else
                             (cut[1], n, *rows))
                    # seq and expert rank 0's tensor ranks of the stage
                    shares = [mine if g == 0 else
                              world.recv_kv(g, shape, dtype, "kv_gather")
                              for g in (world.grid.process(stage=s, tensor=t)
                                        for t in range(T))]
                    stages.append(join_kv_shares(shares, inner.cfg, T))
                return torch.cat(stages, dim=ax)

            return self._moved(join)

    def _import_stages(self, method: str, args: tuple,
                       cut: list) -> None:
        """Each process's part of ``cut`` (the tensor ranks' shares of the
        whole) on a grid with stages: its stage's layers, sent from
        rank 0 point to point; rank 0 writes its own."""
        inner, world = self._inner, self.ranks
        ax = 1 if method == "import_slabs" else 0
        layer_lo, n_layers = (args[1] if ax == 0 else 0), cut[0].shape[ax]
        with self._lock:
            self._send(method, args, {"shape": tuple(cut[0].shape)})

            def send() -> Optional[torch.Tensor]:
                mine = None
                for g in range(world.size):
                    at = world.grid.coords(g)
                    c = inner.stage_cut(layer_lo, n_layers, at[AXIS_STAGE])
                    if c is None:
                        continue
                    part = cut[at[AXIS_TENSOR]].narrow(ax, c[2], c[1])
                    if g == 0:
                        mine = part
                    else:
                        world.send_kv(part, g, "kv_scatter")
                return mine

            mine = self._moved(send)
            if mine is not None:
                with self._launched.counting():
                    getattr(inner, KV_SCATTERS[method])(*args, mine)

    def _import(self, method: str, args: tuple, whole: torch.Tensor,
                want: tuple) -> None:
        """Cut ``whole`` (on rank 0's device) into the ranks' shares and
        scatter them; each rank writes its own. ``want`` is the whole's
        shape this call needs, checked before anything is sent."""
        self._check_blocks(args[0])
        if tuple(whole.shape) != tuple(want):
            raise ValueError(f"KV of shape {tuple(whole.shape)} where this "
                             f"engine takes {tuple(want)}")
        cfg, tp = self._inner.cfg, self.ranks.tensor_size
        # process g takes tensor rank g % tp's share (tensor innermost)
        cut = ([whole] if tp == 1 else
               [split_kv_share(whole, cfg, t, tp) for t in range(tp)])
        if self.ranks.stage is not None:
            self._import_stages(method, args, cut)
            return
        shares = [cut[g % tp] for g in range(self.ranks.size)]
        shape = tuple(shares[0].shape)
        with self._lock:
            self._send(method, args, {"shape": shape})
            mine = self._moved(lambda: self.ranks.scatter_kv(
                shares, shape, whole.dtype))
            with self._launched.counting():
                getattr(self._inner, KV_SCATTERS[method])(*args, mine)

    def _kv_rows(self) -> tuple:
        """A whole block's (bs, 2KH, D)."""
        cfg = self._inner.cfg
        return (self._inner.config.cache.block_size, 2 * cfg.num_kv_heads,
                cfg.head_dim)

    def export_blocks(self, block_ids) -> torch.Tensor:
        """Whole blocks (L, n, bs, 2KH, D) on the host, every rank's heads
        joined."""
        return self.export_blocks_range(block_ids, 0,
                                        self._inner.cfg.num_layers)

    def export_blocks_range(self, block_ids, layer_lo: int,
                            n_layers: int) -> torch.Tensor:
        return self._inner.to_host(self._export(
            "export_blocks_range", (list(block_ids), int(layer_lo),
                                    int(n_layers))))

    def export_slabs(self, block_ids) -> list[torch.Tensor]:
        """Each whole block's (L, bs, 2KH, D) slab in pinned host memory
        of its own (rank 0's; a follower's share never leaves its
        device)."""
        return self._inner.slabs_to_host(self._export(
            "export_slabs", (list(block_ids),)))

    def import_blocks(self, block_ids, data) -> None:
        self.import_blocks_range(block_ids, 0, data)

    def import_blocks_range(self, block_ids, layer_lo: int, data) -> None:
        """Whole blocks' layer group (n_layers, n, bs, 2KH, D) into every
        rank's pool."""
        ids = list(block_ids)
        n_layers = int(data.shape[0])
        if not 0 <= layer_lo <= self._inner.cfg.num_layers - n_layers:
            raise ValueError(f"layers [{layer_lo}, {layer_lo + n_layers}) "
                             f"outside the pool's "
                             f"{self._inner.cfg.num_layers}")
        self._import("import_blocks_range", (ids, int(layer_lo)),
                     self._inner.blocks_to_device(data),
                     (n_layers, len(ids), *self._kv_rows()))

    def import_slabs(self, block_ids, slabs) -> None:
        """Whole blocks' (L, bs, 2KH, D) slabs into every rank's pool."""
        ids = list(block_ids)
        self._import("import_slabs", (ids,),
                     self._inner.slabs_to_device(slabs),
                     (len(ids), self._inner.cfg.num_layers,
                      *self._kv_rows()))

    def report(self) -> dict:
        """This rank's place on each axis (``place``), agreement state,
        live Whisper handles, kernel launches inside the ranks' calls
        (``Launched``) and its device group's bytes by op
        (``RankGroup.wire``)."""
        return {"rank": 0, "place": place(self.ranks), "pid": os.getpid(),
                "calls": self._digest.calls,
                "digest": self._digest.hex(), "diverged_at": None,
                "live": live_handles(self._inner),
                "launches": self._launched.counts(),
                "wire": dict(getattr(self.ranks, "wire", {}))}

    def follower_reports(self) -> list[dict]:
        """Every rank's report (``report``), rank 0's first. A follower's
        digest equals the leader's exactly when it sampled the same
        tokens in every call so far."""
        with self._lock:
            self._send("_report", (), {})
            return self._gather(self.report())

    def gather(self, method: str, *args) -> list:
        """Every rank's result of the read-only runner call ``method``,
        as numpy, in rank order (e.g. ``export_blocks``: each rank's KV
        heads of those blocks)."""
        with self._lock:
            self._send("_gather", (method, *args), {})
            with self._launched.counting():
                mine = _host(getattr(self._inner, method)(*args))
            return self._gather(mine)

    def close(self) -> None:
        """Stop the followers (``_shutdown``; spawned ones are then
        joined, and one that does not leave in ``JOIN_SECONDS`` is
        terminated; multi-host ones leave on the closed channel) and
        leave the group."""
        if self._closed:
            return
        if self.channel is not None:
            self._closed = True
            try:
                self.channel.close()
            finally:
                self.ranks.close()
            return
        try:
            if all(p.is_alive() for p in self.procs):
                self._send("_shutdown", (), {})
        finally:
            self._closed = True
            for p in self.procs:
                p.join(JOIN_SECONDS)
                if p.is_alive():
                    logger.error("tensor-parallel rank pid %d did not "
                                 "leave; terminating it", p.pid)
                    p.terminate()
                    p.join(JOIN_SECONDS)
            self.ranks.close()

    def __getattr__(self, name):  # host-side state passes straight through
        return getattr(self._inner, name)


class FollowerReplayer:
    """Replays mirrored calls against the local runner shard, keeping the
    running digest and the device-resident ``next_tok`` of each
    ``decode_multi(fetch=False)`` for the leader's chained dispatches."""

    def __init__(self, runner):
        self.runner = runner
        self.digest = _Digest()
        self.diverged_at: Optional[int] = None
        self.launched = Launched()
        self._next_tok = None

    def check(self, seq: int, leader_digest: str) -> None:
        """Compare this rank's digest with the leader's after call
        ``seq - 1``; the first mismatch is logged and kept."""
        if self.diverged_at is None and leader_digest != self.digest.hex():
            self.diverged_at = seq - 1
            logger.error("tensor-parallel rank %d sampled other tokens than "
                         "rank 0 by call %d", self.runner.ranks.rank,
                         seq - 1)

    def replay(self, method: str, args: tuple, kwargs: dict) -> None:
        td = kwargs.get("tokens_dev")
        if isinstance(td, str) and td == _CHAINED_NEXT_TOK:
            if self._next_tok is None:
                raise RuntimeError("chained decode_multi replay without a "
                                   "cached next_tok: the call order broke")
            kwargs = dict(kwargs, tokens_dev=self._next_tok)
        result = getattr(self.runner, method)(*args, **kwargs)
        if method == "decode_multi" and not kwargs.get("fetch", True):
            self._next_tok = result[1]
        self.digest.fold(method, result)

    def report(self) -> dict:
        return {"rank": self.runner.ranks.rank,
                "place": place(self.runner.ranks), "pid": os.getpid(),
                "calls": self.digest.calls, "digest": self.digest.hex(),
                "diverged_at": self.diverged_at,
                "live": live_handles(self.runner),
                "launches": self.launched.counts(),
                "wire": dict(getattr(self.runner.ranks, "wire", {}))}


def check_share(runner, method: str, args: tuple, shape: tuple) -> None:
    """Raise unless ``shape`` is a share that ``method`` can write into
    this follower's pool: whole slabs of its heads (``import_slabs``), or
    a layer group of its heads inside the pool (``import_blocks_range``)."""
    L, rows, n = runner.kv.shape[0], tuple(runner.kv.shape[2:]), len(args[0])
    if method == "import_slabs":
        ok = shape == (n, L, *rows)
    else:
        ok = shape[1:] == (n, *rows) and 0 <= args[1] <= L - shape[0]
    if not ok:
        raise RuntimeError(f"rank {runner.ranks.rank}: {method} sent a KV "
                           f"share of shape {shape}; this rank's pool is "
                           f"{tuple(runner.kv.shape)}")


def follower_loop(runner, ranks,
                  channel: Optional[FollowerChannel] = None) -> None:
    """Replay the leader's runner calls until it sends ``_shutdown``, over
    the control group, or over the multi-host ``channel``, which also
    ends the loop, cleanly, when the leader closes it."""
    replayer = FollowerReplayer(runner)
    recv = ranks.broadcast if channel is None else channel.recv
    reply = ranks.gather if channel is None else channel.reply
    n = 0
    while True:
        frame = recv()
        if frame is None:
            logger.info("rank %d: the leader closed the control channel",
                        ranks.rank)
            return
        _, method, args, kwargs, digest = frame
        if method == "_shutdown":
            logger.info("rank %d: shutdown from the leader", ranks.rank)
            return
        n += 1
        replayer.check(n, digest)
        if method == "_report":
            reply(replayer.report())
            continue
        if channel is not None:
            args, kwargs = _unwire(args, kwargs, runner.device)
        with replayer.launched.counting():
            _follow(runner, ranks, replayer, method, args, kwargs, reply)


def _follow(runner, ranks, replayer, method: str, args: tuple,
            kwargs: dict, reply) -> None:
    """One of the leader's calls on a follower: a read-only gather, an
    adapter share (the channel's call frame carries it; the control group
    scatters it after the call), a KV share sent or received, or a
    replay."""
    if method == "_gather":
        reply(_host(getattr(runner, args[0])(*args[1:])))
    elif method == "register_lora":
        share = kwargs["share"] if "share" in kwargs else ranks.scatter()
        runner.put_lora(args[0], share, kwargs["root"])
    elif method in KV_GATHERS:
        # an export joins the tensor ranks (of each stage) of seq and
        # expert rank 0: the other seq and expert ranks move nothing
        if ranks.coord(AXIS_SEQ) or ranks.coord(AXIS_EXPERT):
            return
        part = getattr(runner, KV_GATHERS[method])(*args)
        if ranks.stage is None:
            ranks.tensor.gather_kv(part)
        elif part is not None:  # its stage holds some of the layers
            ranks.send_kv(part, 0, "kv_gather")
    elif method in KV_SCATTERS:
        shape = tuple(kwargs["shape"])
        if ranks.stage is not None:
            _follow_stage_import(runner, ranks, method, args, shape)
            return
        check_share(runner, method, args, shape)
        getattr(runner, KV_SCATTERS[method])(
            *args, ranks.scatter_kv(None, shape, runner.kv.dtype))
    else:
        try:
            replayer.replay(method, args, kwargs)
        except Exception:
            logger.exception("rank %d: replay of %s failed; the ranks can "
                             "no longer agree, exiting", ranks.rank, method)
            raise


def _follow_stage_import(runner, ranks, method: str, args: tuple,
                         shape: tuple) -> None:
    """A KV import on a grid with stages: ``shape`` is a tensor
    share of the whole; this process receives its stage's layers of it
    from rank 0, if its stage holds any, and writes them."""
    slabs = method == "import_slabs"
    ax = 1 if slabs else 0
    cut = runner.stage_cut(0 if slabs else args[1], shape[ax])
    if cut is None:
        return
    part = shape[:ax] + (cut[1],) + shape[ax + 1:]
    check_share(runner, method, args if slabs else (args[0], cut[0]), part)
    getattr(runner, KV_SCATTERS[method])(
        *args, ranks.recv_kv(0, part, runner.kv.dtype, "kv_scatter"))


def float32_math() -> dict:
    """This process's float32 math settings, which every rank must share
    so that the ranks compute their replicated parts (the norms, Whisper's
    conv front end) alike: TF32 in cuBLAS and in cuDNN, and the float32
    matmul precision."""
    return {"precision": torch.get_float32_matmul_precision(),
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32}


def set_float32_math(math: dict) -> None:
    torch.set_float32_matmul_precision(math["precision"])
    torch.backends.cuda.matmul.allow_tf32 = math["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = math["cudnn_tf32"]


def _watch_parent(parent_pid: int) -> None:
    """End this process when its parent is gone (a killed leader)."""

    def watch():
        while os.getppid() == parent_pid:
            time.sleep(0.5)
        os._exit(3)

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


def build_runner(config, params, num_blocks, ranks):
    """This rank's runner: a stage's on a grid with stages
    (engine/pp_runner.py ``StageRankRunner``), Whisper's for a Whisper
    model, the paged text engine's otherwise."""
    if ranks.stage is not None:
        from production_stack_tpu_torch.engine.pp_runner import (
            StageRankRunner,
        )

        return StageRankRunner(config, params, num_blocks, ranks)
    if config.model.architecture == "whisper":
        from production_stack_tpu_torch.engine.whisper_runner import (
            WhisperRunner,
        )

        return WhisperRunner(config, params=params, ranks=ranks)
    from production_stack_tpu_torch.engine.model_runner import ModelRunner

    return ModelRunner(config, params, num_blocks, ranks=ranks)


def follower_main(rank: int, store_port: int, devices: list, backend: str,
                  config, params, num_blocks, parent_pid: int, threads: int,
                  math: dict, grid) -> None:
    """A follower process: join the ``grid``'s group, build this rank's
    runner, and replay the leader's calls, with the leader's thread count
    and float32 math (``float32_math``)."""
    _watch_parent(parent_pid)
    torch.set_num_threads(threads)
    set_float32_math(math)
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format=f"%(asctime)s %(levelname)s rank{rank} %(name)s "
                   "%(message)s")
    ranks = pdist.init_rank(rank, grid.size, store_port, devices, backend,
                            grid=grid)
    try:
        follower_loop(build_runner(config, params, num_blocks, ranks),
                      ranks)
    finally:
        ranks.close()
    # the leader's _shutdown: nothing is left to flush but the log, and
    # the leader's stop waits on this process, so skip the interpreter's
    # teardown of torch and of the card's memory
    logging.shutdown()
    os._exit(0)


def refusal(config, grid=AXIS_TENSOR) -> Optional[str]:
    """What the processes of ``grid`` (a ``Grid``, or the name of its one
    axis) do not carry yet in ``config``, named as the flag that asks for
    it; None when they carry all of it. Tensor ranks carry every model and
    feature the port serves, and every grid with another axis above 1
    every text model and feature its runner serves (MoE models, int8
    weights, multi-LoRA, the prefix cache, a disaggregated role and the
    host and remote KV tiers included; a dense model at expert size N
    holds everything whole; with stages, what the staged runner serves).
    None of them carries a Whisper model beyond tensor ranks: its runner
    has no ring, no staged form and no experts to split."""
    axes = grid.axes if isinstance(grid, pdist.Grid) else (grid,)
    if set(axes) <= {AXIS_TENSOR}:
        return None
    m = config.model
    if m.architecture == "whisper":
        return f"--model {m.name} (Whisper)"
    return None


def start_ranks(config, params, num_blocks, device, grid,
                devices=None, backend: Optional[str] = None,
                whisper: bool = False):
    """Start the processes of ``grid`` (parallel/distributed.py ``Grid``)
    for an engine on ``device``: this process is rank 0, the others are
    spawned followers. ``devices`` (one a process, by global rank; default
    ``cuda:r`` on a card, the CPU otherwise) and ``backend`` (default
    ``nccl`` on a card, ``gloo`` on the CPU) are the caller's to choose; a
    rank whose card does not exist raises before any process starts.
    ``params`` is None (seeded or loaded on each rank) or the whole
    parameter dict, which every process cuts by its stage, tensor rank and
    expert rank. What the grid does not carry (``refusal``) raises before
    any process starts. ``whisper`` says the caller is a
    ``WhisperRunner``; a Whisper model for the text engine, or the
    reverse, raises before any process starts. Returns rank 0's
    ``MirroredRunner``."""
    size, what = grid.size, grid.parallelism
    why = refusal(config, grid)
    if why is not None:
        raise ValueError(f"{why}: not ported under {what} yet "
                         f"({grid.shape})")
    if (config.model.architecture == "whisper") != whisper:
        raise ValueError(
            f"{config.model.name} is not a Whisper model" if whisper else
            f"{config.model.name} is an encoder-decoder Whisper model: it "
            "runs on engine/whisper_runner.WhisperRunner, not the paged "
            "text engine")
    devices = list(devices or pdist.rank_devices(device, size))
    if len(devices) != size:
        raise ValueError(f"{len(devices)} rank devices for {size} ranks")
    backend = backend or pdist.default_backend(devices[0])
    pdist.check_devices(devices, what)
    if torch.device(devices[0]).type == "cuda" and not whisper:
        # built once here; the followers load the same libraries
        from production_stack_tpu_torch.ops import _build

        _build.build_all()
    store = pdist.open_store(size)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(
        target=follower_main, name=f"{grid.label}-rank-{r}", daemon=True,
        args=(r, store.port, devices, backend, config, params, num_blocks,
              os.getpid(), torch.get_num_threads(), float32_math(), grid))
        for r in range(1, size)]
    for p in procs:
        p.start()
    ranks = None
    try:
        pdist.await_ranks(store, procs)
        ranks = pdist.init_rank(0, size, store.port, devices, backend,
                                store=store, grid=grid)
        inner = build_runner(config, params, num_blocks, ranks)
    except BaseException:
        for p in procs:
            p.terminate()
            p.join(JOIN_SECONDS)
        if ranks is not None:
            ranks.close()
        raise
    return MirroredRunner(inner, ranks, procs)


# -- multi-host ranks: processes started on their own (module docstring) ---
def process_device(device, dcfg, devices=None) -> str:
    """This process's device in the multi-host group ``dcfg``: the one
    ``devices`` names where the caller names it, else ``cuda:i`` on a
    card, processes taking the machine's cards in turn by id, else the
    CPU."""
    if devices:
        if len(devices) != 1:
            raise ValueError(f"{len(devices)} devices for one process of "
                             "a multi-host group: name its own")
        return str(devices[0])
    if torch.device(device).type == "cuda":
        return f"cuda:{dcfg.process_id % max(torch.cuda.device_count(), 1)}"
    return "cpu"


def _grid_of(config, grid, tensor: int):
    """``grid``, or, given the name of an axis or None, the grid of
    ``config.mesh`` at tensor size ``tensor``."""
    return (grid if isinstance(grid, pdist.Grid)
            else pdist.Grid.of(config.mesh, tensor))


def check_group(config, dcfg, grid, tensor: int = 1) -> None:
    """Raise unless ``config`` can run on the multi-host group ``dcfg``
    as the processes of ``grid`` (``_grid_of``), in the reference's
    order: no pipeline stages (the staged runner's stages do not span
    processes), a coordinator of ``host:port``, no Whisper model (its
    serving is single-controller), no expert ranks (the reference's CLI
    has no flag for them), the grid's process count, and nothing the
    grid does not carry (``refusal``). The server turns this ValueError
    into its exit at start."""
    grid = _grid_of(config, grid, tensor)
    if grid.stage > 1:
        raise ValueError(
            "multi-host serving does not compose with the staged pipeline "
            f"runner (pipeline size {grid.stage}): shard across processes "
            "with --tensor-parallel-size or --sequence-parallel-size "
            "instead")
    dcfg.check()
    if config.model.architecture == "whisper":
        raise ValueError("multi-host serving does not run Whisper (its "
                         "serving is single-controller): scale it with "
                         "--tensor-parallel-size within one process tree "
                         "or add replicas")
    if grid.expert > 1:
        raise ValueError(
            f"multi-host serving does not reach the expert axis (expert "
            f"size {grid.expert}): the reference's CLI has no flag for "
            "it; start expert ranks through EngineConfig.mesh in one "
            "process tree")
    if dcfg.num_processes != grid.size:
        raise ValueError(
            f"--num-processes {dcfg.num_processes} does not match the "
            f"mesh's {grid.size} processes (tensor size {grid.tensor} x "
            f"sequence size {grid.seq}, one process a rank)")
    why = refusal(config, grid)
    if why is not None:
        raise ValueError(f"{why}: not ported under {grid.parallelism} yet")


def lead_ranks(config, params, num_blocks, device, dcfg, devices=None,
               backend: Optional[str] = None, grid=None, tensor: int = 1,
               secret: Optional[bytes] = None,
               bind_host: Optional[str] = None):
    """Process 0 of the multi-host group ``dcfg``, the processes of
    ``grid`` (``_grid_of``): wait on the channel for its ``num_processes
    - 1`` followers (each authenticated, then sent this process's
    settings), join the group (``join_world``), build the runner, and
    return it as a ``MirroredRunner`` over the channel. The channel binds
    the loopback where the coordinator is local, otherwise ``bind_host``
    (default ``PSTPU_CONTROL_BIND``, or every interface, as the
    reference). ``params``, where given, must be the followers' too: a
    follower whose ``weights_fingerprint`` differs raises here."""
    grid = _grid_of(config, grid, tensor)
    check_group(config, dcfg, grid)
    dev = process_device(device, dcfg, devices)
    backend = backend or pdist.default_backend(dev)
    secret = secret if secret is not None else control_secret()
    if bind_host is None and pdist.is_local(dcfg.coordinator_host):
        bind_host = pdist.HOST
    channel = LeaderBroadcaster(dcfg.control_port, dcfg.num_processes - 1,
                                secret, bind_host=bind_host,
                                weights=weights_fingerprint(params))
    ranks = None
    try:
        logger.info("waiting for %d follower(s) on control port %d",
                    dcfg.num_processes - 1, dcfg.control_port)
        channel.wait_for_followers()
        if torch.device(dev).type == "cuda":
            from production_stack_tpu_torch.ops import _build

            _build.build_all()
        ranks = pdist.join_world(dcfg, dev, backend, grid)
        inner = build_runner(config, params, num_blocks, ranks)
    except BaseException:
        channel.close()
        if ranks is not None:
            ranks.close()
        raise
    return MirroredRunner(inner, ranks, [], channel=channel)


def follow_leader(config, dcfg, device, devices=None,
                  backend: Optional[str] = None, grid=None, tensor: int = 1,
                  params=None, num_blocks=None,
                  secret: Optional[bytes] = None) -> None:
    """A follower of the multi-host group ``dcfg``, the processes of
    ``grid`` (``_grid_of``): reach the leader's channel
    (``connect_leader``; a refused handshake raises), take its settings,
    join the group, build this rank's runner as the leader builds its
    own, and replay the leader's calls until it sends ``_shutdown`` or
    closes the channel. ``params`` must be the leader's
    (``weights_fingerprint``): the leader refuses a follower with other
    weights."""
    grid = _grid_of(config, grid, tensor)
    check_group(config, dcfg, grid)
    dev = process_device(device, dcfg, devices)
    backend = backend or pdist.default_backend(dev)
    channel, settings = connect_leader(
        dcfg.coordinator_host, dcfg.control_port, dcfg.process_id, secret,
        weights=weights_fingerprint(params))
    ranks = None
    try:
        apply_settings(settings)
        if torch.device(dev).type == "cuda":
            from production_stack_tpu_torch.ops import _build

            _build.build_all()
        ranks = pdist.join_world(dcfg, dev, backend, grid)
        follower_loop(build_runner(config, params, num_blocks, ranks),
                      ranks, channel)
    finally:
        channel.close()
        if ranks is not None:
            ranks.close()
