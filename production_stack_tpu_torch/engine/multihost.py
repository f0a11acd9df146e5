"""Tensor-parallel ranks: the leader mirrors every device-touching runner
call to its followers, which replay it on their shard.

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

The reference sends frames over a TCP channel of its own, authenticated
for cross-host use; here the control group is gloo over the loopback
address among processes this one started (``start_ranks``), and the
cross-host control port and its secret belong to the multi-host slice.

The list starts from the reference's ``MIRRORED_METHODS`` and adds
``ragged_step`` (which the reference's list lacks) and the port's warmup
(``warm_decode_graphs``). It leaves out ``prefill_ring`` (not ported)
and the KV export/import calls: under tensor parallelism the server
refuses the routes that reach them (a rank holds only its KV heads, so
no whole block exists on one rank yet). It leaves out ``register_lora``
too, which ``MirroredRunner`` defines itself: the leader cuts every
rank's share of the adapter (``lora.adapter_share``) and sends each
follower only its own over the control group (``RankGroup.scatter``),
with the whole adapter's prefix-cache root; the whole of a rank-16
adapter on llama-3-8b is 168 MB in float32.

Agreement is checked, not assumed: each rank folds the tokens every call
sampled into a running digest, the leader sends its digest with each
call, and a follower whose digest differs logs the fault at once and
keeps the call it first diverged at; ``MirroredRunner.follower_reports``
gathers every rank's digest, call count, divergence and kernel launch
counts, and ``MirroredRunner.gather`` every rank's answer to a read-only
runner call (its KV blocks, say). Both run between runner calls, on the
thread that makes them. Chained decode dispatches pass the previous dispatch's
device-resident tokens (``tokens_dev``); those cannot be sent, so a
sentinel goes instead and each follower uses its own copy from its replay
of that dispatch, as in the reference.

Followers are started with the ``spawn`` method, as daemons of the leader:
they exit on the leader's ``_shutdown`` (``close``), are ended with the
leader's interpreter, and, if the leader is killed, leave within a second
through a parent-pid watch.
"""

from __future__ import annotations

import hashlib
import logging
import multiprocessing
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.kv_cache import adapter_root
from production_stack_tpu_torch.engine.lora import adapter_share
from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel.shardings import Shard

logger = logging.getLogger(__name__)

MIRRORED_METHODS = (
    "prefill", "ragged_step", "decode_multi", "set_count_row",
    "register_grammar", "drop_kv", "restore_kv", "drop_params",
    "restore_params", "pooled_embed", "sequence_logprobs", "prompt_logprobs",
    "warm_decode_graphs", "unregister_lora",
)
# sentinel for a device-resident arg the follower reconstructs locally
_CHAINED_NEXT_TOK = "__pstpu_chained_next_tok__"
# seconds a follower is given to leave after the leader's _shutdown
JOIN_SECONDS = 10.0


def sampled_tokens(method: str, result) -> Optional[np.ndarray]:
    """The tokens a runner call sampled, flattened (None for calls that
    sample none): a ragged step's samples and verify columns, a prefill's
    first tokens, a decode dispatch's (K, S) samples."""
    if method in ("ragged_step", "prefill"):
        # (sampled[, verify], tok_lp, top_ids, top_lps)
        toks = result[:len(result) - 3]
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
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _launches() -> dict:
    from production_stack_tpu_torch.ops import _build

    return {c.name.split()[0]: c.n for c in _build.COUNTERS}


class MirroredRunner:
    """Rank 0's runner: send the call, then run it locally.

    The send precedes the local call so the followers start as soon as the
    leader does; the control group keeps the leader's program order. Other
    attributes pass through to the local runner. ``close`` stops the
    followers and leaves the group."""

    def __init__(self, inner, ranks, procs: list):
        self._inner = inner
        self.ranks = ranks
        self.procs = procs
        self._digest = _Digest()
        self._pending = None  # (method, result) not yet folded
        self._seq = 0
        self._lock = threading.RLock()
        self._closed = False
        for name in MIRRORED_METHODS:
            if hasattr(inner, name):
                setattr(self, name, self._make_mirror(name))

    def _make_mirror(self, name: str):
        def mirrored(*args, **kwargs):
            self._send(name, args, kwargs)
            # looked up at call time: the compile tracker wraps the local
            # runner's step methods after this runner is made
            result = getattr(self._inner, name)(*args, **kwargs)
            self._pending = (name, result)
            return result

        mirrored.__name__ = name
        return mirrored

    def _fold(self) -> None:
        if self._pending is not None:
            self._digest.fold(*self._pending)
            self._pending = None

    def _check_alive(self) -> None:
        for r, p in enumerate(self.procs, start=1):
            if not p.is_alive():
                raise RuntimeError(
                    f"tensor-parallel rank {r} (pid {p.pid}) exited with "
                    f"code {p.exitcode}")

    def _send(self, method: str, args: tuple, kwargs: dict) -> None:
        if self._closed:
            raise RuntimeError("the tensor-parallel ranks are closed")
        with self._lock:
            self._check_alive()
            self._fold()
            if method == "decode_multi" and isinstance(
                    kwargs.get("tokens_dev"), torch.Tensor):
                kwargs = dict(kwargs, tokens_dev=_CHAINED_NEXT_TOK)
            self._seq += 1
            self.ranks.broadcast((self._seq, method, args, kwargs,
                                  self._digest.hex()))

    def register_lora(self, slot: int, bank_np: dict) -> None:
        """``ModelRunner.register_lora`` on every rank, each follower sent
        only its share of the adapter (module docstring)."""
        cfg, size = self._inner.cfg, self.ranks.size
        root = adapter_root(bank_np)
        shares = [adapter_share(bank_np, Shard.of(cfg, r, size), cfg)
                  for r in range(size)]
        with self._lock:
            self._send("register_lora", (slot,), {"root": root})
            self.ranks.scatter(shares)
            self._inner.put_lora(slot, shares[0], root)

    def report(self) -> dict:
        """This rank's agreement state and kernel launch counts."""
        return {"rank": 0, "pid": os.getpid(), "calls": self._digest.calls,
                "digest": self._digest.hex(), "diverged_at": None,
                "launches": _launches()}

    def follower_reports(self) -> list[dict]:
        """Every rank's report (``report``), rank 0's first. A follower's
        digest equals the leader's exactly when it sampled the same
        tokens in every call so far."""
        with self._lock:
            self._send("_report", (), {})
            return self.ranks.gather(self.report())

    def gather(self, method: str, *args) -> list:
        """Every rank's result of the read-only runner call ``method``,
        as numpy, in rank order (e.g. ``export_blocks``: each rank's KV
        heads of those blocks)."""
        with self._lock:
            self._send("_gather", (method, *args), {})
            return self.ranks.gather(_host(getattr(self._inner, method)(
                *args)))

    def close(self) -> None:
        """Stop the followers (``_shutdown``, then a join; one that does
        not leave in ``JOIN_SECONDS`` is terminated) and leave the
        group."""
        if self._closed:
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
        return {"rank": self.runner.ranks.rank, "pid": os.getpid(),
                "calls": self.digest.calls, "digest": self.digest.hex(),
                "diverged_at": self.diverged_at, "launches": _launches()}


def follower_loop(runner, ranks) -> None:
    """Replay the leader's runner calls until it sends ``_shutdown``."""
    replayer = FollowerReplayer(runner)
    while True:
        seq, method, args, kwargs, digest = ranks.broadcast()
        if method == "_shutdown":
            logger.info("rank %d: shutdown from the leader", ranks.rank)
            return
        replayer.check(seq, digest)
        if method == "_report":
            ranks.gather(replayer.report())
            continue
        if method == "_gather":
            ranks.gather(_host(getattr(runner, args[0])(*args[1:])))
            continue
        if method == "register_lora":
            runner.put_lora(args[0], ranks.scatter(), kwargs["root"])
            continue
        try:
            replayer.replay(method, args, kwargs)
        except Exception:
            logger.exception("rank %d: replay of %s failed; the ranks can "
                             "no longer agree, exiting", ranks.rank, method)
            raise


def _watch_parent(parent_pid: int) -> None:
    """End this process when its parent is gone (a killed leader)."""

    def watch():
        while os.getppid() == parent_pid:
            time.sleep(0.5)
        os._exit(3)

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


def follower_main(rank: int, size: int, store_port: int, devices: list,
                  backend: str, config, params, num_blocks, parent_pid: int,
                  threads: int) -> None:
    """A follower process: join the group, build this rank's runner, and
    replay the leader's calls."""
    from production_stack_tpu_torch.engine.model_runner import ModelRunner

    _watch_parent(parent_pid)
    torch.set_num_threads(threads)
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format=f"%(asctime)s %(levelname)s rank{rank} %(name)s "
                   "%(message)s")
    ranks = pdist.init_rank(rank, size, store_port, devices, backend)
    try:
        runner = ModelRunner(config, params, num_blocks, ranks=ranks)
        follower_loop(runner, ranks)
    finally:
        ranks.close()
    # the leader's _shutdown: nothing is left to flush but the log, and
    # the leader's stop waits on this process, so skip the interpreter's
    # teardown of torch and of the card's memory
    logging.shutdown()
    os._exit(0)


def refusal(config) -> Optional[str]:
    """What tensor parallelism does not carry yet in ``config``, named as
    the flag that asks for it; None when it carries all of it."""
    m, c = config.model, config.cache
    if m.architecture == "whisper":
        return "Whisper models"
    if config.role != "unified":
        return f"--role {config.role}"
    if c.kv_host_cache_bytes or c.host_offload_blocks:
        return "the host KV tier (--kv-host-cache-bytes/--host-offload-blocks)"
    if c.remote_kv_url:
        return "the remote KV tier (--remote-kv-url)"
    return None


def start_ranks(config, params, num_blocks, device, size: int,
                devices=None, backend: Optional[str] = None):
    """Start ``size`` tensor-parallel ranks for an engine on ``device``:
    this process is rank 0, the others are spawned followers. ``devices``
    (one a rank; default ``cuda:r`` on a card, the CPU otherwise) and
    ``backend`` (default ``nccl`` on a card, ``gloo`` on the CPU) are the
    caller's to choose; a rank whose card does not exist raises before any
    process starts. ``params`` is None (seeded or loaded on each rank) or
    the whole parameter dict, which every rank cuts. Returns rank 0's
    ``MirroredRunner``."""
    from production_stack_tpu_torch.engine.model_runner import ModelRunner

    why = refusal(config)
    if why is not None:
        raise ValueError(f"{why}: not ported under tensor parallelism yet "
                         f"(tensor-parallel size {size})")
    devices = list(devices or pdist.rank_devices(device, size))
    if len(devices) != size:
        raise ValueError(f"{len(devices)} rank devices for {size} ranks")
    backend = backend or pdist.default_backend(devices[0])
    pdist.check_devices(devices)
    if torch.device(devices[0]).type == "cuda":
        # built once here; the followers load the same libraries
        from production_stack_tpu_torch.ops import _build

        _build.build_all()
    store = pdist.open_store(size)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(
        target=follower_main, name=f"tp-rank-{r}", daemon=True,
        args=(r, size, store.port, devices, backend, config, params,
              num_blocks, os.getpid(), torch.get_num_threads()))
        for r in range(1, size)]
    for p in procs:
        p.start()
    ranks = None
    try:
        pdist.await_ranks(store, procs)
        ranks = pdist.init_rank(0, size, store.port, devices, backend,
                                store=store)
        inner = ModelRunner(config, params, num_blocks, ranks=ranks)
    except BaseException:
        for p in procs:
            p.terminate()
            p.join(JOIN_SECONDS)
        if ranks is not None:
            ranks.close()
        raise
    return MirroredRunner(inner, ranks, procs)
