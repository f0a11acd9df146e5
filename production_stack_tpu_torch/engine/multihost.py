"""Tensor- and sequence-parallel ranks: the leader mirrors every
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

The reference sends frames over a TCP channel of its own, authenticated
for cross-host use; here the control group is gloo over the loopback
address among processes this one started (``start_ranks``), and the
cross-host control port and its secret belong to the multi-host slice.

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

**Sequence parallelism** (``start_ranks(..., axis=AXIS_SEQ)``): every
rank holds the whole model, seeded or loaded on each rank, and a whole
pool, and replays every call on its own copy; ``prefill_ring`` is the one
call whose work the ranks divide, over the ring's exchange
(parallel/ring_attention.py). An adapter is sent whole to each rank, a
KV export is rank 0's own blocks (no call is sent), and an import sends
every follower the whole blocks. What the seq ranks do not carry yet
raises at start (``refusal``).

**The seq x tensor grid** (``start_ranks(..., axis=AXIS_GRID,
tensor=T)``, parallel/distributed.py): N seq ranks of T tensor ranks
each, N * T processes, process ``g`` holding tensor rank ``g % T``'s
shard, so the seq ranks of one tensor rank hold the same shard. Every
call goes to all N * T - 1 followers. An adapter share goes to each
process by its tensor rank. An export joins the tensor shares of seq rank
0's tensor group (``RankGroup.tensor``; the other followers take the call
and move nothing); an import sends each process its tensor share over the
device group of them all, every seq rank the same shares.

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

Followers are started with the ``spawn`` method, as daemons of the leader:
they exit on the leader's ``_shutdown`` (``close``), are ended with the
leader's interpreter, and, if the leader is killed, leave within a second
through a parent-pid watch.
"""

from __future__ import annotations

import contextlib
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
from production_stack_tpu_torch.parallel.mesh import AXIS_TENSOR
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


def sampled_tokens(method: str, result) -> Optional[np.ndarray]:
    """The tokens a runner call sampled, flattened (None for calls that
    sample none): a ragged step's samples and verify columns, a prefill's
    first tokens, a decode dispatch's (K, S) samples, a Whisper chunk's
    tokens."""
    if method == "chunk_request":
        return np.asarray(result[0], np.int64)
    if method in ("ragged_step", "prefill", "prefill_ring"):
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
    leader does; the control group keeps the leader's program order. Other
    attributes pass through to the local runner. ``close`` stops the
    followers and leaves the group."""

    def __init__(self, inner, ranks, procs: list):
        self._inner = inner
        self.ranks = ranks
        self.procs = procs
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

    def _check_alive(self) -> None:
        for r, p in enumerate(self.procs, start=1):
            if not p.is_alive():
                raise RankLost(
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
        shares = [adapter_share(bank_np, self.ranks.shard_of(cfg, r), cfg)
                  for r in range(size)]
        with self._lock:
            self._send("register_lora", (slot,), {"root": root})
            self.ranks.scatter(shares)
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
        """The whole of a KV gather on rank 0's device: its own blocks on
        seq ranks, which each hold them whole; its tensor group's shares
        joined otherwise (on the grid, seq rank 0's)."""
        self._check_blocks(args[0])
        tp = self.ranks.tensor
        if tp is None:
            return getattr(self._inner, KV_GATHERS[method])(*args)
        with self._lock:
            self._send(method, args, {})
            with self._launched.counting():
                mine = getattr(self._inner, KV_GATHERS[method])(*args)
            shares = self._moved(lambda: tp.gather_kv(mine))
        return join_kv_shares(shares, self._inner.cfg, tp.size)

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
        """This rank's agreement state, live Whisper handles and kernel
        launches inside the ranks' calls (``Launched``)."""
        return {"rank": 0, "pid": os.getpid(), "calls": self._digest.calls,
                "digest": self._digest.hex(), "diverged_at": None,
                "live": live_handles(self._inner),
                "launches": self._launched.counts()}

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
            with self._launched.counting():
                mine = _host(getattr(self._inner, method)(*args))
            return self.ranks.gather(mine)

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
        return {"rank": self.runner.ranks.rank, "pid": os.getpid(),
                "calls": self.digest.calls, "digest": self.digest.hex(),
                "diverged_at": self.diverged_at,
                "live": live_handles(self.runner),
                "launches": self.launched.counts()}


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
        with replayer.launched.counting():
            _follow(runner, ranks, replayer, method, args, kwargs)


def _follow(runner, ranks, replayer, method: str, args: tuple,
            kwargs: dict) -> None:
    """One of the leader's calls on a follower: a read-only gather, an
    adapter share, a KV share sent or received, or a replay."""
    if method == "_gather":
        ranks.gather(_host(getattr(runner, args[0])(*args[1:])))
    elif method == "register_lora":
        runner.put_lora(args[0], ranks.scatter(), kwargs["root"])
    elif method in KV_GATHERS:
        # an export joins seq rank 0's tensor group: on the grid the
        # other seq ranks move nothing
        seq = ranks.seq
        if seq is None or seq.rank == 0:
            ranks.tensor.gather_kv(getattr(runner, KV_GATHERS[method])(
                *args))
    elif method in KV_SCATTERS:
        shape = tuple(kwargs["shape"])
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
    """This rank's runner: Whisper's for a Whisper model, the paged text
    engine's otherwise."""
    if config.model.architecture == "whisper":
        from production_stack_tpu_torch.engine.whisper_runner import (
            WhisperRunner,
        )

        return WhisperRunner(config, params=params, ranks=ranks)
    from production_stack_tpu_torch.engine.model_runner import ModelRunner

    return ModelRunner(config, params, num_blocks, ranks=ranks)


def follower_main(rank: int, size: int, store_port: int, devices: list,
                  backend: str, config, params, num_blocks, parent_pid: int,
                  threads: int, math: dict, axis: str = AXIS_TENSOR,
                  tensor: int = 1) -> None:
    """A follower process: join the group, build this rank's runner, and
    replay the leader's calls, with the leader's thread count and float32
    math (``float32_math``)."""
    _watch_parent(parent_pid)
    torch.set_num_threads(threads)
    set_float32_math(math)
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format=f"%(asctime)s %(levelname)s rank{rank} %(name)s "
                   "%(message)s")
    ranks = pdist.init_rank(rank, size, store_port, devices, backend,
                            axis=axis, tensor=tensor)
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


def refusal(config, axis: str = AXIS_TENSOR) -> Optional[str]:
    """What the ranks of ``axis`` do not carry yet in ``config``, named as
    the flag that asks for it; None when they carry all of it. Tensor
    parallelism carries every model and feature the port serves. Sequence
    parallelism, alone or on the seq x tensor grid, carries the dense
    models at full precision, unified: Whisper, MoE models, int8 weights,
    a disaggregated role and the host and remote KV tiers are later
    slices."""
    if axis == AXIS_TENSOR:
        return None
    m, cache = config.model, config.cache
    if m.architecture == "whisper":
        return f"--model {m.name} (Whisper)"
    if getattr(m, "num_experts", 0):
        return f"--model {m.name} (a MoE model)"
    if m.quant:
        return f"--quantization {m.quant}"
    if config.role != "unified":
        return f"--role {config.role}"
    if cache.host_offload_blocks or cache.kv_host_cache_bytes:
        return "--kv-host-cache-bytes (the host KV tier)"
    if cache.remote_kv_url:
        return "--remote-kv-url (the remote KV tier)"
    return None


def start_ranks(config, params, num_blocks, device, size: int,
                devices=None, backend: Optional[str] = None,
                whisper: bool = False, axis: str = AXIS_TENSOR,
                tensor: int = 1):
    """Start ``size`` ranks of ``axis`` (tensor, seq, or the seq x tensor
    grid of ``size`` processes at tensor size ``tensor``: ``AXIS_GRID``)
    for an engine on ``device``:
    this process is rank 0, the others are spawned followers. ``devices``
    (one a rank; default ``cuda:r`` on a card, the CPU otherwise) and
    ``backend`` (default ``nccl`` on a card, ``gloo`` on the CPU) are the
    caller's to choose; a rank whose card does not exist raises before any
    process starts. ``params`` is None (seeded or loaded on each rank) or
    the whole parameter dict, which every rank cuts by its tensor rank (on
    the seq axis, keeps whole). What the axis does not carry
    (``refusal``) raises before any process starts. ``whisper`` says the
    caller is a ``WhisperRunner``; a Whisper model for the text engine, or
    the reverse, raises before any process starts. Returns rank 0's
    ``MirroredRunner``."""
    what = pdist.PARALLELISM[axis]
    if axis == pdist.AXIS_GRID:
        pdist.check_grid(size, tensor)
    why = refusal(config, axis)
    if why is not None:
        raise ValueError(f"{why}: not ported under {what} yet ({axis} "
                         f"size {size})")
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
        target=follower_main, name=f"{axis}-rank-{r}", daemon=True,
        args=(r, size, store.port, devices, backend, config, params,
              num_blocks, os.getpid(), torch.get_num_threads(),
              float32_math(), axis, tensor))
        for r in range(1, size)]
    for p in procs:
        p.start()
    ranks = None
    try:
        pdist.await_ranks(store, procs)
        ranks = pdist.init_rank(0, size, store.port, devices, backend,
                                store=store, axis=axis, tensor=tensor)
        inner = build_runner(config, params, num_blocks, ranks)
    except BaseException:
        for p in procs:
            p.terminate()
            p.join(JOIN_SECONDS)
        if ranks is not None:
            ranks.close()
        raise
    return MirroredRunner(inner, ranks, procs)
