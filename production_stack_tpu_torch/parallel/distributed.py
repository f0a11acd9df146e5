"""Rank start-up for tensor parallelism: one process a rank under
torch.distributed, with two process groups.

- The **device group** carries the model's collectives (the float32
  all-reduces of the row-parallel products and of the vocab-parallel
  embedding; on an int8 model's W8A8 route the max of each row's
  activation scale and the exact int32 sum of the int8 products; the
  all-gather of the vocab-sharded logits) on each rank's device: ``nccl``
  where each rank has a card of its own, ``gloo`` on the CPU. gloo also
  takes CUDA tensors, staging them through host memory, which lets two
  ranks share one card for a check (NCCL refuses that).
- The **control group** is ``gloo`` on the CPU and carries the leader's
  step inputs to the followers (engine/multihost.py) and the few integers
  the ranks must agree on, such as the KV pool's block count.

The rendezvous is a ``TCPStore`` that rank 0 opens on ``127.0.0.1`` at a
free port and hands to the ranks it starts; gloo binds the loopback
address too. The backend and every rank's device are the launcher's
arguments, and nothing here reads an environment variable: a rank whose
card does not exist raises (``check_devices``); it never moves to another
card or to the CPU. Reaching ranks on other hosts is the multi-host
slice's work.

The reference reaches other chips through ``jax.distributed`` and XLA's
collectives (production_stack_tpu/parallel/distributed.py); its step
inputs ride a TCP channel of its own (engine/multihost.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from production_stack_tpu_torch.parallel.shardings import Shard

HOST = "127.0.0.1"
# a step's collectives wait at most this long for the slowest rank
DEVICE_TIMEOUT = datetime.timedelta(minutes=10)
# a follower waits on the control group for the leader's next call for
# as long as the server idles; a leader that dies is noticed by the
# follower's parent watch (engine/multihost.py), not by this timeout
CONTROL_TIMEOUT = datetime.timedelta(days=365)
STORE_TIMEOUT = datetime.timedelta(seconds=120)


def rank_devices(device, size: int) -> list[str]:
    """Each rank's device when the caller names none: ``cuda:r`` for rank
    r on a card, the CPU for every rank otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [f"cuda:{r}" for r in range(size)]
    return ["cpu"] * size


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_devices(devices: Sequence[str]) -> None:
    """Raise unless every rank's device exists on this machine."""
    n = torch.cuda.device_count()
    for r, d in enumerate(devices):
        dev = torch.device(d)
        if dev.type == "cpu":
            continue
        if dev.type != "cuda":
            raise ValueError(f"rank {r}: unsupported device {d!r}")
        index = 0 if dev.index is None else dev.index
        if index >= n:
            raise RuntimeError(
                f"tensor parallelism over {len(devices)} ranks puts rank "
                f"{r} on {d}, but this machine has {n} CUDA card(s)")


def open_store(size: int) -> dist.TCPStore:
    """Rank 0's rendezvous store on a free loopback port."""
    return dist.TCPStore(HOST, 0, size, True, timeout=STORE_TIMEOUT,
                         wait_for_workers=False)


def await_ranks(store: dist.TCPStore, procs: list) -> None:
    """Rank 0: wait until every started rank has reached the store,
    failing at once if one of their processes ends first (its exit code
    named), and after ``STORE_TIMEOUT`` if one never arrives."""
    t_end = time.monotonic() + STORE_TIMEOUT.total_seconds()
    for r, p in enumerate(procs, start=1):
        while not store.check([f"rank{r}/up"]):
            if not p.is_alive():
                raise RuntimeError(
                    f"tensor-parallel rank {r} (pid {p.pid}) exited with "
                    f"code {p.exitcode} before joining the group")
            if time.monotonic() > t_end:
                raise RuntimeError(f"tensor-parallel rank {r} did not join "
                                   f"the group in {STORE_TIMEOUT}")
            time.sleep(0.05)


def _gloo_options():
    opts = dist.ProcessGroupGloo._Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=HOST)]
    return opts


@dataclasses.dataclass
class RankGroup:
    """One rank's place in a tensor-parallel group: its rank, its device,
    every rank's device, its shard of the model (``shard``, set by the
    model runner) and the two process groups (module docstring)."""

    rank: int
    size: int
    device: torch.device
    devices: tuple
    backend: str
    control: Any
    shard: Optional[Shard] = None
    # per-card bytes the device group's collectives put on the wire, by
    # op (``_count``); the perf accountant reads them on rank 0
    wire: dict = dataclasses.field(default_factory=dict)

    @property
    def cards(self) -> int:
        """Distinct cards the ranks run on (ranks may share one)."""
        return len({d for d in self.devices if d != "cpu"}) or 1

    def _count(self, op: str, payload: int) -> None:
        """Add a collective's per-card wire bytes to ``wire[op]``: a ring
        all-reduce sends 2 (n - 1) / n of its payload from each card, an
        all-gather (n - 1) / n of the gathered result."""
        n = self.size
        fac = (n - 1) / n if op == "all_gather" else 2.0 * (n - 1) / n
        self.wire[op] = self.wire.get(op, 0.0) + payload * fac

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, in ``x``'s dtype. The sum is
        taken in float32 on every backend (the model's row-parallel
        partials are float32 already; a bf16 ``x`` is widened first and
        the total rounded once), so gloo computes what NCCL will. At two
        ranks the order of the sum cannot matter; above two it is the
        backend's ring order. A float32 ``x`` is summed in place."""
        y = x if x.dtype == torch.float32 else x.float()
        y = y.contiguous()
        dist.all_reduce(y)
        self._count("all_reduce", y.nbytes)
        return y if x.dtype == torch.float32 else y.to(x.dtype)

    def all_reduce_int32(self, x: torch.Tensor) -> torch.Tensor:
        """The exact sum of the int32 ``x`` over the ranks (the int8
        products' partials), in place where ``x`` is contiguous. A float32
        sum of partials past 2^24 would round where one device's int32
        sum does not."""
        if x.dtype != torch.int32:
            raise TypeError(f"all_reduce_int32 of a {x.dtype} tensor")
        x = x.contiguous()
        dist.all_reduce(x)
        self._count("all_reduce_int32", x.nbytes)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of the float32 ``x`` over the ranks (each
        row's activation absmax where the row is cut), in place where
        ``x`` is contiguous."""
        if x.dtype != torch.float32:
            raise TypeError(f"all_reduce_max of a {x.dtype} tensor")
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        self._count("all_reduce_max", x.nbytes)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` side by side along the last dim, in rank
        order: the vocab-sharded logits joined."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        self._count("all_gather", x.nbytes * self.size)
        return torch.cat(parts, dim=-1)

    def min_int(self, n: int) -> int:
        """The least of each rank's ``n`` (over the control group)."""
        t = torch.tensor([int(n)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.control)
        return int(t.item())

    def broadcast(self, obj=None):
        """Rank 0's ``obj`` on every rank (over the control group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def scatter(self, objs: Optional[list] = None):
        """Rank r's entry of rank 0's ``objs`` (over the control group):
        each rank receives only its own."""
        out = [None]
        dist.scatter_object_list(out, objs if self.rank == 0 else None,
                                 src=0, group=self.control)
        return out[0]

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.control)
        return out

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def init_rank(rank: int, size: int, store_port: int, devices: Sequence[str],
              backend: str, store: Optional[dist.TCPStore] = None
              ) -> RankGroup:
    """Join the group as ``rank``: rank 0 passes the ``store`` it opened,
    the others connect to ``store_port``. One group a process: the device
    group is torch.distributed's default group."""
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a "
                           "torch.distributed group")
    device = torch.device(devices[rank])
    if device.type == "cuda":
        check_devices(devices)
        torch.cuda.set_device(device)
    if store is None:
        store = dist.TCPStore(HOST, store_port, size, False,
                              timeout=STORE_TIMEOUT)
        store.set(f"rank{rank}/up", "1")
    opts = _gloo_options() if backend == "gloo" else None
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=DEVICE_TIMEOUT,
                            pg_options=opts)
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT,
                             pg_options=_gloo_options())
    return RankGroup(rank, size, device, tuple(devices), backend, control)
