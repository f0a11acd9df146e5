"""Rank start-up for every mesh of processes: tensor, sequence, expert
and pipeline parallelism alone or together, on one process grid, one
process a rank under torch.distributed, with two process groups.

- The **device group** carries the model's collectives (the float32
  all-reduces of the row-parallel products and of the vocab-parallel
  embedding; on an int8 model's W8A8 route the max of each row's
  activation scale and the exact int32 sum of the int8 products; the
  all-gather of the vocab-sharded logits) on each rank's device: ``nccl``
  where each rank has a card of its own, ``gloo`` on the CPU. gloo also
  takes CUDA tensors, staging them through host memory, which lets two
  ranks share one card for a check (NCCL refuses that). A ``seq`` view
  cuts no weights: it carries only the ring prefill's exchange
  (``ring_*``; parallel/ring_attention.py). A ``stage`` view carries only
  the stage relay. An ``expert`` view carries only the MoE block's
  combine (``moe_combine``), where the rules cut the experts over it.
- The **control group** is ``gloo`` on the CPU and carries the leader's
  step inputs to the followers (engine/multihost.py) and the few integers
  the ranks must agree on, such as the KV pool's block count.

**The grid** (``Grid``): named sizes ``stage``, ``seq``, ``expert`` and
``tensor``, ``stage * seq * expert * tensor`` processes, process ``g =
((stage_i * SEQ + seq_i) * EXP + expert_i) * T + tensor_i``. Outside the
tensor axis this is the reference's device order (``("data", "stage",
"seq", "tensor", "expert")``, production_stack_tpu/parallel/mesh.py);
the reference puts ``expert`` innermost, the port ``tensor``, so that the
tensor group, whose collectives run in every layer, has the neighbouring
cards under NCCL and the expert group's one combine a MoE layer crosses
farther. A process's ``RankGroup`` spans all of them: its device group is
torch.distributed's default group, its control group the same processes,
its shard the tensor and expert rank's (``shard_of``). It holds a view of
each axis above 1 (``views``): the processes that differ from it only on
that axis, a ``RankGroup`` with a device group of its own (where the axis
is the only one above 1, the group itself). An axis of size 1 has no view
and runs no collective, as in the reference, where axes of size 1 cost
nothing (production_stack_tpu/parallel/mesh.py:17-18). The views are
``tensor`` (the model's collectives and the KV shares of an export),
``seq`` (the ring), ``stage`` (the stage relay: ``relay_send``,
``relay_recv``, ``from_last``) and ``expert`` (the MoE combine). Every
process creates the subgroups in the same order, and the views add their
bytes to the process's ``wire``.

The rendezvous is a ``TCPStore`` that rank 0 opens on ``127.0.0.1`` at a
free port and hands to the ranks it starts; gloo binds the loopback
address too. The backend and every rank's device are the launcher's
arguments: a rank whose card does not exist raises (``check_devices``);
it never moves to another card or to the CPU.

**Multi-host** (``DistributedConfig``, ``join_world``): processes started
on their own, one a rank, each told the coordinator (``host:port`` of
process 0), the process count and its own id, by flags or by the
``PSTPU_*`` environment the chart sets. Process 0 opens the ``TCPStore``
at the coordinator's port, the others connect to it, and a process's
global rank is its id; each names its device in the store, so every
process knows every rank's. gloo binds the address of the interface that
routes to the coordinator (``local_address``; the loopback where the
coordinator is local). Such a group has no control group: its step
inputs and the followers' answers ride the authenticated channel of
engine/multihost.py, never a pickling collective, and only plain tensors
cross its device group (``min_int`` among them).

The reference reaches other chips through ``jax.distributed`` and XLA's
collectives (production_stack_tpu/parallel/distributed.py); its step
inputs ride a TCP channel of its own (engine/multihost.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import math
import os
import socket
import time
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from production_stack_tpu_torch.parallel.mesh import (
    AXIS_EXPERT,
    AXIS_SEQ,
    AXIS_STAGE,
    AXIS_TENSOR,
)
from production_stack_tpu_torch.parallel.shardings import Shard

HOST = "127.0.0.1"
# a step's collectives wait at most this long for the slowest rank
DEVICE_TIMEOUT = datetime.timedelta(minutes=10)
# a follower waits on the control group for the leader's next call for
# as long as the server idles; a leader that dies is noticed by the
# follower's parent watch (engine/multihost.py), not by this timeout
CONTROL_TIMEOUT = datetime.timedelta(days=365)
STORE_TIMEOUT = datetime.timedelta(seconds=120)
# ``RankGroup.wire``'s ops that move KV shares between the ranks (the KV
# plane's exports and imports), not a step's collectives
KV_OPS = ("kv_gather", "kv_scatter")
# its ops of the ring prefill (sequence parallelism): a K/V shard passed
# to the next rank, a layer's K/V gathered for every rank's pool, the last
# prompt token's hidden row sent to every rank, and a MoE layer's routed
# slots an expert sent to every rank (``moe_counts``). The perf
# accountant bills them to no dispatch
RING_OPS = ("ring_rotate", "ring_gather", "ring_last", "ring_moe_counts")
# its ops of the stage relay (a grid with stages): the residual stream
# sent to the next stage, the last stage's results (sampled tokens, scores)
# sent to the others. The perf accountant bills them to no dispatch
STAGE_OPS = ("stage_relay", "stage_last")
# the grid's axes, outermost first (module docstring)
GRID_AXES = (AXIS_STAGE, AXIS_SEQ, AXIS_EXPERT, AXIS_TENSOR)
# each axis as a message names its parallelism, in the order it lists them
_PARALLELISM = {AXIS_SEQ: "sequence", AXIS_STAGE: "pipeline",
                AXIS_EXPERT: "expert", AXIS_TENSOR: "tensor"}


@dataclasses.dataclass(frozen=True)
class Grid:
    """The processes of a mesh (module docstring): a size on each of
    ``GRID_AXES``, tensor innermost."""

    stage: int = 1
    seq: int = 1
    expert: int = 1
    tensor: int = 1

    def __post_init__(self):
        for a in GRID_AXES:
            if getattr(self, a) < 1:
                raise ValueError(f"grid axis {a} of size {getattr(self, a)}")

    @classmethod
    def of(cls, mesh, tensor: int) -> "Grid":
        """``mesh``'s processes (parallel/mesh.MeshConfig) at the resolved
        tensor size ``tensor``."""
        return cls(mesh.stage, mesh.seq, mesh.expert, tensor)

    @classmethod
    def named(cls, axis: str, size: int) -> "Grid":
        """``size`` processes on the one axis ``axis``."""
        if axis not in GRID_AXES:
            raise ValueError(f"no grid axis {axis!r}")
        return cls(**{axis: size})

    @property
    def shape(self) -> dict:
        return {a: getattr(self, a) for a in GRID_AXES}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def axes(self) -> tuple:
        """The axes above 1, outermost first."""
        return tuple(a for a, n in self.shape.items() if n > 1)

    @property
    def label(self) -> str:
        """The axes above 1 joined by commas (``seq,tensor``); ``tensor``
        for one process."""
        return ",".join(self.axes) or AXIS_TENSOR

    @property
    def parallelism(self) -> str:
        """The grid in words, as messages name it ("sequence and tensor
        parallelism")."""
        names = [n for a, n in _PARALLELISM.items() if a in self.axes] or [
            _PARALLELISM[AXIS_TENSOR]]
        head = ", ".join(names[:-1])
        return f"{head + ' and ' if head else ''}{names[-1]} parallelism"

    def coords(self, g: int) -> dict:
        """Process ``g``'s index on each axis."""
        if not 0 <= g < self.size:
            raise ValueError(f"process {g} outside the grid's {self.size}")
        out = {}
        for a in reversed(GRID_AXES):
            g, out[a] = divmod(g, getattr(self, a))
        return {a: out[a] for a in GRID_AXES}

    def process(self, **coords) -> int:
        """The process at ``coords`` (an axis left out is at 0)."""
        g = 0
        for a in GRID_AXES:
            g = g * getattr(self, a) + coords.get(a, 0)
        return g

    def members(self, g: int, axis: str) -> tuple:
        """The processes that differ from ``g`` only on ``axis``, by their
        index there: ``g``'s view of ``axis``."""
        c = self.coords(g)
        return tuple(self.process(**{**c, axis: i})
                     for i in range(getattr(self, axis)))

    def groups(self, axis: str) -> list:
        """Every view of ``axis``, once each, ordered by its first
        process."""
        return list(dict.fromkeys(self.members(g, axis)
                                  for g in range(self.size)))


@dataclasses.dataclass
class DistributedConfig:
    """The multi-host topology (the reference's, parallel/distributed.py
    there). Every field defaults from the environment, so the chart wires
    them without touching argv: ``PSTPU_COORDINATOR``,
    ``PSTPU_NUM_PROCESSES``, ``PSTPU_PROCESS_ID``, ``PSTPU_CONTROL_PORT``."""

    coordinator: Optional[str] = None  # host:port of process 0's store
    num_processes: int = 1
    process_id: int = 0
    # the leader's step-plan channel (engine/multihost.py); the
    # coordinator's port is the store's, this one is the channel's
    control_port: int = 18100

    @classmethod
    def from_env(cls, coordinator=None, num_processes=None, process_id=None,
                 control_port=None) -> "DistributedConfig":
        def pick(arg, env, cast, default):
            if arg is not None:
                return arg
            v = os.environ.get(env)
            return cast(v) if v else default

        return cls(
            coordinator=pick(coordinator, "PSTPU_COORDINATOR", str, None),
            num_processes=pick(num_processes, "PSTPU_NUM_PROCESSES", int, 1),
            process_id=pick(process_id, "PSTPU_PROCESS_ID", int, 0),
            control_port=pick(control_port, "PSTPU_CONTROL_PORT", int, 18100),
        )

    @property
    def enabled(self) -> bool:
        return self.num_processes > 1

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    @property
    def coordinator_host(self) -> str:
        return (self.coordinator or HOST).rsplit(":", 1)[0]

    @property
    def coordinator_port(self) -> int:
        return int(self.coordinator.rsplit(":", 1)[1])

    def check(self) -> None:
        """Raise unless the topology can be joined: a coordinator with a
        port when there are several processes (the reference's
        ``initialize_distributed``), and an id among them."""
        if not self.enabled:
            return
        if self.coordinator is None:
            raise ValueError(
                "multi-host serving needs --distributed-coordinator "
                "(host:port of process 0) when num_processes > 1")
        host, _, port = self.coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"--distributed-coordinator "
                             f"{self.coordinator!r} is not host:port")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(f"--process-id {self.process_id} outside the "
                             f"{self.num_processes} processes")


def is_local(host: str) -> bool:
    """Whether ``host`` names this machine's loopback."""
    try:
        ip = socket.getaddrinfo(host, None, socket.AF_INET)[0][4][0]
    except socket.gaierror:
        return False
    return ipaddress.ip_address(ip).is_loopback


def local_address(coordinator_host: str) -> str:
    """The address this process's gloo device binds: the loopback where
    the coordinator is local, otherwise the address of the interface the
    kernel routes to the coordinator through (a UDP ``connect`` picks the
    route and sends nothing)."""
    if is_local(coordinator_host):
        return HOST
    ip = socket.getaddrinfo(coordinator_host, None, socket.AF_INET)[0][4][0]
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((ip, 9))
        return s.getsockname()[0]


def rank_devices(device, size: int) -> list[str]:
    """Each rank's device when the caller names none: ``cuda:r`` for rank
    r on a card, the CPU for every rank otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [f"cuda:{r}" for r in range(size)]
    return ["cpu"] * size


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_devices(devices: Sequence[str],
                  what: str = "tensor parallelism") -> None:
    """Raise unless every rank's device exists on this machine (``what``
    names the parallelism in the message)."""
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
                f"{what} over {len(devices)} ranks puts rank "
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


def _gloo_options(host: str = HOST):
    opts = dist.ProcessGroupGloo._Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=host)]
    return opts


@dataclasses.dataclass
class RankGroup:
    """One process's place on the grid (``grid``; a group of one axis, as a
    view is, holds that axis's grid): its rank, its device, every rank's
    device, its shard of the model (``shard``, set by the model runner)
    and the two process groups (module docstring). ``axis`` is the grid's
    ``label``, or a view's one axis. ``pg`` is the device group (None:
    torch.distributed's default group) and ``members`` the global rank of
    each of its ranks (empty: the rank itself); ``views`` are its views of
    the axes above 1 (module docstring)."""

    rank: int
    size: int
    device: torch.device
    devices: tuple
    backend: str
    control: Any
    axis: str = AXIS_TENSOR
    shard: Optional[Shard] = None
    # per-card bytes the device group's collectives put on the wire, by
    # op (``_count``); the perf accountant reads them on rank 0
    wire: dict = dataclasses.field(default_factory=dict)
    pg: Any = None
    members: tuple = ()
    views: dict = dataclasses.field(default_factory=dict)
    host: str = HOST
    grid: Optional[Grid] = None

    def __post_init__(self):
        if self.grid is None:
            self.grid = Grid.named(self.axis, self.size)

    @property
    def cards(self) -> int:
        """Distinct cards the ranks run on (ranks may share one)."""
        return len({d for d in self.devices if d != "cpu"}) or 1

    def view(self, axis: str) -> Optional["RankGroup"]:
        """This process's view of ``axis``: the group itself where the
        axis is its only one, a subgroup on a grid of several, None where
        the axis is of size 1."""
        return self if self.axis == axis else self.views.get(axis)

    def coord(self, axis: str) -> int:
        """This process's index on ``axis`` (0 on an axis of size 1)."""
        return self.grid.coords(self.rank)[axis]

    @property
    def tensor(self) -> Optional["RankGroup"]:
        """The group the model's collectives run over (None at tensor
        size 1, where each process holds the model uncut by it)."""
        return self.view(AXIS_TENSOR)

    @property
    def seq(self) -> Optional["RankGroup"]:
        """The group the ring prefill runs over (None at seq size 1)."""
        return self.view(AXIS_SEQ)

    @property
    def stage(self) -> Optional["RankGroup"]:
        """The group the stage relay runs over: this process's pipeline
        of stages (None at one stage)."""
        return self.view(AXIS_STAGE)

    @property
    def expert(self) -> Optional["RankGroup"]:
        """The group the MoE combine runs over (None at expert size
        1)."""
        return self.view(AXIS_EXPERT)

    @property
    def tensor_size(self) -> int:
        """The tensor-parallel degree the group cuts the model over."""
        return self.grid.tensor

    @property
    def expert_size(self) -> int:
        """The expert-parallel degree."""
        return self.grid.expert

    def shard_of(self, cfg, rank: Optional[int] = None) -> Shard:
        """Process ``rank``'s (default this process's) cut of ``cfg``'s
        model: ``Shard.of`` at its tensor and expert ranks; nothing cut at
        tensor and expert size 1, where each process holds the whole
        model (of its stage)."""
        r = self.rank if rank is None else rank
        tp, ep = self.tensor_size, self.expert_size
        if tp == 1 and ep == 1:
            return Shard(r, self.size, {}, frozenset())
        c = self.grid.coords(r)
        return Shard.of(cfg, c[AXIS_TENSOR], tp,
                        (c[AXIS_EXPERT], ep) if ep > 1 else (0, 1))

    def _global(self, r: int) -> int:
        """The global rank of this group's rank ``r`` (torch.distributed
        names a peer and a root by it)."""
        return self.members[r] if self.members else r

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
        dist.all_reduce(y, group=self.pg)
        self._count("all_reduce", y.nbytes)
        return y if x.dtype == torch.float32 else y.to(x.dtype)

    def moe_combine(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the expert ranks of a MoE layer's float32 combine
        partials ``x (T, E)`` (each rank's kept slots' weighted rows, zero
        elsewhere; models/llama.py ``_moe_mlp``), in place where ``x`` is
        contiguous, counted under ``moe_combine`` as an all-reduce: 2 (n -
        1) / n of ``T E 4`` bytes from each card, ``T E 4`` at two
        ranks."""
        if x.dtype != torch.float32:
            raise TypeError(f"moe_combine of a {x.dtype} tensor")
        x = x.contiguous()
        dist.all_reduce(x, group=self.pg)
        self._count("moe_combine", x.nbytes)
        return x

    def all_reduce_int32(self, x: torch.Tensor) -> torch.Tensor:
        """The exact sum of the int32 ``x`` over the ranks (the int8
        products' partials), in place where ``x`` is contiguous. A float32
        sum of partials past 2^24 would round where one device's int32
        sum does not."""
        if x.dtype != torch.int32:
            raise TypeError(f"all_reduce_int32 of a {x.dtype} tensor")
        x = x.contiguous()
        dist.all_reduce(x, group=self.pg)
        self._count("all_reduce_int32", x.nbytes)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of the float32 ``x`` over the ranks (each
        row's activation absmax where the row is cut), in place where
        ``x`` is contiguous."""
        if x.dtype != torch.float32:
            raise TypeError(f"all_reduce_max of a {x.dtype} tensor")
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.pg)
        self._count("all_reduce_max", x.nbytes)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` side by side along the last dim, in rank
        order: the vocab-sharded logits joined."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.pg)
        self._count("all_gather", x.nbytes * self.size)
        return torch.cat(parts, dim=-1)

    def gather_kv(self, share: torch.Tensor) -> Optional[list]:
        """Every rank's KV share on rank 0, in rank order, over the device
        group; None elsewhere. The shares have one shape on every rank;
        they travel as their raw bytes (any dtype, exactly), and the
        followers' bytes count under ``kv_gather``."""
        raw = share.contiguous().view(torch.uint8)
        parts = ([torch.empty_like(raw) for _ in range(self.size)]
                 if self.rank == 0 else None)
        dist.gather(raw, parts, dst=self._global(0), group=self.pg)
        self._count_kv("kv_gather", raw.nbytes)
        return None if parts is None else [p.view(share.dtype) for p in parts]

    def scatter_kv(self, shares: Optional[list], shape: tuple,
                   dtype: torch.dtype) -> torch.Tensor:
        """Rank r's entry of rank 0's ``shares`` (each of ``shape`` and
        ``dtype``, on rank 0's device; the caller checks them before it
        sends the call), received on this rank's device over the device
        group: a follower receives only its own share. The followers'
        bytes count under ``kv_scatter``."""
        out = torch.empty(shape, dtype=dtype, device=self.device)
        raw = out.view(torch.uint8)
        parts = (None if self.rank else
                 [s.contiguous().view(torch.uint8) for s in shares])
        dist.scatter(raw, parts, src=self._global(0), group=self.pg)
        self._count_kv("kv_scatter", raw.nbytes)
        return out

    def _count_kv(self, op: str, share_bytes: int) -> None:
        """The bytes the followers' KV shares put on the wire, each once
        (``KV_OPS``: never a dispatch's collectives)."""
        self.wire[op] = (self.wire.get(op, 0.0)
                         + share_bytes * (self.size - 1))

    # -- the ring prefill's exchange (sequence parallelism) ---------------
    def _staged(self) -> bool:
        """Whether the ring's CUDA tensors go through host memory: gloo's
        send and receive read and write host memory only, and its other
        collectives stage CUDA tensors there themselves."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def ring_rotate(self, x: torch.Tensor):
        """Start sending ``x`` to rank ``(r + 1) % n`` and receiving the
        same shape from rank ``(r - 1) % n`` over the device group; returns
        a function that waits for both and gives the received tensor on
        this rank's device. Its bytes count once under ``ring_rotate``."""
        n, r = self.size, self.rank
        send = (x.cpu() if self._staged() else x).contiguous()
        recv = torch.empty_like(send)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._global((r + 1) % n),
                       self.pg),
            dist.P2POp(dist.irecv, recv, self._global((r - 1) % n),
                       self.pg)])
        self.wire["ring_rotate"] = (self.wire.get("ring_rotate", 0.0)
                                    + send.nbytes)

        def wait() -> torch.Tensor:
            for w in works:
                w.wait()
            return recv.to(self.device) if self._staged() else recv

        return wait

    def ring_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined along dim 0 in rank order (a layer's
        K/V of the prompt's slices, whole on every rank), counted under
        ``ring_gather`` as an all-gather: (n - 1) / n of the result from
        each card."""
        y = (x.cpu() if self._staged() else x).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.pg)
        self.wire["ring_gather"] = (self.wire.get("ring_gather", 0.0)
                                    + y.nbytes * (self.size - 1))
        return torch.cat(parts).to(self.device)

    def ring_last(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (the last prompt token's
        hidden row; ``x`` of the same shape and dtype elsewhere, its values
        unused), counted under ``ring_last``: (n - 1) / n of ``x`` from
        each card."""
        y = (x.cpu() if self._staged() else x).contiguous()
        dist.broadcast(y, src=self._global(src), group=self.pg)
        self.wire["ring_last"] = (self.wire.get("ring_last", 0.0)
                                  + y.nbytes * (self.size - 1) / self.size)
        return y.to(self.device) if self._staged() else y

    def moe_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Every rank's ``counts`` (a MoE layer's ``(X,)`` int32 slots
        routed to each expert on this rank's slice of the prompt), stacked
        ``(n, X)`` in rank order on this rank's device: a slot's position
        in the whole prompt counts the earlier ranks' (models/llama.py
        ``_moe_mlp``). Counted under ``ring_moe_counts`` as an all-gather:
        (n - 1) / n of the result from each card, L (n - 1) X 4 bytes a
        prompt over L MoE layers."""
        y = (counts.cpu() if self._staged() else counts).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.pg)
        self.wire["ring_moe_counts"] = (self.wire.get("ring_moe_counts", 0.0)
                                        + y.nbytes * (self.size - 1))
        return torch.stack(parts).to(self.device)

    # -- the stage relay (a grid with stages) -------------------------------
    def relay_send(self, x: torch.Tensor) -> None:
        """Send ``x`` (the residual stream) to the next stage, rank r + 1
        of this stage view; its bytes count under ``stage_relay`` on the
        sender."""
        y = (x.cpu() if self._staged() else x).contiguous()
        dist.send(y, self._global(self.rank + 1), group=self.pg)
        self.wire["stage_relay"] = (self.wire.get("stage_relay", 0.0)
                                    + y.nbytes)

    def relay_recv(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """The previous stage's ``relay_send``, of ``shape`` and ``dtype``,
        on this rank's device."""
        y = torch.empty(shape, dtype=dtype,
                        device="cpu" if self._staged() else self.device)
        dist.recv(y, self._global(self.rank - 1), group=self.pg)
        return y.to(self.device)

    def from_last(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's ``x`` on every stage (its sampled tokens or
        scores; ``x`` of the same shape and dtype elsewhere, its values
        unused), counted under ``stage_last``: (n - 1) / n of ``x`` from
        each card."""
        y = (x.cpu() if self._staged() else x).contiguous()
        dist.broadcast(y, src=self._global(self.size - 1), group=self.pg)
        self.wire["stage_last"] = (self.wire.get("stage_last", 0.0)
                                   + y.nbytes * (self.size - 1) / self.size)
        return y.to(self.device)

    # -- KV parts point to point (a grid with stages) ------------------------
    def send_kv(self, part: torch.Tensor, dst: int, op: str) -> None:
        """``part``'s raw bytes to rank ``dst`` over the device group,
        counted under ``op`` (one of ``KV_OPS``): a KV export's or
        import's part where the ranks' parts differ in shape."""
        raw = part.contiguous().view(torch.uint8)
        dist.send(raw.cpu() if self._staged() else raw, self._global(dst),
                  group=self.pg)
        self.wire[op] = self.wire.get(op, 0.0) + raw.nbytes

    def recv_kv(self, src: int, shape: tuple, dtype: torch.dtype,
                op: str) -> torch.Tensor:
        """Rank ``src``'s ``send_kv`` of ``shape`` and ``dtype``, on this
        rank's device, counted under ``op``."""
        out = torch.empty(shape, dtype=dtype, device=self.device)
        raw = out.view(torch.uint8)
        buf = torch.empty_like(raw, device="cpu") if self._staged() else raw
        dist.recv(buf, self._global(src), group=self.pg)
        if buf is not raw:
            raw.copy_(buf)
        self.wire[op] = self.wire.get(op, 0.0) + raw.nbytes
        return out

    def min_int(self, n: int) -> int:
        """The least of each rank's ``n``: over the control group, or, in
        a multi-host group, which has none, as a plain tensor over the
        device group (on the rank's device under NCCL)."""
        on = ("cpu" if self.control is not None or self.backend == "gloo"
              else self.device)
        t = torch.tensor([int(n)], dtype=torch.int64, device=on)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.control)
        return int(t.item())

    def _control(self):
        if self.control is None:
            raise RuntimeError(
                "a multi-host group has no control group: its messages "
                "ride the authenticated channel (engine/multihost.py)")
        return self.control

    def broadcast(self, obj=None):
        """Rank 0's ``obj`` on every rank (over the control group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self._control())
        return box[0]

    def scatter(self, objs: Optional[list] = None):
        """Rank r's entry of rank 0's ``objs`` (over the control group):
        each rank receives only its own."""
        out = [None]
        dist.scatter_object_list(out, objs if self.rank == 0 else None,
                                 src=0, group=self._control())
        return out[0]

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self._control())
        return out

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def _grid(grid: Optional[Grid], axis: str, size: int) -> Grid:
    """``grid``, or ``size`` processes on ``axis``; raises unless the grid
    has ``size`` processes."""
    grid = grid if grid is not None else Grid.named(axis, size)
    if grid.size != size:
        raise ValueError(f"{size} processes make no "
                         f"{grid.label.replace(',', ' x ')} grid of "
                         f"{grid.shape}")
    return grid


def init_rank(rank: int, size: int, store_port: int, devices: Sequence[str],
              backend: str, store: Optional[dist.TCPStore] = None,
              axis: str = AXIS_TENSOR, grid: Optional[Grid] = None
              ) -> RankGroup:
    """Join the ``size`` processes of ``grid`` (default: all of them on
    ``axis``) as ``rank``: rank 0 passes the ``store`` it opened, the
    others connect to ``store_port``. One group a process: the device
    group is torch.distributed's default group; the views of a grid of
    several axes are made here."""
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a "
                           "torch.distributed group")
    grid = _grid(grid, axis, size)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        check_devices(devices, grid.parallelism)
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
    group = RankGroup(rank, size, device, tuple(devices), backend, control,
                      grid.label, grid=grid)
    group.views = _grid_views(group)
    return group


def _grid_views(world: RankGroup) -> dict:
    """The views of ``world``'s process (module docstring), one an axis
    above 1: none where the grid has one such axis (the group is its own
    view); otherwise every view of each axis gets its device group, axis
    by axis in ``GRID_AXES`` order, made in the same order on every
    process."""
    grid = world.grid
    if len(grid.axes) < 2:
        return {}
    opts = _gloo_options(world.host) if world.backend == "gloo" else None
    views = {}
    for axis in grid.axes:
        for members in grid.groups(axis):
            pg = dist.new_group(members, backend=world.backend,
                                timeout=DEVICE_TIMEOUT, pg_options=opts)
            if world.rank in members:
                views[axis] = RankGroup(
                    members.index(world.rank), len(members), world.device,
                    tuple(world.devices[g] for g in members), world.backend,
                    None, axis, wire=world.wire, pg=pg, members=members,
                    host=world.host)
    return views


def join_world(cfg: DistributedConfig, device, backend: str,
               grid: Grid) -> RankGroup:
    """Join the multi-host group ``cfg`` names as rank ``process_id`` of
    ``num_processes``, the processes of ``grid``, spawning nothing:
    process 0 opens the store at the coordinator's port, the others
    connect to it (module docstring). ``device`` is this process's; every
    rank's is read from the store. The views of a grid of several axes
    are made here."""
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a "
                           "torch.distributed group")
    cfg.check()
    size, rank = cfg.num_processes, cfg.process_id
    grid = _grid(grid, AXIS_TENSOR, size)
    device = torch.device(device)
    if device.type == "cuda":
        check_devices([str(device)], grid.parallelism)
        torch.cuda.set_device(device)
    host = local_address(cfg.coordinator_host)
    store = dist.TCPStore(cfg.coordinator_host, cfg.coordinator_port, size,
                          rank == 0, timeout=STORE_TIMEOUT,
                          wait_for_workers=False)
    store.set(f"device{rank}", str(device))
    devices = tuple(store.get(f"device{r}").decode() for r in range(size))
    opts = _gloo_options(host) if backend == "gloo" else None
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=DEVICE_TIMEOUT,
                            pg_options=opts)
    group = RankGroup(rank, size, device, devices, backend, None,
                      grid.label, host=host, grid=grid)
    group.views = _grid_views(group)
    return group
