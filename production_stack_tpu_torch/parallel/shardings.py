"""Logical axes, the reference's sharding rules, and each rank's cut of a
parameter.

A copy of production_stack_tpu/parallel/shardings.py's rules: parameters
carry *logical* axis names (``models/llama.param_specs``), and
``rules_for_model`` maps each to a mesh axis, or to None (replicated)
where its size does not divide the axis. The reference hands the rules to
GSPMD, which places the shards and inserts the collectives. Here each rank
holds its own shard (``Shard`` cuts a full leaf along every axis the
rules put on ``tensor``) and the model runs the collectives itself
(``models/llama.py``).

One case the reference leaves to XLA is made explicit: where query heads
are sharded but KV heads are replicated (KH % tp != 0, as tiny-llama's
two KV heads at tp 4), a rank keeps only the KV heads its query heads
read, so its KV pool and its attention kernels see the local group size.
That needs tp to be a multiple of KH: each rank then reads exactly one KV
head.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

from production_stack_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_SEQ,
    AXIS_STAGE,
    AXIS_TENSOR,
    MeshConfig,
)

# Logical axis names used by model definitions.
BATCH = "batch"
SEQUENCE = "sequence"
VOCAB = "vocab"
EMBED = "embed"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"
LAYERS = "layers"
EXPERTS = "experts"
KV_BLOCKS = "kv_blocks"
BLOCK = "block"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping of logical axes to mesh axes (None = replicated)."""

    rules: Mapping[str, Optional[str]] = dataclasses.field(
        default_factory=lambda: {
            BATCH: AXIS_DATA,
            SEQUENCE: AXIS_SEQ,
            VOCAB: AXIS_TENSOR,
            EMBED: None,
            HEADS: AXIS_TENSOR,
            KV_HEADS: AXIS_TENSOR,
            HEAD_DIM: None,
            MLP: AXIS_TENSOR,
            LAYERS: AXIS_STAGE,
            EXPERTS: AXIS_EXPERT,
            KV_BLOCKS: None,
            BLOCK: None,
        }
    )

    def spec(self, logical_axes: Tuple[Optional[str], ...]) -> tuple:
        """The mesh axis of each logical axis (a PartitionSpec's
        entries)."""
        return tuple(self.rules.get(a) if a is not None else None
                     for a in logical_axes)


def rules_for_model(cfg, tp: int) -> ShardingRules:
    """Model-aware rules at tensor-parallel degree ``tp`` (every other
    mesh axis 1): a logical axis whose global size does not divide its
    mesh axis falls back to replication (e.g. GQA KV heads with
    num_kv_heads < tp, as Llama-3-8B's at tp 16)."""
    shape = MeshConfig(tensor=tp).shape
    base = dict(ShardingRules().rules)
    sizes = {
        VOCAB: cfg.vocab_size,
        HEADS: cfg.num_heads,
        KV_HEADS: cfg.num_kv_heads,
        MLP: cfg.intermediate_size,
        LAYERS: cfg.num_layers,
        EXPERTS: getattr(cfg, "num_experts", 0) or 1,
    }
    for logical, size in sizes.items():
        axis = base.get(logical)
        if axis is not None and size % shape[axis] != 0:
            base[logical] = None
    return ShardingRules(rules=base)


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``size``: the ``[lo, hi)`` range it holds of each
    logical axis it does not hold whole (``cuts``), and which axes are
    sharded over ``tensor`` (``sharded``), so that the model knows where
    a product's partial sums need an all-reduce (heads: the attention
    out-projection; mlp: the down-projection) and where the vocabulary is
    split (embedding, logits)."""

    rank: int
    size: int
    cuts: Mapping[str, Tuple[int, int]]
    sharded: frozenset

    @staticmethod
    def of(cfg, rank: int, size: int) -> "Shard":
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        rules = rules_for_model(cfg, size).rules
        sizes = {VOCAB: cfg.vocab_size, HEADS: cfg.num_heads,
                 KV_HEADS: cfg.num_kv_heads, MLP: cfg.intermediate_size}
        cuts, sharded = {}, set()
        if size > 1:
            for axis, n in sizes.items():
                if rules[axis] == AXIS_TENSOR:
                    step = n // size
                    cuts[axis] = (rank * step, (rank + 1) * step)
                    sharded.add(axis)
            H, KH = cfg.num_heads, cfg.num_kv_heads
            if HEADS in sharded and KV_HEADS not in sharded:
                # replicated KV heads: keep the one this rank's heads read
                if size % KH:
                    raise ValueError(
                        f"tensor-parallel size {size} neither divides "
                        f"{cfg.name}'s {KH} KV heads nor is a multiple of "
                        "them: a rank's query heads would read an uneven "
                        "share of KV heads")
                kv = cuts[HEADS][0] // (H // KH)
                cuts[KV_HEADS] = (kv, kv + 1)
        return Shard(rank, size, cuts, frozenset(sharded))

    def cut(self, x, logical_axes: tuple):
        """Rank's part of a full leaf ``x`` (a torch tensor or a numpy
        array) whose dims carry ``logical_axes``: a view, narrowed along
        each cut axis."""
        if len(logical_axes) != len(x.shape):
            raise ValueError(f"{len(x.shape)}-d leaf against axes "
                             f"{logical_axes}")
        index = tuple(slice(*self.cuts[a]) if a in self.cuts
                      else slice(None) for a in logical_axes)
        return x[index]

    def local(self, axis: str, n: int) -> int:
        """The rank's extent of an axis of global size ``n``."""
        lo, hi = self.cuts.get(axis, (0, n))
        return hi - lo
