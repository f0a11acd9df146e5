"""Logical axes, the reference's sharding rules, and each rank's cut of a
parameter.

A copy of production_stack_tpu/parallel/shardings.py's rules: parameters
carry *logical* axis names (``models/llama.param_specs``,
``models/whisper.param_specs``), and
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

Two kinds of leaf are cut here that GSPMD cuts with no rule of their
own in the reference:

- an int8 leaf ``{"q", "s"}`` (engine/quant.py): q is cut like its
  weight, and its scale only along the weight's output axes (the scale
  keeps the contracted axes as size-1 dims), so a row-parallel weight's
  scale (``wo``, ``w_down``) is whole on every rank;
- a LoRA adapter's stacked pairs ``A (L, in, R)``, ``B (L, R, *out)``
  (``LORA_AXES``): A is cut along its input where the target's input is
  sharded (``wo``, ``w_down``), B along its output where the target's
  output is (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``).

The MoE expert stacks ``(X, E, F)`` and ``(X, F, E)`` are cut along F
over ``tensor`` and along X over ``expert`` (expert rank e of N holds
experts ``[e X/N, (e+1) X/N)``; ``Shard.of``'s ``expert``), an int8
stack's ``(X, 1, N)`` scales along X with its q. One leaf carries the
``experts`` axis and stays whole on every expert rank, a deliberate
divergence from the reference: the router ``(E, X)``
(``WHOLE_ON_EXPERT_RANKS``, ``held_specs``). The reference splits its X
columns and GSPMD gathers the logits; here every rank routes every token
itself, and each logit is the same dot product either way.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch

from production_stack_tpu_torch.engine.quant import scale_axes
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


# leaves that carry the experts axis but are held whole on every expert
# rank (module docstring)
WHOLE_ON_EXPERT_RANKS = ("router",)

# LoRA target -> logical axes of its input and of its output (the
# adapted weight's contracted and output axes)
LORA_AXES = {
    "wq": ((EMBED,), (HEADS, HEAD_DIM)),
    "wk": ((EMBED,), (KV_HEADS, HEAD_DIM)),
    "wv": ((EMBED,), (KV_HEADS, HEAD_DIM)),
    "wo": ((HEADS, HEAD_DIM), (EMBED,)),
    "w_gate": ((EMBED,), (MLP,)),
    "w_up": ((EMBED,), (MLP,)),
    "w_down": ((MLP,), (EMBED,)),
}


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


def rules_for_model(cfg, tp: int, ep: int = 1) -> ShardingRules:
    """Model-aware rules at tensor-parallel degree ``tp`` and
    expert-parallel degree ``ep`` (every other mesh axis 1): a logical
    axis whose global size does not divide its mesh axis falls back to
    replication (e.g. GQA KV heads with num_kv_heads < tp, as
    Llama-3-8B's at tp 16; the experts where ``num_experts % ep != 0``,
    and always on a dense model, whose ``experts`` size is 1)."""
    shape = MeshConfig(tensor=tp, expert=ep).shape
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
    """Tensor rank ``rank`` of ``size`` (and expert rank ``expert[0]`` of
    ``expert[1]``): the ``[lo, hi)`` range it holds of each logical axis
    it does not hold whole (``cuts``), and which axes are sharded
    (``sharded``), so that the model knows where a product's partial
    sums need an all-reduce (heads: the attention out-projection; mlp:
    the down-projection), where the vocabulary is split (embedding,
    logits) and where the MoE combine is summed over the expert ranks
    (experts)."""

    rank: int
    size: int
    cuts: Mapping[str, Tuple[int, int]]
    sharded: frozenset

    @staticmethod
    def of(cfg, rank: int, size: int, expert: tuple = (0, 1)) -> "Shard":
        e, ep = expert
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        if not 0 <= e < ep:
            raise ValueError(f"expert rank {e} outside a group of {ep}")
        rules = rules_for_model(cfg, size, ep).rules
        sizes = {VOCAB: cfg.vocab_size, HEADS: cfg.num_heads,
                 KV_HEADS: cfg.num_kv_heads, MLP: cfg.intermediate_size}
        cuts, sharded = {}, set()
        if ep > 1 and rules[EXPERTS] == AXIS_EXPERT:
            step = cfg.num_experts // ep
            cuts[EXPERTS] = (e * step, (e + 1) * step)
            sharded.add(EXPERTS)
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

    def cut_leaf(self, x, logical_axes: tuple):
        """``cut`` for a plain leaf or an int8 one ``{"q", "s"}``: q as
        the weight, s along the axes it keeps (a size-1 dim of s where q
        has more is a contracted axis, whole on every rank)."""
        if not isinstance(x, dict):
            return self.cut(x, logical_axes)
        contracted = scale_axes(x)
        s_axes = tuple(None if i in contracted else a
                       for i, a in enumerate(logical_axes))
        return {"q": self.cut(x["q"], logical_axes),
                "s": self.cut(x["s"], s_axes)}

    def cut_lora(self, target: str, A, B, in_shape: tuple):
        """Rank's share of one target's stacked LoRA pair ``A (L, in, R)``
        and ``B (L, R, *out)``, ``in`` being ``in_shape`` flattened (the
        attention output's (heads, head_dim) for ``wo``)."""
        ins, outs = LORA_AXES[target]
        L, _, R = A.shape
        a = self.cut(A.reshape(L, *in_shape, R), (LAYERS, *ins, None))
        return (a.reshape(L, -1, R),
                self.cut(B, (LAYERS, None, *outs)))

    @property
    def experts(self) -> bool:
        """Whether this rank holds a share of the experts (the MoE
        combine is then summed over the expert ranks)."""
        return EXPERTS in self.sharded

    def local(self, axis: str, n: int) -> int:
        """The rank's extent of an axis of global size ``n``."""
        lo, hi = self.cuts.get(axis, (0, n))
        return hi - lo


def held_specs(specs: dict) -> dict:
    """``param_specs`` as the ranks hold the leaves: the
    ``WHOLE_ON_EXPERT_RANKS`` leaves' experts axis replicated."""
    return {name: held_specs(v) if isinstance(v, dict)
            else (tuple(None if a == EXPERTS else a for a in v)
                  if name in WHOLE_ON_EXPERT_RANKS else v)
            for name, v in specs.items()}


# -- the KV pool's head axis across the ranks ----------------------------------
#
# A pool slab's (2KH, D) rows are the reference's ``combine_kv(k, v, g)``
# layout: g groups of KH / g heads, each group its K rows then its V rows
# (production_stack_tpu/ops/paged_attention.py). g is the tensor-parallel
# size where KV heads shard and 1 where they are replicated (the
# reference's ``ModelRunner.tp``), so the bytes a transfer or a tier moves
# depend on g. A rank holds its KV heads [lo, hi) as (2 (hi - lo), D) rows
# in the g = 1 layout; where KV heads shard, rank r's rows are group r,
# so the ranks' shares side by side in rank order are the whole.


def kv_head_groups(cfg, tp: int) -> int:
    """The KV head grouping ``g`` of the pool's bytes at tensor-parallel
    size ``tp``: ``tp`` where KV heads shard, 1 where they are
    replicated."""
    if tp > 1 and rules_for_model(cfg, tp).rules[KV_HEADS] == AXIS_TENSOR:
        return tp
    return 1


def kv_head_rows(cfg, rank: int, tp: int) -> list[int]:
    """The rows of the whole ``(2KH, D)`` slab (grouped by
    ``kv_head_groups``) that rank ``rank``'s share holds, in the share's
    order: its heads' K rows, then their V rows."""
    KH = cfg.num_kv_heads
    lo, hi = Shard.of(cfg, rank, tp).cuts.get(KV_HEADS, (0, KH))
    hp = KH // kv_head_groups(cfg, tp)

    def row(h: int, part: int) -> int:
        g = h // hp
        return 2 * g * hp + part * hp + h - g * hp

    return [row(h, part) for part in (0, 1) for h in range(lo, hi)]


def _runs(pairs: list) -> list:
    """(source, first, n) runs of consecutive ``(source, index)`` pairs."""
    runs: list = []
    for src, i in pairs:
        if runs and runs[-1][0] == src and runs[-1][1] + runs[-1][2] == i:
            runs[-1][2] += 1
        else:
            runs.append([src, i, 1])
    return runs


def join_kv_shares(shares: list, cfg, tp: int):
    """The whole ``(..., 2KH, D)`` from every rank's ``(..., 2KH_r, D)``
    share in rank order (torch tensors): each row taken from the first
    rank that holds it, so a replicated head is read once. Where KV heads
    shard this is the shares side by side."""
    where: dict = {}
    for r in range(tp):
        for i, row in enumerate(kv_head_rows(cfg, r, tp)):
            where.setdefault(row, (r, i))
    if len(where) != 2 * cfg.num_kv_heads:
        raise ValueError(f"the ranks hold {len(where)} of the "
                         f"{2 * cfg.num_kv_heads} KV rows")
    parts = [shares[r].narrow(-2, i, n)
             for r, i, n in _runs([where[row] for row in sorted(where)])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def split_kv_share(whole, cfg, rank: int, tp: int):
    """Rank ``rank``'s ``(..., 2KH_r, D)`` share of a whole ``(..., 2KH,
    D)`` (a view where its rows are contiguous there)."""
    rows = kv_head_rows(cfg, rank, tp)
    parts = [whole.narrow(-2, i, n)
             for _, i, n in _runs([(0, row) for row in rows])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)
