"""Device steps over the paged cache: the ragged unified step, the
bucketed prefill step and the decode step.

Ports the ragged and the bucketed path of
production_stack_tpu/engine/model_runner.py:

- ``ragged_step`` (``_ragged_step``): ONE forward over a packed token
  stream ``tokens (T,)`` that covers prefill chunks AND decode rows, with
  per-slot spans ``cu_q_lens (S+1,)`` in slot order; ``S`` is
  ``max_num_seqs``. The engine packs ``T = max_num_batched_tokens`` tokens
  as the reference does, whose compiled step keeps one shape; this eager
  step runs only the live tokens, rounded up to ``STREAM_ROUND``, so a
  step of a few decode rows or verify spans does not pay a full-budget
  forward. Each slot samples at its span's last token (``last_idx``).
- ``prefill`` (``_prefill_step``): one forward over ``P`` prefill chunks
  padded to one bucket, ``tokens (P, S)``; inactive rows carry context 0.
  Each chunk samples its first token at ``last_idx``.
- ``decode_multi`` (``_decode_multi_step``): ``multi_step`` fused
  decode+sample iterations over the fixed ``(S,)`` decode batch. Its host
  arrays go up in one copy into static device buffers
  (``step_graphs.StaticInputs``), and one body (``_decode_body``) runs the
  iterations over them: on a CUDA device, by default, as a CUDA graph
  captured once a ``DecodeKey`` (the static flags, ``multi_step`` and K3's
  plan rung: ``plan_ladder``) and replayed every step, the counterpart of
  the reference's jitted ``_decode_multi``; eagerly on the CPU and with
  ``SchedulerConfig.decode_graphs`` off, the same body over the same
  buffers. ``fetch=False`` and ``tokens_dev`` chain dispatches through the
  device-resident last tokens (the reference's ``chain_decode``).

Attention goes through the kernel wrappers (``ops/kv_write.py``,
``ops/ragged_paged_attention.py``, ``ops/paged_prefill_attention.py``,
``ops/paged_decode_attention.py``): their plain versions for CPU tensors,
the CUDA kernels for CUDA tensors. The pool is updated in place.

Every step takes per-token LoRA adapters (the multi-LoRA bank,
``register_lora``) and per-row grammars (the grammar bank,
``register_grammar``, applied by ``grammar_mask``); the ragged step also
verifies speculative drafts (``verify_idx``). These three are plain
PyTorch on tensors (gathers, ``torch.where``, matmuls), as in the
reference, where they run outside any Pallas kernel. The ragged and
bucketed prefill steps run eagerly.

The dense scoring path (``pooled_embed``, ``sequence_logprobs``,
``prompt_logprobs``) runs whole sequences through the model with no pool,
attending with ``ops/attention.dense_causal_attention`` (plain PyTorch, as
the reference's is XLA). Its transients are bounded: rows go in groups of
at most ``score_tokens()`` tokens, queries in blocks whose float32 scores
fit ``ATTN_SCORE_BYTES``, the MLP in chunks of the step's token budget,
and the LM head in chunks of ``LOGIT_CHUNK`` rows; ``_transient_bytes``
reserves the larger of a step's and this path's peak. ``drop_kv`` /
``drop_params`` and their ``restore_*`` are sleep mode's.

Parameters come from ``weights.init_or_load`` (random from the seed, or
a local checkpoint) or the caller, and pass through
``quant.maybe_quantize`` as in the reference. Each step hands the model
the token count of the reference's same step (``ref_tokens``: the
budget-wide T on the ragged path), which picks the int8 route and sets
Mixtral's MoE capacity (models/llama.py).

**Tensor parallelism.** With ``ranks`` (parallel/distributed.RankGroup)
the runner holds rank's shard of the weights (``weights.init_or_load``
or ``weights.shard_params`` with ``(rank, tp)``) and a KV pool of its own
KV heads in the tp = 1 layout (``combine_kv``), and passes the group to
the model, which runs the collectives (models/llama.py). Its geometry for
the pool and the kernels is the shard's (``self.local``: its query and
KV heads; where KV heads are replicated, the one its query heads read),
so K1-K4 run at the local group size. The pool's block count is the
least over the ranks (``_resolve_num_blocks``); ranks that share a card
must be given it. Decode graphs stay off: a gloo collective cannot be
captured, and capturing NCCL's is unchecked (ROADMAP). Every rank runs the
same calls in the same order (engine/multihost.py) and samples from the
same gathered logits, so their results agree. A KV export or import
gathers or scatters each rank's own heads on its device (``gather_*``,
``scatter_*``); rank 0's ``MirroredRunner`` moves the shares and joins
them into the whole blocks a transfer or a tier carries, grouped as the
reference's pool is at this tp (``kv_head_groups``).

**Sequence parallelism.** With ``ranks`` on the ``seq`` axis every rank
holds the whole model and a whole pool, and its group runs nothing in the
model (its ``Shard`` cuts no axis). ``prefill_ring`` is the reference's
``prefill_ring``: one long prompt, rank r running the model over its
``S / n`` tokens, the attention a ring over the ranks
(parallel/ring_attention.py), and each layer's K/V of all S tokens
gathered and written into every rank's pool by K1; every rank then
samples the same token from the same logits. Decode has no collective
under seq ranks, so each rank keeps its decode graphs on a card.

**The seq x tensor grid.** With ``ranks`` on the grid
(parallel/distributed.py ``AXIS_GRID``) the runner has two groups: the
model's collectives run over ``ranks.tensor`` (``group``), as at tensor
parallelism alone, and the ring over ``ranks.seq``, on this rank's
local query and KV heads (``self.local``: where KV heads are
replicated, as tiny-llama's two at tp 4, the one its query heads read,
which is all its queries need), so the ring rotates, gathers and writes
only this rank's KV heads. Decode runs the tensor group's collectives:
its graphs stay off, as at tensor parallelism alone.

**Expert parallelism.** With ``ranks`` on the ``expert`` axis (alone, or
the expert x tensor grid's ``AXIS_EP_GRID``) the runner holds its expert
rank's share of every expert stack (``expert_of``; the router and
everything outside the MoE block whole, or its tensor rank's cut on the
grid) and passes the expert group to the model, which sums each MoE
block's combine over it (models/llama.py ``_moe_mlp``). Activations, the
KV pool and sampling are every rank's own, as at tensor size 1 (or as
the tensor group's on the grid). Where the expert ranks sum a combine,
decode runs that collective, so its graphs stay off; where the rules
replicate the experts (a dense model, or ``X % N != 0``), the ranks run
no collective at tensor size 1 and keep their graphs. The pool is sized
from what the rank holds: its free memory after its share of the
weights, less its steps' transients at its own expert count.

``install_compile_observer`` wraps the ragged and prefill steps and the
decode step's program lookup (``decode_program``, which captures a new
key's graph) in the perf accountant's ``CompileTracker``, keyed on what the
card runs: the ragged step on its stream length (``stream_length``) and its
static flags, not on the budget-wide arrays it is handed; the decode step
on its graph key. ``drop_kv`` and ``drop_params`` drop every graph first;
the ``restore_*`` calls capture the held keys again.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import kv_cache as kvmod
from production_stack_tpu_torch.engine.config import EngineConfig, resolve_device
from production_stack_tpu_torch.engine.lora import bank_bytes
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGPROBS,
    MAX_TOKEN_CONTROLS,
    NEG_INF,
    apply_token_controls,
    compute_logprobs,
    penalize_logits,
    sample_tokens,
)
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.engine.quant import (
    DEQUANT_TILE_ELEMS,
    maybe_quantize,
)
from production_stack_tpu_torch.engine.step_graphs import (
    DecodeGraphs,
    Deferred,
    StaticInputs,
)
from production_stack_tpu_torch.engine.weights import (
    init_or_load,
    shard_params,
    to_device,
)
from production_stack_tpu_torch.models.registry import get_model
from production_stack_tpu_torch.ops.attention import dense_causal_attention
from production_stack_tpu_torch.ops.kv_write import kv_write
from production_stack_tpu_torch.ops.paged_attention import combine_kv
from production_stack_tpu_torch.ops.paged_decode_attention import (
    ladder_rung,
    paged_decode_attention,
    plan_ladder,
    split_plan,
)
from production_stack_tpu_torch.ops.paged_prefill_attention import (
    paged_prefill_attention,
)
from production_stack_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention,
    ragged_work_map,
)
from production_stack_tpu_torch.parallel import shardings as ln
from production_stack_tpu_torch.parallel.ring_attention import (
    ATTN_SCORE_BYTES as RING_SCORE_BYTES,
    ring_attention,
    ring_length,
)

_log = logging.getLogger(__name__)


# the ragged stream runs at its live length rounded up to this many tokens
STREAM_ROUND = 64
# the dense scoring path: the float32 score buffer of one query block, and
# the rows the LM head unembeds at once (the reference's prompt_logprobs
# chunk)
ATTN_SCORE_BYTES = 256 << 20
LOGIT_CHUNK = 128


def stream_length(budget: int, live: int) -> int:
    """The tokens a ragged step's forward runs: its ``live`` tokens rounded
    up to ``STREAM_ROUND``, at most the ``budget``-wide stream."""
    return min(budget, -(-live // STREAM_ROUND) * STREAM_ROUND)


class DecodeKey(NamedTuple):
    """What a decode step's program depends on beyond its inputs' values:
    the reference's static flags (greedy_only, use_penalties,
    use_controls, want_logprobs, use_grammar), the LoRA bank's target keys
    (None without adapters: a bank that gains a target needs a new graph,
    or the old one would skip its delta), ``multi_step`` and K3's plan
    rung. One CUDA graph a key."""
    greedy: bool
    penalties: bool
    controls: bool
    lora: Optional[tuple]
    grammar: bool
    logprobs: bool
    steps: int
    rung: int


def decode_fields(S: int, M: int) -> list:
    """The decode step's static inputs (``step_graphs.StaticInputs``), in
    the types its eager uploads had."""
    C = MAX_TOKEN_CONTROLS
    return [("tokens", np.int32, (S,)), ("positions", np.int32, (S,)),
            ("block_tables", np.int32, (S, M)),
            ("context_lens", np.int32, (S,)),
            ("slot_mapping", np.int32, (S,)), ("temps", np.float32, (S,)),
            ("top_ps", np.float32, (S,)), ("top_ks", np.int64, (S,)),
            ("seeds", np.int64, (S,)), ("steps", np.int64, (S,)),
            ("presence", np.float32, (S,)), ("frequency", np.float32, (S,)),
            ("ctrl_ids", np.int32, (S, C)), ("ctrl_vals", np.float32, (S, C)),
            ("ctrl_mode", np.int32, (S,)), ("adapter_ids", np.int64, (S,)),
            ("g_ids", np.int64, (S,)), ("g_states", np.int64, (S,))]


# inactive rows: no KV slot, no grammar, no token control
DECODE_EMPTY = {"slot_mapping": -1, "g_ids": -1, "ctrl_ids": -1}


def grammar_mask(logits, bank, accept, g_ids, g_states, eos_id):
    """Hard-constrain logits (B, V) to each row's FSM transitions.

    Rows with g_id < 0 pass through. Returns the masked logits and each
    row's transition row (B, V) int16, which the sampled token indexes for
    the next state. EOS is allowed exactly in accepting states; a row with
    no allowed token at all (which ``build_token_fsm`` prunes, unless the
    tokenizer drifted from a cached FSM) may take EOS rather than let the
    argmax emit token 0. Ports the reference's ``_grammar_mask``."""
    gi = g_ids.clamp(min=0).long()
    st = g_states.clamp(min=0).long()
    row_t = bank[gi, st]
    allowed = row_t >= 0
    if eos_id is not None:
        allowed[:, eos_id] |= accept[gi, st]
        dead = ~allowed.any(dim=-1, keepdim=True)
        is_eos = torch.arange(allowed.shape[-1], device=allowed.device) == eos_id
        allowed = allowed | (dead & is_eos[None, :])
    con = (g_ids >= 0)[:, None]
    return torch.where(con & ~allowed, NEG_INF, logits), row_t


class ModelRunner:
    """Owns params, the KV block pool and the step functions."""

    # decode dispatches chain through device-resident tokens
    # (``decode_multi``'s ``tokens_dev`` and ``fetch=False``)
    supports_chaining = True
    # every step returns the raw logits' logprobs beside its samples
    supports_logprobs = True

    def __init__(
        self,
        config: EngineConfig,
        params: Optional[dict] = None,
        num_blocks: Optional[int] = None,
        device="cuda",
        ranks=None,
        pool: bool = True,
        sharded: bool = False,
    ):
        """``pool=False`` leaves the KV pool to a later ``set_pool``: a
        pipeline's stages (engine/pp_runner.py) size theirs together, once
        every stage's weights are on its device. ``sharded``: a given
        ``params`` is this rank's share already (a stage's tensor shard on
        the pipeline x tensor grid), not the whole model to cut."""
        self.config = config
        self.cfg = config.model
        # the tensor- or sequence-parallel group (None on one device) and
        # this rank's geometry: its query and KV heads
        self.ranks = ranks
        self.local = self.cfg
        if ranks is not None:
            device = ranks.device
            ranks.shard = ranks.shard_of(self.cfg)
            for view in (ranks.tensor, ranks.expert):
                if view is not None:
                    view.shard = ranks.shard
            self.local = dataclasses.replace(
                self.cfg,
                num_heads=ranks.shard.local(ln.HEADS, self.cfg.num_heads),
                num_kv_heads=ranks.shard.local(ln.KV_HEADS,
                                               self.cfg.num_kv_heads))
        self.device = resolve_device(device)
        if (self.cfg.sliding_window
                and self.cfg.max_model_len > self.cfg.sliding_window):
            # local and global attention coincide only within the window;
            # beyond it this engine would silently diverge from the model
            raise ValueError(
                f"{self.cfg.name}: max_model_len {self.cfg.max_model_len} "
                f"exceeds the local-attention window "
                f"{self.cfg.sliding_window}; serve with max_model_len <= "
                "window (exactness gate, see ModelConfig.sliding_window)"
            )
        impl = config.attention_impl or "auto"
        if impl not in ("auto", "ragged", "bucketed"):
            raise ValueError(
                f"attention_impl must be auto|ragged|bucketed, got {impl!r}"
            )
        # auto is ragged on both devices (see EngineConfig.attention_impl)
        self.attention_impl = "ragged" if impl == "auto" else impl
        if self.cfg.architecture == "whisper":
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder Whisper model: it "
                "runs on engine/whisper_runner.WhisperRunner, not the paged "
                "text engine")
        self.model = get_model(self.cfg)
        if self.device.type == "cuda":
            # compile every kernel now, not on the first request
            from production_stack_tpu_torch.ops import _build

            _build.build_all()
        # every way params are made goes through maybe_quantize, as in the
        # reference: a caller's bf16 dict is quantized here under cfg.quant
        rank, tp = self.rank_of()
        if params is not None and ranks is not None and not sharded:
            # every rank gets the whole dict (on the CPU) and keeps its
            # cut, quantized whole first: a row-parallel weight's scale is
            # the max over its whole contraction
            params = to_device(shard_params(maybe_quantize(
                self.cfg, params), self.cfg, rank, tp, self.expert_of()),
                self.device)
        self.params = maybe_quantize(
            self.cfg, params if params is not None
            else init_or_load(self.cfg, config.seed, self.device, rank, tp,
                              expert=self.expert_of()))
        mbs = -(-self.cfg.max_model_len // config.cache.block_size)
        # table width padded to a multiple of 8, as the reference pads it
        # for its kernels' DMA windows (tables are 0-padded past live blocks)
        self.max_blocks_per_seq = (mbs + 7) // 8 * 8
        self.num_blocks: Optional[int] = None
        self.kv: Optional[torch.Tensor] = None
        if pool:
            self.set_pool(self._resolve_num_blocks(num_blocks))
        # per-slot output-token counts for presence/frequency penalties
        # ((S, V) int32, allocated on the first penalised batch)
        self.token_counts: Optional[torch.Tensor] = None
        # grammar masking must know where EOS lives (allowed exactly in
        # accepting FSM states)
        self.eos_id = get_tokenizer(self.cfg.tokenizer).eos_id
        # multi-LoRA bank: target -> (A (L, in, N, R), B (L, N, R, *out)) in
        # the model dtype, allocated per target by the first adapter that
        # has it; slot 0 stays zeros (the base model). A keeps the N slots
        # inside, so one layer's A is a single (in, N * R) matrix.
        self.lora_bank: Optional[dict] = None
        # each bank slot's prefix-cache chain root: a digest of the loaded
        # adapter's weights (kv_cache.adapter_root), HASH_SEED while the
        # slot is empty (its zero delta computes the base model's KV)
        self.lora_roots = [kvmod.HASH_SEED] * config.max_loras
        # constrained-decoding grammar bank: (G, S, V) int16 token
        # transition tables and (G, S) accept flags, allocated on the first
        # guided request (engine/grammar.py)
        self.grammar_bank: Optional[torch.Tensor] = None
        self.grammar_accept: Optional[torch.Tensor] = None
        # the decode step: static inputs, K3's plan ladder, and the graph
        # cache on a CUDA device with decode_graphs on (None: eager)
        sched = config.scheduler
        self.decode_steps = max(sched.multi_step, 1)
        self.decode_inputs = StaticInputs(
            decode_fields(sched.max_num_seqs, self.max_blocks_per_seq),
            self.device, DECODE_EMPTY)
        # a step's contexts reach at most max_model_len + multi_step - 1
        self.decode_rungs = plan_ladder(self.cfg.max_model_len
                                        + self.decode_steps - 1)
        # seq ranks, and expert ranks that hold every expert, decode with
        # no collective at tensor size 1, so they keep their graphs
        collective = ranks is not None and (ranks.tensor_size > 1
                                            or ranks.shard.experts)
        self.graphs: Optional[DecodeGraphs] = (
            DecodeGraphs() if self.device.type == "cuda"
            and sched.decode_graphs and not collective else None)
        if collective and self.device.type == "cuda":
            _log.info("tensor or expert parallel rank %d of %d: decode "
                      "graphs off (collectives are not captured)",
                      ranks.rank, ranks.size)
        self._graphed_kv: Optional[torch.Tensor] = None
        # keys whose graphs sleep dropped, captured again at wake
        self._held_keys: list = []

    # -- tensor and sequence parallelism -------------------------------------
    def rank_of(self) -> tuple[int, int]:
        """(tensor rank, tensor-parallel size) of this runner's cut of the
        weights; (0, 1) on one device and on seq ranks at tensor size 1,
        which hold them whole. The seq ranks of one tensor rank hold the
        same cut."""
        if self.ranks is None or self.ranks.tensor_size == 1:
            return (0, 1)
        return (self.ranks.tensor.rank, self.ranks.tensor_size)

    def expert_of(self) -> tuple[int, int]:
        """(expert rank, expert-parallel size) of this runner's share of
        the experts; (0, 1) off the expert axis and its grid. The tensor
        ranks of one expert rank hold the same experts."""
        if self.ranks is None or self.ranks.expert is None:
            return (0, 1)
        return (self.ranks.expert.rank, self.ranks.expert_size)

    @property
    def group(self):
        """The group the model's collectives run over: the tensor group
        (None on one device and on seq and expert ranks at tensor size
        1)."""
        return None if self.ranks is None else self.ranks.tensor

    @property
    def expert_group(self):
        """The group a MoE block's combine is summed over: the expert
        ranks of this tensor rank (None off the expert axis; the model
        sums nothing where the rules replicate the experts)."""
        return None if self.ranks is None else self.ranks.expert

    @property
    def local_experts(self) -> int:
        """The experts this runner holds (0 on a dense model)."""
        X = self.cfg.num_experts if self.model.is_moe(self.cfg) else 0
        if self.ranks is None:
            return X
        return self.ranks.shard.local(ln.EXPERTS, X)

    @property
    def seq_parallel(self) -> bool:
        """Whether this runner is a seq rank, alone or on the grid (the
        reference runner's ``seq_parallel``)."""
        return self.ranks is not None and self.ranks.seq is not None

    @property
    def tensor_parallel(self) -> int:
        """The degree the attention heads are sharded over (the
        reference's accountant keys its collectives on it): the group's
        size, 1 where the heads are replicated or there is no group."""
        if self.ranks is None or ln.HEADS not in self.ranks.shard.sharded:
            return 1
        return self.ranks.tensor_size

    @property
    def cards(self) -> int:
        """Distinct cards the ranks run on (two ranks may share one)."""
        return 1 if self.ranks is None else self.ranks.cards

    @property
    def kv_head_groups(self) -> int:
        """The KV head grouping of this engine's whole blocks, the bytes
        its transfers and tier slabs carry (``shardings.kv_head_groups``:
        the reference's pool layout at this tensor-parallel size)."""
        return (1 if self.ranks is None
                else ln.kv_head_groups(self.cfg, self.ranks.tensor_size))

    def _logits(self, hidden, tokens=None):
        return self.model.logits_from_hidden(self.cfg, self.params, hidden,
                                             tokens, self.group)

    # -- compile tracking ----------------------------------------------------
    def ragged_lengths(self) -> list[int]:
        """Every stream length ``ragged_step`` can run."""
        T = self.config.scheduler.max_num_batched_tokens
        return sorted({stream_length(T, live)
                       for live in range(STREAM_ROUND, T + STREAM_ROUND,
                                         STREAM_ROUND)})

    def install_compile_observer(self, observer) -> None:
        """Wrap ``ragged_step``, ``prefill``, ``prefill_ring`` (on seq
        ranks) and ``decode_program`` in ``CompileTracker``s reporting to
        ``observer(kind, bucket, seconds)``. A signature is a program's
        shape on the card and its static flags: greedy, LoRA, grammar,
        verify (ragged) and token controls (ring); a decode
        step's is its graph key (``DecodeKey``), so on the card a new
        signature is a capture and its seconds are the capture's (with the
        eager warm-up run before it)."""
        from production_stack_tpu_torch.engine.perf_accounting import (
            CompileTracker,
        )

        def flags(kw) -> tuple:
            return (bool(kw.get("greedy_only", False)),
                    kw.get("adapter_ids") is not None,
                    kw.get("g_ids") is not None)

        def ragged_n(tokens, *args, **kw) -> int:
            return stream_length(len(tokens), int(args[3][-1]))

        S = self.config.scheduler.max_num_seqs
        programs = {
            "ragged": ("ragged_step",
                       lambda *a, **kw: (ragged_n(*a), *flags(kw),
                                         kw.get("verify_idx") is not None),
                       lambda *a, **kw: str(ragged_n(*a))),
            "prefill": ("prefill",
                        lambda *a, **kw: (tuple(a[0].shape), *flags(kw)),
                        lambda *a, **kw: "x".join(map(str, a[0].shape))),
            "decode_multi": ("decode_program",
                             lambda key, plan: key,
                             lambda key, plan: f"{S}@{key.rung}"),
        }
        if self.seq_parallel:
            programs["prefill_ring"] = (
                "prefill_ring",
                lambda *a, **kw: (a[0].shape[1], *flags(kw),
                                  kw.get("ctrl") is not None),
                lambda *a, **kw: str(a[0].shape[1]))
        for kind, (attr, key, bucket) in programs.items():
            fn = getattr(self, attr)
            if isinstance(fn, CompileTracker):
                continue
            setattr(self, attr, CompileTracker(kind, fn, observer, key=key,
                                               bucket=bucket))

    # -- sizing ------------------------------------------------------------
    def score_tokens(self) -> int:
        """The most tokens one dense scoring forward runs: the power of two
        at or above ``max_model_len``, which every admitted scoring shape
        fits (row groups never exceed it)."""
        return 1 << (self.cfg.max_model_len - 1).bit_length()

    def score_bytes(self) -> int:
        """Device memory the dense scoring path needs beside the weights,
        at its largest forward (``score_tokens()`` rows): per row the
        residual, the normed input, q, k, v and the attention output in
        the model dtype, float32 RoPE and RMSNorm temporaries, and k and v
        in float32; one query block's scores; the MLP's chunk of
        ``max_num_batched_tokens`` rows (a MoE model's capacity buffer at
        one slot a token an expert); ``LOGIT_CHUNK`` rows of float32
        logits with their log-softmax; an int8 model's float32 and int8
        activation copies."""
        c = self.cfg
        S = self.score_tokens()
        T = min(self.config.scheduler.max_num_batched_tokens, S)
        b = c.torch_dtype.itemsize
        E, F = c.hidden_size, c.intermediate_size
        rows = S * (8 * E * b + 4 * E * 4 + 2 * self.local.num_kv_heads
                    * c.head_dim * 4)
        if self.local_experts:
            k, X = c.num_experts_per_tok, self.local_experts
            mlp = (X * T * (2 * E + 3 * F) * b + T * k * E * 4)
        else:
            mlp = 4 * T * F * b
        logits = 3 * LOGIT_CHUNK * c.vocab_size * 4
        extra = 0
        if c.quant:
            extra = S * E * (4 + 1 + 4) + T * F * (4 + 1 + 4) + (
                DEQUANT_TILE_ELEMS * b)
        return int(rows + 2 * ATTN_SCORE_BYTES + mlp + logits + extra)

    def _step_bytes(self, tokens: int, rows: int,
                    ref_tokens: Optional[int] = None) -> int:
        """Device memory one step of ``tokens`` tokens and ``rows`` sampled
        rows needs beside the pool: hidden states and MLP intermediates,
        the float32 logits with their sampling temporaries, an int8 model's
        float32 activations, int32 accumulators and one dequantized weight
        tile, a MoE model's capacity buffers (up to 2 T k / X rows an
        expert, T the reference call's ``ref_tokens``, at most ``tokens``,
        in and out, with their gate and up products, over the experts
        this rank holds)."""
        c = self.cfg
        hidden = tokens * c.hidden_size * 4
        mlp = tokens * c.intermediate_size * 2
        logits = rows * c.vocab_size * 4
        extra = 0
        if c.quant:
            wide = max(c.intermediate_size, c.hidden_size)
            # float32 activations, int8 copies, int32 accumulators; the
            # dequantized W8A16 tile
            extra += (tokens * wide * (4 + 1 + 4)
                      + DEQUANT_TILE_ELEMS * c.torch_dtype.itemsize)
        if self.local_experts:
            k, X = c.num_experts_per_tok, c.num_experts
            T = tokens if ref_tokens is None else ref_tokens
            slots = self.local_experts * min(max(int(2.0 * T * k / X), k),
                                             tokens)
            # dispatched rows in and out (E), gate, up and their product
            # (F), in the model dtype, and the gathered (T, k, E) float32
            extra += (slots * (2 * c.hidden_size + 3 * c.intermediate_size)
                      * c.torch_dtype.itemsize
                      + tokens * k * c.hidden_size * 4)
        return 8 * hidden + 4 * mlp + 4 * logits + extra

    def decode_graph_bytes(self) -> int:
        """The decode graphs' shared memory pool: one decode step's
        transients at ``max_num_seqs`` rows (graphs share the pool, and a
        capture reuses what the step frees), with the (S, V) float32
        copies the penalties, token controls and grammar make on top, the
        grammar's int16 transition rows and masks, and every iteration's
        outputs. Held for as long as the graphs are, beside the eager
        steps' transients; 0 where the step runs eagerly. (237 MB measured
        at llama-3-8b against 278 MB reserved, NVIDIA H100 80GB HBM3,
        chip_smoke.py phase 14.)"""
        sched = self.config.scheduler
        if self.device.type != "cuda" or not sched.decode_graphs:
            return 0
        S = sched.max_num_seqs
        flags = S * self.cfg.vocab_size * (3 * 4 + 2 + 1 + 1)
        outs = max(sched.multi_step, 1) * S * (2 + 4 * MAX_LOGPROBS) * 4
        return self._step_bytes(S, S) + flags + outs

    def _transient_bytes(self) -> int:
        """Device memory the steps need beside the pool: an eager step's
        (``_step_bytes``), the decode graphs' pool (``decode_graph_bytes``)
        and the grammar and LoRA banks at their full size (each is
        allocated at its first use, after the pool). A ragged step has T
        tokens and (S, V) logits. A bucketed prefill step has up to
        prefill_batch chunks padded to the bucket of the largest chunk the
        scheduler issues (as the reference's _prefill_temp_bytes sizes
        it), and its decode steps have (S, V) logits. The dense scoring
        path (``score_bytes``) runs between steps, so the reserve takes
        the larger of the two."""
        sched = self.config.scheduler
        c = self.cfg
        rows = sched.max_num_seqs
        if self.attention_impl == "ragged":
            tokens = sched.max_num_batched_tokens
        else:
            Pb = max(sched.prefill_batch, 1)
            chunk = min(sched.max_num_batched_tokens, c.max_model_len,
                        max(sched.prefill_buckets))
            tokens = Pb * sched.bucket_for(chunk)
            rows = max(rows, Pb)
        cfg = self.config
        grammar = cfg.max_grammars * cfg.max_grammar_states * (
            c.vocab_size * 2 + 1)
        lora = bank_bytes(c, cfg.max_loras, cfg.max_lora_rank,
                          c.torch_dtype.itemsize)
        # the dense scoring path and a ring prefill run between steps,
        # never inside one
        step = max(self._step_bytes(tokens, rows), self.score_bytes(),
                   self.ring_bytes())
        return int(step + self.decode_graph_bytes() + grammar + lora)

    def ring_bytes(self) -> int:
        """Device memory a ring prefill needs beside the pool at its
        longest prompt (``max_model_len``, padded as the engine pads it:
        ``ring_length``), 0 off seq ranks: a step's of this rank's slice
        of ``Sl`` tokens and one sampled row (``_step_bytes``), one query
        tile's float32 scores twice over (for their temporaries), the
        slice's float32
        queries, output and running state, the K/V shard in flight (sent,
        received and its float32 copies) and a layer's K/V of all ``S``
        tokens gathered; on the grid at this rank's local heads."""
        if not self.seq_parallel:
            return 0
        c, n = self.local, self.ranks.seq.size
        S = ring_length(c.max_model_len, n)
        Sl = S // n
        b = c.torch_dtype.itemsize
        kv_row = 2 * c.num_kv_heads * c.head_dim
        return int(self._step_bytes(Sl, 1, S) + 2 * RING_SCORE_BYTES
                   + 3 * Sl * c.num_heads * c.head_dim * 4
                   + Sl * kv_row * (3 * b + 4) + S * kv_row * b)

    def set_pool(self, num_blocks: int) -> None:
        """Allocate the KV pool at ``num_blocks`` blocks."""
        self.num_blocks = num_blocks
        self.kv = kvmod.init_kv_cache(self.local, self.config.cache,
                                      num_blocks, self.device)

    def _resolve_num_blocks(self, explicit: Optional[int]) -> int:
        """The pool's block count: the caller's, the config's, or sized
        from free memory; under tensor parallelism the least over the
        ranks, so that every rank's pool holds every block the scheduler
        hands out."""
        n = self._local_num_blocks(explicit)
        return n if self.ranks is None else self.ranks.min_int(n)

    def _local_num_blocks(self, explicit: Optional[int]) -> int:
        if explicit is not None:
            return explicit
        if self.config.cache.num_blocks > 0:
            return self.config.cache.num_blocks
        if self.device.type == "cpu":
            # no device memory to size from: room for every slot to hold a
            # full-length context
            return self.config.scheduler.max_num_seqs * self.max_blocks_per_seq
        if (self.ranks is not None
                and len(set(self.ranks.devices)) < self.ranks.size):
            # each would size its pool from the same free memory
            raise ValueError(
                "tensor-, sequence- or expert-parallel ranks that share a "
                "card must be given num_blocks")
        return max(self.pool_bytes() // self.block_bytes(), 16)

    def block_bytes(self) -> int:
        """One KV block's bytes in this runner's pool."""
        return kvmod.kv_cache_bytes_per_block(self.local, self.config.cache)

    def pool_bytes(self) -> int:
        """The card's memory this runner's pool may take: its free memory
        at ``hbm_utilization``, less the steps' transients and 1 GiB."""
        free, _total = torch.cuda.mem_get_info(self.device)
        return int(free * self.config.cache.hbm_utilization
                   - self._transient_bytes() - (1 << 30))

    # -- attention ---------------------------------------------------------
    def _attend_ragged(self, q, k, v, kv, layer, meta):
        """q (T, H, D), k/v (T, KH, D) over the packed stream: write the
        tokens' K+V, then attend each span against its slot's context."""
        newkv = combine_kv(k, v).to(kv.dtype).contiguous()
        kv_write(kv, newkv, meta["slot_mapping"], layer)
        out = ragged_paged_attention(
            q.contiguous(), kv, meta["block_tables"], meta["cu_q_lens"],
            meta["context_lens"], layer, soft_cap=self.cfg.attn_logit_softcap,
            tiles=meta["tiles"],
        )
        return out, kv

    def _attend_prefill(self, q, k, v, kv, layer, meta):
        """q (P, S, H, D), k/v (P, S, KH, D): the chunks' K+V written over
        the flattened (P*S) tokens (slot -1 on padding), then each chunk
        attends its context; inactive rows carry context 0."""
        P, S, KH, D = k.shape
        newkv = combine_kv(k.reshape(P * S, KH, D),
                           v.reshape(P * S, KH, D)).to(kv.dtype).contiguous()
        kv_write(kv, newkv, meta["slot_mapping"], layer)
        out = paged_prefill_attention(
            q.contiguous(), kv, meta["block_tables"], meta["q_starts"],
            meta["context_lens"], layer, soft_cap=self.cfg.attn_logit_softcap,
        )
        return out, kv

    def _attend_decode(self, q, k, v, kv, layer, meta):
        """q (B, H, D), k/v (B, KH, D): one token per slot."""
        newkv = combine_kv(k, v).to(kv.dtype).contiguous()
        kv_write(kv, newkv, meta["slot_mapping"], layer)
        out = paged_decode_attention(
            q.contiguous(), kv, meta["block_tables"], meta["context_lens"],
            layer, soft_cap=self.cfg.attn_logit_softcap, plan=meta["plan"],
        )
        return out, kv

    def _attend_ring(self, q, k, v, kv, layer, meta):
        """q (1, Sl, H, D), k/v (1, Sl, KH, D), this seq rank's slice of
        the prompt at its local heads: the ring over the seq ranks, then the
        layer's K+V of every seq rank's slice gathered
        (``RankGroup.ring_gather``) and all S rows written into this rank's
        pool (slot -1 on padding)."""
        seq = self.ranks.seq
        mine = combine_kv(k[0], v[0]).to(kv.dtype).contiguous()
        out = ring_attention(q, k, v, seq,
                             soft_cap=self.cfg.attn_logit_softcap)
        kv_write(kv, seq.ring_gather(mine), meta["slot_mapping"], layer)
        return out, kv

    def _forward(self, attend_impl, tokens, positions, meta, lora=None,
                 ref_tokens=None, seq=None):
        """The decoder stack over ``tokens``; ``ref_tokens`` is the token
        count of the reference's same step (models/llama.py), None where
        it runs the same rows as this one; ``seq`` the seq group of a ring
        prefill, whose ranks hold the prompt's slices."""
        def attend(q, k, v, kv, layer):
            return attend_impl(q, k, v, kv, layer, meta)

        hidden, self.kv = self.model.forward_tokens(
            self.cfg, self.params, tokens, positions, attend, self.kv, lora,
            ref_tokens, group=self.group, seq=seq, expert=self.expert_group)
        return hidden

    # -- constrained-decoding grammar bank ---------------------------------
    def register_grammar(self, slot: int, fsm) -> None:
        """Upload one TokenFsm's transition table into bank slot ``slot``
        (padded to the configured state budget)."""
        S = self.config.max_grammar_states
        V = self.cfg.vocab_size
        if fsm.n_states > S:
            raise ValueError(
                f"grammar needs {fsm.n_states} states > budget {S}"
            )
        self._ensure_grammar_bank()
        table = np.full((S, V), -1, np.int16)
        table[: fsm.n_states] = fsm.trans.astype(np.int16)
        acc = np.zeros(S, bool)
        acc[: fsm.n_states] = fsm.accept
        self.grammar_bank[slot] = self._dev(table)
        self.grammar_accept[slot] = self._dev(acc)

    def _ensure_grammar_bank(self) -> None:
        if self.grammar_bank is None:
            G = self.config.max_grammars
            S = self.config.max_grammar_states
            self.grammar_bank = torch.full((G, S, self.cfg.vocab_size), -1,
                                           dtype=torch.int16,
                                           device=self.device)
            self.grammar_accept = torch.zeros((G, S), dtype=torch.bool,
                                              device=self.device)

    # -- multi-LoRA bank ---------------------------------------------------
    def register_lora(self, slot: int, bank_np: dict) -> None:
        """Write an adapter's stacked (A (L, in, R), B (L, R, *out)) pairs
        (engine/lora.py ``load_adapter_raw``, float32 with the scaling
        folded into B) into bank slot ``slot``, cast to the model dtype as
        the reference casts them. One device only: under tensor
        parallelism engine/multihost.py ``MirroredRunner.register_lora``
        cuts each rank's share and calls ``put_lora`` on every rank."""
        self.put_lora(slot, bank_np, kvmod.adapter_root(bank_np))

    def put_lora(self, slot: int, share: dict, root: int) -> None:
        """Write this rank's ``share`` of an adapter into bank slot
        ``slot``, keyed in the prefix cache by ``root``, the whole
        adapter's ``kv_cache.adapter_root``: every rank, and one device,
        key its blocks the same."""
        N = self.config.max_loras
        dt = self.cfg.torch_dtype
        if self.lora_bank is None:
            self.lora_bank = {}
        for key, (A_st, B_st) in share.items():
            if key not in self.lora_bank:
                L, E, R = A_st.shape
                self.lora_bank[key] = (
                    torch.zeros((L, E, N, R), dtype=dt, device=self.device),
                    torch.zeros((L, N, *B_st.shape[1:]), dtype=dt,
                                device=self.device),
                )
            A_dev, B_dev = self.lora_bank[key]
            A_dev[:, :, slot] = self._dev(A_st, dt)
            B_dev[:, slot] = self._dev(B_st, dt)
        self.lora_roots[slot] = root

    def unregister_lora(self, slot: int) -> None:
        self.lora_roots[slot] = kvmod.HASH_SEED
        if self.lora_bank is None:
            return
        for A_dev, B_dev in self.lora_bank.values():
            A_dev[:, :, slot] = 0
            B_dev[:, slot] = 0

    def _lora(self, adapter_ids) -> Optional[dict]:
        """The forward's ``lora`` argument for adapter ids of any shape
        (one a token, or one a row of a step whose rows broadcast over
        their tokens), or None without adapters."""
        if adapter_ids is None or self.lora_bank is None:
            return None
        return self._lora_of(self._dev(adapter_ids, torch.int64))

    def _lora_of(self, ids: torch.Tensor) -> dict:
        """The ``lora`` argument for int64 adapter ids on the device."""
        onehot = torch.nn.functional.one_hot(ids, self.config.max_loras)
        return {"onehot": onehot.to(self.cfg.torch_dtype),
                "bank": self.lora_bank}

    def _grammar(self, g_ids, g_states) -> Optional[list]:
        """[g_ids, g_states] on the device for ``_process_logits``, or None
        when the step has no guided row."""
        if g_ids is None or self.grammar_bank is None:
            return None
        return [self._dev(g_ids, torch.int64), self._dev(g_states, torch.int64)]

    # -- the dense scoring path (no pool) -----------------------------------
    def _score_groups(self, N: int, S: int):
        """(row group, query block) of a dense forward over (N, S): rows in
        groups of at most ``score_tokens()`` tokens, queries in blocks whose
        float32 scores fit ``ATTN_SCORE_BYTES``."""
        g = max(1, min(N, self.score_tokens() // S))
        blk = max(1, ATTN_SCORE_BYTES // (g * self.local.num_heads * S * 4))
        return g, blk

    def score_forwards(self, rows: np.ndarray, S: int) -> list:
        """(rows, query block) of each dense forward a scoring call runs
        over ``rows`` of its (N, S) tokens, in order (``_score_groups``);
        a pipeline stage that only relays runs the same ones."""
        g, blk = self._score_groups(len(rows), S)
        return [(rows[r0:r0 + g], blk) for r0 in range(0, len(rows), g)]

    def _dense_hidden(self, tokens: torch.Tensor, q_block: int,
                      ref_tokens: int) -> torch.Tensor:
        """Final hidden states (g, S, E) of a dense causal forward over
        ``tokens (g, S)`` at positions 0..S-1; ``ref_tokens`` is the token
        count of the reference's whole call (models/llama.py)."""
        cfg = self.cfg

        def attend(q, k, v, kv, layer):
            return dense_causal_attention(
                q, k, v, soft_cap=cfg.attn_logit_softcap,
                q_block=q_block), kv

        positions = torch.arange(tokens.shape[1], device=self.device
                                 ).expand(tokens.shape)
        hidden, _ = self.model.forward_tokens(
            cfg, self.params, tokens, positions, attend, None,
            ref_tokens=ref_tokens,
            mlp_rows=self.config.scheduler.max_num_batched_tokens,
            group=self.group, expert=self.expert_group)
        return hidden

    @torch.inference_mode()
    def pooled_embed(self, tokens: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
        """Mean of the final hidden states over ``mask``'s positions, a
        dense causal forward a row group at a time. tokens, mask (N, S);
        returns (N, E) float32."""
        N, S = tokens.shape
        out = []
        for rows, blk in self.score_forwards(np.arange(N), S):
            hidden = self._dense_hidden(self._dev(tokens[rows]), blk, N * S)
            m = self._dev(mask[rows], torch.float32)[:, :, None]
            pooled = (hidden.float() * m).sum(dim=1)
            out.append(pooled / m.sum(dim=1).clamp(min=1.0))
        return torch.cat(out).cpu().numpy()

    @torch.inference_mode()
    def sequence_logprobs(self, tokens: np.ndarray,
                          cont_mask: np.ndarray) -> np.ndarray:
        """Sum of log P(token_j | tokens_<j) over the positions
        ``cont_mask`` sets, teacher-forced in a dense causal pass: the
        score of a continuation given its prompt. tokens (N, S) 0-padded,
        cont_mask (N, S) bool marking the continuation tokens (each
        predicted at the position before it). Returns (N,) float32.

        The (N, S, V) logits of the reference never exist: rows run in
        groups, and the LM head unembeds only the predicting positions,
        ``LOGIT_CHUNK`` rows at a time. A row with no continuation scores
        0, as its masked sum does in the reference."""
        N, S = tokens.shape
        ref = N * S
        out = np.zeros(N, np.float32)
        live = np.flatnonzero(cont_mask[:, 1:].any(axis=1))
        for rows, blk in self.score_forwards(live, S):
            hidden = self._dense_hidden(self._dev(tokens[rows]), blk, ref)
            r, j = np.nonzero(cont_mask[rows, 1:])  # logits at j predict j+1
            tgt = self._dev(tokens[rows][r, j + 1], torch.int64)
            ridx, jidx = self._dev(r, torch.int64), self._dev(j, torch.int64)
            # each term at its (row, position), then one sum a row: the
            # same order on every run (no atomic adds)
            picked = torch.zeros((len(rows), S - 1), dtype=torch.float32,
                                 device=self.device)
            for c0 in range(0, len(r), LOGIT_CHUNK):
                sl = slice(c0, c0 + LOGIT_CHUNK)
                logits = self._logits(hidden[ridx[sl], jidx[sl]], ref)
                picked[ridx[sl], jidx[sl]] = torch.log_softmax(
                    logits, dim=-1).gather(1, tgt[sl, None])[:, 0]
            out[rows] = picked.sum(dim=1).cpu().numpy()
        return out

    @torch.inference_mode()
    def prompt_logprobs(self, tokens: np.ndarray):
        """Per-position next-token logprobs of a prompt, teacher-forced in
        one dense causal pass. tokens (1, S) 0-padded; returns (tok_lps
        (S-1,), top_ids (S-1, N), top_lps (S-1, N)), row p holding
        position p's prediction of token p+1 from the raw model
        distribution (as generation logprobs); rows at or past the live
        length are the caller's to slice off. The LM head runs
        ``LOGIT_CHUNK`` positions at a time, as the reference's."""
        S = tokens.shape[1]
        _, blk = self._score_groups(1, S)
        tok = self._dev(tokens)
        hidden = self._dense_hidden(tok, blk, S)[0, :-1]
        targets = tok[0, 1:].long()
        parts = []
        for c0 in range(0, S - 1, LOGIT_CHUNK):
            logits = self._logits(hidden[c0:c0 + LOGIT_CHUNK])
            parts.append(compute_logprobs(logits,
                                          targets[c0:c0 + LOGIT_CHUNK]))
        return tuple(torch.cat(col).cpu().numpy() for col in zip(*parts))

    # -- sleep mode ----------------------------------------------------------
    def _release_memory(self) -> None:
        """Hand freed device memory back to the card (``mem_get_info``
        and other processes see it), not only to PyTorch's cache. cuBLAS
        keeps a workspace a handle in PyTorch's allocator, carved from
        whatever segment was free at the first product: one left in a
        segment the weights share would keep the whole segment, so the
        workspaces go too (cuBLAS makes them again at the next product). A
        captured product would replay into a freed workspace, so the
        decode graphs go before this runs (``_drop_graphs``)."""
        if self.device.type == "cuda":
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()
            torch.cuda.empty_cache()

    def drop_kv(self) -> None:
        self._drop_graphs()
        self.kv = None
        self._release_memory()

    def restore_kv(self) -> None:
        if self.kv is None:
            self.kv = kvmod.init_kv_cache(self.local, self.config.cache,
                                          self.num_blocks, self.device)
        self._recapture()

    def drop_params(self) -> None:
        self._drop_graphs()
        self.params = None
        self._release_memory()

    def restore_params(self) -> None:
        """The weights again, as at start: seeded on the device or loaded
        from ``weights_path``, quantized under ``cfg.quant``."""
        if self.params is None:
            self.params = maybe_quantize(
                self.cfg, init_or_load(self.cfg, self.config.seed,
                                       self.device, *self.rank_of(),
                                       expert=self.expert_of()))
        self._recapture()

    def param_bytes(self) -> int:
        """The bytes of the parameters this runner holds (its shard under
        tensor or expert parallelism; int8 values and float32 scales each
        at their own size; ``MirroredRunner.gather`` reads every
        process's)."""
        def size(tree) -> int:
            return sum(size(v) if isinstance(v, dict)
                       else v.numel() * v.element_size()
                       for v in tree.values())

        return size(self.params or {})

    @property
    def params_alive(self) -> bool:
        return self.params is not None

    @property
    def kv_alive(self) -> bool:
        return self.kv is not None

    # -- KV block export / import (P->D transfer, tier movement) -----------
    # Under tensor parallelism each rank gathers and scatters its own KV
    # heads with the device-side calls (``gather_*``, ``scatter_*``), and
    # rank 0's ``MirroredRunner`` joins and splits the whole
    # (engine/multihost.py); the ``export_*`` / ``import_*`` calls here are
    # one device's, its whole pool.
    def _block_index(self, block_ids) -> torch.Tensor:
        return torch.as_tensor(list(block_ids), dtype=torch.int64,
                               device=self.device)

    def to_host(self, data: torch.Tensor) -> torch.Tensor:
        """One copy of a gathered device tensor into pinned host memory
        (on the CPU the gather already made a fresh tensor)."""
        if data.device.type == "cpu":
            return data
        out = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
        out.copy_(data)
        return out

    def gather_blocks(self, block_ids, layer_lo: int,
                      n_layers: int) -> torch.Tensor:
        """One layer group of the blocks on the device: ``index_select``
        on the block axis; (n_layers, n, bs, 2KH, D)."""
        grp = self.kv[layer_lo:layer_lo + n_layers]
        return grp.index_select(1, self._block_index(block_ids))

    def gather_slabs(self, block_ids) -> torch.Tensor:
        """The blocks block-major on the device: (n, L, bs, 2KH, D)."""
        idx = self._block_index(block_ids)
        return self.kv.index_select(1, idx).transpose(0, 1).contiguous()

    def scatter_blocks(self, block_ids, layer_lo: int,
                       dev: torch.Tensor) -> None:
        """A layer group (n_layers, n, bs, 2KH, D) on the device into the
        pool: ``index_copy_`` on the block axis."""
        n_layers = int(dev.shape[0])
        self.kv[layer_lo:layer_lo + n_layers].index_copy_(
            1, self._block_index(block_ids), dev)

    def scatter_slabs(self, block_ids, dev: torch.Tensor) -> None:
        """Block-major slabs (n, L, bs, 2KH, D) on the device into the
        pool."""
        self.kv.index_copy_(1, self._block_index(block_ids),
                            dev.transpose(0, 1))

    def slabs_to_host(self, data: torch.Tensor) -> list[torch.Tensor]:
        """Each block's (L, bs, 2KH, D) slab of block-major ``data`` in host
        memory of its own, for the tiers (a tier holds and frees them one
        by one, so none may keep a shared buffer alive): a copy a slab
        into pinned memory, all enqueued before one wait. Pinned slabs go
        back up at the link's rate (``slabs_to_device``)."""
        if data.device.type == "cpu":
            return [s.clone() for s in data]
        slabs = [torch.empty(data.shape[1:], dtype=data.dtype,
                             pin_memory=True) for _ in range(len(data))]
        for slab, src in zip(slabs, data):
            slab.copy_(src, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return slabs

    def slabs_to_device(self, slabs) -> torch.Tensor:
        """Slabs (L, bs, 2KH, D) up into one block-major device buffer in
        the pool's dtype, each copied on its own (asynchronously from
        pinned memory); no host-side stack."""
        if self.device.type == "cpu":
            return torch.stack(slabs).to(self.kv.dtype)
        dev = torch.empty((len(slabs), *slabs[0].shape), dtype=self.kv.dtype,
                          device=self.device)
        for dst, slab in zip(dev, slabs):
            dst.copy_(slab, non_blocking=True)
        return dev

    def blocks_to_device(self, data) -> torch.Tensor:
        """A host layer group (n_layers, n, bs, 2KH, D) on the device in
        the pool's dtype: one host-to-device copy."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        return data.to(self.device, dtype=self.kv.dtype)

    def export_blocks(self, block_ids) -> torch.Tensor:
        """Blocks out of the pool: the gather on the device, then one copy
        to the host; (L, n, bs, 2KH, D)."""
        return self.export_blocks_range(block_ids, 0, self.cfg.num_layers)

    def export_blocks_range(self, block_ids, layer_lo: int,
                            n_layers: int) -> torch.Tensor:
        """One layer group of the blocks, the unit of the streamed
        transfer (engine/kv_transfer.py); (n_layers, n, bs, 2KH, D)."""
        return self.to_host(self.gather_blocks(block_ids, layer_lo,
                                               n_layers))

    def export_slabs(self, block_ids) -> list[torch.Tensor]:
        """Each block's (L, bs, 2KH, D) slab in host memory of its own:
        one gather, made block-major on the device, then
        ``slabs_to_host``."""
        return self.slabs_to_host(self.gather_slabs(block_ids))

    def import_slabs(self, block_ids, slabs) -> None:
        """Slabs (L, bs, 2KH, D) into the pool, one a block: up into a
        block-major buffer, then one ``index_copy_``."""
        self.scatter_slabs(block_ids, self.slabs_to_device(slabs))

    def import_blocks(self, block_ids, data) -> None:
        """Blocks into the pool: one host-to-device copy of ``data`` (L, n,
        bs, 2KH, D), then ``index_copy_`` on the block axis."""
        self.import_blocks_range(block_ids, 0, data)

    def import_blocks_range(self, block_ids, layer_lo: int, data) -> None:
        """One layer group (n_layers, n, bs, 2KH, D) into the pool."""
        self.scatter_blocks(block_ids, layer_lo, self.blocks_to_device(data))

    # -- host -> device ----------------------------------------------------
    def _dev(self, x, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device)

    def _sampling_inputs(self, temps, top_ps, top_ks, seeds, steps):
        return (self._dev(temps, torch.float32), self._dev(top_ps, torch.float32),
                self._dev(top_ks, torch.int64),
                self._dev(np.asarray(seeds, np.int64)),
                self._dev(steps, torch.int64))

    def _ensure_counts(self) -> None:
        if self.token_counts is None:
            self.token_counts = torch.zeros(
                (self.config.scheduler.max_num_seqs, self.cfg.vocab_size),
                dtype=torch.int32, device=self.device)

    def set_count_row(self, slot: int, token_ids: list[int]) -> None:
        """(Re)build one slot's output-token counts: a fresh sequence counts
        its first sampled token, a preemption-recompute its whole history."""
        self._ensure_counts()
        row = np.zeros(self.cfg.vocab_size, np.int32)
        for t in token_ids:
            if 0 <= t < self.cfg.vocab_size:
                row[t] += 1
        self.token_counts[slot] = self._dev(row)

    def _penalties(self, presence, frequency) -> Optional[tuple]:
        if presence is None:
            return None
        return (self._dev(presence, torch.float32),
                self._dev(frequency, torch.float32))

    def _ctrl(self, ctrl) -> Optional[tuple]:
        return None if ctrl is None else tuple(self._dev(c) for c in ctrl)

    def _process_logits(self, logits, samp, greedy_only, penalties, ctrl,
                        grammar=None):
        """Penalties, token controls, the grammar mask, then sampling, over
        device tensors: ``penalties`` (presence, frequency) (S,) or None,
        ``ctrl`` (ids, vals, mode) or None. Returns (sampled (S,), each
        row's grammar transition row (S, V) or None without
        ``grammar``)."""
        if penalties is not None:
            logits = penalize_logits(logits, self.token_counts, *penalties)
        if ctrl is not None:
            logits = apply_token_controls(logits, *ctrl)
        row_t = None
        if grammar is not None:
            logits, row_t = grammar_mask(logits, self.grammar_bank,
                                         self.grammar_accept, *grammar,
                                         self.eos_id)
        if greedy_only:
            return torch.argmax(logits, dim=-1).to(torch.int32), row_t
        return sample_tokens(logits, *samp), row_t

    # -- public steps (host numpy in, device tensors out) ------------------
    @torch.inference_mode()
    def ragged_step(self, tokens, positions, block_tables, context_lens,
                    cu_q_lens, slot_mapping, last_idx, sample_mask,
                    temps, top_ps, top_ks, seeds, steps,
                    greedy_only: bool = False, presence=None, frequency=None,
                    ctrl=None, adapter_ids=None, g_ids=None, g_states=None,
                    verify_idx=None):
        """One forward over the packed mixed prefill+decode stream.

        tokens/positions (T,) with position -1 on tail padding;
        block_tables (S, M), context_lens (S,), cu_q_lens (S+1,);
        slot_mapping (T,) flat KV slots (-1 = skip); last_idx (S,) stream
        index of each slot's last token; sample_mask (S,) 1 where the
        sample is consumed this step (it gates the penalty-count update).
        adapter_ids (T,) selects each token's adapter, so spans of
        different slots carry different adapters; g_ids / g_states (S,)
        each slot's grammar slot (-1 = none) and FSM state.

        ``verify_idx`` (S, k) holds the stream indices of each slot's draft
        tokens (0 for rows with fewer or none), and the result gains, right
        after ``sampled``, the greedy argmax of the raw logits there, (S,
        k): the model's own token after each draft. The LM head runs one
        column at a time, so no (S, k, V) cube exists. Raw logits are right
        because only rows without penalties, controls, grammar or logprobs
        speculate, and their sampling is the argmax of the same logits.

        Returns device tensors (sampled (S,)[, verify (S, k)], tok_lp (S,),
        top_ids (S, N), top_lps (S, N)); the caller fetches them when it
        needs them."""
        c = self.cfg
        # the reference runs the whole budget-wide stream: its token count
        # picks the int8 route and the MoE capacity here too
        ref_tokens = len(tokens)
        # the tail past the live tokens is padding: cut it to STREAM_ROUND
        n = stream_length(len(tokens), int(cu_q_lens[-1]))
        tokens, positions, slot_mapping = (tokens[:n], positions[:n],
                                           slot_mapping[:n])
        if adapter_ids is not None:
            adapter_ids = adapter_ids[:n]
        meta = {
            "block_tables": self._dev(block_tables),
            "context_lens": self._dev(context_lens),
            "cu_q_lens": self._dev(cu_q_lens),
            "slot_mapping": self._dev(slot_mapping),
            # the kernel's work map, made on the host from the step's span
            # lengths and uploaded once a step rather than once a layer
            "tiles": ragged_work_map(
                cu_q_lens, context_lens, len(tokens), self.local.num_heads,
                self.local.num_kv_heads, c.head_dim, self.kv.dtype,
                self.device),
        }
        hidden = self._forward(self._attend_ragged, self._dev(tokens),
                               self._dev(positions), meta,
                               self._lora(adapter_ids), ref_tokens)
        last = hidden[self._dev(last_idx, torch.int64)]  # (S, E)
        logits = self._logits(last)
        samp = self._sampling_inputs(temps, top_ps, top_ks, seeds, steps)
        if presence is not None:
            self._ensure_counts()
        sampled, _ = self._process_logits(logits, samp, greedy_only,
                                          self._penalties(presence, frequency),
                                          self._ctrl(ctrl),
                                          self._grammar(g_ids, g_states))
        if presence is not None:
            S = sampled.shape[0]
            rows = torch.arange(S, device=self.device)
            self.token_counts.index_put_(
                (rows, sampled.long()),
                self._dev(sample_mask).to(torch.int32), accumulate=True)
        # logprobs report the raw model distribution
        lp = compute_logprobs(logits, sampled)
        if verify_idx is None:
            return (sampled, *lp)
        vidx = self._dev(verify_idx, torch.int64)
        verify = torch.stack([
            torch.argmax(self._logits(hidden[vidx[:, j]]), dim=-1)
            for j in range(vidx.shape[1])], dim=1).to(torch.int32)
        return (sampled, verify, *lp)

    @torch.inference_mode()
    def prefill(self, tokens, positions, block_tables, context_lens,
                slot_mapping, last_idx, temps, top_ps, top_ks, seeds,
                greedy_only: bool = False, ctrl=None, adapter_ids=None,
                g_ids=None):
        """A batch of prefill chunks padded to one bucket, with each chunk's
        first token sampled in the same step.

        tokens/positions (P, S) with position -1 on padding (a whole row of
        -1 on an inactive chunk); block_tables (P, M); context_lens (P,),
        0 = inactive; slot_mapping (P*S,) flat KV slots (-1 = skip);
        last_idx (P,) index of each chunk's last token; adapter_ids (P,)
        each chunk's adapter; g_ids (P,) the grammar of each chunk that
        completes its prompt (-1 = none), which constrains the first token
        at FSM state 0. No penalties apply: the first token has no output
        history. Logprobs of the raw logits ride every step. Returns device
        tensors (sampled (P,), tok_lp (P,), top_ids (P, N), top_lps (P,
        N))."""
        meta = {
            "block_tables": self._dev(block_tables),
            "context_lens": self._dev(context_lens),
            "slot_mapping": self._dev(slot_mapping),
            # each chunk's first position (-1 on an inactive chunk)
            "q_starts": self._dev(positions[:, 0]),
        }
        # one adapter a chunk, broadcast over the chunk's tokens
        hidden = self._forward(
            self._attend_prefill, self._dev(tokens), self._dev(positions),
            meta, self._lora(None if adapter_ids is None
                             else np.asarray(adapter_ids)[:, None]))
        P = hidden.shape[0]
        last = hidden[torch.arange(P, device=self.device),
                      self._dev(last_idx, torch.int64)]  # (P, E)
        logits = self._logits(last)
        samp = self._sampling_inputs(temps, top_ps, top_ks, seeds,
                                     np.zeros(P, np.int32))
        grammar = (None if g_ids is None
                   else self._grammar(g_ids, np.zeros(P, np.int32)))
        sampled, _ = self._process_logits(logits, samp, greedy_only, None,
                                          self._ctrl(ctrl), grammar)
        return (sampled, *compute_logprobs(logits, sampled))

    @torch.inference_mode()
    def prefill_ring(self, tokens, positions, slot_mapping, last_idx, temps,
                     top_ps, top_ks, seeds, greedy_only: bool = True,
                     adapter_ids=None, ctrl=None):
        """One whole prompt prefilled over the seq ranks, its first token
        sampled in the same call: the reference's ``prefill_ring``.

        tokens/positions (1, S) with S a multiple of the ranks (the prompt
        zero-padded, positions 0..S-1); slot_mapping (S,) flat KV slots
        (-1 on padding); last_idx (1,) the prompt's last token; adapter_ids
        (1,) its adapter. Rank r runs the model over tokens [r * Sl, (r +
        1) * Sl), Sl = S / n over the n seq ranks (``_attend_ring``; on the
        grid each tensor group runs its slice with the model's
        collectives). Every product takes its int8 route, and a MoE block
        its capacity, from the whole call's S tokens, as the reference's
        call over the whole (1, S) prompt does, and a MoE block ranks its
        slots over the whole prompt (models/llama.py ``_moe_mlp``); the
        last token's hidden row goes from the seq rank
        that holds it to every seq rank (``RankGroup.ring_last``), the
        vocab shards' logits are gathered over the tensor group, and each
        rank samples the same token under the token controls. Returns device tensors (sampled (1,), tok_lp
        (1,), top_ids (1, N), top_lps (1, N)), the logprobs of the raw
        logits."""
        if not self.seq_parallel:
            raise RuntimeError("prefill_ring runs on sequence-parallel ranks")
        seq = self.ranks.seq
        n, r = seq.size, seq.rank
        S = tokens.shape[1]
        if S % n:
            raise ValueError(f"ring prefill of {S} tokens over {n} ranks")
        Sl = S // n
        mine = slice(r * Sl, (r + 1) * Sl)
        hidden = self._forward(
            self._attend_ring, self._dev(tokens[:, mine]),
            self._dev(positions[:, mine]),
            {"slot_mapping": self._dev(slot_mapping)},
            self._lora(None if adapter_ids is None
                       else np.asarray(adapter_ids)[:, None]),
            ref_tokens=S, seq=seq)
        last = int(last_idx[0])
        src = last // Sl
        row = (hidden[0, last - src * Sl] if r == src
               else hidden.new_empty(hidden.shape[-1]))
        logits = self._logits(seq.ring_last(row, src)[None])
        samp = self._sampling_inputs(temps, top_ps, top_ks, seeds,
                                     np.zeros(1, np.int32))
        sampled, _ = self._process_logits(logits, samp, greedy_only, None,
                                          self._ctrl(ctrl))
        return (sampled, *compute_logprobs(logits, sampled))

    # -- the decode step ----------------------------------------------------
    def decode_key(self, context_lens, greedy_only: bool = False,
                   penalties: bool = False, controls: bool = False,
                   lora: bool = False, grammar: bool = False,
                   logprobs: bool = False) -> DecodeKey:
        """The graph key of a decode step: its flags and the plan ladder's
        rung that holds its longest context at the last iteration."""
        K = self.decode_steps
        need = int(np.asarray(context_lens).max(initial=0)) + K - 1
        return DecodeKey(
            bool(greedy_only), bool(penalties), bool(controls),
            tuple(sorted(self.lora_bank)) if lora else None, bool(grammar),
            bool(logprobs), K, ladder_rung(self.decode_rungs, need))

    def _plan(self, key: DecodeKey) -> tuple[int, int]:
        """K3's split plan at the key's rung, for every slot of the batch:
        a function of the rung alone, so one graph a rung."""
        return split_plan(key.rung, self.config.scheduler.max_num_seqs,
                          self.local.num_kv_heads)

    def decode_program(self, key: DecodeKey, plan) -> Optional[object]:
        """The graph of ``key``, captured at its first use; None where the
        step runs eagerly (the CPU, or ``decode_graphs`` off). Wrapped by
        the compile tracker: a new key is a compile event."""
        if self.graphs is None:
            return None
        entry = self.graphs.entries.get(key)
        return entry if entry is not None else self._capture(key, plan)

    def _capture(self, key: DecodeKey, plan):
        """Capture ``key``'s graph from a batch without live rows, so the
        eager warm-up run before the capture writes no KV and counts no
        token; the caller stages the step's inputs after it."""
        if self.graphs.entries and self.kv is not self._graphed_kv:
            raise RuntimeError("the KV pool moved under the decode graphs")
        self._graphed_kv = self.kv
        if key.penalties:
            self._ensure_counts()
        if key.grammar:
            self._ensure_grammar_bank()
        self.decode_inputs.clear()
        return self.graphs.capture(key, lambda: self._decode_body(key, plan))

    def warm_decode_graphs(self) -> int:
        """Every decode key serving can reach without an adapter: each
        rung of the plan ladder x greedy or sampled x penalties x token
        controls x grammar x logprobs, through ``decode_program`` (on the
        card a capture each; eagerly a compile-tracker key each). Returns
        the number of keys."""
        keys = [DecodeKey(g, p, c, None, gr, lp, self.decode_steps, r)
                for r in self.decode_rungs
                for g, p, c, gr, lp in itertools.product((False, True),
                                                         repeat=5)]
        for key in keys:
            self.decode_program(key, self._plan(key))
        self._settle_captures()
        return len(keys)

    def _settle_captures(self) -> None:
        """Return what the warm-up runs on the capture stream left in
        PyTorch's cache to the card."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _drop_graphs(self) -> None:
        """Release every decode graph before the memory a graph reads
        goes (the KV pool, the weights, cuBLAS's workspaces); keep the
        keys for ``_recapture``."""
        if self.graphs is not None and len(self.graphs):
            self._held_keys += [k for k in self.graphs.drop_all()
                                if k not in self._held_keys]
        self._graphed_kv = None

    def _recapture(self) -> None:
        """At wake: capture again every key sleep dropped, once the pool
        and the weights are back, so live traffic pays no capture."""
        if self.graphs is None or self.kv is None or self.params is None:
            return
        keys, self._held_keys = self._held_keys, []
        for key in keys:
            self._capture(key, self._plan(key))
        self._settle_captures()

    def _decode_body(self, key: DecodeKey, plan) -> list:
        """``key.steps`` decode+sample iterations over the static inputs
        (``decode_inputs``): what a decode graph captures, and what the
        eager step runs. Returns [sampled (K, S)(, tok_lp (K, S), ids (K,
        S, N), lps (K, S, N)), next_tok (S,)], next_tok being each row's
        token after the last iteration (the input of a chained
        dispatch)."""
        inp = self.decode_inputs.views
        bs = self.config.cache.block_size
        bt, ctx = inp["block_tables"], inp["context_lens"]
        active = ctx > 0
        tok, pos, slots = inp["tokens"], inp["positions"], inp["slot_mapping"]
        samp = [inp["temps"], inp["top_ps"], inp["top_ks"], inp["seeds"],
                inp["steps"]]
        penalties = ((inp["presence"], inp["frequency"]) if key.penalties
                     else None)
        ctrl = ((inp["ctrl_ids"], inp["ctrl_vals"], inp["ctrl_mode"])
                if key.controls else None)
        lora = (self._lora_of(inp["adapter_ids"]) if key.lora is not None
                else None)
        grammar = [inp["g_ids"], inp["g_states"]] if key.grammar else None
        S = tok.shape[0]
        rows = torch.arange(S, device=self.device)
        kv = self.kv
        outs = []
        for _ in range(key.steps):
            meta = {"block_tables": bt, "context_lens": ctx,
                    "slot_mapping": slots, "plan": plan}
            hidden = self._forward(self._attend_decode, tok, pos, meta, lora)
            logits = self._logits(hidden)
            sampled, row_t = self._process_logits(
                logits, samp, key.greedy, penalties, ctrl, grammar)
            step_out = [sampled]
            if key.logprobs:
                step_out += compute_logprobs(logits, sampled)
            outs.append(step_out)
            if grammar is not None:
                g_ids_dev, g_state = grammar
                nxt = row_t.gather(1, sampled.long()[:, None])[:, 0].long()
                grammar[1] = torch.where((g_ids_dev >= 0) & active, nxt,
                                         g_state)
            new_pos = torch.where(active, pos + 1, pos)
            ctx = torch.where(active, ctx + 1, ctx)
            block = bt[rows, torch.clamp(new_pos, min=0) // bs]
            # positions at/past max_model_len have no allocated slot: a
            # stray write there could land in a block the prefix cache
            # later serves
            valid = active & (new_pos < self.cfg.max_model_len)
            slots = torch.where(valid, block * bs + new_pos % bs,
                                torch.full_like(new_pos, -1)).to(torch.int32)
            pos = new_pos
            tok = torch.where(active, sampled, tok)
            samp[4] = samp[4] + 1
            if penalties is not None:
                self.token_counts.index_put_(
                    (rows, sampled.long()), active.to(torch.int32),
                    accumulate=True)
        if self.kv is not kv:
            raise RuntimeError("the KV pool moved during a decode step")
        return [torch.stack(col) for col in zip(*outs)] + [tok]

    @torch.inference_mode()
    def decode_multi(self, tokens, positions, block_tables, context_lens,
                     slot_mapping, temps, top_ps, top_ks, seeds, steps,
                     greedy_only: bool = False, presence=None, frequency=None,
                     ctrl=None, want_logprobs: bool = False,
                     adapter_ids=None, g_ids=None, g_states=None,
                     tokens_dev=None, fetch: bool = True):
        """``multi_step`` fused decode+sample iterations over the (S,)
        decode batch. The token sampled at iteration i feeds iteration
        i + 1 on the device; positions, context lengths and slots advance
        there too (the scheduler allocated ``multi_step`` tokens of block
        capacity), and so does each guided row's FSM state, from the
        transition row its token was sampled from. adapter_ids (S,) each
        row's adapter; g_ids / g_states (S,) each row's grammar slot (-1 =
        none) and FSM state at the first iteration.

        The host arrays go up in one copy into ``decode_inputs``; then the
        key's graph replays, or the body runs eagerly. ``tokens_dev``
        feeds the batch's input tokens from the previous dispatch's
        device-resident ``next_tok`` instead of ``tokens``. Returns host
        arrays: sampled (K, S), plus (tok_lp (K, S), ids (K, S, N), lps
        (K, S, N)) with ``want_logprobs``; with ``fetch=False`` (no
        logprobs) returns (a ``Deferred`` of sampled, next_tok (S,)), both
        copies that no later step overwrites."""
        key = self.decode_key(
            context_lens, greedy_only, presence is not None,
            ctrl is not None,
            adapter_ids is not None and self.lora_bank is not None,
            g_ids is not None and self.grammar_bank is not None,
            want_logprobs)
        plan = self._plan(key)
        if key.penalties:
            self._ensure_counts()
        entry = self.decode_program(key, plan)
        none = ctrl is None
        self.decode_inputs.stage({
            "tokens": tokens, "positions": positions,
            "block_tables": block_tables, "context_lens": context_lens,
            "slot_mapping": slot_mapping, "temps": temps, "top_ps": top_ps,
            "top_ks": top_ks, "seeds": seeds, "steps": steps,
            "presence": 0.0 if presence is None else presence,
            "frequency": 0.0 if frequency is None else frequency,
            "ctrl_ids": -1 if none else ctrl[0],
            "ctrl_vals": 0.0 if none else ctrl[1],
            "ctrl_mode": 0 if none else ctrl[2],
            "adapter_ids": 0 if adapter_ids is None else adapter_ids,
            "g_ids": -1 if g_ids is None else g_ids,
            "g_states": 0 if g_states is None else g_states})
        if tokens_dev is not None:
            self.decode_inputs.views["tokens"].copy_(tokens_dev)
        if entry is None:
            outs = self._decode_body(key, plan)
        else:
            if self.kv is not self._graphed_kv:
                raise RuntimeError("the KV pool moved under the decode "
                                   "graphs")
            entry.replay()
            outs = entry.outputs
        if not fetch:
            return Deferred(outs[:1]), outs[-1].clone()
        got = Deferred(outs[:-1]).result()
        return tuple(got) if want_logprobs else got[0]
