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
  decode+sample iterations over the fixed ``(S,)`` decode batch, as a
  Python loop.

Attention goes through the kernel wrappers (``ops/kv_write.py``,
``ops/ragged_paged_attention.py``, ``ops/paged_prefill_attention.py``,
``ops/paged_decode_attention.py``): their plain versions for CPU tensors,
the CUDA kernels for CUDA tensors. The pool is updated in place.

Every step takes per-token LoRA adapters (the multi-LoRA bank,
``register_lora``) and per-row grammars (the grammar bank,
``register_grammar``, applied by ``grammar_mask``); the ragged step also
verifies speculative drafts (``verify_idx``). These three are plain
PyTorch on tensors (gathers, ``torch.where``, matmuls), as in the
reference, where they run outside any Pallas kernel. Ring prefill, KV
block export/import and CUDA-graph capture are not ported yet.

Parameters come from ``weights.init_or_load`` (random from the seed, or
a local checkpoint) or the caller, and pass through
``quant.maybe_quantize`` as in the reference. Each step hands the model
the token count of the reference's same step (``ref_tokens``: the
budget-wide T on the ragged path), which picks the int8 route and sets
Mixtral's MoE capacity (models/llama.py).

``install_compile_observer`` wraps the three steps in the perf
accountant's ``CompileTracker``, keyed on what the card runs: the ragged
step on its stream length (``stream_length``) and its static flags, not on
the budget-wide arrays it is handed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import kv_cache as kvmod
from production_stack_tpu_torch.engine.config import EngineConfig, resolve_device
from production_stack_tpu_torch.engine.lora import bank_bytes
from production_stack_tpu_torch.engine.sampling import (
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
from production_stack_tpu_torch.engine.weights import init_or_load
from production_stack_tpu_torch.models.registry import get_model
from production_stack_tpu_torch.ops.kv_write import kv_write
from production_stack_tpu_torch.ops.paged_attention import combine_kv
from production_stack_tpu_torch.ops.paged_decode_attention import (
    paged_decode_attention,
    split_plan,
)
from production_stack_tpu_torch.ops.paged_prefill_attention import (
    paged_prefill_attention,
)
from production_stack_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention,
    ragged_work_map,
)


# the ragged stream runs at its live length rounded up to this many tokens
STREAM_ROUND = 64


def stream_length(budget: int, live: int) -> int:
    """The tokens a ragged step's forward runs: its ``live`` tokens rounded
    up to ``STREAM_ROUND``, at most the ``budget``-wide stream."""
    return min(budget, -(-live // STREAM_ROUND) * STREAM_ROUND)


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

    def __init__(
        self,
        config: EngineConfig,
        params: Optional[dict] = None,
        num_blocks: Optional[int] = None,
        device="cuda",
    ):
        self.config = config
        self.cfg = config.model
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
        self.model = get_model(self.cfg)
        if self.device.type == "cuda":
            # compile every kernel now, not on the first request
            from production_stack_tpu_torch.ops import _build

            _build.build_all()
        # every way params are made goes through maybe_quantize, as in the
        # reference: a caller's bf16 dict is quantized here under cfg.quant
        self.params = maybe_quantize(
            self.cfg, params if params is not None
            else init_or_load(self.cfg, config.seed, self.device))
        mbs = -(-self.cfg.max_model_len // config.cache.block_size)
        # table width padded to a multiple of 8, as the reference pads it
        # for its kernels' DMA windows (tables are 0-padded past live blocks)
        self.max_blocks_per_seq = (mbs + 7) // 8 * 8
        self.num_blocks = self._resolve_num_blocks(num_blocks)
        self.kv = kvmod.init_kv_cache(self.cfg, config.cache,
                                      self.num_blocks, self.device)
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

    # -- compile tracking ----------------------------------------------------
    def ragged_lengths(self) -> list[int]:
        """Every stream length ``ragged_step`` can run."""
        T = self.config.scheduler.max_num_batched_tokens
        return sorted({stream_length(T, live)
                       for live in range(STREAM_ROUND, T + STREAM_ROUND,
                                         STREAM_ROUND)})

    def install_compile_observer(self, observer) -> None:
        """Wrap ``ragged_step``, ``prefill`` and ``decode_multi`` in
        ``CompileTracker``s reporting to ``observer(kind, bucket,
        seconds)``. A signature is a program's shape on the card and its
        static flags: greedy, LoRA, grammar, and verify (ragged) or
        logprobs (decode). Penalties and token controls, elementwise work
        on the (S, V) logits, are not keyed."""
        from production_stack_tpu_torch.engine.perf_accounting import (
            CompileTracker,
        )

        def flags(kw) -> tuple:
            return (bool(kw.get("greedy_only", False)),
                    kw.get("adapter_ids") is not None,
                    kw.get("g_ids") is not None)

        def ragged_n(tokens, *args, **kw) -> int:
            return stream_length(len(tokens), int(args[3][-1]))

        programs = {
            "ragged": ("ragged_step",
                       lambda *a, **kw: (ragged_n(*a), *flags(kw),
                                         kw.get("verify_idx") is not None),
                       lambda *a, **kw: str(ragged_n(*a))),
            "prefill": ("prefill",
                        lambda *a, **kw: (tuple(a[0].shape), *flags(kw)),
                        lambda *a, **kw: "x".join(map(str, a[0].shape))),
            "decode_multi": ("decode_multi",
                             lambda *a, **kw: (
                                 len(a[0]), *flags(kw),
                                 bool(kw.get("want_logprobs", False))),
                             lambda *a, **kw: str(len(a[0]))),
        }
        for kind, (attr, key, bucket) in programs.items():
            fn = getattr(self, attr)
            if isinstance(fn, CompileTracker):
                continue
            setattr(self, attr, CompileTracker(kind, fn, observer, key=key,
                                               bucket=bucket))

    # -- sizing ------------------------------------------------------------
    def _transient_bytes(self) -> int:
        """Device memory a step needs beside the pool: hidden states and
        MLP intermediates of the step's tokens, the float32 logits with
        their sampling temporaries, and the grammar and LoRA banks at their
        full size (each is allocated at its first use, after the pool). A
        ragged step has T tokens and (S, V) logits. A bucketed prefill step
        has up to prefill_batch chunks padded to the bucket of the largest
        chunk the scheduler issues (as the reference's _prefill_temp_bytes
        sizes it), and its decode steps have (S, V) logits. An int8 model
        adds a float32 copy of the activations, the int32 accumulators and
        one dequantized weight tile; a MoE model its capacity buffers: up
        to 2 T k / X rows an expert (at most T), in and out, with their
        gate and up products."""
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
        hidden = tokens * c.hidden_size * 4
        mlp = tokens * c.intermediate_size * 2
        logits = rows * c.vocab_size * 4
        cfg = self.config
        grammar = cfg.max_grammars * cfg.max_grammar_states * (
            c.vocab_size * 2 + 1)
        lora = bank_bytes(c, cfg.max_loras, cfg.max_lora_rank,
                          c.torch_dtype.itemsize)
        extra = 0
        if c.quant:
            wide = max(c.intermediate_size, c.hidden_size)
            # float32 activations, int8 copies, int32 accumulators; the
            # dequantized W8A16 tile
            extra += (tokens * wide * (4 + 1 + 4)
                      + DEQUANT_TILE_ELEMS * c.torch_dtype.itemsize)
        if c.architecture == "mixtral" and c.num_experts > 0:
            k, X = c.num_experts_per_tok, c.num_experts
            slots = X * min(max(int(2.0 * tokens * k / X), k), tokens)
            # dispatched rows in and out (E), gate, up and their product
            # (F), in the model dtype, and the gathered (T, k, E) float32
            extra += (slots * (2 * c.hidden_size + 3 * c.intermediate_size)
                      * c.torch_dtype.itemsize
                      + tokens * k * c.hidden_size * 4)
        return int(8 * hidden + 4 * mlp + 4 * logits + grammar + lora
                   + extra)

    def _resolve_num_blocks(self, explicit: Optional[int]) -> int:
        if explicit is not None:
            return explicit
        if self.config.cache.num_blocks > 0:
            return self.config.cache.num_blocks
        if self.device.type == "cpu":
            # no device memory to size from: room for every slot to hold a
            # full-length context
            return self.config.scheduler.max_num_seqs * self.max_blocks_per_seq
        per_block = kvmod.kv_cache_bytes_per_block(self.cfg, self.config.cache)
        free, _total = torch.cuda.mem_get_info(self.device)
        usable = (free * self.config.cache.hbm_utilization
                  - self._transient_bytes() - (1 << 30))
        return max(int(usable) // per_block, 16)

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

    def _forward(self, attend_impl, tokens, positions, meta, lora=None,
                 ref_tokens=None):
        """The decoder stack over ``tokens``; ``ref_tokens`` is the token
        count of the reference's same step (models/llama.py), None where
        it runs the same rows as this one."""
        def attend(q, k, v, kv, layer):
            return attend_impl(q, k, v, kv, layer, meta)

        hidden, self.kv = self.model.forward_tokens(
            self.cfg, self.params, tokens, positions, attend, self.kv, lora,
            ref_tokens)
        return hidden

    # -- constrained-decoding grammar bank ---------------------------------
    def register_grammar(self, slot: int, fsm) -> None:
        """Upload one TokenFsm's transition table into bank slot ``slot``
        (padded to the configured state budget)."""
        G = self.config.max_grammars
        S = self.config.max_grammar_states
        V = self.cfg.vocab_size
        if fsm.n_states > S:
            raise ValueError(
                f"grammar needs {fsm.n_states} states > budget {S}"
            )
        if self.grammar_bank is None:
            self.grammar_bank = torch.full((G, S, V), -1, dtype=torch.int16,
                                           device=self.device)
            self.grammar_accept = torch.zeros((G, S), dtype=torch.bool,
                                              device=self.device)
        table = np.full((S, V), -1, np.int16)
        table[: fsm.n_states] = fsm.trans.astype(np.int16)
        acc = np.zeros(S, bool)
        acc[: fsm.n_states] = fsm.accept
        self.grammar_bank[slot] = self._dev(table)
        self.grammar_accept[slot] = self._dev(acc)

    # -- multi-LoRA bank ---------------------------------------------------
    def register_lora(self, slot: int, bank_np: dict) -> None:
        """Write an adapter's stacked (A (L, in, R), B (L, R, *out)) pairs
        (engine/lora.py ``load_adapter_raw``, float32 with the scaling
        folded into B) into bank slot ``slot``, cast to the model dtype as
        the reference casts them."""
        N = self.config.max_loras
        dt = self.cfg.torch_dtype
        if self.lora_bank is None:
            self.lora_bank = {}
        for key, (A_st, B_st) in bank_np.items():
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
        self.lora_roots[slot] = kvmod.adapter_root(bank_np)

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
        onehot = torch.nn.functional.one_hot(
            self._dev(adapter_ids, torch.int64), self.config.max_loras)
        return {"onehot": onehot.to(self.cfg.torch_dtype),
                "bank": self.lora_bank}

    def _grammar(self, g_ids, g_states) -> Optional[list]:
        """[g_ids, g_states] on the device for ``_process_logits``, or None
        when the step has no guided row."""
        if g_ids is None or self.grammar_bank is None:
            return None
        return [self._dev(g_ids, torch.int64), self._dev(g_states, torch.int64)]

    # -- KV block export / import (P->D transfer, tier movement) -----------
    def _block_index(self, block_ids) -> torch.Tensor:
        return torch.as_tensor(list(block_ids), dtype=torch.int64,
                               device=self.device)

    def _to_host(self, data: torch.Tensor) -> torch.Tensor:
        """One copy of a gathered device tensor into pinned host memory
        (on the CPU the gather already made a fresh tensor)."""
        if data.device.type == "cpu":
            return data
        out = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
        out.copy_(data)
        return out

    def export_blocks(self, block_ids) -> torch.Tensor:
        """Blocks out of the pool: ``index_select`` on the block axis on
        the device, then one copy to the host; (L, n, bs, 2KH, D)."""
        return self.export_blocks_range(block_ids, 0, self.cfg.num_layers)

    def export_blocks_range(self, block_ids, layer_lo: int,
                            n_layers: int) -> torch.Tensor:
        """One layer group of the blocks, the unit of the streamed
        transfer (engine/kv_transfer.py); (n_layers, n, bs, 2KH, D)."""
        grp = self.kv[layer_lo:layer_lo + n_layers]
        return self._to_host(grp.index_select(1,
                                              self._block_index(block_ids)))

    def export_slabs(self, block_ids) -> list[torch.Tensor]:
        """Each block's (L, bs, 2KH, D) slab in host memory of its own, for
        the tiers (a tier holds and frees them one by one, so none may keep
        a shared buffer alive): one gather, made block-major on the device,
        then a copy a slab into pinned memory, all enqueued before one
        wait. Pinned slabs go back up at the link's rate
        (``import_slabs``)."""
        idx = self._block_index(block_ids)
        data = self.kv.index_select(1, idx).transpose(0, 1).contiguous()
        if data.device.type == "cpu":
            return [s.clone() for s in data]
        slabs = [torch.empty(data.shape[1:], dtype=data.dtype,
                             pin_memory=True) for _ in range(len(data))]
        for slab, src in zip(slabs, data):
            slab.copy_(src, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return slabs

    def import_slabs(self, block_ids, slabs) -> None:
        """Slabs (L, bs, 2KH, D) into the pool, one a block: each copied up
        on its own (asynchronously from pinned memory) into a block-major
        buffer, then one ``index_copy_``; no host-side stack."""
        idx = self._block_index(block_ids)
        if self.device.type == "cpu":
            self.kv.index_copy_(1, idx, torch.stack(slabs, dim=1).to(
                self.kv.dtype))
            return
        dev = torch.empty((len(slabs), *self.kv.shape[:1],
                           *self.kv.shape[2:]), dtype=self.kv.dtype,
                          device=self.device)
        for dst, slab in zip(dev, slabs):
            dst.copy_(slab, non_blocking=True)
        self.kv.index_copy_(1, idx, dev.transpose(0, 1))

    def import_blocks(self, block_ids, data) -> None:
        """Blocks into the pool: one host-to-device copy of ``data`` (L, n,
        bs, 2KH, D), then ``index_copy_`` on the block axis."""
        self.import_blocks_range(block_ids, 0, data)

    def import_blocks_range(self, block_ids, layer_lo: int, data) -> None:
        """One layer group (n_layers, n, bs, 2KH, D) into the pool."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        dev = data.to(self.device, dtype=self.kv.dtype)
        n_layers = int(dev.shape[0])
        self.kv[layer_lo:layer_lo + n_layers].index_copy_(
            1, self._block_index(block_ids), dev)

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

    def _process_logits(self, logits, samp, greedy_only, presence, frequency,
                        ctrl, grammar=None):
        """Penalties, token controls, the grammar mask, then sampling.
        Returns (sampled (S,), each row's grammar transition row (S, V) or
        None without ``grammar``)."""
        if presence is not None:
            logits = penalize_logits(logits, self.token_counts,
                                     self._dev(presence, torch.float32),
                                     self._dev(frequency, torch.float32))
        if ctrl is not None:
            logits = apply_token_controls(
                logits, self._dev(ctrl[0]), self._dev(ctrl[1]),
                self._dev(ctrl[2]))
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
                cu_q_lens, context_lens, len(tokens), c.num_heads,
                c.num_kv_heads, c.head_dim, self.kv.dtype, self.device),
        }
        hidden = self._forward(self._attend_ragged, self._dev(tokens),
                               self._dev(positions), meta,
                               self._lora(adapter_ids), ref_tokens)
        last = hidden[self._dev(last_idx, torch.int64)]  # (S, E)
        logits = self.model.logits_from_hidden(self.cfg, self.params, last)
        samp = self._sampling_inputs(temps, top_ps, top_ks, seeds, steps)
        if presence is not None:
            self._ensure_counts()
        sampled, _ = self._process_logits(logits, samp, greedy_only, presence,
                                          frequency, ctrl,
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
            torch.argmax(self.model.logits_from_hidden(
                self.cfg, self.params, hidden[vidx[:, j]]), dim=-1)
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
        logits = self.model.logits_from_hidden(self.cfg, self.params, last)
        samp = self._sampling_inputs(temps, top_ps, top_ks, seeds,
                                     np.zeros(P, np.int32))
        grammar = (None if g_ids is None
                   else self._grammar(g_ids, np.zeros(P, np.int32)))
        sampled, _ = self._process_logits(logits, samp, greedy_only, None,
                                          None, ctrl, grammar)
        return (sampled, *compute_logprobs(logits, sampled))

    @torch.inference_mode()
    def decode_multi(self, tokens, positions, block_tables, context_lens,
                     slot_mapping, temps, top_ps, top_ks, seeds, steps,
                     greedy_only: bool = False, presence=None, frequency=None,
                     ctrl=None, want_logprobs: bool = False,
                     adapter_ids=None, g_ids=None, g_states=None):
        """``multi_step`` fused decode+sample iterations over the (S,)
        decode batch. The token sampled at iteration i feeds iteration
        i + 1 on the device; positions, context lengths and slots advance
        there too (the scheduler allocated ``multi_step`` tokens of block
        capacity), and so does each guided row's FSM state, from the
        transition row its token was sampled from. adapter_ids (S,) each
        row's adapter; g_ids / g_states (S,) each row's grammar slot (-1 =
        none) and FSM state at the first iteration. Returns host arrays:
        sampled (K, S), plus (tok_lp (K, S), ids (K, S, N), lps (K, S, N))
        with ``want_logprobs``."""
        bs = self.config.cache.block_size
        K = max(self.config.scheduler.multi_step, 1)
        bt = self._dev(block_tables)
        ctx = self._dev(context_lens)
        active = ctx > 0
        tok = self._dev(tokens)
        pos = self._dev(positions)
        slots = self._dev(slot_mapping)
        samp = list(self._sampling_inputs(temps, top_ps, top_ks, seeds, steps))
        if presence is not None:
            self._ensure_counts()
        lora = self._lora(adapter_ids)
        grammar = self._grammar(g_ids, g_states)
        S = tok.shape[0]
        rows = torch.arange(S, device=self.device)
        # K3's split plan, fixed for the step from the host's context
        # lengths: contexts grow on the device by one an iteration, and
        # each of K3's CTAs reads its own from ``ctx``
        lens = np.asarray(context_lens)
        plan = split_plan(int(lens.max(initial=0)) + K,
                          int(np.count_nonzero(lens)), self.cfg.num_kv_heads)
        outs = []
        for _ in range(K):
            meta = {"block_tables": bt, "context_lens": ctx,
                    "slot_mapping": slots, "plan": plan}
            hidden = self._forward(self._attend_decode, tok, pos, meta, lora)
            logits = self.model.logits_from_hidden(self.cfg, self.params,
                                                   hidden)
            sampled, row_t = self._process_logits(
                logits, samp, greedy_only, presence, frequency, ctrl, grammar)
            step_out = [sampled]
            if want_logprobs:
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
            if presence is not None:
                self.token_counts.index_put_(
                    (rows, sampled.long()), active.to(torch.int32),
                    accumulate=True)
        stacked = [torch.stack(col).cpu().numpy() for col in zip(*outs)]
        return tuple(stacked) if want_logprobs else stacked[0]
