"""Pipeline-parallel serving: one ModelRunner and one KV pool a stage.

The port's counterpart of production_stack_tpu/engine/pp_runner.py. The
reference cuts its mesh's ``stage`` axis into S submeshes; here stage s is
a ``ModelRunner`` on ``devices[s]`` (parallel/mesh.stage_devices; stages
may share a card) holding layers ``[s L/S, (s+1) L/S)`` and its own paged
KV pool of L/S layers, the embedding at stage 0 and the final norm and the
LM head (a tied model's embedding) at the last stage. The host relays the
activations between stages: each stage hands the next exactly what the
layer loop carries from one layer to the next (``models/llama.py``
``forward_hidden``'s residual stream, in the model dtype), moved to the
next stage's device, so the stages run the operations of one device in
the same order and their tokens are its tokens.

The steps are the bucketed path's (the reference's staged runner has no
ragged step): a prefill chunk batch and a decode step each run stage by
stage through the stage runner's ``_attend_prefill`` / ``_attend_decode``
(K1 and K4, K1 and K3), and the last stage samples, with the penalties'
token counts kept there. ``decode_multi`` runs ``multi_step`` steps, each
relayed through every stage, the sampled token carried back to stage 0
and positions and slots advanced as ``ModelRunner._decode_body`` advances
them. Decode runs eagerly: the stages' decode graphs are later work.

Weights are made, loaded or cut a stage's share at a time
(engine/weights.py ``stage``), each quantized under ``cfg.quant`` by its
stage runner. The pool's block count is resolved once every stage's
weights are on its device (``_resolve_num_blocks``) and every stage's
pool holds that many blocks, since one allocator hands them out.

The rest of ModelRunner's surface, joined or cut along the layer axis:
KV blocks, layer ranges and slabs; the LoRA bank (each stage holds its
layers' share of every adapter, keyed in the prefix cache by the whole
adapter's root); sleep's drop and restore hooks; the dense scoring path
(``pooled_embed``, ``sequence_logprobs``), which runs on the last stage
with its hidden states streamed through every stage (``pipe_hidden``).
As in the reference, there are no logprobs (``supports_logprobs``), no
grammar bank (guided regex and JSON are refused by the engine) and no
chained decode (``supports_chaining``).

**Pipeline x tensor parallelism** (``StageRankRunner``): the reference
keeps the tensor axis inside each stage's submesh
(production_stack_tpu/engine/pp_runner.py), GSPMD sharding a stage's
layers over it. Here S * T processes make the stage x tensor grid
(parallel/distributed.py ``AXIS_PP_GRID``), process ``g = s * T + t``
stage ``s`` and tensor rank ``t``: its stage's layers cut to tensor rank
``t``'s shard (``init_or_load(..., t, T, stage=(s, S))``, or a whole
dict cut by stage, then by tensor rank), one ``ModelRunner`` whose model
collectives run over the process's ``tensor`` view, and a pool of its
stage's layers and its KV heads. Rank 0's ``MirroredRunner``
(engine/multihost.py) sends every call to every process. Each runs its
stage of it: stage 0 embeds the tokens, a later stage receives the
residual stream from the stage before over its ``stage`` view
(``RankGroup.relay_recv``; through host memory under gloo on a card),
each stage but the last sends its own on (``relay_send``), and the last
stage's tensor ranks sample the same tokens from the gathered logits and
send them to every other stage of their tensor rank (``from_last``), so
every process returns, and folds into its digest, the same tokens.
Positions, context lengths and slots advance on every process; penalty
counts stay on the last stage. The pool's block count is the least over
all S * T processes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from production_stack_tpu_torch.engine import kv_cache as kvmod
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.lora import layer_share
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.quant import maybe_quantize
from production_stack_tpu_torch.engine.weights import (
    init_or_load,
    stage_layers,
    stage_params,
    to_device,
)
from production_stack_tpu_torch.ops.attention import dense_causal_attention


def _paged(attend_impl, meta: dict):
    """``forward_hidden``'s attend callback over a stage's paged pool."""
    def attend(q, k, v, kv, layer):
        return attend_impl(q, k, v, kv, layer, meta)

    return attend


def _dense(soft_cap, q_block: int):
    """``forward_hidden``'s attend callback of the dense scoring path (no
    pool)."""
    def attend(q, k, v, kv, layer):
        return dense_causal_attention(q, k, v, soft_cap=soft_cap,
                                      q_block=q_block), kv

    return attend


def _advance(active, pos, ctx, bt, rows, block_size: int, max_len: int):
    """A decode step's next positions, context lengths and slots, as
    ``ModelRunner._decode_body`` advances them: active rows move one
    token on, a slot past ``max_len`` is -1."""
    new_pos = torch.where(active, pos + 1, pos)
    ctx = torch.where(active, ctx + 1, ctx)
    block = bt[rows, torch.clamp(new_pos, min=0) // block_size]
    valid = active & (new_pos < max_len)
    slots = torch.where(valid, block * block_size + new_pos % block_size,
                        torch.full_like(new_pos, -1)).to(torch.int32)
    return new_pos, ctx, slots


def _stage_config(config: EngineConfig, stage_cfg) -> EngineConfig:
    """A stage runner's config: its layers, the bucketed path, no decode
    graphs."""
    return dataclasses.replace(
        config, model=stage_cfg, attention_impl="bucketed",
        scheduler=dataclasses.replace(config.scheduler, decode_graphs=False))


def _check_model(cfg) -> None:
    if cfg.architecture == "whisper":
        raise ValueError(f"{cfg.name} is an encoder-decoder Whisper "
                         "model: it is not served under pipeline "
                         "parallelism")


class _Staged:
    """What both staged runners share: the bucketed path, eager decode,
    no logprobs, no chaining, and their compile tracking."""

    # stages relay through the host each step
    supports_chaining = False
    # the staged steps return sampled tokens only
    supports_logprobs = False
    attention_impl = "bucketed"
    graphs = None

    def _decode_rung(self, context_lens) -> int:
        raise NotImplementedError

    def install_compile_observer(self, observer) -> None:
        """Wrap ``prefill`` and ``decode_multi`` in ``CompileTracker``s:
        a prefill's signature is its shape and static flags, as
        ``ModelRunner``'s; a decode step's its flags and K3's plan rung.
        Each stage runs eagerly, so a new signature's seconds are its
        first call's."""
        from production_stack_tpu_torch.engine.perf_accounting import (
            CompileTracker,
        )

        S = self.config.scheduler.max_num_seqs

        def decode_key(*a, **kw) -> tuple:
            return (bool(kw.get("greedy_only", False)),
                    kw.get("presence") is not None,
                    kw.get("ctrl") is not None,
                    kw.get("adapter_ids") is not None,
                    self._decode_rung(a[3]))

        if not isinstance(self.prefill, CompileTracker):
            self.prefill = CompileTracker(
                "prefill", self.prefill, observer,
                key=lambda *a, **kw: (tuple(a[0].shape),
                                      bool(kw.get("greedy_only", False)),
                                      kw.get("adapter_ids") is not None),
                bucket=lambda *a, **kw: "x".join(map(str, a[0].shape)))
        if not isinstance(self.decode_multi, CompileTracker):
            self.decode_multi = CompileTracker(
                "decode_multi", self.decode_multi, observer, key=decode_key,
                bucket=lambda *a, **kw: f"{S}@{decode_key(*a, **kw)[-1]}")

    def warm_decode_graphs(self) -> int:
        """No decode graphs: every stage decodes eagerly."""
        return 0

    def ragged_lengths(self) -> list[int]:
        """No ragged step: the staged runner runs the bucketed path."""
        return []


class StagedModelRunner(_Staged):
    """ModelRunner-compatible facade over S per-stage runners, so the
    engine serves the same over one device or a staged pipeline."""

    ranks = None
    kv_head_groups = 1

    def __init__(self, config: EngineConfig, params: Optional[dict] = None,
                 num_blocks: Optional[int] = None,
                 devices: Sequence = ("cpu", "cpu")):
        cfg = config.model
        S = len(devices)
        if S < 2:
            raise ValueError("a staged runner needs at least 2 stages")
        _check_model(cfg)
        self.config = config
        self.cfg = cfg
        self.n_stages = S
        self.layers_per_stage = len(stage_layers(cfg, (0, S)))
        self.stage_cfg = dataclasses.replace(
            cfg, num_layers=self.layers_per_stage)
        stage_config = _stage_config(config, self.stage_cfg)
        self.stages = []
        for s, dev in enumerate(devices):
            weights = (self._made(s, dev) if params is None
                       else to_device(stage_params(params, cfg, (s, S)),
                                      dev))
            self.stages.append(ModelRunner(stage_config, weights, device=dev,
                                           pool=False))
        self.num_blocks = self._resolve_num_blocks(num_blocks)
        for r in self.stages:
            r.set_pool(self.num_blocks)
        self.device = self.stages[0].device
        self.max_blocks_per_seq = self.stages[0].max_blocks_per_seq
        # the dense scoring path runs on the last stage over hidden states
        # streamed through every stage
        self.stages[-1]._dense_hidden = self.pipe_hidden

    def _made(self, s: int, device) -> dict:
        """Stage ``s``'s share, seeded or loaded as the whole model's."""
        return init_or_load(self.cfg, self.config.seed, device,
                            stage=(s, self.n_stages))

    def _resolve_num_blocks(self, explicit: Optional[int]) -> int:
        """The block count of every stage's pool: the caller's, the
        config's, the CPU's default (``ModelRunner``'s), or sized from the
        cards' free memory once every stage's weights are placed. Stages
        that share a card share its free memory and run one after the
        other: each card gives its free memory, less the largest of its
        stages' transients, over the sum of their block bytes; the least
        over the cards is taken. The slices a stage drew and dropped
        (``weights.init_random``) go back to the cards first."""
        first = self.stages[0]
        if (explicit is not None or self.config.cache.num_blocks > 0
                or first.device.type == "cpu"):
            return first._local_num_blocks(explicit)
        torch.cuda.empty_cache()
        by_card: dict = {}
        for r in self.stages:
            by_card.setdefault(r.device, []).append(r)
        return max(min(min(r.pool_bytes() for r in rs)
                       // sum(r.block_bytes() for r in rs)
                       for rs in by_card.values()), 16)

    # -- the relay ------------------------------------------------------------
    def _run_stage(self, s: int, x: torch.Tensor, positions, attend,
                   lora=None, ref_tokens=None, mlp_rows=None,
                   paged: bool = True) -> torch.Tensor:
        """Stage ``s``'s layers over ``x`` (token ids at stage 0, the
        residual stream after), moved to its device; updates its pool
        where ``paged``. Returns the stage's hidden states."""
        r = self.stages[s]
        x = x.to(r.device)
        if s == 0:
            x = r.model.embed_tokens(r.cfg, r.params, x)
        hidden, kv = r.model.forward_hidden(
            r.cfg, r.params, x, positions.to(r.device), attend,
            r.kv if paged else None, lora, ref_tokens, mlp_rows)
        if paged:
            r.kv = kv
        return hidden

    @torch.inference_mode()
    def prefill(self, tokens, positions, block_tables, context_lens,
                slot_mapping, last_idx, temps, top_ps, top_ks, seeds,
                greedy_only: bool = False, ctrl=None, adapter_ids=None,
                g_ids=None):
        """``ModelRunner.prefill`` relayed through the stages; the last
        samples each chunk's first token. Returns (sampled (P,),) on the
        last stage's device."""
        if g_ids is not None:
            raise ValueError("guided decoding is not supported with "
                             "pipeline parallelism")
        ids = None if adapter_ids is None else np.asarray(adapter_ids)[:, None]
        x = torch.from_numpy(np.ascontiguousarray(tokens))
        for s, r in enumerate(self.stages):
            meta = {"block_tables": r._dev(block_tables),
                    "context_lens": r._dev(context_lens),
                    "slot_mapping": r._dev(slot_mapping),
                    "q_starts": r._dev(positions[:, 0])}
            x = self._run_stage(s, x, r._dev(positions),
                                _paged(r._attend_prefill, meta), r._lora(ids))
        last = self.stages[-1]
        P = x.shape[0]
        hidden = x[torch.arange(P, device=last.device),
                   last._dev(last_idx, torch.int64)]
        logits = last._logits(hidden)
        samp = last._sampling_inputs(temps, top_ps, top_ks, seeds,
                                     np.zeros(P, np.int32))
        sampled, _ = last._process_logits(logits, samp, greedy_only, None,
                                          last._ctrl(ctrl))
        return (sampled,)

    @torch.inference_mode()
    def decode_multi(self, tokens, positions, block_tables, context_lens,
                     slot_mapping, temps, top_ps, top_ks, seeds, steps,
                     greedy_only: bool = False, presence=None, frequency=None,
                     ctrl=None, want_logprobs: bool = False,
                     adapter_ids=None, g_ids=None, g_states=None,
                     tokens_dev=None, fetch: bool = True) -> np.ndarray:
        """``multi_step`` decode steps over the (S,) batch, each relayed
        through the stages and sampled on the last; the sampled token
        goes back to stage 0 as the next step's input, and positions,
        context lengths and slots advance on stage 0's device as
        ``ModelRunner._decode_body`` advances them. K3 runs at the plan of
        the batch's longest context, as there. Returns sampled (K, S) on
        the host."""
        if want_logprobs or g_ids is not None:
            raise ValueError("logprobs and guided decoding are not "
                             "supported with pipeline parallelism")
        if tokens_dev is not None or not fetch:
            raise ValueError("a staged runner does not chain decode steps")
        first, last = self.stages[0], self.stages[-1]
        plan = first._plan(first.decode_key(context_lens))
        bs = self.config.cache.block_size
        tok, pos = first._dev(tokens), first._dev(positions)
        ctx, slots = first._dev(context_lens), first._dev(slot_mapping)
        tables = {r.device: r._dev(block_tables) for r in self.stages}
        bt = tables[first.device]
        active = ctx > 0
        rows = torch.arange(tok.shape[0], device=first.device)
        loras = [r._lora(adapter_ids) for r in self.stages]
        samp = list(last._sampling_inputs(temps, top_ps, top_ks, seeds,
                                          steps))
        penalties = last._penalties(presence, frequency)
        if penalties is not None:
            last._ensure_counts()
        ctrl_dev = last._ctrl(ctrl)
        last_rows = rows.to(last.device)
        outs = []
        for _ in range(first.decode_steps):
            x = tok
            for s, r in enumerate(self.stages):
                meta = {"block_tables": tables[r.device],
                        "context_lens": ctx.to(r.device),
                        "slot_mapping": slots.to(r.device), "plan": plan}
                x = self._run_stage(s, x, pos, _paged(r._attend_decode, meta),
                                    loras[s])
            sampled, _ = last._process_logits(last._logits(x), samp,
                                              greedy_only, penalties,
                                              ctrl_dev)
            outs.append(sampled)
            pos, ctx, slots = _advance(active, pos, ctx, bt, rows, bs,
                                       self.cfg.max_model_len)
            tok = torch.where(active, sampled.to(first.device), tok)
            samp[4] = samp[4] + 1
            if penalties is not None:
                last.token_counts.index_put_(
                    (last_rows, sampled.long()),
                    active.to(last.device, torch.int32), accumulate=True)
        return torch.stack(outs).cpu().numpy()

    def _decode_rung(self, context_lens) -> int:
        return self.stages[0].decode_key(context_lens).rung

    # -- the whole model --------------------------------------------------------
    @property
    def cards(self) -> int:
        """Distinct devices the stages run on."""
        return len({r.device for r in self.stages})

    def param_shares(self) -> list[dict]:
        """Each stage's parameters, a tied embedding counted once (at stage
        0): together the whole model's."""
        shares = [r.params for r in self.stages]
        if self.cfg.tie_word_embeddings:
            shares[-1] = {k: v for k, v in shares[-1].items() if k != "embed"}
        return shares

    # -- penalties --------------------------------------------------------------
    def set_count_row(self, slot: int, token_ids: list[int]) -> None:
        self.stages[-1].set_count_row(slot, token_ids)

    # -- LoRA bank (cut along the layer axis) ----------------------------------
    @property
    def lora_roots(self) -> list:
        return self.stages[0].lora_roots

    def register_lora(self, slot: int, bank_np: dict) -> None:
        """An adapter's stacked pairs (``ModelRunner.register_lora``), each
        stage given its layers."""
        self.put_lora(slot, bank_np, kvmod.adapter_root(bank_np))

    def put_lora(self, slot: int, share: dict, root: int) -> None:
        """``share`` of an adapter (every layer) into bank slot ``slot`` of
        every stage, cut by layer, keyed in the prefix cache by ``root``."""
        for s, r in enumerate(self.stages):
            r.put_lora(slot, layer_share(share, stage_layers(
                self.cfg, (s, self.n_stages))), root)

    def unregister_lora(self, slot: int) -> None:
        for r in self.stages:
            r.unregister_lora(slot)

    # -- KV export / import (the layer axis joined across stages) --------------
    def _cuts(self, layer_lo: int, n_layers: int):
        """(stage runner, its first layer, layers, offset into the range)
        of each stage holding part of ``[layer_lo, layer_lo + n_layers)``."""
        n = self.layers_per_stage
        for s, r in enumerate(self.stages):
            lo = max(layer_lo, s * n)
            hi = min(layer_lo + n_layers, (s + 1) * n)
            if lo < hi:
                yield r, lo - s * n, hi - lo, lo - layer_lo

    def export_blocks(self, block_ids) -> torch.Tensor:
        """(L, n, bs, 2KH, D) on the host, every stage's layers joined."""
        return self.export_blocks_range(block_ids, 0, self.cfg.num_layers)

    def export_blocks_range(self, block_ids, layer_lo: int,
                            n_layers: int) -> torch.Tensor:
        return torch.cat([r.export_blocks_range(block_ids, lo, n)
                          for r, lo, n, _ in self._cuts(layer_lo, n_layers)])

    def import_blocks(self, block_ids, data) -> None:
        self.import_blocks_range(block_ids, 0, data)

    def import_blocks_range(self, block_ids, layer_lo: int, data) -> None:
        for r, lo, n, off in self._cuts(layer_lo, int(data.shape[0])):
            r.import_blocks_range(block_ids, lo, data[off:off + n])

    def export_slabs(self, block_ids) -> list[torch.Tensor]:
        """Each block's (L, bs, 2KH, D) slab in host memory of its own."""
        per_stage = [r.export_slabs(block_ids) for r in self.stages]
        return [torch.cat(parts) for parts in zip(*per_stage)]

    def import_slabs(self, block_ids, slabs) -> None:
        for r, lo, n, off in self._cuts(0, self.cfg.num_layers):
            r.import_slabs(block_ids, [slab[off:off + n] for slab in slabs])

    # -- sleep mode ---------------------------------------------------------------
    def drop_kv(self) -> None:
        for r in self.stages:
            r.drop_kv()

    def restore_kv(self) -> None:
        for r in self.stages:
            r.restore_kv()

    def drop_params(self) -> None:
        for r in self.stages:
            r.drop_params()

    def restore_params(self) -> None:
        """Each stage's share again, as at start (seeded or loaded,
        quantized under ``cfg.quant``)."""
        for s, r in enumerate(self.stages):
            if r.params is None:
                r.params = maybe_quantize(self.stage_cfg,
                                          self._made(s, r.device))

    @property
    def params_alive(self) -> bool:
        return all(r.params is not None for r in self.stages)

    @property
    def kv_alive(self) -> bool:
        return all(r.kv is not None for r in self.stages)

    # -- the dense scoring path -----------------------------------------------
    def pipe_hidden(self, tokens: torch.Tensor, q_block: int,
                    ref_tokens: int) -> torch.Tensor:
        """Final hidden states (g, S, E) of a dense causal forward over
        ``tokens (g, S)``, chained through the stages (no pool): the last
        stage's ``_dense_hidden`` (module docstring)."""
        positions = torch.arange(tokens.shape[1]).expand(tokens.shape)
        mlp_rows = self.config.scheduler.max_num_batched_tokens
        x = tokens
        for s, r in enumerate(self.stages):
            x = self._run_stage(s, x, positions,
                                _dense(r.cfg.attn_logit_softcap, q_block),
                                None, ref_tokens, mlp_rows, paged=False)
        return x

    def pooled_embed(self, tokens: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
        return self.stages[-1].pooled_embed(tokens, mask)

    def sequence_logprobs(self, tokens: np.ndarray,
                          cont_mask: np.ndarray) -> np.ndarray:
        return self.stages[-1].sequence_logprobs(tokens, cont_mask)


class StageRankRunner(_Staged):
    """One process of the pipeline x tensor grid (module docstring): its
    stage of every call, over one ``ModelRunner`` of its stage's layers
    at its tensor shard. ``ranks`` is the process's grid group
    (parallel/distributed.py ``AXIS_PP_GRID``): the model's collectives
    run over ``ranks.tensor``, the relay over ``ranks.stage``, and the
    pool's block count is resolved over every process."""

    def __init__(self, config: EngineConfig, params: Optional[dict] = None,
                 num_blocks: Optional[int] = None, ranks=None):
        cfg = config.model
        _check_model(cfg)
        relay = ranks.stage
        self.config = config
        self.cfg = cfg
        self.ranks = ranks
        self.stage_index, self.n_stages = relay.rank, relay.size
        self.layers = stage_layers(cfg, (self.stage_index, self.n_stages))
        self.layers_per_stage = len(self.layers)
        self.stage_cfg = dataclasses.replace(
            cfg, num_layers=self.layers_per_stage)
        if params is None:
            weights, sharded = self._made(ranks.device), True
        else:
            # cut by stage here, by tensor rank in the runner (quantized
            # whole first there, as at tensor parallelism alone)
            weights, sharded = stage_params(
                params, cfg, (self.stage_index, self.n_stages)), False
        self.runner = ModelRunner(_stage_config(config, self.stage_cfg),
                                  weights, ranks=ranks, pool=False,
                                  sharded=sharded)
        self.device = self.runner.device
        if self.device.type == "cuda":
            # the slices the seeded init drew and dropped go back first
            torch.cuda.empty_cache()
        self.num_blocks = self.runner._resolve_num_blocks(num_blocks)
        self.runner.set_pool(self.num_blocks)
        self.max_blocks_per_seq = self.runner.max_blocks_per_seq
        # the dense scoring path's forwards run through every stage
        self.runner._dense_hidden = self.pipe_hidden

    def _made(self, device) -> dict:
        """This process's share, seeded or loaded as the whole model's:
        its stage's layers at its tensor rank's cut."""
        return init_or_load(self.cfg, self.config.seed, device,
                            self.ranks.tensor.rank, self.ranks.tensor_size,
                            stage=(self.stage_index, self.n_stages))

    @property
    def first(self) -> bool:
        return self.stage_index == 0

    @property
    def last(self) -> bool:
        return self.stage_index == self.n_stages - 1

    # -- the relay ------------------------------------------------------------
    def _stage(self, tokens: torch.Tensor, positions: torch.Tensor, attend,
               kv=None, lora=None, ref_tokens=None, mlp_rows=None) -> tuple:
        """This stage's layers over ``tokens``' residual stream: stage 0
        embeds ``tokens`` (on the device), a later stage receives the
        stream from the stage before; every stage but the last sends its
        hidden states on. Returns (hidden states, the pool)."""
        r, relay = self.runner, self.ranks.stage
        if self.first:
            x = r.model.embed_tokens(r.cfg, r.params, tokens, r.group)
        else:
            x = relay.relay_recv((*tokens.shape, self.cfg.hidden_size),
                                 self.cfg.torch_dtype)
        hidden, kv = r.model.forward_hidden(
            r.cfg, r.params, x, positions, attend, kv, lora, ref_tokens,
            mlp_rows, r.group)
        if not self.last:
            relay.relay_send(hidden)
        return hidden, kv

    def _sampled(self, rows: int, sample) -> torch.Tensor:
        """The last stage's sampled tokens (``sample()``, int32) on every
        stage of this tensor rank."""
        got = (sample().to(torch.int32) if self.last else
               torch.zeros(rows, dtype=torch.int32, device=self.device))
        return self.ranks.stage.from_last(got)

    @torch.inference_mode()
    def prefill(self, tokens, positions, block_tables, context_lens,
                slot_mapping, last_idx, temps, top_ps, top_ks, seeds,
                greedy_only: bool = False, ctrl=None, adapter_ids=None,
                g_ids=None):
        """``ModelRunner.prefill``, this process's stage of it; the last
        stage samples each chunk's first token. Returns (sampled (P,),) on
        this process's device, the same on every process."""
        if g_ids is not None:
            raise ValueError("guided decoding is not supported with "
                             "pipeline parallelism")
        r = self.runner
        ids = None if adapter_ids is None else np.asarray(adapter_ids)[:, None]
        meta = {"block_tables": r._dev(block_tables),
                "context_lens": r._dev(context_lens),
                "slot_mapping": r._dev(slot_mapping),
                "q_starts": r._dev(positions[:, 0])}
        x, r.kv = self._stage(r._dev(tokens), r._dev(positions),
                              _paged(r._attend_prefill, meta), r.kv,
                              r._lora(ids))
        P = tokens.shape[0]

        def sample():
            hidden = x[torch.arange(P, device=self.device),
                       r._dev(last_idx, torch.int64)]
            samp = r._sampling_inputs(temps, top_ps, top_ks, seeds,
                                      np.zeros(P, np.int32))
            return r._process_logits(r._logits(hidden), samp, greedy_only,
                                     None, r._ctrl(ctrl))[0]

        return (self._sampled(P, sample),)

    @torch.inference_mode()
    def decode_multi(self, tokens, positions, block_tables, context_lens,
                     slot_mapping, temps, top_ps, top_ks, seeds, steps,
                     greedy_only: bool = False, presence=None, frequency=None,
                     ctrl=None, want_logprobs: bool = False,
                     adapter_ids=None, g_ids=None, g_states=None,
                     tokens_dev=None, fetch: bool = True) -> np.ndarray:
        """``StagedModelRunner.decode_multi``, this process's stage of each
        step: the last stage samples, every stage takes the tokens
        (stage 0 feeds them to the next step) and advances positions,
        context lengths and slots. K3 runs at the plan of the batch's
        longest context. Returns sampled (K, S) on the host, the same on
        every process."""
        if want_logprobs or g_ids is not None:
            raise ValueError("logprobs and guided decoding are not "
                             "supported with pipeline parallelism")
        if tokens_dev is not None or not fetch:
            raise ValueError("a staged runner does not chain decode steps")
        r = self.runner
        plan = r._plan(r.decode_key(context_lens))
        tok, pos = r._dev(tokens), r._dev(positions)
        ctx, slots = r._dev(context_lens), r._dev(slot_mapping)
        bt = r._dev(block_tables)
        active = ctx > 0
        rows = torch.arange(tok.shape[0], device=self.device)
        lora = r._lora(adapter_ids)
        samp = list(r._sampling_inputs(temps, top_ps, top_ks, seeds, steps))
        penalties = r._penalties(presence, frequency) if self.last else None
        if penalties is not None:
            r._ensure_counts()
        ctrl_dev = r._ctrl(ctrl)
        outs = []
        for _ in range(r.decode_steps):
            meta = {"block_tables": bt, "context_lens": ctx,
                    "slot_mapping": slots, "plan": plan}
            x, r.kv = self._stage(tok, pos, _paged(r._attend_decode, meta),
                                  r.kv, lora)
            sampled = self._sampled(len(rows), lambda: r._process_logits(
                r._logits(x), samp, greedy_only, penalties, ctrl_dev)[0])
            outs.append(sampled)
            pos, ctx, slots = _advance(active, pos, ctx, bt, rows,
                                       self.config.cache.block_size,
                                       self.cfg.max_model_len)
            tok = torch.where(active, sampled, tok)
            samp[4] = samp[4] + 1
            if penalties is not None:
                r.token_counts.index_put_((rows, sampled.long()),
                                          active.to(torch.int32),
                                          accumulate=True)
        return torch.stack(outs).cpu().numpy()

    def _decode_rung(self, context_lens) -> int:
        return self.runner.decode_key(context_lens).rung

    # -- the whole model --------------------------------------------------------
    @property
    def kv(self):
        return self.runner.kv

    def param_bytes(self) -> int:
        """This process's parameter bytes: its stage's layers at its
        tensor shard (``MirroredRunner.gather`` reads every process's)."""
        return self.runner.param_bytes()

    @property
    def params(self):
        return self.runner.params

    @property
    def cards(self) -> int:
        return self.runner.cards

    @property
    def tensor_parallel(self) -> int:
        return self.runner.tensor_parallel

    @property
    def kv_head_groups(self) -> int:
        """tp's grouping: a stage's KV heads are cut as at tensor
        parallelism alone."""
        return self.runner.kv_head_groups

    # -- penalties --------------------------------------------------------------
    def set_count_row(self, slot: int, token_ids: list[int]) -> None:
        """Penalty counts live on the last stage, which samples."""
        if self.last:
            self.runner.set_count_row(slot, token_ids)

    # -- LoRA bank: each process holds its stage's layers of its share ---------
    @property
    def lora_roots(self) -> list:
        return self.runner.lora_roots

    def put_lora(self, slot: int, share: dict, root: int) -> None:
        """This process's share of an adapter (its tensor rank's cut of
        its stage's layers, ``MirroredRunner.register_lora``) into bank
        slot ``slot``, keyed in the prefix cache by the whole adapter's
        ``root``."""
        self.runner.put_lora(slot, share, root)

    def unregister_lora(self, slot: int) -> None:
        self.runner.unregister_lora(slot)

    # -- KV: this process's layers and heads; rank 0's MirroredRunner joins ----
    def stage_cut(self, layer_lo: int, n_layers: int,
                  s: Optional[int] = None) -> Optional[tuple]:
        """(its first layer, layers, offset into the range) of stage
        ``s``'s (default this process's) part of ``[layer_lo, layer_lo +
        n_layers)``; None where it holds none of them."""
        s = self.stage_index if s is None else s
        n = self.layers_per_stage
        lo, hi = max(layer_lo, s * n), min(layer_lo + n_layers, (s + 1) * n)
        return (lo - s * n, hi - lo, lo - layer_lo) if lo < hi else None

    def gather_blocks(self, block_ids, layer_lo: int,
                      n_layers: int) -> Optional[torch.Tensor]:
        """This process's part of a layer group of the blocks on the
        device (None where its stage holds none of those layers)."""
        cut = self.stage_cut(layer_lo, n_layers)
        return (None if cut is None
                else self.runner.gather_blocks(block_ids, *cut[:2]))

    def gather_slabs(self, block_ids) -> torch.Tensor:
        return self.runner.gather_slabs(block_ids)

    def scatter_blocks(self, block_ids, layer_lo: int,
                       dev: torch.Tensor) -> None:
        """This process's part ``dev`` of a layer group starting at the
        model's layer ``layer_lo`` into its pool: the part starts at the
        later of ``layer_lo`` and its stage's first layer."""
        self.runner.scatter_blocks(
            block_ids, max(layer_lo - self.layers.start, 0), dev)

    def scatter_slabs(self, block_ids, dev: torch.Tensor) -> None:
        self.runner.scatter_slabs(block_ids, dev)

    def export_blocks(self, block_ids) -> torch.Tensor:
        """This process's own layers and KV heads of the blocks (what
        ``MirroredRunner.gather`` reads on each process)."""
        return self.runner.export_blocks(block_ids)

    def to_host(self, data: torch.Tensor) -> torch.Tensor:
        return self.runner.to_host(data)

    def slabs_to_host(self, data: torch.Tensor) -> list[torch.Tensor]:
        return self.runner.slabs_to_host(data)

    def slabs_to_device(self, slabs) -> torch.Tensor:
        return self.runner.slabs_to_device(slabs)

    def blocks_to_device(self, data) -> torch.Tensor:
        return self.runner.blocks_to_device(data)

    # -- sleep mode ---------------------------------------------------------------
    def drop_kv(self) -> None:
        self.runner.drop_kv()

    def restore_kv(self) -> None:
        self.runner.restore_kv()

    def drop_params(self) -> None:
        self.runner.drop_params()

    def restore_params(self) -> None:
        """This process's share again, as at start (seeded or loaded,
        quantized under ``cfg.quant``)."""
        if self.runner.params is None:
            self.runner.params = maybe_quantize(self.stage_cfg,
                                                self._made(self.device))

    @property
    def params_alive(self) -> bool:
        return self.runner.params_alive

    @property
    def kv_alive(self) -> bool:
        return self.runner.kv_alive

    # -- the dense scoring path -----------------------------------------------
    def pipe_hidden(self, tokens: torch.Tensor, q_block: int,
                    ref_tokens: int) -> Optional[torch.Tensor]:
        """``ModelRunner._dense_hidden`` through the stages: a dense causal
        forward (no pool) over ``tokens (g, S)`` on the device, this
        process's stage of it; the last stage's final hidden states (g, S,
        E), the others' hidden states sent on."""
        r = self.runner
        positions = torch.arange(tokens.shape[1], device=self.device
                                 ).expand(tokens.shape)
        hidden, _ = self._stage(
            tokens, positions, _dense(r.cfg.attn_logit_softcap, q_block),
            ref_tokens=ref_tokens,
            mlp_rows=self.config.scheduler.max_num_batched_tokens)
        return hidden

    def _scored(self, result, tokens: np.ndarray, rows: np.ndarray,
                shape: tuple) -> np.ndarray:
        """``result()``, the last stage's score of a call, on every stage;
        a stage before the last relays the same forwards
        (``ModelRunner.score_forwards`` over ``rows``)."""
        if self.last:
            out = torch.from_numpy(result()).to(self.device)
        else:
            N, S = tokens.shape
            for part, blk in self.runner.score_forwards(rows, S):
                self.pipe_hidden(self.runner._dev(tokens[part]), blk, N * S)
            out = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return self.ranks.stage.from_last(out).cpu().numpy()

    @torch.inference_mode()
    def pooled_embed(self, tokens: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
        N = tokens.shape[0]
        return self._scored(lambda: self.runner.pooled_embed(tokens, mask),
                            tokens, np.arange(N), (N, self.cfg.hidden_size))

    @torch.inference_mode()
    def sequence_logprobs(self, tokens: np.ndarray,
                          cont_mask: np.ndarray) -> np.ndarray:
        live = np.flatnonzero(cont_mask[:, 1:].any(axis=1))
        return self._scored(
            lambda: self.runner.sequence_logprobs(tokens, cont_mask),
            tokens, live, (tokens.shape[0],))
