"""LLMEngine: the synchronous engine core (scheduler + model runner).

Ports the ragged and the bucketed path of
production_stack_tpu/engine/engine.py. ``step()`` runs one scheduler
decision on the device and returns per-request increments; the server
(engine/server.py) drives it from its engine thread, and tests drive it
directly.

On the ragged path a step with a prefill chunk packs every decode row and
the FCFS prefill chunks into one token stream (``_run_ragged``). On the
bucketed path a step with prefill chunks runs only those, padded to one
bucket (``_run_prefill``). Either dispatch's results are fetched at the
start of a later step, as in the reference, so the host builds the next
step while the card computes this one. A step with only decode rows runs
``_run_decode`` (on the card a CUDA graph replay, model_runner.py) and
resolves at once, unless n-gram speculation proposed drafts: then those
rows ride ``_run_ragged`` as spans of 1 + drafts, verified in the same
dispatch, which resolves at once. With ``SchedulerConfig.chain_decode``
consecutive decode dispatches over the same requests chain through their
device-resident tokens and resolve one dispatch late, as the reference's
(``_pending_decode``): a step with prefill work, an empty schedule or a
change of the decode rows lands the chain first.

Requests may carry a LoRA adapter (``adapter_slot``, a slot of the
runner's bank) and a grammar (``guided_regex`` / ``guided_json``, compiled
here to a token FSM, cached by pattern, in a refcounted slot of the
runner's grammar bank), on both paths.

The perf accountant (engine/perf_accounting.py) costs every dispatch at
the reference's points and wraps the runner's three step programs in its
compile tracker; ``warmup()`` runs every signature the serving traffic can
reach, then marks the accountant steady. ``stats()`` reads host counters
only, so a scrape never waits on the card.

The KV plane (engine/kv_offload.py, engine/kv_transfer.py): with a host
or remote tier, an admitted sequence whose chain misses the pool parks in
``PREFETCHING`` while the tiers are searched, and a later step commits the
fetched slabs into its blocks; blocks the pool evicts are demoted to the
host, and finished sequences are offloaded. ``export_kv``, the
``*_kv_import`` calls and ``splice_request`` move blocks between engines
for P->D disaggregation.

The dense scoring surface (``embed``, ``choice_logprobs``,
``prompt_logprobs``) pads each call to a size class and runs the runner's
dense forward; sleep mode (``sleep_mode``, ``wake_mode``) drops the pool,
and at level 2 the weights, and makes them again.

The tenant plane (tenancy.py): every request carries its ``tenant``; each
dispatch bills its rows' tokens and wall seconds to their tenants through
the perf accountant (``_tenant_map``) and to each sequence
(``_attribute_seq_seconds``, the usage ledger's chip-seconds), and
``tenant_stats()`` exports the folded table. The brownout's stage 2 sets
``prefetch_paused``: an admitted sequence then starts no tier prefetch and
prefills cold.

The ranks (``config.mesh``, its tensor size resolved by
parallel/mesh.tensor_size): every mesh of the stage, seq, expert and
tensor axes is one process grid (parallel/distributed.py ``Grid``). On
one process the runner is a ``ModelRunner``, and with pipeline stages
alone a ``StagedModelRunner`` (engine/pp_runner.py) over one device a
stage (``stage_devices``), on the bucketed path. Every other mesh makes
the engine rank 0 of the grid's processes, started by one
``multihost.start_ranks`` call (one spawned process a follower), or, given
a multi-host ``distributed`` topology, joined by one
``multihost.lead_ranks`` call (processes started on their own, their
calls sent over the authenticated channel). Rank 0's runner mirrors every
device call to them, and ``close`` stops them. A process holds its tensor
rank's shard and a pool of its KV heads, its expert rank's share of every
MoE layer's experts, and its stage's layers (a ``StageRankRunner``, the
residual stream relayed stage to stage); seq ranks hold what the other
axes give them whole. What the grid does not carry raises at start
(``multihost.refusal``: a Whisper model beyond tensor ranks;
``multihost.check_group``: stages or expert ranks multi-host). The KV
plane's calls and the tiers are rank 0's: its runner hands them whole
blocks, every rank's heads and every stage's layers joined, and scatters
what they import.

With seq ranks and no stages and ``ring_prefill_threshold`` above 0
(``ring_enabled``) the scheduler sends each long fresh prompt whole and
alone to ``_run_prefill_ring``, the reference's: the prompt padded to a
power of two and a multiple of the ranks, prefilled by ring attention over
them (``prefill_ring``), its first token sampled and fetched in the same
call; every other step, decode included, runs as at seq 1 on every rank.
MoE and int8 models, a disaggregated role and the host and remote tiers
serve as at size 1: the ring pick is the reference's, so a prompt with a
cached prefix or one a tier prefetched has computed tokens and takes the
chunked path; at expert size N the MoE blocks of a ring prefill rank
their slots over the seq ranks and sum their combine over the expert
ranks. With stages the ring is off, as the reference's staged runner has
no ``seq_parallel``: each seq rank is a whole pipeline that computes
every call, and ``ring_prefill_threshold`` has no effect. As in the
reference, under stages a request with logprobs and a guided regex or
JSON grammar are refused at ``add_request``, and warmup skips them.

The expert axis (the reference's ``MeshConfig(expert=N)``; its CLI has no
flag, so only a caller's ``EngineConfig.mesh`` reaches it) serves every
feature tensor parallelism serves, on both attention paths (with stages,
on the bucketed path).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional, Sequence as Seq

import numpy as np
import torch

from production_stack_tpu_torch.engine import grammar as G
from production_stack_tpu_torch.tenancy import split_shares
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kv_cache import (
    HASH_SEED,
    PrefixCachingBlockAllocator,
    kv_cache_bytes_per_block,
    slot_mapping_for,
)
from production_stack_tpu_torch.engine.kv_offload import (
    KVPrefetcher,
    chain_hashes,
    maybe_make_remote,
    maybe_make_store,
)
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.multihost import (
    kernel_launches,
    MirroredRunner,
    lead_ranks,
    start_ranks,
)
from production_stack_tpu_torch.engine.pp_runner import StagedModelRunner
from production_stack_tpu_torch.parallel.distributed import Grid
from production_stack_tpu_torch.parallel.mesh import AXIS_STAGE
from production_stack_tpu_torch.parallel.mesh import stage_devices as pstages
from production_stack_tpu_torch.parallel.mesh import tensor_size
from production_stack_tpu_torch.parallel.ring_attention import ring_length
from production_stack_tpu_torch.engine.perf_accounting import PerfAccountant
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGPROBS,
    MAX_TOKEN_CONTROLS,
    SamplingParams,
    make_token_controls,
)
from production_stack_tpu_torch.engine.scheduler import Scheduler
from production_stack_tpu_torch.engine.sequence import (
    RequestOutput,
    Sequence,
    SequenceStatus,
)
from production_stack_tpu_torch.engine.spec import (
    SpecController,
    accept_drafts,
    propose_ngram,
)
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer


class GrammarBankFull(ValueError):
    """Every grammar-bank slot is referenced by a live request: the server
    answers 429 (retry later) where other ValueErrors are 400s."""


def _grammar_key(guided_regex, guided_json):
    """The cache key of a guided grammar, the one place it is derived, so
    admission and availability checks agree."""
    if guided_regex is not None:
        return ("re", guided_regex)
    return ("json", json.dumps(guided_json, sort_keys=True))


def _lp_row(lp: tuple, i: int):
    """One token's logprob entry from fetched (tok_lp, ids, lps) arrays:
    (token_logprob, [(token_id, logprob) * top-N])."""
    tok_lp, ids, lps = lp
    return (
        float(tok_lp[i]),
        [(int(t), float(v)) for t, v in zip(ids[i], lps[i])],
    )


class LLMEngine:
    # vllm:kv_prefetch_seconds bucket edges (+Inf implied), the reference's
    _PREFETCH_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                         1.0, 2.5, 5.0)

    def __init__(
        self,
        config: EngineConfig,
        params: Optional[dict] = None,
        num_blocks: Optional[int] = None,
        device="cuda",
        rank_devices: Optional[list] = None,
        backend: Optional[str] = None,
        stage_devices: Optional[list] = None,
        distributed=None,
    ):
        """``rank_devices`` and ``backend`` place the processes of the
        mesh's grid (parallel/distributed.py ``Grid``), one device a
        process by global rank (parallel/distributed.py's defaults:
        ``cuda:r`` and ``nccl`` on cards, the CPU and ``gloo``
        otherwise); unused on one process and with stages alone.
        ``stage_devices`` places the pipeline stages of one process
        (parallel/mesh.stage_devices' default: ``cuda:s`` on cards, the
        CPU otherwise); unused otherwise. ``distributed``
        (parallel/distributed.DistributedConfig), when it spans several
        processes, makes this engine process 0 of a multi-host group: its
        ranks are processes started on their own
        (``multihost.lead_ranks``), one a rank, and ``rank_devices`` names
        this process's device; ``params``, where given, must then be
        every follower's too (a follower with other weights is refused,
        and this raises)."""
        self.config = config
        self.tokenizer = get_tokenizer(config.model.tokenizer)
        grid = Grid.of(config.mesh, tensor_size(config.mesh, device))
        if distributed is not None and distributed.enabled:
            self.runner = lead_ranks(config, params, num_blocks, device,
                                     distributed, rank_devices, backend,
                                     grid)
        elif grid.size == 1:
            self.runner = ModelRunner(config, params, num_blocks, device)
        elif grid.axes == (AXIS_STAGE,):
            self.runner = StagedModelRunner(
                config, params, num_blocks,
                pstages(device, grid.stage, stage_devices))
        else:
            self.runner = start_ranks(config, params, num_blocks, device,
                                      grid, rank_devices, backend)
        self.device = self.runner.device
        self.scheduler = Scheduler(
            config.scheduler, config.cache, self.runner.num_blocks,
            max_model_len=config.model.max_model_len,
        )
        sched = config.scheduler
        # the reference's ring_enabled: long fresh prompts prefill whole
        # over the seq ranks
        self.scheduler.ring_enabled = (
            grid.seq > 1 and sched.ring_prefill_threshold > 0
            and getattr(self.runner, "seq_parallel", False))
        self.attention_impl = self.runner.attention_impl
        B = sched.max_num_seqs
        M = self.runner.max_blocks_per_seq
        # persistent host arrays, rewritten in place each step
        if self.attention_impl == "ragged":
            if sched.max_num_batched_tokens < sched.max_num_seqs:
                raise ValueError(
                    "ragged attention needs max_num_batched_tokens "
                    f"({sched.max_num_batched_tokens}) >= max_num_seqs "
                    f"({sched.max_num_seqs}): every decode row claims one "
                    "stream token per step"
                )
            self.scheduler.unified = True
            T = sched.max_num_batched_tokens
            self._r_tokens = np.zeros(T, np.int32)
            self._r_positions = np.full(T, -1, np.int32)
            self._r_slot_mapping = np.full(T, -1, np.int32)
            self._r_adapter_ids = np.zeros(T, np.int32)
            self._r_cu = np.zeros(B + 1, np.int32)
            self._r_last_idx = np.zeros(B, np.int32)
            self._r_sample_mask = np.zeros(B, np.float32)
        self._tokens = np.zeros(B, np.int32)
        self._positions = np.zeros(B, np.int32)
        self._block_tables = np.zeros((B, M), np.int32)
        self._context_lens = np.zeros(B, np.int32)
        self._slot_mapping = np.full(B, -1, np.int32)
        self._temps = np.zeros(B, np.float32)
        self._top_ps = np.ones(B, np.float32)
        self._top_ks = np.full(B, -1, np.int32)
        self._seeds = np.zeros(B, np.uint32)
        self._steps = np.zeros(B, np.int32)
        self._presence = np.zeros(B, np.float32)
        self._frequency = np.zeros(B, np.float32)
        self._ctrl_ids = np.full((B, MAX_TOKEN_CONTROLS), -1, np.int32)
        self._ctrl_vals = np.zeros((B, MAX_TOKEN_CONTROLS), np.float32)
        self._ctrl_mode = np.zeros(B, np.int32)
        self._adapter_ids = np.zeros(B, np.int32)
        self._g_ids = np.full(B, -1, np.int32)
        self._g_states = np.zeros(B, np.int32)
        # constrained decoding: compiled grammars keyed by pattern, grammar
        # bank slots refcounted; a slot is evicted (refs == 0) only when
        # slots run out
        self._grammar_cache: dict = {}
        self._grammar_by_slot: dict = {}
        self._grammar_free = list(range(config.max_grammars - 1, -1, -1))
        self._token_bytes = None  # each token id's bytes, made on first use
        self._count_reset_slots: list[Sequence] = []
        # the ragged or prefill dispatch whose results land at a later step
        self._pending_ragged: Optional[dict] = None
        self._pending_prefill: Optional[tuple] = None
        # chained decode (SchedulerConfig.chain_decode): consecutive decode
        # dispatches over the same requests feed each other's last tokens
        # on the device, and each one's (K, S) samples are fetched one
        # dispatch later, so stop checks lag one dispatch too. A finished
        # sequence's surplus tokens land only in its own uncommitted tail
        # blocks (prefix hashes cover full blocks of host-side token_ids),
        # and a dispatch issued after its blocks are released runs later
        # on the same stream, so a deferred stop cannot corrupt a reused or
        # cached block
        self._pending_decode: Optional[dict] = None
        # n-gram speculative decoding (engine/spec.py): drafts ride the
        # ragged stream as spans of 1 + drafts, verified in the same step,
        # so speculation needs the ragged path. Eligibility is per sequence
        # and the draft width adapts to each one's acceptance.
        k = sched.spec_ngram_k
        self._spec: Optional[SpecController] = None
        if k > 0 and self.attention_impl != "ragged":
            logging.getLogger(__name__).warning(
                "speculative decoding disabled: its verification rides the "
                "ragged step and attention_impl=%s has none (spec_ngram_k="
                "%d ignored)", self.attention_impl, k)
        elif k > 0:
            self._spec = SpecController(k_max=k)
            self.scheduler.spec_grant_fn = self._spec_grant_fn
            # stream indices of each slot's draft tokens
            self._r_verify_idx = np.zeros((B, k), np.int32)
        self.total_prompt_tokens = 0
        self.total_output_tokens = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_steps = 0  # verified spans
        self.spec_step_tokens = 0  # tokens those spans emitted
        self.aborted_seqs = 0
        self.ragged_dispatches = 0
        self.ragged_live_tokens = 0
        self.prefill_dispatches = 0
        self.prefill_live_tokens = 0
        self.prefill_padded_tokens = 0
        self.decode_dispatches = 0
        self.spliced_seqs = 0  # pushed P->D transfers entered decode-ready
        # the tiers: admission starts a prefetch (the sequence parks in
        # PREFETCHING), pool evictions demote to the host, host evictions
        # to the remote tier. Bytes are counted from the pool's side: "in"
        # is a promotion into it, "out" a demotion or offload
        self.host_kv = maybe_make_store(
            config.cache, bytes_per_block=kv_cache_bytes_per_block(
                config.model, config.cache))
        self.remote_kv = maybe_make_remote(config.cache,
                                           self.runner.kv_head_groups)
        self._prefetcher: Optional[KVPrefetcher] = None
        # (block id, chain hash) of pool blocks evicted during this step's
        # decisions, copied to the host in one batch before the step's
        # dispatch reuses them (_flush_demotions)
        self._demote_queue: list[tuple[int, int]] = []
        self.hbm_demotions = 0
        # brownout stage 2+ (engine/overload.py): start no new tier
        # prefetch; an admitted sequence prefills cold instead
        self.prefetch_paused = False
        self.prefetch_shed_count = 0
        self.prefetch_blocks = 0
        self.prefetch_count = 0
        self.prefetch_seconds_sum = 0.0
        self.prefetch_stall_seconds = 0.0
        self.prefetch_hist = [0] * (len(self._PREFETCH_BUCKETS) + 1)
        self.tier_bytes = {("host", "in"): 0, ("host", "out"): 0,
                           ("remote", "in"): 0, ("remote", "out"): 0}
        if self.host_kv is not None or self.remote_kv is not None:
            self._prefetcher = KVPrefetcher(
                self.host_kv, self.remote_kv, config.cache.block_size,
                config.cache.kv_prefetch_workers)
            self.scheduler.admission_hook = self._start_tier_prefetch
        self._wire_tier_hooks()
        self.sleep_level = 0  # 0 awake; 1 pool dropped; 2 weights too
        # goodput accounting + compile tracking (engine/perf_accounting.py)
        self.perf: Optional[PerfAccountant] = None
        if config.perf.enabled:
            self.perf = PerfAccountant.from_runner(config, self.runner)
            self.runner.install_compile_observer(self.perf.on_compile)

    # -- request intake ------------------------------------------------------
    def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[Seq[int]] = None,
        sampling: Optional[SamplingParams] = None,
        adapter_slot: int = 0,
        pin_on_finish: bool = False,
        tenant: str = "anonymous",
    ) -> Sequence:
        """Queue a request. ``pin_on_finish``: a P->D producer's blocks
        keep a reference after it finishes (``Sequence.pin_on_finish``);
        the caller frees them after its push. ``tenant``: the identity the
        attribution plane and fair share read."""
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("prompt or prompt_token_ids required")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if not prompt_token_ids:
            raise ValueError("empty prompt")
        if len(prompt_token_ids) > self.config.model.max_model_len - 1:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} exceeds max_model_len "
                f"{self.config.model.max_model_len}"
            )
        sampling = (sampling or SamplingParams()).clamped(
            self.config.model.max_model_len, len(prompt_token_ids)
        )
        if sampling.logprobs is not None:
            if not self.runner.supports_logprobs:
                raise ValueError(
                    "logprobs are not supported with pipeline parallelism")
            if not 0 <= sampling.logprobs <= MAX_LOGPROBS:
                raise ValueError(f"logprobs must be in [0, {MAX_LOGPROBS}]")
        if not 0 <= adapter_slot < self.config.max_loras:
            raise ValueError(f"adapter_slot must be in [0, "
                             f"{self.config.max_loras})")
        if sampling.seed is None:
            # unseeded sampling is nondeterministic (OpenAI/vLLM semantics)
            sampling = dataclasses.replace(
                sampling, seed=int.from_bytes(os.urandom(4), "little"))
        seq = Sequence(request_id, list(prompt_token_ids), sampling,
                       adapter_slot=adapter_slot,
                       tenant=tenant or "anonymous",
                       prefix_root=self.runner.lora_roots[adapter_slot],
                       pin_on_finish=pin_on_finish,
                       token_ctrl=make_token_controls(
                           sampling, self.config.model.vocab_size))
        if sampling.guided_regex is not None or sampling.guided_json is not None:
            if not hasattr(self.runner, "register_grammar"):
                raise ValueError("guided decoding is not supported with "
                                 "pipeline parallelism")
            ent = self._acquire_grammar(sampling)
            seq.grammar_slot = ent["slot"]
            seq.fsm = ent["fsm"]
            seq.fsm_state = 0
        try:
            self.scheduler.add(seq)
        except Exception:
            self._release_grammar(seq)
            raise
        self.total_prompt_tokens += len(prompt_token_ids)
        return seq

    def abort_request(self, request_id: str) -> bool:
        seq = self.scheduler.abort(request_id)
        if seq is not None:
            self._release_grammar(seq)
            self.aborted_seqs += 1
        return seq is not None

    # -- constrained decoding (engine/grammar.py) ----------------------------
    def _acquire_grammar(self, sampling: SamplingParams) -> dict:
        key = _grammar_key(sampling.guided_regex, sampling.guided_json)
        if sampling.guided_regex is not None:
            pattern = sampling.guided_regex
        else:
            pattern = G.schema_to_regex(sampling.guided_json)
        ent = self._grammar_cache.get(key)
        if ent is None:
            dfa = G.compile_regex(
                pattern, max_states=self.config.max_grammar_states
            )
            if self._token_bytes is None:
                self._token_bytes = G.token_byte_images(
                    self.tokenizer, self.config.model.vocab_size
                )
            fsm = G.build_token_fsm(dfa, self._token_bytes)
            if not self._grammar_free:
                for k, e in list(self._grammar_cache.items()):
                    if e["refs"] == 0:  # evict a cold grammar's slot
                        self._grammar_free.append(e["slot"])
                        del self._grammar_cache[k]
                        del self._grammar_by_slot[e["slot"]]
                        break
            if not self._grammar_free:
                raise GrammarBankFull(
                    f"too many concurrent guided grammars "
                    f"(max {self.config.max_grammars})"
                )
            slot = self._grammar_free.pop()
            self.runner.register_grammar(slot, fsm)
            ent = {"slot": slot, "fsm": fsm, "refs": 0, "key": key}
            self._grammar_cache[key] = ent
            self._grammar_by_slot[slot] = ent
        ent["refs"] += 1
        return ent

    def grammar_slot_available(self, guided_regex=None,
                               guided_json=None) -> bool:
        """Advisory: could a request with this grammar be admitted now?
        A check, not a reservation: admission itself (``add_request`` on
        the engine thread) raises GrammarBankFull."""
        key = _grammar_key(guided_regex, guided_json)
        if key in self._grammar_cache or self._grammar_free:
            return True
        return any(e["refs"] == 0 for e in self._grammar_cache.values())

    def _release_grammar(self, seq: Sequence) -> None:
        if seq.grammar_slot < 0:
            return
        ent = self._grammar_by_slot.get(seq.grammar_slot)
        if ent is not None and ent["refs"] > 0:
            ent["refs"] -= 1
        seq.grammar_slot = -1

    @staticmethod
    def _advance_fsm(seq: Sequence, token: int, first: bool = False) -> None:
        """The host's mirror of the device-side FSM advance, for kept
        tokens only (a token discarded by a stop must not move it); a
        prompt's first token leaves state 0."""
        if seq.grammar_slot < 0 or seq.fsm is None:
            return
        if 0 <= token < seq.fsm.trans.shape[1]:
            state = 0 if first else max(seq.fsm_state, 0)
            seq.fsm_state = int(seq.fsm.trans[state, token])

    def has_unfinished(self) -> bool:
        return self.scheduler.has_work()

    def live_request_ids(self) -> list[str]:
        """Request ids with scheduler state (waiting or running); aborting
        each one releases its KV blocks."""
        return self.scheduler.live_request_ids()

    # -- the step ------------------------------------------------------------
    def step(self) -> list[RequestOutput]:
        # finished tier fetches land first, so their sequences are
        # schedulable in this step's decision
        self._poll_prefetches()
        out = self.scheduler.schedule()
        # blocks evicted by this decision are copied down before this
        # step's dispatch writes into them
        self._flush_demotions()
        if out.is_empty:
            outputs = self._resolve_pending_ragged()
            outputs.extend(self._resolve_pending_prefill())
            outputs.extend(self._resolve_pending_decode())
            if (not outputs and self._prefetcher is not None
                    and self._prefetcher.jobs):
                # nothing else runnable while fetches are in flight: a
                # bounded wait, counted as prefetch time not overlapped
                t0 = time.monotonic()
                self._prefetcher.wait_any(0.002)
                self.prefetch_stall_seconds += time.monotonic() - t0
            return outputs
        if out.prefills and out.prefills[0].ring:
            # every pending dispatch lands before the ring takes the ranks
            outputs = self._resolve_pending_ragged()
            outputs.extend(self._resolve_pending_prefill())
            outputs.extend(self._resolve_pending_decode())
            outputs.extend(self._run_prefill_ring(out.prefills[0]))
            return outputs
        if out.prefills:
            if self.attention_impl == "ragged":
                return self._run_ragged(out)
            # a chained decode's tokens land before the prefill phase
            outputs = self._resolve_pending_decode()
            outputs.extend(self._run_prefill(out.prefills))
            return outputs
        # decode consumes the last sampled token: the pending ragged or
        # prefill results land first, and may finish sequences the
        # scheduler put in this step's decode batch
        outputs = self._resolve_pending_ragged()
        outputs.extend(self._resolve_pending_prefill())
        if self._spec is not None:
            # drafts come from complete token histories
            outputs.extend(self._resolve_pending_decode())
        decodes = [s for s in out.decodes
                   if s.status is SequenceStatus.RUNNING]
        if decodes:
            if self._spec is not None and self._propose_spec_drafts(decodes):
                # drafts ride the packed stream as spans of 1 + drafts,
                # verified in the same ragged dispatch
                outputs.extend(self._run_ragged(out, proposed=True))
            else:
                outputs.extend(self._run_decode(decodes))
        else:
            outputs.extend(self._resolve_pending_decode())
        return outputs

    # -- speculative decoding (engine/spec.py) -------------------------------
    @staticmethod
    def _spec_seq_eligible(seq: Sequence) -> bool:
        """Speculation verifies against the raw-logits argmax, so only
        greedy rows with plain logits are eligible; sampled, penalised,
        controlled, guided and logprob rows decode normally in the same
        dispatch."""
        return (
            seq.sampling.temperature <= 0.0
            and not seq.sampling.presence_penalty
            and not seq.sampling.frequency_penalty
            and seq.token_ctrl is None
            and seq.sampling.logprobs is None  # verify emits argmax only
            and seq.grammar_slot < 0  # verify has no FSM mask
        )

    def _spec_grant_fn(self, seq: Sequence) -> int:
        """Scheduler hook: the draft width to charge against the stream
        budget for this decode row (0 = ineligible or cold)."""
        if not self._spec_seq_eligible(seq):
            return 0
        bound = min(seq.num_prompt_tokens + seq.sampling.max_tokens,
                    self.config.model.max_model_len)
        # drafting past the completion bound can never emit tokens
        return min(self._spec.grant(seq),
                   max(bound - 1 - seq.num_computed_tokens, 0))

    def _propose_spec_drafts(self, decodes: list[Sequence]) -> bool:
        """Turn each row's scheduler grant into drafts (n-gram lookup over
        the complete token history: pending results must be resolved
        first). Returns True if any row has drafts; a granted row with no
        match decays its EWMA, so cold sequences stop being charged."""
        sched = self.config.scheduler
        any_drafts = False
        for seq in decodes:
            k, seq.spec_grant = seq.spec_grant, 0  # consumed
            seq.spec_drafts = []
            if k <= 0:
                continue
            drafts = propose_ngram(seq.token_ids, k, sched.spec_ngram_max,
                                   sched.spec_ngram_min, sched.spec_window)
            if drafts:
                seq.spec_drafts = drafts
                any_drafts = True
            else:
                self._spec.update(seq, k, 0)
        return any_drafts

    def _fill_sampling_row(self, slot: int, seq: Sequence) -> None:
        s = seq.sampling
        self._temps[slot] = s.temperature
        self._top_ps[slot] = s.top_p
        self._top_ks[slot] = s.top_k
        self._seeds[slot] = s.seed or 0
        if seq.token_ctrl is not None:
            (self._ctrl_ids[slot], self._ctrl_vals[slot],
             self._ctrl_mode[slot]) = seq.token_ctrl

    def _reset_count_rows(self, use_penalties: bool) -> None:
        if use_penalties and self._count_reset_slots:
            for seq in self._count_reset_slots:
                if seq.slot >= 0:
                    self.runner.set_count_row(seq.slot, seq.output_token_ids)
            self._count_reset_slots.clear()

    # -- unified ragged step -------------------------------------------------
    def _run_ragged(self, out, proposed: bool = False) -> list[RequestOutput]:
        """ONE dispatch for a mixed step: every decode row contributes one
        token (or a span of 1 + drafts with speculation), and the FCFS
        prefill chunks fill the rest of the budget, packed in slot order
        into a single stream of ``max_num_batched_tokens`` tokens.
        ``proposed``: the caller already turned the grants into drafts."""
        bs = self.config.cache.block_size
        outputs = self._resolve_pending_ragged()
        outputs.extend(self._resolve_pending_decode())
        decodes = [s for s in out.decodes
                   if s.status is SequenceStatus.RUNNING]
        prefills = [sp for sp in out.prefills
                    if not sp.seq.status.is_finished]
        if not decodes and not prefills:
            return outputs
        if self._spec is not None and not proposed:
            # pending results are resolved: the token histories are
            # complete, so the scheduler's grants can become drafts now
            self._propose_spec_drafts(decodes)
        B = self.config.scheduler.max_num_seqs
        T = self.config.scheduler.max_num_batched_tokens
        rows: dict[int, tuple] = {s.slot: ("d", s) for s in decodes}
        for sp in prefills:
            rows[sp.seq.slot] = ("p", sp)

        self._r_tokens[:] = 0
        self._r_positions[:] = -1
        self._r_slot_mapping[:] = -1
        self._r_adapter_ids[:] = 0
        self._r_last_idx[:] = 0
        self._r_sample_mask[:] = 0.0
        self._context_lens[:] = 0
        self._presence[:] = 0.0
        self._frequency[:] = 0.0
        self._g_ids[:] = -1
        self._g_states[:] = 0
        self._ctrl_ids[:] = -1
        self._ctrl_vals[:] = 0.0
        self._ctrl_mode[:] = 0
        if self._spec is not None:
            # index 0 is a live stream token, so the columns past a row's
            # drafts compute harmless argmaxes the resolve ignores
            self._r_verify_idx[:] = 0

        cu = 0
        seqs_in_step: list[Sequence] = []
        spec_rows: list[tuple[int, Sequence, list[int]]] = []
        # the accountant's live counts: prefill tokens, post-chunk contexts
        # and rows; decode contexts; draft tokens and post-span contexts
        p_tokens = p_ctx = p_rows = d_ctx = sp_tokens = sp_ctx = 0
        # (seq, phase, goodput, live) a packed row: the tenant shares of
        # this dispatch (drafts carry live weight but no goodput; they
        # become goodput only if accepted, via record_spec_accepted)
        t_entries: list[tuple] = []
        for slot in range(B):
            ent = rows.get(slot)
            if ent is None:
                self._r_cu[slot + 1] = cu
                continue
            kind, obj = ent
            if kind == "d":
                seq = obj
                pos = seq.num_computed_tokens  # index of the incoming token
                drafts = seq.spec_drafts if self._spec is not None else []
                n = 1 + len(drafts)
                self._r_tokens[cu : cu + n] = [seq.token_ids[pos]] + drafts
                self._r_positions[cu : cu + n] = np.arange(pos, pos + n)
                self._r_slot_mapping[cu : cu + n] = slot_mapping_for(
                    seq.block_ids, pos, n, bs)
                self._context_lens[slot] = pos + n
                self._steps[slot] = pos - seq.num_prompt_tokens + 1
                self._r_sample_mask[slot] = 1.0
                self._presence[slot] = seq.sampling.presence_penalty
                self._frequency[slot] = seq.sampling.frequency_penalty
                self._g_ids[slot] = seq.grammar_slot
                self._g_states[slot] = max(seq.fsm_state, 0)
                if drafts:
                    # the span's j-th token predicts position pos + j + 1:
                    # the verify columns cover the drafts, and the span's
                    # last token (last_idx) samples the bonus token
                    self._r_verify_idx[slot, : len(drafts)] = np.arange(
                        cu, cu + len(drafts))
                    spec_rows.append((slot, seq, list(drafts)))
                    sp_tokens += len(drafts)
                    sp_ctx += pos + n
                d_ctx += pos + 1
                t_entries.append((seq, "decode", 1, n))
            else:
                sp = obj
                seq = sp.seq
                n = sp.chunk_len
                start = sp.chunk_start
                self._r_tokens[cu : cu + n] = seq.token_ids[start : start + n]
                self._r_positions[cu : cu + n] = np.arange(start, start + n)
                self._r_slot_mapping[cu : cu + n] = slot_mapping_for(
                    seq.block_ids, start, n, bs)
                self._context_lens[slot] = start + n
                self._steps[slot] = 0
                completing = start + n >= seq.prefill_target
                if completing and not seq.output_token_ids:
                    self._r_sample_mask[slot] = 1.0
                # the grammar constrains the first sampled token only when
                # this chunk completes the prompt (state 0)
                if completing and seq.grammar_slot >= 0:
                    self._g_ids[slot] = seq.grammar_slot
                    self._g_states[slot] = 0
                p_tokens += n
                p_ctx += start + n
                p_rows += 1
                t_entries.append((seq, "prefill", n, n))
            self._r_adapter_ids[cu : cu + n] = seq.adapter_slot
            cu += n
            nb = len(seq.block_ids)
            self._block_tables[slot, :nb] = seq.block_ids
            self._r_last_idx[slot] = cu - 1
            self._fill_sampling_row(slot, seq)
            self._r_cu[slot + 1] = cu
            seqs_in_step.append(seq)
        if cu > T:
            raise RuntimeError(f"packed {cu} tokens over budget {T}")

        greedy_only = all(s.sampling.temperature <= 0.0 for s in seqs_in_step)
        # prefill rows never penalise their first sample; penalties gate on
        # the decode rows only
        use_penalties = any(
            s.sampling.presence_penalty or s.sampling.frequency_penalty
            for s in decodes
        )
        self._reset_count_rows(use_penalties)
        use_controls = any(s.token_ctrl is not None for s in seqs_in_step)
        use_lora = any(s.adapter_slot for s in seqs_in_step)
        use_grammar = bool((self._g_ids >= 0).any())
        t_dispatch = time.monotonic()
        result = self.runner.ragged_step(
            self._r_tokens, self._r_positions, self._block_tables,
            self._context_lens, self._r_cu, self._r_slot_mapping,
            self._r_last_idx, self._r_sample_mask,
            self._temps, self._top_ps, self._top_ks, self._seeds,
            self._steps,
            greedy_only=greedy_only,
            presence=self._presence if use_penalties else None,
            frequency=self._frequency if use_penalties else None,
            ctrl=((self._ctrl_ids, self._ctrl_vals, self._ctrl_mode)
                  if use_controls else None),
            adapter_ids=self._r_adapter_ids if use_lora else None,
            g_ids=self._g_ids if use_grammar else None,
            g_states=self._g_states if use_grammar else None,
            verify_idx=self._r_verify_idx if spec_rows else None,
        )
        if self.perf is not None:
            # verify spans are prefill-shaped work with zero goodput;
            # accepted drafts land as decode goodput at resolve time
            dispatch_s = time.monotonic() - t_dispatch
            self.perf.record_ragged(p_tokens, p_ctx, p_rows, len(decodes),
                                    d_ctx, spec_tokens=sp_tokens,
                                    spec_ctx=sp_ctx, spec_rows=len(spec_rows),
                                    seconds=dispatch_s,
                                    tenants=self._tenant_map(t_entries))
            self._attribute_seq_seconds(dispatch_s, t_entries)
        self.ragged_dispatches += 1
        self.ragged_live_tokens += cu

        # scheduler-visible state advances now; results land next step. A
        # spec row advances only its guaranteed token here: position pos
        # holds the last accepted token's KV whatever the drafts' outcome,
        # and each accepted draft advances it at the resolve
        spec_slots = {slot for slot, _, _ in spec_rows}
        decode_rows = []
        for seq in decodes:
            seq.num_computed_tokens += 1
            if seq.slot not in spec_slots:
                decode_rows.append((seq.slot, seq))
        prefill_rows = []
        for sp in prefills:
            seq = sp.seq
            seq.num_computed_tokens = sp.chunk_start + sp.chunk_len
            if not seq.prefill_done:
                continue  # more chunks to go
            seq.status = SequenceStatus.RUNNING
            s = seq.sampling
            if s.presence_penalty or s.frequency_penalty:
                self._count_reset_slots.append(seq)
            if seq.output_token_ids:
                # preemption-recompute: the newest token is still the
                # pending decode input, nothing was sampled for it
                continue
            prefill_rows.append((seq.slot, seq))
        self._pending_ragged = {
            "prefill_rows": prefill_rows,
            "decode_rows": decode_rows,
            "spec_rows": spec_rows,
            "result": result,
            "tenant_entries": t_entries,
        }
        if spec_rows:
            # acceptance decides how far each spec row advanced, and the
            # scheduler must see that before its next decision: a verifying
            # dispatch resolves at once
            outputs.extend(self._resolve_pending_ragged())
        return outputs

    def _resolve_pending_ragged(self) -> list[RequestOutput]:
        """Append the previous ragged dispatch's tokens: first tokens for
        the prompts it completed, next tokens for its decode rows
        (num_computed already advanced at dispatch) and, for spec rows, the
        longest prefix of drafts the model confirmed plus its own next
        token. Rejected drafts' KV is rolled back by not advancing
        num_computed past the accepted prefix: Scheduler.finish commits
        only positions below it, and the next dispatch rewrites the slots
        past it."""
        if self._pending_ragged is None:
            return []
        pending = self._pending_ragged
        self._pending_ragged = None
        t_fetch = time.monotonic()
        fetched = [x.cpu().numpy() for x in pending["result"]]
        if self.perf is not None:
            # the blocking result fetch is dispatch wall time too, billed
            # by the same live-token shares
            entries = pending["tenant_entries"]
            fetch_s = time.monotonic() - t_fetch
            tmap = self._tenant_map(entries)
            if tmap:
                self.perf.attribute_seconds(
                    {t: rec["live"] for t, rec in tmap.items()}, fetch_s)
            self._attribute_seq_seconds(fetch_s, entries)
        sampled = fetched[0]
        if pending["spec_rows"]:
            verify, lp = fetched[1], fetched[2:]
        else:
            verify, lp = None, fetched[1:]
        live, token_lists, lp_lists = [], [], []
        for slot, seq, drafts in pending["spec_rows"]:
            if seq.status.is_finished:
                continue  # aborted while the dispatch was in flight
            d = len(drafts)
            verified = [int(verify[slot, j]) for j in range(d)]
            verified.append(int(sampled[slot]))  # the span's last token
            new_tokens, n_acc = accept_drafts(drafts, np.asarray(verified))
            self._spec.update(seq, d, n_acc)
            self.spec_drafted += d
            self.spec_accepted += n_acc
            self.spec_steps += 1
            new_toks = []
            for j, t in enumerate(new_tokens):
                if j:
                    # position pos + j's KV (input: accepted draft j - 1)
                    # just became valid; the dispatch advanced pos only
                    seq.num_computed_tokens += 1
                seq.output_token_ids.append(t)
                new_toks.append(t)
                self.total_output_tokens += 1
                if self._check_stop(seq, t) is not None:
                    break
            self.spec_step_tokens += len(new_toks)
            if self.perf is not None and len(new_toks) > 1:
                # the guaranteed token was counted as decode goodput at
                # dispatch; accepted drafts land here
                self.perf.record_spec_accepted(len(new_toks) - 1,
                                               tenant=seq.tenant)
            live.append(seq)
            token_lists.append(new_toks)
            lp_lists.append(None)  # spec rows never ask for logprobs
        for kind, rows in (("p", pending["prefill_rows"]),
                           ("d", pending["decode_rows"])):
            for slot, seq in rows:
                if seq.status.is_finished:
                    continue  # aborted while the dispatch was in flight
                token = int(sampled[slot])
                if kind == "p":
                    seq.first_token_time = time.monotonic()
                seq.output_token_ids.append(token)
                self._advance_fsm(seq, token, first=kind == "p")
                self.total_output_tokens += 1
                live.append(seq)
                token_lists.append([token])
                lp_lists.append([_lp_row(lp, slot)]
                                if seq.sampling.logprobs is not None else None)
        return self._postprocess(live, token_lists, lp_lists)

    # -- bucketed prefill step -----------------------------------------------
    def _bucket(self, n: int) -> int:
        return self.config.scheduler.bucket_for(n,
                                                self.config.model.max_model_len)

    def _run_prefill(self, prefills: list) -> list[RequestOutput]:
        """ONE dispatch for up to ``prefill_batch`` chunks, each padded to
        the bucket of the longest. The batch is padded to a power of two
        (inactive rows skip attention but pay the projections and the MLP,
        so P stays as small as the chunks allow), capped at
        ``prefill_batch``; padded rows carry context 0."""
        bs = self.config.cache.block_size
        P = 1 << (len(prefills) - 1).bit_length()
        P = min(P, self.config.scheduler.prefill_batch)
        M = self.runner.max_blocks_per_seq
        bucket = self._bucket(max(sp.chunk_len for sp in prefills))

        tokens = np.zeros((P, bucket), np.int32)
        positions = np.full((P, bucket), -1, np.int32)
        slot_mapping = np.full((P, bucket), -1, np.int32)
        tables = np.zeros((P, M), np.int32)
        context_lens = np.zeros(P, np.int32)  # 0 = inactive row
        last_idx = np.zeros(P, np.int32)
        temps = np.zeros(P, np.float32)
        top_ps = np.ones(P, np.float32)
        top_ks = np.full(P, -1, np.int32)
        seeds = np.zeros(P, np.uint32)
        adapter_ids = np.zeros(P, np.int32)
        g_ids = np.full(P, -1, np.int32)
        for i, sp in enumerate(prefills):
            seq = sp.seq
            n, start = sp.chunk_len, sp.chunk_start
            tokens[i, :n] = seq.token_ids[start : start + n]
            positions[i, :n] = np.arange(start, start + n)
            slot_mapping[i, :n] = slot_mapping_for(seq.block_ids, start, n, bs)
            tables[i, : len(seq.block_ids)] = seq.block_ids
            context_lens[i] = start + n
            last_idx[i] = n - 1
            s = seq.sampling
            temps[i] = s.temperature
            top_ps[i] = s.top_p
            top_ks[i] = s.top_k
            seeds[i] = s.seed or 0
            adapter_ids[i] = seq.adapter_slot
            # the grammar constrains the first sampled token only when this
            # chunk completes the prompt
            if seq.grammar_slot >= 0 and start + n >= seq.prefill_target:
                g_ids[i] = seq.grammar_slot

        greedy_only = all(sp.seq.sampling.temperature <= 0.0
                          for sp in prefills)
        use_lora = any(sp.seq.adapter_slot for sp in prefills)
        use_grammar = bool((g_ids >= 0).any())
        ctrl = None
        if any(sp.seq.token_ctrl is not None for sp in prefills):
            c_ids = np.full((P, MAX_TOKEN_CONTROLS), -1, np.int32)
            c_vals = np.zeros((P, MAX_TOKEN_CONTROLS), np.float32)
            c_mode = np.zeros(P, np.int32)
            for i, sp in enumerate(prefills):
                if sp.seq.token_ctrl is not None:
                    c_ids[i], c_vals[i], c_mode[i] = sp.seq.token_ctrl
            ctrl = (c_ids, c_vals, c_mode)
        t_dispatch = time.monotonic()
        result = self.runner.prefill(
            tokens, positions, tables, context_lens, slot_mapping.reshape(-1),
            last_idx, temps, top_ps, top_ks, seeds, greedy_only=greedy_only,
            ctrl=ctrl, adapter_ids=adapter_ids if use_lora else None,
            g_ids=g_ids if use_grammar else None,
        )
        if self.perf is not None:
            dispatch_s = time.monotonic() - t_dispatch
            entries = [(sp.seq, "prefill", sp.chunk_len, sp.chunk_len)
                       for sp in prefills]
            self.perf.record_prefill(
                sum(sp.chunk_len for sp in prefills), int(context_lens.sum()),
                len(prefills), seconds=dispatch_s,
                tenants=self._tenant_map(entries))
            self._attribute_seq_seconds(dispatch_s, entries)
        self.prefill_dispatches += 1
        self.prefill_live_tokens += sum(sp.chunk_len for sp in prefills)
        self.prefill_padded_tokens += P * bucket

        # scheduler-visible state advances now; the sampled tokens are
        # fetched one step later, so this dispatch's device time overlaps
        # the host's next-step work
        resolve_list = []
        for i, sp in enumerate(prefills):
            seq = sp.seq
            seq.num_computed_tokens = sp.chunk_start + sp.chunk_len
            if not seq.prefill_done:
                continue  # more chunks to go
            seq.status = SequenceStatus.RUNNING
            s = seq.sampling
            if s.presence_penalty or s.frequency_penalty:
                # fresh prompt: the prefill-sampled token must count;
                # recompute: restore the full output history
                self._count_reset_slots.append(seq)
            if seq.output_token_ids:
                # preemption-recompute: the newest token is still the
                # pending decode input, nothing was sampled for it
                continue
            resolve_list.append((i, seq))
        outputs = self._resolve_pending_prefill()
        self._pending_prefill = (resolve_list, result)
        return outputs

    def _run_prefill_ring(self, sp) -> list[RequestOutput]:
        """The reference's ``_run_prefill_ring``: one long fresh prompt
        prefilled whole over the seq ranks (``ring_length``: padded to a
        power of two, then to a multiple of the ranks), its first token
        sampled in the same call and fetched at once; it decodes on the
        paged path after. Recorded as a prefill of its tokens."""
        bs = self.config.cache.block_size
        seq = sp.seq
        n = sp.chunk_len
        S = ring_length(n, self.config.mesh.seq)
        tokens = np.zeros((1, S), np.int32)
        tokens[0, :n] = seq.token_ids[:n]
        positions = np.arange(S, dtype=np.int32)[None]
        slot_mapping = np.full(S, -1, np.int32)
        slot_mapping[:n] = slot_mapping_for(seq.block_ids, 0, n, bs)
        s = seq.sampling
        t_dispatch = time.monotonic()
        result = self.runner.prefill_ring(
            tokens, positions, slot_mapping, np.asarray([n - 1], np.int32),
            np.asarray([s.temperature], np.float32),
            np.asarray([s.top_p], np.float32),
            np.asarray([s.top_k], np.int32),
            np.asarray([s.seed or 0], np.uint32),
            greedy_only=s.temperature <= 0.0,
            adapter_ids=(np.asarray([seq.adapter_slot], np.int32)
                         if seq.adapter_slot else None),
            ctrl=((seq.token_ctrl[0][None, :], seq.token_ctrl[1][None, :],
                   np.asarray([seq.token_ctrl[2]], np.int32))
                  if seq.token_ctrl is not None else None))
        sampled, *lp = (x.cpu().numpy() for x in result)
        if self.perf is not None:
            dispatch_s = time.monotonic() - t_dispatch
            entries = [(seq, "prefill", n, n)]
            self.perf.record_prefill(n, n, 1, seconds=dispatch_s,
                                     tenants=self._tenant_map(entries))
            self._attribute_seq_seconds(dispatch_s, entries)
        seq.num_computed_tokens = n
        seq.status = SequenceStatus.RUNNING
        if s.presence_penalty or s.frequency_penalty:
            self._count_reset_slots.append(seq)
        if seq.output_token_ids:
            return []  # preemption-recompute: the newest token is pending
        token = int(sampled[0])
        seq.first_token_time = time.monotonic()
        seq.output_token_ids.append(token)
        self.total_output_tokens += 1
        return self._postprocess(
            [seq], [[token]],
            [[_lp_row(lp, 0)] if s.logprobs is not None else None])

    def _resolve_pending_prefill(self) -> list[RequestOutput]:
        """Fetch and post-process the previous prefill dispatch, if any."""
        if self._pending_prefill is None:
            return []
        resolve_list, result = self._pending_prefill
        self._pending_prefill = None
        sampled, *lp = (x.cpu().numpy() for x in result)
        live, token_lists, lp_lists = [], [], []
        for i, seq in resolve_list:
            if seq.status.is_finished:
                continue  # aborted while the dispatch was in flight
            token = int(sampled[i])
            seq.first_token_time = time.monotonic()
            seq.output_token_ids.append(token)
            self._advance_fsm(seq, token, first=True)
            self.total_output_tokens += 1
            live.append(seq)
            token_lists.append([token])
            lp_lists.append([_lp_row(lp, i)]
                            if seq.sampling.logprobs is not None else None)
        return self._postprocess(live, token_lists, lp_lists)

    # -- decode-only step ----------------------------------------------------
    def _run_decode(self, decodes: list[Sequence]) -> list[RequestOutput]:
        """One ``decode_multi`` dispatch over the decode rows. With
        ``chain_decode`` and the runner's support, its samples stay on the
        device: the next decode dispatch over the same requests takes its
        input tokens from them, and they are fetched after that dispatch
        is queued (``_pending_decode``). Rows with logprobs or a grammar
        never chain (their results must reach the host each step), and a
        change of membership resolves the chain first."""
        bs = self.config.cache.block_size
        outputs: list[RequestOutput] = []
        use_logprobs = any(s.sampling.logprobs is not None for s in decodes)
        use_grammar = any(s.grammar_slot >= 0 for s in decodes)
        can_chain = (self.config.scheduler.chain_decode
                     and self.runner.supports_chaining
                     and not use_logprobs and not use_grammar)
        pending = self._pending_decode
        if pending is not None:
            # identity by request id, not slot: a freed slot can be taken
            # by another sequence within one step window
            same = (can_chain
                    and [s.request_id for s in decodes] == pending["rids"])
            if not same:
                # membership changed: land the in-flight tokens, then build
                # from what they leave
                outputs.extend(self._resolve_pending_decode())
                decodes = [s for s in decodes
                           if s.status is SequenceStatus.RUNNING]
                if not decodes:
                    return outputs
                pending = None
        chain = pending is not None
        self._context_lens[:] = 0
        self._slot_mapping[:] = -1
        self._g_ids[:] = -1
        for seq in decodes:
            i = seq.slot
            pos = seq.num_computed_tokens  # index of the incoming token
            if not chain:
                self._tokens[i] = seq.token_ids[pos]
            self._positions[i] = pos
            n = len(seq.block_ids)
            self._block_tables[i, :n] = seq.block_ids
            self._context_lens[i] = pos + 1
            self._slot_mapping[i] = seq.block_ids[pos // bs] * bs + pos % bs
            self._fill_sampling_row(i, seq)
            if seq.token_ctrl is None:
                self._ctrl_ids[i] = -1
                self._ctrl_vals[i] = 0.0
                self._ctrl_mode[i] = 0
            # sample counter = tokens sampled so far; under a chain the
            # output list lags, so it comes from num_computed
            self._steps[i] = pos - seq.num_prompt_tokens + 1
            self._presence[i] = seq.sampling.presence_penalty
            self._frequency[i] = seq.sampling.frequency_penalty
            self._adapter_ids[i] = seq.adapter_slot
            self._g_ids[i] = seq.grammar_slot
            self._g_states[i] = max(seq.fsm_state, 0)

        greedy_only = all(s.sampling.temperature <= 0.0 for s in decodes)
        use_lora = any(s.adapter_slot for s in decodes)
        use_penalties = any(
            s.sampling.presence_penalty or s.sampling.frequency_penalty
            for s in decodes
        )
        self._reset_count_rows(use_penalties)
        use_controls = any(s.token_ctrl is not None for s in decodes)
        K = max(self.config.scheduler.multi_step, 1)
        t_dispatch = time.monotonic()
        result = self.runner.decode_multi(
            self._tokens, self._positions, self._block_tables,
            self._context_lens, self._slot_mapping,
            self._temps, self._top_ps, self._top_ks, self._seeds, self._steps,
            greedy_only=greedy_only,
            presence=self._presence if use_penalties else None,
            frequency=self._frequency if use_penalties else None,
            ctrl=((self._ctrl_ids, self._ctrl_vals, self._ctrl_mode)
                  if use_controls else None),
            want_logprobs=use_logprobs,
            adapter_ids=self._adapter_ids if use_lora else None,
            g_ids=self._g_ids if use_grammar else None,
            g_states=self._g_states if use_grammar else None,
            tokens_dev=pending["next_tok"] if chain else None,
            fetch=not can_chain,
        )
        if self.perf is not None:
            # a chained dispatch's seconds are the host's enqueue time, as
            # the reference counts them
            dispatch_s = time.monotonic() - t_dispatch
            entries = [(seq, "decode", K, K) for seq in decodes]
            self.perf.record_decode(
                len(decodes), K, int(self._context_lens.sum()),
                seconds=dispatch_s, tenants=self._tenant_map(entries))
            self._attribute_seq_seconds(dispatch_s, entries)
        self.decode_dispatches += 1
        if can_chain:
            sampled, next_tok = result
            # the scheduler's block growth reads num_computed now; the
            # tokens are appended when the samples land
            for seq in decodes:
                seq.num_computed_tokens += K
            self._pending_decode = {
                "decodes": list(decodes),
                "slots": [s.slot for s in decodes],
                "rids": [s.request_id for s in decodes],
                "sampled": sampled,
                "next_tok": next_tok,
            }
            if chain:
                # the previous dispatch's samples are read while this one
                # runs
                outputs.extend(self._finish_decode(pending))
                if not any(s.status is SequenceStatus.RUNNING
                           for s in decodes):
                    # they finished every row: this dispatch is surplus
                    self._resolve_pending_decode()
            return outputs
        pend = {"decodes": decodes, "slots": [s.slot for s in decodes]}
        if use_logprobs:
            pend["sampled"], pend["lp"] = result[0], result[1:]
        else:
            pend["sampled"] = result
        outputs.extend(self._finish_decode(pend, fetched=True, advance=True))
        return outputs

    def _resolve_pending_decode(self) -> list[RequestOutput]:
        """Land the chained decode dispatch still in flight, if any."""
        if self._pending_decode is None:
            return []
        pending = self._pending_decode
        self._pending_decode = None
        return self._finish_decode(pending)

    def _finish_decode(self, pending: dict, fetched: bool = False,
                       advance: bool = False) -> list[RequestOutput]:
        """Fetch (unless already on the host), append and stop-check one
        decode dispatch's samples. ``advance`` moves num_computed a token
        at a time (a dispatch that was not chained did not advance it).
        A sequence that finished or was preempted while the dispatch was
        in flight gets none of its tokens: an aborted one's blocks went
        with the abort, and a preempted one computes them again from its
        history, with the same sample counters."""
        sampled = pending["sampled"]
        if not fetched:
            sampled = sampled.result()[0]
        lp = pending.get("lp")  # (tok_lp (K, S), ids (K, S, N), lps ...)
        live, token_lists, lp_lists = [], [], []
        for seq, slot in zip(pending["decodes"], pending["slots"]):
            if seq.status is not SequenceStatus.RUNNING:
                continue  # aborted or preempted in flight: surplus dropped
            want_lp = lp is not None and seq.sampling.logprobs is not None
            new_toks, new_lps = [], [] if want_lp else None
            for k in range(sampled.shape[0]):
                t = int(sampled[k, slot])
                if advance:
                    seq.num_computed_tokens += 1
                seq.output_token_ids.append(t)
                # mirror the device-side FSM advance (kept tokens only)
                self._advance_fsm(seq, t)
                new_toks.append(t)
                if want_lp:
                    new_lps.append(
                        _lp_row((lp[0][k], lp[1][k], lp[2][k]), slot))
                self.total_output_tokens += 1
                if self._check_stop(seq, t) is not None:
                    break
            live.append(seq)
            token_lists.append(new_toks)
            lp_lists.append(new_lps)
        return self._postprocess(live, token_lists, lp_lists)

    # -- tenant attribution (observe-only; tenancy.py) ------------------------
    def _tenant_map(self, entries) -> Optional[dict]:
        """Per-tenant token shares of one dispatch, from ``(seq, phase,
        goodput_tokens, live_tokens)`` rows: goodput feeds the per-tenant
        phase counters, live tokens weight the chip-second split. None
        when metering is off (the record_* calls then attribute
        nothing)."""
        if self.perf is None or not self.perf.tenant_metering:
            return None
        tmap: dict = {}
        for seq, phase, goodput, live in entries:
            rec = tmap.setdefault(
                seq.tenant, {"prefill": 0, "decode": 0, "live": 0})
            rec[phase] += goodput
            rec["live"] += live
        return tmap

    def _attribute_seq_seconds(self, seconds: float, entries) -> None:
        """Split one dispatch's wall time over its sequences by the same
        live-token weights as the tenant split; a sequence's sum lands in
        its usage-ledger record at finish."""
        if (self.perf is None or not self.perf.tenant_metering
                or seconds <= 0 or not entries):
            return
        shares = split_shares(
            seconds, {seq.request_id: live for seq, _, _, live in entries})
        for seq, _, _, _ in entries:
            seq.chip_seconds += shares.get(seq.request_id, 0.0)

    def _postprocess(self, seqs: list[Sequence], token_lists: list[list[int]],
                     lp_lists: list) -> list[RequestOutput]:
        outputs = []
        for seq, toks, lps in zip(seqs, token_lists, lp_lists):
            status = self._check_stop(seq, toks[-1]) if toks else None
            if status is not None:
                if self.host_kv is not None or self.remote_kv is not None:
                    self._host_offload_finished(seq)
                if seq.pin_on_finish:
                    self.scheduler.allocator.pin_blocks(seq.block_ids)
                self.scheduler.finish(seq, status)
                self._release_grammar(seq)
                seq.finish_time = time.monotonic()
                if self.perf is not None and seq.admit_time is not None:
                    self.perf.note_request(
                        seq.tenant, seq.admit_time - seq.arrival_time)
            done = status is not None
            outputs.append(RequestOutput(
                request_id=seq.request_id,
                new_token_ids=list(toks),
                finished=done,
                finish_reason=seq.finish_reason(),
                num_prompt_tokens=seq.num_prompt_tokens,
                num_output_tokens=len(seq.output_token_ids),
                num_cached_tokens=seq.num_cached_tokens,
                tenant=seq.tenant,
                chip_seconds=seq.chip_seconds,
                block_ids=seq.released_block_ids if done else None,
                arrival_time=seq.arrival_time if done else None,
                admit_time=seq.admit_time if done else None,
                first_token_time=seq.first_token_time if done else None,
                finish_time=seq.finish_time if done else None,
                new_logprobs=lps,
            ))
        return outputs

    # -- the tiers (device pool <-> host <-> remote; engine/kv_offload.py) ---
    def _wire_tier_hooks(self) -> None:
        """Point the allocator's eviction at host demotion and the host
        store's eviction at remote demotion."""
        if self.host_kv is not None:
            self.scheduler.allocator.evict_hook = self._demote_evicted_block
            if self.remote_kv is not None:
                self.host_kv.demote_hook = self._demote_to_remote

    def _demote_evicted_block(self, block_id: int, chain_hash: int) -> None:
        """Allocator evict hook: queue the block's slab for the host tier.
        It runs inside a scheduling decision (or ``take_free_blocks``),
        while the block's KV is intact; ``_flush_demotions`` copies the
        queue down in one batch right after that decision, before anything
        is enqueued that could write the block, so stream order keeps the
        copy ahead of the block's next writer (K1 of the step)."""
        if chain_hash in self.host_kv:
            return  # already resident (offloaded at finish)
        self._demote_queue.append((block_id, chain_hash))

    def _flush_demotions(self) -> None:
        if not self._demote_queue:
            return
        queue, self._demote_queue = self._demote_queue, []
        slabs = self.runner.export_slabs([bid for bid, _ in queue])
        for (_, chain_hash), slab in zip(queue, slabs):
            if self.host_kv.put(chain_hash, slab):
                self.hbm_demotions += 1
                self.tier_bytes[("host", "out")] += slab.nbytes

    def _demote_to_remote(self, chain_hash: int, slab) -> None:
        """Host-store demote hook: the evicted slab moves on to the remote
        tier (a bounded fire-and-forget put)."""
        self.remote_kv.put_slab(chain_hash, slab)
        self.tier_bytes[("remote", "out")] += slab.nbytes

    def _start_tier_prefetch(self, seq: Sequence) -> None:
        """Admission hook: start the tier lookup and park the sequence in
        PREFETCHING until it lands; a cold tier delays only this
        sequence's prefill. Under brownout stage 2+ (``prefetch_paused``)
        no fetch starts and the sequence prefills cold."""
        if self.prefetch_paused:
            self.prefetch_shed_count += 1
            return
        if self._prefetcher.submit(seq) is not None:
            seq.status = SequenceStatus.PREFETCHING

    def _poll_prefetches(self) -> None:
        if self._prefetcher is None:
            return
        for job in self._prefetcher.pop_done():
            self._commit_prefetch(job)

    def _commit_prefetch(self, job) -> None:
        """Land one finished lookup: import the fetched slabs into the
        blocks the sequence took at admission and release it to
        PREFILLING. A sequence aborted in flight gave its blocks back (they
        may be another's now), so slabs are imported only while it still
        owns the blocks it held at submit."""
        try:
            slabs, host_n, remote_n = job.future.result()
        except Exception:  # the lookup died: a clean miss
            slabs, host_n, remote_n = [], 0, 0
        self._observe_prefetch(time.monotonic() - job.submit_time)
        seq = self.scheduler.seqs.get(job.request_id)
        if (seq is None or seq.status is not SequenceStatus.PREFETCHING
                or tuple(seq.block_ids[:len(job.block_snapshot)])
                != job.block_snapshot):
            self._prefetcher.dropped += 1
            if seq is not None and seq.status is SequenceStatus.PREFETCHING:
                seq.status = SequenceStatus.PREFILLING
            return
        seq.status = SequenceStatus.PREFILLING
        n = len(slabs)
        if not n:
            return  # a tier miss: the prefill computes the blocks
        bs = self.config.cache.block_size
        start = job.start_block
        self.runner.import_slabs(seq.block_ids[start:start + n], slabs)
        seq.num_computed_tokens += n * bs
        seq.num_cached_tokens += n * bs
        self.scheduler.allocator.commit_full_blocks(
            seq.token_ids[:seq.num_computed_tokens],
            seq.block_ids[:start + n], seq.prefix_root)
        self._prefetcher.committed += 1
        self.prefetch_blocks += n
        if host_n:
            self.tier_bytes[("host", "in")] += sum(
                s.nbytes for s in slabs[:host_n])
        if remote_n:
            self.tier_bytes[("remote", "in")] += sum(
                s.nbytes for s in slabs[host_n:])

    def _observe_prefetch(self, seconds: float) -> None:
        self.prefetch_count += 1
        self.prefetch_seconds_sum += seconds
        for i, edge in enumerate(self._PREFETCH_BUCKETS):
            if seconds <= edge:
                self.prefetch_hist[i] += 1
                return
        self.prefetch_hist[-1] += 1  # +Inf

    def _host_offload_finished(self, seq: Sequence) -> None:
        """Copy a finishing sequence's full blocks to the tiers, keyed by
        its own chain."""
        bs = self.config.cache.block_size
        # only positions below num_computed hold valid KV (Scheduler.finish)
        n_valid = min(len(seq.token_ids), seq.num_computed_tokens)
        n_full = min(n_valid // bs, len(seq.block_ids))
        if n_full <= 0:
            return
        slabs = self.runner.export_slabs(seq.block_ids[:n_full])
        tokens = seq.token_ids[:n_full * bs]
        if self.host_kv is not None:
            added = self.host_kv.put_sequence(tokens, slabs, seq.prefix_root)
            if added:
                self.tier_bytes[("host", "out")] += added * slabs[0].nbytes
        if self.remote_kv is not None:
            for h, slab in zip(chain_hashes(tokens, bs, seq.prefix_root),
                               slabs):
                self.remote_kv.put_slab(h, slab)
                self.tier_bytes[("remote", "out")] += slab.nbytes

    # -- KV export / import (P->D disaggregation) ----------------------------
    def export_kv(self, block_ids: list[int]) -> torch.Tensor:
        return self.runner.export_blocks(block_ids)

    def import_kv(self, prompt_token_ids: list[int], data,
                  root: int = HASH_SEED) -> int:
        """Write transferred blocks (L, n, bs, 2KH, D) into the pool and
        register their chain hashes, so admission prefix-hits them;
        returns the tokens now cached (the whole-transfer form of the
        begin / range / finish calls)."""
        got = self.begin_kv_import(prompt_token_ids, int(data.shape[1]))
        if got is None:
            return 0
        local, n_full = got
        self.runner.import_blocks(local, data[:, :n_full])
        return self.finish_kv_import(prompt_token_ids, local, root)

    def begin_kv_import(self, prompt_token_ids: list[int],
                        n_remote_blocks: int):
        """Take pool blocks for an incoming pulled transfer of full blocks
        (never the block of the prompt's last token, which admission
        recomputes). (local block ids, n_full), or None when the pool is
        full."""
        bs = self.config.cache.block_size
        n_full = min(n_remote_blocks, (len(prompt_token_ids) - 1) // bs)
        if n_full <= 0:
            return None
        local = self.scheduler.allocator.take_free_blocks(n_full)
        self._flush_demotions()  # before the import writes those blocks
        if local is None:
            return None
        return local, n_full

    def import_kv_range(self, local_blocks: list[int], layer_lo: int,
                        data) -> None:
        self.runner.import_blocks_range(local_blocks, layer_lo, data)

    def finish_kv_import(self, prompt_token_ids: list[int],
                         local_blocks: list[int],
                         root: int = HASH_SEED) -> int:
        """Commit pulled blocks as prefix-cache content on the chain from
        ``root`` (the request's adapter root, HASH_SEED for the base
        model) and release them to the cache."""
        bs = self.config.cache.block_size
        alloc = self.scheduler.allocator
        alloc.commit_full_blocks(prompt_token_ids[:len(local_blocks) * bs],
                                 local_blocks, root)
        alloc.free_blocks(local_blocks)  # refcount 0: cached, matchable
        return len(local_blocks) * bs

    def abort_kv_import(self, local_blocks: list[int]) -> None:
        self.scheduler.allocator.free_blocks(local_blocks)

    def begin_kv_receive(self, n_blocks: int) -> Optional[list[int]]:
        """Take ``n_blocks`` pool blocks for a pushed transfer: the
        producer's whole block list, the last partial block included (they
        become a live sequence's table, not cache content). None when the
        pool cannot give them."""
        if n_blocks <= 0:
            return None
        blocks = self.scheduler.allocator.take_free_blocks(n_blocks)
        self._flush_demotions()  # before the transfer writes those blocks
        return blocks

    def splice_request(self, request_id: str, prompt_token_ids: list[int],
                       first_token: int, sampling: SamplingParams,
                       blocks: list[int], adapter_slot: int = 0,
                       tenant: str = "anonymous") -> Sequence:
        """Turn a landed P->D transfer into a decode row: the prompt is
        computed and the prefill's first token is already the first
        output, so the next step decodes it; no re-prefill.
        ``sampling.max_tokens`` counts the whole completion, the first
        token included. On failure the caller still owns ``blocks``; on
        success the finish and abort paths release them."""
        if len(blocks) * self.config.cache.block_size < len(prompt_token_ids):
            raise ValueError("spliced blocks do not cover the prompt")
        if not 0 <= adapter_slot < self.config.max_loras:
            raise ValueError(f"adapter_slot must be in [0, "
                             f"{self.config.max_loras})")
        sampling = sampling.clamped(self.config.model.max_model_len,
                                    len(prompt_token_ids))
        if sampling.seed is None:
            sampling = dataclasses.replace(
                sampling, seed=int.from_bytes(os.urandom(4), "little"))
        seq = Sequence(request_id, list(prompt_token_ids), sampling,
                       adapter_slot=adapter_slot,
                       tenant=tenant or "anonymous",
                       prefix_root=self.runner.lora_roots[adapter_slot],
                       token_ctrl=make_token_controls(
                           sampling, self.config.model.vocab_size))
        seq.output_token_ids = [int(first_token)]
        seq.num_computed_tokens = len(prompt_token_ids)
        seq.num_cached_tokens = len(prompt_token_ids)
        seq.block_ids = list(blocks)
        self.scheduler.splice(seq)
        if sampling.presence_penalty or sampling.frequency_penalty:
            # the first token counts toward the penalties, as if this
            # engine had sampled it
            self._count_reset_slots.append(seq)
        self.total_prompt_tokens += len(prompt_token_ids)
        self.spliced_seqs += 1
        return seq

    def _check_stop(self, seq: Sequence, token: int) -> Optional[SequenceStatus]:
        s = seq.sampling
        eos = self.tokenizer.eos_id
        if not s.ignore_eos and eos is not None and token == eos:
            return SequenceStatus.FINISHED_STOPPED
        if token in s.stop_token_ids:
            return SequenceStatus.FINISHED_STOPPED
        if len(seq.output_token_ids) >= s.max_tokens:
            return SequenceStatus.FINISHED_LENGTH
        if seq.num_tokens >= self.config.model.max_model_len:
            return SequenceStatus.FINISHED_LENGTH
        return None

    # -- metrics (the /metrics contract) -------------------------------------
    def stats(self) -> dict:
        """Host counters for the exposition, with the reference's keys,
        the tiers' snapshot (``kv_tier``) when a tier is on, ``perf``, the
        accountant's fields, and ``tenants``, the folded tenant table."""
        alloc = self.scheduler.allocator
        out = {
            "num_requests_running": self.scheduler.num_running,
            "num_requests_waiting": self.scheduler.num_waiting,
            "gpu_cache_usage_perc": alloc.usage,
            "gpu_prefix_cache_hits_total": alloc.prefix_hits,
            "gpu_prefix_cache_queries_total": alloc.prefix_queries,
            "prompt_tokens_total": self.total_prompt_tokens,
            "generation_tokens_total": self.total_output_tokens,
            "cpu_cache_usage_perc": 0.0,
            "cpu_prefix_cache_hits_total": 0,
            "cpu_prefix_cache_queries_total": 0,
            "aborted_seqs_total": self.aborted_seqs,
            "spliced_seqs_total": self.spliced_seqs,
            "batch_occupancy": (self.scheduler.num_running
                                / max(1, self.config.scheduler.max_num_seqs)),
            "kv_blocks_total": self.runner.num_blocks,
            "kv_blocks_free": self.scheduler.num_free_blocks,
            "ragged_dispatches_total": self.ragged_dispatches,
            "ragged_live_tokens_total": self.ragged_live_tokens,
            "ragged_stream_utilization": (
                self.ragged_live_tokens
                / max(1, self.ragged_dispatches
                      * self.config.scheduler.max_num_batched_tokens)
            ),
            "prefill_dispatches_total": self.prefill_dispatches,
            "prefill_live_tokens_total": self.prefill_live_tokens,
            "prefill_bucket_utilization": (
                self.prefill_live_tokens / max(1, self.prefill_padded_tokens)
            ),
            "decode_dispatches_total": self.decode_dispatches,
            "spec_decode_num_draft_tokens_total": self.spec_drafted,
            "spec_decode_num_accepted_tokens_total": self.spec_accepted,
            # the cumulative acceptance ratio and the mean tokens a verified
            # span emitted (1 guaranteed + accepted drafts); both 0 until
            # the first verify
            "spec_decode_acceptance_rate": (
                self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0
            ),
            "spec_decode_tokens_per_step": (
                self.spec_step_tokens / self.spec_steps
                if self.spec_steps else 0.0
            ),
        }
        if self.host_kv is not None:
            out["cpu_cache_usage_perc"] = self.host_kv.usage
            out["cpu_prefix_cache_hits_total"] = self.host_kv.hits
            out["cpu_prefix_cache_queries_total"] = self.host_kv.queries
        if self.host_kv is not None or self.remote_kv is not None:
            out["kv_tier"] = self.tier_stats()
        if self.perf is not None:
            out["perf"] = self.perf.stats_fields()
            out["tenants"] = self.tenant_stats()
        return out

    def tenant_stats(self) -> dict:
        """The attribution snapshot (tokens by phase, chip-seconds, live
        KV blocks, request and queue-time sums), folded to the top K: the
        source of the ``vllm:tenant_*`` families and ``/debug/tenants``.
        Empty-shaped when perf accounting is off."""
        if self.perf is None:
            return {"enabled": False, "tenants": {}}
        kv: dict[str, int] = {}
        for seq in list(self.scheduler.seqs.values()):
            kv[seq.tenant] = kv.get(seq.tenant, 0) + len(seq.block_ids)
        return self.perf.tenant_fields(kv_blocks=kv)

    def tier_stats(self) -> dict:
        """The tiers' snapshot: hit, query, demotion and eviction counters
        a tier, bytes moved a tier and direction, and the prefetch
        pipeline's latency histogram (``vllm:kv_tier_*``,
        ``vllm:kv_prefetch_*``)."""
        alloc = self.scheduler.allocator
        tiers: dict = {"hbm": {"hits": alloc.prefix_hits,
                               "queries": alloc.prefix_queries,
                               "demotions": self.hbm_demotions,
                               "evictions": alloc.evictions,
                               "usage": alloc.usage}}
        if self.host_kv is not None:
            tiers["host"] = {"hits": self.host_kv.hits,
                             "queries": self.host_kv.queries,
                             "demotions": self.host_kv.demotions,
                             "evictions": self.host_kv.evictions,
                             "usage": self.host_kv.usage,
                             "bytes_used": self.host_kv.used_bytes,
                             "bytes_capacity": self.host_kv.capacity_bytes}
        if self.remote_kv is not None:
            tiers["remote"] = {"hits": self.remote_kv.hits,
                               "queries": self.remote_kv.queries,
                               "refused": self.remote_kv.refused}
        prefetch = None
        if self._prefetcher is not None:
            total = self.prefetch_seconds_sum
            prefetch = {
                "submitted": self._prefetcher.submitted,
                "committed": self._prefetcher.committed,
                "dropped": self._prefetcher.dropped,
                "in_flight": len(self._prefetcher.jobs),
                "blocks": self.prefetch_blocks,
                "count": self.prefetch_count,
                "seconds_sum": total,
                "stall_seconds": self.prefetch_stall_seconds,
                # share of prefetch wall time that overlapped engine work
                "overlap_fraction": (
                    max(0.0, 1.0 - self.prefetch_stall_seconds / total)
                    if total > 0 else 1.0),
                "hist_buckets": list(self._PREFETCH_BUCKETS),
                "hist_counts": list(self.prefetch_hist),
            }
        return {"tiers": tiers,
                "bytes": {f"{t}_{d}": v
                          for (t, d), v in sorted(self.tier_bytes.items())},
                "prefetch": prefetch}

    def shutdown_tiers(self) -> None:
        """Stop the tier threads (prefetch and remote IO)."""
        if self._prefetcher is not None:
            self._prefetcher.shutdown()
        if self.remote_kv is not None:
            self.remote_kv.shutdown()

    @property
    def tensor_parallel_ranks(self) -> int:
        """Processes the engine's runner spans (1 on one process and with
        stages alone; the grid's size otherwise)."""
        return self.runner.ranks.size if self.runner.ranks else 1

    def rank_info(self) -> dict:
        """The ranks: their count and the grid's ``label`` (the axes
        above 1, ``seq,tensor`` say), each such axis's size (``shape``),
        process ids (this process first, then by global rank) and
        devices; whether decode steps run as CUDA graphs; this process's
        kernel launches so far (rank 0's)."""
        ranks = getattr(self.runner, "ranks", None)
        info = {"size": self.tensor_parallel_ranks,
                "axis": ranks.axis if ranks is not None else None,
                "shape": ({} if ranks is None else
                          {a: ranks.grid.shape[a] for a in ranks.grid.axes}),
                "pids": [os.getpid()],
                "devices": [str(self.device)],
                "decode_graphs": self.runner.graphs is not None,
                "launches": kernel_launches()}
        if isinstance(self.runner, MirroredRunner):
            info["pids"] += self.runner.follower_pids
            info["devices"] = list(self.runner.ranks.devices)
        return info

    def close(self) -> None:
        """Stop the tier threads and the tensor-parallel followers."""
        self.shutdown_tiers()
        if isinstance(self.runner, MirroredRunner):
            self.runner.close()

    # -- sleep mode ----------------------------------------------------------
    def sleep_mode(self, level: int = 1) -> None:
        """Level 1 drops the KV pool (the largest allocation) and keeps the
        weights; level 2 drops the weights too. The prefix cache goes with
        the pool: the allocator is rebuilt, its evictions still demote to
        the host tier. LoRA and grammar banks stay. The decode graphs go
        first, and ``wake_mode`` captures them again. Refused while
        requests are unfinished."""
        if self.has_unfinished():
            raise RuntimeError("cannot sleep with unfinished requests")
        # a chain whose requests were all aborted still holds a dispatch
        self._resolve_pending_decode()
        self.runner.drop_kv()
        self.scheduler.allocator = PrefixCachingBlockAllocator(
            self.runner.num_blocks, self.config.cache.block_size,
            self.config.cache.enable_prefix_caching)
        self._wire_tier_hooks()
        if level >= 2:
            self.runner.drop_params()
        self.sleep_level = level

    def wake_mode(self) -> None:
        self.runner.restore_params()
        self.runner.restore_kv()
        self.sleep_level = 0

    # -- dense scoring (embeddings, guided_choice, echo logprobs) ------------
    def _score_length(self, n: int) -> int:
        """The padded length of a dense scoring forward over ``n`` tokens:
        its prefill bucket, or the next power of two where the bucket
        clamps below ``n``."""
        S = self._bucket(n)
        return S if S >= n else 1 << (n - 1).bit_length()

    def embed(self, prompt_token_ids: list[int]) -> np.ndarray:
        """Mean-pooled final hidden state, the /v1/embeddings encoder (a
        causal LM's pooled hidden). Pads past the top bucket to the next
        power of two, as ``choice_logprobs`` does: the reference's
        ``embed`` pads to the clamped bucket and fails on a longer
        prompt."""
        n = len(prompt_token_ids)
        S = self._score_length(n)
        tokens = np.zeros((1, S), np.int32)
        tokens[0, :n] = prompt_token_ids
        mask = np.zeros((1, S), np.int32)
        mask[0, :n] = 1
        return self.runner.pooled_embed(tokens, mask)[0]

    def choice_logprobs(self, prompt_token_ids: list[int],
                        choices_ids: list[list[int]]) -> list[float]:
        """log P(choice | prompt) of each choice, teacher-forced: the
        guided_choice primitive. Choices pad to a power of two and the
        length to ``_score_length``, the reference's size classes."""
        n = len(choices_ids)
        N = 1 << (n - 1).bit_length() if n else 1
        p = len(prompt_token_ids)
        S = self._score_length(p + max(len(c) for c in choices_ids))
        tokens = np.zeros((N, S), np.int32)
        cont = np.zeros((N, S), bool)
        for i, c in enumerate(choices_ids):
            tokens[i, :p + len(c)] = list(prompt_token_ids) + list(c)
            cont[i, p:p + len(c)] = True
        return self.runner.sequence_logprobs(tokens, cont)[:n].tolist()

    def prompt_logprobs(self, prompt_token_ids: list[int]) -> list:
        """Logprob entries of ``prompt_token_ids[1:]``, teacher-forced (token
        0 has no prediction): the completions ``echo`` + ``logprobs``
        surface, in generation's (lp, [(id, lp), ...]) shape. Pads to a
        power of two."""
        n = len(prompt_token_ids)
        if n < 2:
            return []
        tokens = np.zeros((1, 1 << (n - 1).bit_length()), np.int32)
        tokens[0, :n] = prompt_token_ids
        lp = self.runner.prompt_logprobs(tokens)
        return [_lp_row(lp, p) for p in range(n - 1)]

    # -- warmup --------------------------------------------------------------
    def warmup(self) -> None:
        """Run every step signature the serving traffic can reach once,
        so no live request pays a first call, then mark the accountant
        steady: a later new signature is an unexpected recompile."""
        # the admission bound is client back-pressure; warmup's internal
        # bursts must not trip it
        sched_cfg = self.config.scheduler
        bound, sched_cfg.max_queue_len = sched_cfg.max_queue_len, 0
        try:
            self._warmup_impl()
            if self.perf is not None:
                self.perf.mark_steady()
        finally:
            sched_cfg.max_queue_len = bound

    def _warmup_impl(self) -> None:
        """The port's signature set (``ModelRunner.install_compile_observer``
        keys): on the ragged path every stream length the step can run
        (``ModelRunner.ragged_lengths``), greedy and sampled, plain and
        guided; on the bucketed path the reference's bucket x row-class
        walk, greedy and sampled; on both, every decode variant (greedy or
        sampled, logprobs, grammar) and a guided prefill, then every decode
        graph key without an adapter at every rung of K3's plan ladder
        (``ModelRunner.warm_decode_graphs``); with speculation on, one
        motif run that verifies drafts; with ring prefill on, the
        reference's ring size classes, greedy and sampled: each power of
        two from the threshold up to ``max_model_len``."""
        rng = np.random.default_rng(0)
        sched = self.config.scheduler
        vocab = self.config.model.vocab_size
        K = max(sched.multi_step, 1)
        # the longest prompt that still leaves room for one decode step
        cap = max(self.config.model.max_model_len - K - 2, 1)
        # what the staged runner lacks (as the reference's warmup skips
        # it): logprobs, and the grammar bank
        lp_on = self.runner.supports_logprobs
        regex = "[ -~]*" if hasattr(self.runner, "register_grammar") else None

        def run(prompts, temperature, **kw):
            sp = SamplingParams(temperature=temperature, max_tokens=K + 1,
                                ignore_eos=True, **kw)
            for i, p in enumerate(prompts):
                self.add_request(f"warmup-{time.monotonic_ns()}-{i}",
                                 prompt_token_ids=p, sampling=sp)
            while self.has_unfinished():
                self.step()

        def prompts(total: int, n: int = 1) -> list:
            """``n`` random prompts of ``total`` tokens together, none
            longer than ``cap``."""
            n = max(n, -(-total // cap))
            sizes = [total // n + (i < total % n) for i in range(n)]
            return [rng.integers(1, vocab, m).tolist() for m in sizes]

        if self.attention_impl == "ragged":
            for n in self.runner.ragged_lengths():
                for temp in (0.0, 0.7):
                    for g in (None, regex):
                        run(prompts(n), temp, guided_regex=g)
        else:
            buckets = [b for b in sched.prefill_buckets
                       if b <= self.config.model.max_model_len]
            for b in buckets:
                n = max(min(b, sched.max_num_batched_tokens, cap), 1)
                if self._bucket(n) != b:
                    continue  # the budget cuts chunks below this bucket
                for temp in (0.0, 0.7):
                    run(prompts(n), temp)
            # every reachable (pow-2 rows, bucket) prefill variant: rows
            # pad to the next power of two of the chunk count (capped at
            # prefill_batch), and a bucket-b step carries at most
            # budget // (b / 2 + 1) + 1 chunks
            budget = sched.max_num_batched_tokens
            row_classes = sorted({
                min(1 << i, sched.prefill_batch)
                for i in range(
                    1, max((sched.prefill_batch - 1).bit_length(), 0) + 1)
            })
            for b in buckets:
                lo = b // 2 + 1 if b > buckets[0] else 1
                max_rows = min(sched.prefill_batch, budget // lo + 1)
                for p in row_classes:
                    if p > max_rows:
                        break
                    for temp in (0.0, 0.7):  # fresh prompts: no prefix hit
                        run(prompts(p * min(lo + 1, b), p), temp)
            for temp in (0.0, 0.7):  # guided first tokens
                if regex is not None:
                    run(prompts(8), temp, guided_regex=regex)
        # every decode variant (decode_multi's static flags)
        for temp in (0.0, 0.7):
            for lp in ((None, 5) if lp_on else (None,)):
                for g in ((None, regex) if regex else (None,)):
                    run(prompts(8), temp, logprobs=lp, guided_regex=g)
        # every decode graph key at every plan rung (on the card a capture
        # each, from a batch without live rows)
        self.runner.warm_decode_graphs()
        if self._spec is not None:
            # a draft-carrying span (propose, pack, verify, accept) runs
            # end to end before live traffic does
            motif = rng.integers(1, vocab, 8).tolist()
            sp = SamplingParams(temperature=0.0, max_tokens=8,
                                ignore_eos=True)
            self.add_request(f"warmup-spec-{time.monotonic_ns()}",
                             prompt_token_ids=motif * 4, sampling=sp)
            while self.has_unfinished():
                self.step()
        if self.scheduler.ring_enabled:
            limit = self.config.model.max_model_len
            n = sched.ring_prefill_threshold
            while n < limit:
                size = min(n, limit - K - 1)
                for temp in (0.0, 0.7):
                    run([rng.integers(1, vocab, size).tolist()], temp)
                n = 1 << n.bit_length()  # the next power of two above

    # -- convenience for tests / offline use ---------------------------------
    def generate(
        self,
        prompts: list[str] | list[list[int]],
        sampling: Optional[SamplingParams] = None,
        max_steps: int = 100_000,
        adapter_slot: int = 0,
        tenant: str = "anonymous",
    ) -> dict[str, list[int]]:
        seqs = {}
        for i, p in enumerate(prompts):
            rid = f"offline-{i}"
            if isinstance(p, str):
                seqs[rid] = self.add_request(rid, prompt=p, sampling=sampling,
                                             adapter_slot=adapter_slot,
                                             tenant=tenant)
            else:
                seqs[rid] = self.add_request(rid, prompt_token_ids=p,
                                             sampling=sampling,
                                             adapter_slot=adapter_slot,
                                             tenant=tenant)
        for _ in range(max_steps):
            if not self.has_unfinished():
                break
            self.step()
        return {rid: s.output_token_ids for rid, s in seqs.items()}
