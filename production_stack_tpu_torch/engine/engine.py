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
``_run_decode`` and resolves at once, unless n-gram speculation proposed
drafts: then those rows ride ``_run_ragged`` as spans of 1 + drafts,
verified in the same dispatch, which resolves at once.

Requests may carry a LoRA adapter (``adapter_slot``, a slot of the
runner's bank) and a grammar (``guided_regex`` / ``guided_json``, compiled
here to a token FSM, cached by pattern, in a refcounted slot of the
runner's grammar bank), on both paths. Ring prefill, KV tiers and
transfer, the brownout's speculation shedding and the perf accountant are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional, Sequence as Seq

import numpy as np

from production_stack_tpu_torch.engine import grammar as G
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kv_cache import (
    adapter_root,
    slot_mapping_for,
)
from production_stack_tpu_torch.engine.model_runner import ModelRunner
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
    def __init__(
        self,
        config: EngineConfig,
        params: Optional[dict] = None,
        num_blocks: Optional[int] = None,
        device="cuda",
    ):
        self.config = config
        self.tokenizer = get_tokenizer(config.model.tokenizer)
        self.runner = ModelRunner(config, params, num_blocks, device)
        self.device = self.runner.device
        self.scheduler = Scheduler(
            config.scheduler, config.cache, self.runner.num_blocks,
            max_model_len=config.model.max_model_len,
        )
        sched = config.scheduler
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

    # -- request intake ------------------------------------------------------
    def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[Seq[int]] = None,
        sampling: Optional[SamplingParams] = None,
        adapter_slot: int = 0,
    ) -> Sequence:
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
        if (sampling.logprobs is not None
                and not 0 <= sampling.logprobs <= MAX_LOGPROBS):
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
                       prefix_root=adapter_root(
                           adapter_slot,
                           self.runner.lora_generation[adapter_slot]),
                       token_ctrl=make_token_controls(
                           sampling, self.config.model.vocab_size))
        if sampling.guided_regex is not None or sampling.guided_json is not None:
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

    # -- the step ------------------------------------------------------------
    def step(self) -> list[RequestOutput]:
        out = self.scheduler.schedule()
        if out.is_empty:
            outputs = self._resolve_pending_ragged()
            outputs.extend(self._resolve_pending_prefill())
            return outputs
        if out.prefills:
            if self.attention_impl == "ragged":
                return self._run_ragged(out)
            # decode steps resolve at once, so no decode token is pending
            return self._run_prefill(out.prefills)
        # decode consumes the last sampled token: the pending ragged or
        # prefill results land first, and may finish sequences the
        # scheduler put in this step's decode batch
        outputs = self._resolve_pending_ragged()
        outputs.extend(self._resolve_pending_prefill())
        decodes = [s for s in out.decodes
                   if s.status is SequenceStatus.RUNNING]
        if decodes:
            if self._spec is not None and self._propose_spec_drafts(decodes):
                # drafts ride the packed stream as spans of 1 + drafts,
                # verified in the same ragged dispatch
                outputs.extend(self._run_ragged(out, proposed=True))
            else:
                outputs.extend(self._run_decode(decodes))
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
        fetched = [x.cpu().numpy() for x in pending["result"]]
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
        result = self.runner.prefill(
            tokens, positions, tables, context_lens, slot_mapping.reshape(-1),
            last_idx, temps, top_ps, top_ks, seeds, greedy_only=greedy_only,
            ctrl=ctrl, adapter_ids=adapter_ids if use_lora else None,
            g_ids=g_ids if use_grammar else None,
        )
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
        bs = self.config.cache.block_size
        use_logprobs = any(s.sampling.logprobs is not None for s in decodes)
        self._context_lens[:] = 0
        self._slot_mapping[:] = -1
        self._g_ids[:] = -1
        for seq in decodes:
            i = seq.slot
            pos = seq.num_computed_tokens  # index of the incoming token
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
            # sample counter = tokens sampled so far
            self._steps[i] = pos - seq.num_prompt_tokens + 1
            self._presence[i] = seq.sampling.presence_penalty
            self._frequency[i] = seq.sampling.frequency_penalty
            self._adapter_ids[i] = seq.adapter_slot
            self._g_ids[i] = seq.grammar_slot
            self._g_states[i] = max(seq.fsm_state, 0)

        greedy_only = all(s.sampling.temperature <= 0.0 for s in decodes)
        use_lora = any(s.adapter_slot for s in decodes)
        use_grammar = any(s.grammar_slot >= 0 for s in decodes)
        use_penalties = any(
            s.sampling.presence_penalty or s.sampling.frequency_penalty
            for s in decodes
        )
        self._reset_count_rows(use_penalties)
        use_controls = any(s.token_ctrl is not None for s in decodes)
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
        )
        self.decode_dispatches += 1
        sampled, lp = (result[0], result[1:]) if use_logprobs else (result, None)
        live, token_lists, lp_lists = [], [], []
        for seq in decodes:
            if seq.status.is_finished:
                continue
            slot = seq.slot
            want_lp = lp is not None and seq.sampling.logprobs is not None
            new_toks, new_lps = [], [] if want_lp else None
            for k in range(sampled.shape[0]):
                t = int(sampled[k, slot])
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

    def _postprocess(self, seqs: list[Sequence], token_lists: list[list[int]],
                     lp_lists: list) -> list[RequestOutput]:
        outputs = []
        for seq, toks, lps in zip(seqs, token_lists, lp_lists):
            status = self._check_stop(seq, toks[-1]) if toks else None
            if status is not None:
                self.scheduler.finish(seq, status)
                self._release_grammar(seq)
                seq.finish_time = time.monotonic()
            done = status is not None
            outputs.append(RequestOutput(
                request_id=seq.request_id,
                new_token_ids=list(toks),
                finished=done,
                finish_reason=seq.finish_reason(),
                num_prompt_tokens=seq.num_prompt_tokens,
                num_output_tokens=len(seq.output_token_ids),
                num_cached_tokens=seq.num_cached_tokens,
                arrival_time=seq.arrival_time if done else None,
                first_token_time=seq.first_token_time if done else None,
                finish_time=seq.finish_time if done else None,
                new_logprobs=lps,
            ))
        return outputs

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

    # -- metrics ---------------------------------------------------------------
    def stats(self) -> dict:
        alloc = self.scheduler.allocator
        return {
            "num_requests_running": self.scheduler.num_running,
            "num_requests_waiting": self.scheduler.num_waiting,
            "gpu_cache_usage_perc": alloc.usage,
            "gpu_prefix_cache_hits_total": alloc.prefix_hits,
            "gpu_prefix_cache_queries_total": alloc.prefix_queries,
            "prompt_tokens_total": self.total_prompt_tokens,
            "generation_tokens_total": self.total_output_tokens,
            "aborted_seqs_total": self.aborted_seqs,
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

    # -- convenience for tests / offline use ---------------------------------
    def generate(
        self,
        prompts: list[str] | list[list[int]],
        sampling: Optional[SamplingParams] = None,
        max_steps: int = 100_000,
        adapter_slot: int = 0,
    ) -> dict[str, list[int]]:
        seqs = {}
        for i, p in enumerate(prompts):
            rid = f"offline-{i}"
            if isinstance(p, str):
                seqs[rid] = self.add_request(rid, prompt=p, sampling=sampling,
                                             adapter_slot=adapter_slot)
            else:
                seqs[rid] = self.add_request(rid, prompt_token_ids=p,
                                             sampling=sampling,
                                             adapter_slot=adapter_slot)
        for _ in range(max_steps):
            if not self.has_unfinished():
                break
            self.step()
        return {rid: s.output_token_ids for rid, s in seqs.items()}
