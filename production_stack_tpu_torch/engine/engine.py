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
``_run_decode`` and resolves at once. Speculation, grammar, LoRA, ring
prefill, KV tiers and transfer, and the perf accountant are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence as Seq

import numpy as np

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kv_cache import slot_mapping_for
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
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer


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
        self._count_reset_slots: list[Sequence] = []
        # the ragged or prefill dispatch whose results land at a later step
        self._pending_ragged: Optional[dict] = None
        self._pending_prefill: Optional[tuple] = None
        self.total_prompt_tokens = 0
        self.total_output_tokens = 0
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
        if sampling.seed is None:
            # unseeded sampling is nondeterministic (OpenAI/vLLM semantics)
            sampling = dataclasses.replace(
                sampling, seed=int.from_bytes(os.urandom(4), "little"))
        seq = Sequence(request_id, list(prompt_token_ids), sampling,
                       token_ctrl=make_token_controls(
                           sampling, self.config.model.vocab_size))
        self.scheduler.add(seq)
        self.total_prompt_tokens += len(prompt_token_ids)
        return seq

    def abort_request(self, request_id: str) -> bool:
        seq = self.scheduler.abort(request_id)
        if seq is not None:
            self.aborted_seqs += 1
        return seq is not None

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
            outputs.extend(self._run_decode(decodes))
        return outputs

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
    def _run_ragged(self, out) -> list[RequestOutput]:
        """ONE dispatch for a mixed step: every decode row contributes one
        token and the FCFS prefill chunks fill the rest of the budget,
        packed in slot order into a single stream of
        ``max_num_batched_tokens`` tokens."""
        bs = self.config.cache.block_size
        outputs = self._resolve_pending_ragged()
        decodes = [s for s in out.decodes
                   if s.status is SequenceStatus.RUNNING]
        prefills = [sp for sp in out.prefills
                    if not sp.seq.status.is_finished]
        if not decodes and not prefills:
            return outputs
        B = self.config.scheduler.max_num_seqs
        T = self.config.scheduler.max_num_batched_tokens
        rows: dict[int, tuple] = {s.slot: ("d", s) for s in decodes}
        for sp in prefills:
            rows[sp.seq.slot] = ("p", sp)

        self._r_tokens[:] = 0
        self._r_positions[:] = -1
        self._r_slot_mapping[:] = -1
        self._r_last_idx[:] = 0
        self._r_sample_mask[:] = 0.0
        self._context_lens[:] = 0
        self._presence[:] = 0.0
        self._frequency[:] = 0.0
        self._ctrl_ids[:] = -1
        self._ctrl_vals[:] = 0.0
        self._ctrl_mode[:] = 0

        cu = 0
        seqs_in_step: list[Sequence] = []
        for slot in range(B):
            ent = rows.get(slot)
            if ent is None:
                self._r_cu[slot + 1] = cu
                continue
            kind, obj = ent
            if kind == "d":
                seq = obj
                pos = seq.num_computed_tokens  # index of the incoming token
                self._r_tokens[cu] = seq.token_ids[pos]
                self._r_positions[cu] = pos
                self._r_slot_mapping[cu : cu + 1] = slot_mapping_for(
                    seq.block_ids, pos, 1, bs)
                self._context_lens[slot] = pos + 1
                self._steps[slot] = pos - seq.num_prompt_tokens + 1
                self._r_sample_mask[slot] = 1.0
                self._presence[slot] = seq.sampling.presence_penalty
                self._frequency[slot] = seq.sampling.frequency_penalty
                cu += 1
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
                if start + n >= seq.prefill_target and not seq.output_token_ids:
                    self._r_sample_mask[slot] = 1.0
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
        )
        self.ragged_dispatches += 1
        self.ragged_live_tokens += cu

        # scheduler-visible state advances now; results land next step
        decode_rows = []
        for seq in decodes:
            seq.num_computed_tokens += 1
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
            "result": result,
        }
        return outputs

    def _resolve_pending_ragged(self) -> list[RequestOutput]:
        if self._pending_ragged is None:
            return []
        pending = self._pending_ragged
        self._pending_ragged = None
        sampled, *lp = (x.cpu().numpy() for x in pending["result"])
        live, token_lists, lp_lists = [], [], []
        for kind, rows in (("p", pending["prefill_rows"]),
                           ("d", pending["decode_rows"])):
            for slot, seq in rows:
                if seq.status.is_finished:
                    continue  # aborted while the dispatch was in flight
                token = int(sampled[slot])
                if kind == "p":
                    seq.first_token_time = time.monotonic()
                seq.output_token_ids.append(token)
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

        greedy_only = all(sp.seq.sampling.temperature <= 0.0
                          for sp in prefills)
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
            ctrl=ctrl,
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

        greedy_only = all(s.sampling.temperature <= 0.0 for s in decodes)
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
        }

    # -- convenience for tests / offline use ---------------------------------
    def generate(
        self,
        prompts: list[str] | list[list[int]],
        sampling: Optional[SamplingParams] = None,
        max_steps: int = 100_000,
    ) -> dict[str, list[int]]:
        seqs = {}
        for i, p in enumerate(prompts):
            rid = f"offline-{i}"
            if isinstance(p, str):
                seqs[rid] = self.add_request(rid, prompt=p, sampling=sampling)
            else:
                seqs[rid] = self.add_request(rid, prompt_token_ids=p,
                                             sampling=sampling)
        for _ in range(max_steps):
            if not self.has_unfinished():
                break
            self.step()
        return {rid: s.output_token_ids for rid, s in seqs.items()}
