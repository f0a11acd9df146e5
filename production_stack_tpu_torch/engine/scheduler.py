"""Continuous-batching scheduler: the unified and the bucketed policy.

Ports FCFS admission and the two policies of ``Scheduler.schedule`` from
production_stack_tpu/engine/scheduler.py, which share admission, blocks
and preemption:

- **Unified** (``unified = True``, set by the engine on the ragged path,
  ``_schedule_unified``): every step collects all decodable sequences (one
  stream token each), then FCFS prefill chunks fill whatever budget decode
  left; ``max_num_batched_tokens`` is the only shape knob.
- **Bucketed** (prefill priority): up to ``prefill_batch`` FCFS chunks a
  step, each at most the remaining prompt, the budget left and the largest
  bucket; chunks after the first are cut to the first chunk's bucket (the
  rest follows in a later step). Sequences decode only in a step that
  scheduled no chunk.

When the pool runs dry a decode row preempts the youngest running sequence
(vLLM-style recompute). With speculation on (the ragged path), each
eligible decode row is also granted draft tokens against the same budget
(``_grant_spec_drafts``). The engine's ``admission_hook`` may park an
admitted sequence in ``PREFETCHING`` while a tier fetch runs: it holds its
slot and blocks and takes no token budget (both policies schedule only
``PREFILLING`` and ``RUNNING`` sequences). ``splice`` enters a sequence
prefilled on another engine as a decode row. The brownout's grant
shedding, ring prefill and per-tenant fair share come in later slices.

The scheduler is host-side control plane: it decides and never touches
device tensors.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

from production_stack_tpu_torch.engine.config import CacheConfig, SchedulerConfig
from production_stack_tpu_torch.engine.kv_cache import PrefixCachingBlockAllocator
from production_stack_tpu_torch.engine.sequence import Sequence, SequenceStatus


class SchedulerQueueFull(Exception):
    """``Scheduler.add`` found the waiting queue at ``max_queue_len``."""


@dataclasses.dataclass
class ScheduledPrefill:
    seq: Sequence
    chunk_start: int  # == seq.num_computed_tokens
    chunk_len: int


@dataclasses.dataclass
class SchedulerOutput:
    prefills: list[ScheduledPrefill] = dataclasses.field(default_factory=list)
    decodes: list[Sequence] = dataclasses.field(default_factory=list)
    preempted: list[Sequence] = dataclasses.field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.prefills and not self.decodes


class Scheduler:
    def __init__(self, sched: SchedulerConfig, cache: CacheConfig,
                 num_blocks: int, max_model_len: int = 1 << 30):
        self.config = sched
        self.cache_config = cache
        self.max_model_len = max_model_len
        self.allocator = PrefixCachingBlockAllocator(
            num_blocks, cache.block_size, cache.enable_prefix_caching
        )
        self.waiting: collections.deque[Sequence] = collections.deque()
        self.seqs: dict[str, Sequence] = {}  # admitted, not finished
        self.free_slots = list(range(sched.max_num_seqs - 1, -1, -1))
        # the engine sets this on the ragged path; False = bucketed policy
        self.unified = False
        # set by the engine when speculative decoding is on: the draft width
        # to reserve for a decode row (0 = ineligible or cold; see
        # spec.SpecController). The row is charged 1 + grant stream tokens
        # and gets KV blocks for the whole span.
        self.spec_grant_fn = None
        # called with each sequence right after admission, before its first
        # chunk; the tiered engine starts a prefix fetch there and may park
        # the sequence in PREFETCHING
        self.admission_hook = None

    # -- queue management ---------------------------------------------------
    def add(self, seq: Sequence) -> None:
        if (self.config.max_queue_len > 0
                and len(self.waiting) >= self.config.max_queue_len):
            raise SchedulerQueueFull(
                f"waiting queue full ({len(self.waiting)} >= "
                f"{self.config.max_queue_len})")
        self.waiting.append(seq)

    def abort(self, request_id: str) -> Optional[Sequence]:
        for s in list(self.waiting):
            if s.request_id == request_id:
                self.waiting.remove(s)
                s.status = SequenceStatus.FINISHED_ABORTED
                return s
        s = self.seqs.get(request_id)
        if s is not None:
            self._release(s)
            s.status = SequenceStatus.FINISHED_ABORTED
        return s

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.seqs)

    @property
    def num_prefetching(self) -> int:
        """Admitted sequences parked on an in-flight tier fetch."""
        return sum(1 for s in self.seqs.values()
                   if s.status is SequenceStatus.PREFETCHING)

    @property
    def num_free_blocks(self) -> int:
        return self.allocator.num_free_blocks

    def has_work(self) -> bool:
        return bool(self.waiting or self.seqs)

    def live_request_ids(self) -> list[str]:
        return [s.request_id for s in list(self.waiting)] + list(self.seqs)

    def _decode_exhausted(self, seq: Sequence) -> bool:
        bound = min(seq.num_prompt_tokens + seq.sampling.max_tokens,
                    self.max_model_len)
        return seq.num_computed_tokens >= bound

    # -- internals ------------------------------------------------------------
    def _release(self, seq: Sequence) -> None:
        """Return a sequence's blocks and slot to the pools."""
        if seq.block_ids:
            seq.released_block_ids = list(seq.block_ids)
            self.allocator.free_blocks(seq.block_ids)
            seq.block_ids = []
        if seq.slot >= 0:
            self.free_slots.append(seq.slot)
            seq.slot = -1
        self.seqs.pop(seq.request_id, None)

    def finish(self, seq: Sequence, status: SequenceStatus) -> None:
        """Mark finished. Full blocks stay content-addressed in the
        allocator so a later request with the same prefix hits them. Only
        positions < num_computed_tokens hold valid KV (the final sampled
        token was never fed back, and rejected drafts leave garbage in the
        slots past the accepted prefix), so only those are committed."""
        n_valid = min(len(seq.token_ids), seq.num_computed_tokens)
        self.allocator.commit_full_blocks(seq.token_ids[:n_valid],
                                          seq.block_ids, seq.prefix_root)
        self._release(seq)
        try:
            self.waiting.remove(seq)  # a preempted seq can finish too
        except ValueError:
            pass
        seq.status = status

    def _preempt(self, victim: Sequence) -> None:
        self._release(victim)
        victim.status = SequenceStatus.PREEMPTED
        victim.num_computed_tokens = 0
        victim.num_cached_tokens = 0
        self.waiting.appendleft(victim)

    def _try_admit(self) -> None:
        while self.waiting and self.free_slots:
            seq = self.waiting[0]
            got = self.allocator.allocate_sequence(seq.token_ids,
                                                   seq.prefix_root)
            if got is None:
                break
            self.waiting.popleft()
            seq.block_ids, cached = got
            seq.num_cached_tokens = cached
            seq.num_computed_tokens = cached
            seq.slot = self.free_slots.pop()
            seq.status = SequenceStatus.PREFILLING
            if seq.admit_time is None:  # the first wait is the one users see
                seq.admit_time = time.monotonic()
            self.seqs[seq.request_id] = seq
            if self.admission_hook is not None:
                self.admission_hook(seq)

    def splice(self, seq: Sequence) -> None:
        """Enter a sequence prefilled on another engine (a P->D transfer)
        as a decode row: its blocks hold the prompt's KV, its first token
        is in ``output_token_ids`` and ``num_computed_tokens`` covers the
        prompt, so the next step decodes it; no pass through the waiting
        queue. Raises ``SchedulerQueueFull`` when no slot is free."""
        if not self.free_slots:
            raise SchedulerQueueFull("no decode slot free for spliced seq")
        seq.slot = self.free_slots.pop()
        seq.status = SequenceStatus.RUNNING
        if seq.admit_time is None:
            seq.admit_time = time.monotonic()
        self.seqs[seq.request_id] = seq

    # -- the per-step decision ----------------------------------------------
    def schedule(self) -> SchedulerOutput:
        out = SchedulerOutput()
        self._try_admit()
        if self.unified:
            return self._schedule_unified(out)
        # prefill priority: batch up to prefill_batch chunks per dispatch;
        # the first (FCFS) chunk picks the shape bucket, later chunks are
        # cut to it (they continue next step: chunked prefill)
        budget = self.config.max_num_batched_tokens
        bucket_cap = max(self.config.prefill_buckets)
        for seq in sorted(self.seqs.values(), key=lambda s: s.arrival_time):
            if seq.status is not SequenceStatus.PREFILLING:
                continue
            if seq.prefill_done:
                # a preempted sequence whose context fully prefix-matched
                # on re-admission: nothing to compute
                seq.status = SequenceStatus.RUNNING
                continue
            if len(out.prefills) >= self.config.prefill_batch or budget <= 0:
                break
            remaining = seq.prefill_target - seq.num_computed_tokens
            chunk = min(remaining, budget, bucket_cap)
            if out.prefills:
                first_bucket = self.config.bucket_for(
                    out.prefills[0].chunk_len)
                chunk = min(chunk, first_bucket)
            out.prefills.append(
                ScheduledPrefill(seq, seq.num_computed_tokens, chunk))
            budget -= chunk
        if out.prefills:
            return out
        out.decodes = self._grow_decodes(out)
        return out

    def _schedule_unified(self, out: SchedulerOutput) -> SchedulerOutput:
        """Decode rows claim one stream token each (plus their draft
        grants, with speculation on), then FCFS prefill chunks fill the
        rest of the token budget."""
        out.decodes = self._grow_decodes(out)
        budget = self.config.max_num_batched_tokens - len(out.decodes)
        if self.spec_grant_fn is not None:
            budget = self._grant_spec_drafts(out, budget)
        for seq in sorted(self.seqs.values(), key=lambda s: s.arrival_time):
            if seq.status is not SequenceStatus.PREFILLING:
                continue
            if seq.prefill_done:
                # preemption-recompute whose context fully prefix-matched
                # on re-admission: nothing to compute, decodes next step
                seq.status = SequenceStatus.RUNNING
                continue
            if budget <= 0:
                break
            chunk = min(seq.prefill_target - seq.num_computed_tokens, budget)
            out.prefills.append(
                ScheduledPrefill(seq, seq.num_computed_tokens, chunk))
            budget -= chunk
        return out

    def _grant_spec_drafts(self, out: SchedulerOutput, budget: int) -> int:
        """Reserve stream budget and KV blocks for speculative drafts.

        FCFS over the decode rows: each row asks ``spec_grant_fn`` for its
        adaptive width, clamped to the budget left, and has blocks appended
        so positions ``num_computed .. num_computed + grant`` all have KV
        slots. Drafts are optional work and never preempt: when the pool is
        dry the grant shrinks to what the current table holds. The grant
        lands on ``seq.spec_grant`` for the engine to propose against at
        pack time. Returns the budget left."""
        bs = self.cache_config.block_size
        for seq in sorted(out.decodes, key=lambda s: s.arrival_time):
            seq.spec_grant = 0
            if budget <= 0:
                continue
            k = min(self.spec_grant_fn(seq), budget,
                    self.max_model_len - 1 - seq.num_computed_tokens)
            if k <= 0:
                continue
            target = seq.num_computed_tokens + 1 + k
            while len(seq.block_ids) * bs < target:
                bid = self.allocator.append_block()
                if bid is None:
                    break
                seq.block_ids.append(bid)
            k = min(k, len(seq.block_ids) * bs - seq.num_computed_tokens - 1)
            if k <= 0:
                continue
            seq.spec_grant = k
            budget -= k
        return budget

    def _grow_decodes(self, out: SchedulerOutput) -> list[Sequence]:
        """Collect every decodable sequence, growing block tables first so
        each has capacity for the next ``decode_horizon`` tokens; when the
        pool is exhausted, preempt the youngest running sequence."""
        decodes = sorted(
            (s for s in self.seqs.values()
             if s.status is SequenceStatus.RUNNING
             and not self._decode_exhausted(s)),
            key=lambda s: s.slot,
        )
        bs = self.cache_config.block_size
        horizon = self.config.decode_horizon
        survivors = []
        for seq in decodes:
            if seq.status is not SequenceStatus.RUNNING:
                continue  # preempted earlier in this same pass
            preempted_self = False
            # capacity past max_model_len is never written (the runner
            # drops those KV writes), so it is not allocated
            target = min(seq.num_computed_tokens + horizon, self.max_model_len)
            while len(seq.block_ids) * bs < target:
                bid = self.allocator.append_block()
                while bid is None:
                    victim = self._pick_victim(exclude=seq)
                    if victim is None:
                        self._preempt(seq)
                        out.preempted.append(seq)
                        preempted_self = True
                        break
                    self._preempt(victim)
                    out.preempted.append(victim)
                    if victim in survivors:
                        survivors.remove(victim)
                    bid = self.allocator.append_block()
                if preempted_self:
                    break
                seq.block_ids.append(bid)
            if not preempted_self:
                survivors.append(seq)
        return survivors

    def _pick_victim(self, exclude: Sequence) -> Optional[Sequence]:
        candidates = [
            s for s in self.seqs.values()
            if s is not exclude and s.status is SequenceStatus.RUNNING
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda s: s.arrival_time)
