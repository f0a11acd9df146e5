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
prefilled on another engine as a decode row.

The overload and tenant planes are the reference's: under brownout stage
1 (``spec_shed``) every draft grant is zero; with ``fair_share`` on and at
least two tenants waiting, admission dequeues by stride scheduling
(``_next_waiting``: the tenant with the lowest virtual pass goes next, its
pass advancing 1/weight an admission) and the unified prefill budget is
split deficit-round-robin by tenant weight (``_fair_prefill``). With one
tenant, or with fairness off, the schedule is the FCFS one exactly.
``retry_after_hint`` derives a 429's Retry-After from the queue's depth
over its recent drain rate. Ring prefill is not ported (one card).

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
        # brownout stage 1 (engine/overload.py): drafts are optional work,
        # so under sustained pressure grants go to zero first
        self.spec_shed = False
        self.spec_shed_count = 0  # decode rows whose grant was suppressed
        # -- per-tenant fair share (config.fair_share) -----------------------
        # carried DRR credit per tenant, in stream tokens (capped at one
        # full budget)
        self._deficits: dict[str, float] = {}
        # stride-scheduling virtual pass per tenant for the weighted-fair
        # admission dequeue (lowest pass admits next; +1/weight an admit)
        self._admit_pass: dict[str, float] = {}
        # recent queue-exit stamps: the drain rate behind retry_after_hint
        self._admit_stamps: collections.deque[float] = collections.deque(
            maxlen=256)

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

    def _next_waiting(self) -> Sequence:
        """The sequence the admission loop should try next.

        FIFO head, unless fair-share is on AND at least two tenants are
        waiting: then stride scheduling picks the per-tenant FCFS head
        whose tenant has the lowest virtual pass (pass advances by
        1/weight per admission), so a flooding tenant's backlog queues
        behind everyone else instead of monopolising the queue head. A
        tenant first seen mid-flight joins at the current pass floor —
        immediately competitive, never owed retroactive credit. With one
        tenant (or fairness off) this IS the FIFO head, bit-identically.
        """
        if not self.config.fair_share:
            return self.waiting[0]
        heads: dict[str, Sequence] = {}
        for s in self.waiting:  # deque order = FCFS within each tenant
            if s.tenant not in heads:
                heads[s.tenant] = s
        if len(heads) < 2:
            return self.waiting[0]
        floor = min(self._admit_pass.get(t, 0.0) for t in heads)
        pick = min(heads, key=lambda t: (
            max(self._admit_pass.get(t, floor), floor), t))
        return heads[pick]

    def _note_admitted(self, seq: Sequence) -> None:
        """Post-admission bookkeeping: drain-rate stamp + stride pass."""
        self._admit_stamps.append(time.monotonic())
        if not self.config.fair_share:
            return
        t = seq.tenant
        floor = min((self._admit_pass.get(s.tenant, 0.0)
                     for s in self.waiting), default=0.0)
        p = max(self._admit_pass.get(t, floor), floor)
        self._admit_pass[t] = p + 1.0 / self.config.tenant_weight(t)
        if len(self._admit_pass) > 512:  # bound churn: keep live tenants
            live = ({s.tenant for s in self.waiting}
                    | {s.tenant for s in self.seqs.values()})
            self._admit_pass = {k: v for k, v in self._admit_pass.items()
                                if k in live}

    def admission_drain_rate(self, now: Optional[float] = None) -> float:
        """Recent queue-exit rate in admissions/sec (0.0 = unknown)."""
        if len(self._admit_stamps) < 2:
            return 0.0
        now = time.monotonic() if now is None else now
        span = now - self._admit_stamps[0]
        if span <= 0:
            return 0.0
        return len(self._admit_stamps) / span

    def retry_after_hint(self, floor: float = 1.0,
                         ceiling: float = 60.0,
                         now: Optional[float] = None) -> float:
        """Seconds until the waiting queue plausibly has room: current
        depth over the measured drain rate, clamped to [floor, ceiling].
        Falls back to ``floor`` (the configured constant) before any
        drain history exists — the 429 Retry-After header derives from
        THIS, so the router's breaker/backoff paces clients
        proportionally to real congestion, not a fixed guess."""
        rate = self.admission_drain_rate(now)
        if rate <= 0.0:
            return floor
        return min(max(len(self.waiting) / rate, floor), ceiling)

    def tenant_loads(self) -> dict[str, float]:
        """Waiting + admitted sequence count per tenant — the load view
        the stage-3 brownout shed set is computed from."""
        loads: dict[str, float] = {}
        for s in list(self.waiting):
            loads[s.tenant] = loads.get(s.tenant, 0.0) + 1.0
        for s in self.seqs.values():
            loads[s.tenant] = loads.get(s.tenant, 0.0) + 1.0
        return loads

    def fair_share_snapshot(self) -> dict:
        """Carried DRR deficits + stride passes, for the
        ``vllm:fair_share_deficit{tenant}`` gauge (folded at export)."""
        return {
            "enabled": bool(self.config.fair_share),
            "deficits": dict(self._deficits),
            "admit_pass": dict(self._admit_pass),
        }

    def _try_admit(self) -> None:
        while self.waiting and self.free_slots:
            seq = self._next_waiting()
            got = self.allocator.allocate_sequence(seq.token_ids,
                                                   seq.prefix_root)
            if got is None:
                break
            if seq is self.waiting[0]:
                self.waiting.popleft()
            else:
                self.waiting.remove(seq)
            seq.block_ids, cached = got
            seq.num_cached_tokens = cached
            seq.num_computed_tokens = cached
            seq.slot = self.free_slots.pop()
            seq.status = SequenceStatus.PREFILLING
            if seq.admit_time is None:  # the first wait is the one users see
                seq.admit_time = time.monotonic()
            self.seqs[seq.request_id] = seq
            self._note_admitted(seq)
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
        rest of the token budget; with fair share on and two tenants or
        more with pending prefill, ``_fair_prefill`` splits that rest."""
        out.decodes = self._grow_decodes(out)
        budget = self.config.max_num_batched_tokens - len(out.decodes)
        if self.spec_grant_fn is not None:
            budget = self._grant_spec_drafts(out, budget)
        ordered = sorted(self.seqs.values(), key=lambda s: s.arrival_time)
        if self.config.fair_share:
            pending_tenants = {s.tenant for s in ordered
                               if s.status is SequenceStatus.PREFILLING
                               and not s.prefill_done}
            if len(pending_tenants) >= 2:
                return self._fair_prefill(out, ordered, budget)
            # one tenant: the FCFS loop below, bit-identical by construction
        for seq in ordered:
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

    def _fair_prefill(self, out: SchedulerOutput,
                      ordered: list[Sequence], budget: int) -> SchedulerOutput:
        """Deficit-round-robin split of the prefill budget across tenants.
        Each dispatch credits every tenant with pending prefill work a
        quantum of ``budget * weight/sum(weights)`` tokens
        on top of its carried deficit, serves quanta largest-deficit
        first, then redistributes whatever the light tenants couldn't use
        to tenants still pending — so the budget is always fully consumed
        when work exists (fairness never costs throughput, it only
        re-orders who prefills first). Chunks pack in global FCFS order
        bounded by each tenant's allocation, keeping intra-tenant order
        and the ragged dispatch shape identical to the FCFS path."""
        queues: dict[str, list[Sequence]] = {}
        for seq in ordered:
            if seq.status is not SequenceStatus.PREFILLING:
                continue
            if seq.prefill_done:
                seq.status = SequenceStatus.RUNNING
                continue
            queues.setdefault(seq.tenant, []).append(seq)
        # a tenant with no pending work banks no credit while idle —
        # idle time is not a claim on future capacity
        for t in list(self._deficits):
            if t not in queues:
                del self._deficits[t]
        if budget <= 0 or not queues:
            return out
        weight = self.config.tenant_weight
        work = {t: sum(s.prefill_target - s.num_computed_tokens for s in q)
                for t, q in queues.items()}
        wsum = sum(weight(t) for t in queues)
        for t in queues:
            self._deficits[t] = (self._deficits.get(t, 0.0)
                                 + budget * weight(t) / wsum)
        alloc = dict.fromkeys(queues, 0)
        left = budget
        # serve the fair quanta, largest carried deficit first (carries can
        # oversubscribe the budget; the longest-shorted tenant goes first)
        for t in sorted(queues, key=lambda t: (-self._deficits[t], t)):
            take = min(int(self._deficits[t]), work[t], left)
            if take > 0:
                alloc[t] = take
                self._deficits[t] -= take
                left -= take
        # unused share redistributes: quanta the light tenants couldn't
        # fill go to tenants still pending, weight-proportionally
        while left > 0:
            act = sorted(t for t in queues if work[t] - alloc[t] > 0)
            if not act:
                break
            rsum = sum(weight(t) for t in act)
            gave = 0
            for t in act:
                take = min(int(left * weight(t) / rsum),
                           work[t] - alloc[t], left - gave)
                alloc[t] += take
                gave += take
            if gave == 0:  # all shares rounded below one token
                alloc[act[0]] += 1
                gave = 1
            left -= gave
        # carried credit is capped at one full dispatch budget: a backlog
        # may be owed, but never more than one dispatch's worth
        cap = float(self.config.max_num_batched_tokens)
        for t in self._deficits:
            self._deficits[t] = min(self._deficits[t], cap)
        for seq in ordered:
            if (seq.status is not SequenceStatus.PREFILLING
                    or seq.prefill_done):
                continue
            quota = alloc.get(seq.tenant, 0)
            if quota <= 0:
                continue
            chunk = min(seq.prefill_target - seq.num_computed_tokens, quota)
            out.prefills.append(
                ScheduledPrefill(seq, seq.num_computed_tokens, chunk)
            )
            alloc[seq.tenant] = quota - chunk
        return out

    def _grant_spec_drafts(self, out: SchedulerOutput, budget: int) -> int:
        """Reserve stream budget and KV blocks for speculative drafts.

        FCFS over the decode rows: each row asks ``spec_grant_fn`` for its
        adaptive width, clamped to the budget left, and has blocks appended
        so positions ``num_computed .. num_computed + grant`` all have KV
        slots. Drafts are optional work and never preempt: when the pool is
        dry the grant shrinks to what the current table holds. The grant
        lands on ``seq.spec_grant`` for the engine to propose against at
        pack time. Returns the budget left.

        Under brownout stage 1+ (``spec_shed``) every grant is zero: rows
        still decode their one real token."""
        if self.spec_shed:
            for seq in out.decodes:
                seq.spec_grant = 0
            self.spec_shed_count += len(out.decodes)
            return budget
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
