"""Per-request sequence state (host side, control plane).

Ports production_stack_tpu/engine/sequence.py with its LoRA, grammar,
speculation and KV-plane fields (the ``PREFETCHING`` state, the blocks a
finished sequence released); the tenancy fields come with their slice.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

from production_stack_tpu_torch.engine.kv_cache import HASH_SEED
from production_stack_tpu_torch.engine.sampling import SamplingParams


class SequenceStatus(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    # admitted with its blocks, but a host or remote tier prefix fetch is
    # still in flight: neither prefill nor decode touches the sequence until
    # the engine commits or drops the fetched blocks and flips it to
    # PREFILLING
    PREFETCHING = "prefetching"
    RUNNING = "running"  # decoding
    PREEMPTED = "preempted"
    FINISHED_STOPPED = "stop"
    FINISHED_LENGTH = "length"
    FINISHED_ABORTED = "abort"

    @property
    def is_finished(self) -> bool:
        return self in (
            SequenceStatus.FINISHED_STOPPED,
            SequenceStatus.FINISHED_LENGTH,
            SequenceStatus.FINISHED_ABORTED,
        )


@dataclasses.dataclass
class Sequence:
    request_id: str
    prompt_token_ids: list[int]
    sampling: SamplingParams
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)
    adapter_slot: int = 0  # multi-LoRA bank slot; 0 = base model
    # the root of the prefix cache's block-hash chain: kv_cache.HASH_SEED
    # for the base model, the adapter's own root for a LoRA request
    prefix_root: int = HASH_SEED
    # compacted token controls (sampling.make_token_controls) or None
    token_ctrl: Optional[tuple] = None
    # constrained decoding: grammar-bank slot (-1 = unconstrained), the
    # current FSM state (generation starts at 0; the host's mirror of the
    # device-side advance), and the host TokenFsm (prefill-token advance)
    grammar_slot: int = -1
    fsm_state: int = 0
    fsm: Optional[object] = None

    output_token_ids: list[int] = dataclasses.field(default_factory=list)
    status: SequenceStatus = SequenceStatus.WAITING
    block_ids: list[int] = dataclasses.field(default_factory=list)
    # the blocks the sequence held when the scheduler released it (the
    # producer's remote_block_ids of a P->D transfer)
    released_block_ids: list[int] = dataclasses.field(default_factory=list)
    # a P->D producer: take a reference on the blocks at finish, before the
    # scheduler frees them, so the push that follows reads them intact; the
    # server frees them after the push
    pin_on_finish: bool = False
    num_computed_tokens: int = 0  # tokens whose KV sits in the pool
    num_cached_tokens: int = 0  # prefix-cache hits at admission
    slot: int = -1  # batch slot index, -1 = none
    admit_time: Optional[float] = None  # waiting -> scheduled (queue exit)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    # speculative decoding (engine/spec.py): acceptance EWMA and cold-probe
    # counter driving the adaptive draft width, the stream-token grant the
    # scheduler charged this step, and the drafts proposed at pack time
    spec_ewma: float = 1.0
    spec_cold_steps: int = 0
    spec_grant: int = 0
    spec_drafts: list[int] = dataclasses.field(default_factory=list)

    @property
    def token_ids(self) -> list[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def prefill_target(self) -> int:
        """Tokens that must be in the pool before decoding can resume: the
        whole prompt for a fresh request, everything but the newest output
        token after a preemption (that token is the next decode input)."""
        if self.output_token_ids:
            return self.num_tokens - 1
        return self.num_prompt_tokens

    @property
    def prefill_done(self) -> bool:
        return self.num_computed_tokens >= self.prefill_target

    def finish_reason(self) -> Optional[str]:
        if not self.status.is_finished:
            return None
        return self.status.value


@dataclasses.dataclass
class RequestOutput:
    """One step's increment for a request (engine -> server layer)."""

    request_id: str
    new_token_ids: list[int]
    finished: bool
    finish_reason: Optional[str]
    num_prompt_tokens: int
    num_output_tokens: int
    num_cached_tokens: int = 0
    # on finish: the blocks the sequence held (pinned for a push when it
    # asked for ``pin_on_finish``)
    block_ids: Optional[list[int]] = None
    # monotonic stamps, set on finish
    arrival_time: Optional[float] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # aligned with new_token_ids when the request asked for logprobs: each
    # entry is (token_logprob, [(token_id, logprob), ...] top-N)
    new_logprobs: Optional[list] = None
