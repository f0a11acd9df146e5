"""N-gram (prompt-lookup) draft proposal for speculative decoding.

A copy of production_stack_tpu/engine/spec.py. The proposer is host-side
control plane: it scans the sequence's own token history (prompt +
generated) for the most recent occurrence of the current tail n-gram and
proposes the tokens that followed it. Multi-round QA and agentic workloads
repeat long spans verbatim, so acceptance rates are high exactly where
decode throughput matters.

Verification rides the ragged step (there is no standalone verify
program): the drafts join the packed token stream as a short span, and the
model's greedy output at every span position either confirms or replaces
them. Output tokens are always the model's own argmax, so greedy output is
the same with speculation on or off, up to float summation order: a
verifying row's attention runs K2's row-tile walk, a decoding row's K3's
split-KV walk.

:class:`SpecController` adapts the per-sequence draft width with an
acceptance EWMA: sequences that keep rejecting drafts shrink to k=0 (their
stream-budget charge drops to the plain-decode 1 token), and a periodic
probe lets a sequence that went cold rediscover a repeating phase.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def propose_ngram(
    token_ids: list[int],
    k: int,
    n_max: int = 3,
    n_min: int = 1,
    window: int = 4096,
) -> list[int]:
    """Propose up to ``k`` draft tokens continuing ``token_ids``.

    Tries tail n-grams from ``n_max`` down to ``n_min``; for the first
    length with a match in the trailing ``window`` tokens, returns the
    (up to k) tokens that followed the MOST RECENT match. Returns [] when
    no n-gram recurs — the caller then decodes normally.
    """
    if k <= 0:
        return []
    arr = np.asarray(token_ids[-window:], dtype=np.int64)
    L = arr.shape[0]
    for n in range(n_max, n_min - 1, -1):
        if L < n + 1:
            continue
        tail = arr[L - n:]
        # candidate start positions: the n-gram must end before the tail
        # itself AND have at least one following token
        starts = np.lib.stride_tricks.sliding_window_view(arr[: L - 1], n)
        hits = np.flatnonzero((starts == tail).all(axis=1))
        if hits.size == 0:
            continue
        pos = int(hits[-1])  # most recent occurrence
        follow = arr[pos + n : pos + n + k]
        if follow.size == 0:
            continue
        return [int(t) for t in follow]
    return []


def accept_drafts(drafts: list[int], verified: np.ndarray) -> tuple[list[int], int]:
    """Greedy acceptance: given the model's argmax ``verified[j]`` at each
    verify position j (position 0 consumed the last accepted token,
    positions 1..n consumed the drafts), return (new_tokens, n_accepted).

    Draft j (1-based) is accepted iff every earlier draft was accepted and
    ``drafts[j-1] == verified[j-1]`` — i.e. the draft equals what the model
    would have produced anyway. The first non-matching model output is the
    bonus token, so each verify yields between 1 and len(drafts)+1 tokens,
    all of them the model's own argmax.
    """
    n_acc = 0
    for j, d in enumerate(drafts):
        if d == int(verified[j]):
            n_acc += 1
        else:
            break
    new_tokens = [int(verified[j]) for j in range(n_acc + 1)]
    return new_tokens, n_acc


@dataclasses.dataclass
class SpecController:
    """Per-sequence acceptance-EWMA adaptation of the draft width k.

    The grant is what the scheduler charges against the stream token
    budget (1 + grant per spec row), so a cold sequence must converge to
    grant 0 quickly — otherwise every step taxes prefill chunks for
    drafts that never get accepted. ``ewma`` starts optimistic (1.0: new
    sequences get the full k_max) and tracks accepted/drafted per verify;
    a grant whose proposal found no recurring n-gram decays it too (the
    budget was reserved and wasted). Once the grant rounds to 0 the
    sequence stops being charged, and every ``probe_interval`` scheduled
    steps it gets one full-width probe so a workload that re-enters a
    repetitive phase (multi-round chat re-feeding context verbatim) can
    recover without any global reset.

    Adaptation only changes WHICH drafts are proposed, never the emitted
    tokens — those are always the model's own argmax.
    """

    k_max: int
    alpha: float = 0.5  # EWMA step toward the newest acceptance ratio
    probe_interval: int = 8  # cold-sequence full-width probe cadence

    def grant(self, seq) -> int:
        """Draft width to reserve budget for this step (may exceed what
        the proposer actually finds; unused grant is idle stream slack)."""
        if self.k_max <= 0:
            return 0
        k = int(round(self.k_max * seq.spec_ewma))
        if k > 0:
            return min(k, self.k_max)
        seq.spec_cold_steps += 1
        if seq.spec_cold_steps >= self.probe_interval:
            seq.spec_cold_steps = 0
            return self.k_max
        return 0

    def update(self, seq, drafted: int, accepted: int) -> None:
        """Fold one verify result (or a granted-but-matchless step, with
        drafted = grant and accepted = 0) into the sequence's EWMA."""
        if drafted <= 0:
            return
        ratio = accepted / drafted
        seq.spec_ewma = (1.0 - self.alpha) * seq.spec_ewma + self.alpha * ratio
        if accepted > 0:
            seq.spec_cold_steps = 0
