"""Golden records and the logit-fingerprint comparison of the
correctness canary plane: the part of production_stack_tpu/canary_golden.py
that the engine's ``GET /debug/canary`` and the tests need.

A probe is a pinned synthetic request: greedy, fixed prompt, logprobs on.
``record_from_response`` turns a trusted ``/v1/completions`` response into
a ``GoldenRecord``; ``compare`` checks a later response against it in two
parts, exact greedy token identity first, then the per-step top-k
``{token: logprob}`` maps under the record's L-infinity tolerance. The
probe set and the record format are the reference's, so a golden recorded
by the JAX engine compares on this one. The golden store and the
record-to-record diff stay with the router's tooling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

DEFAULT_TOP_K = 5
DEFAULT_MAX_TOKENS = 8


@dataclasses.dataclass(frozen=True)
class CanaryProbe:
    """One pinned synthetic request: greedy, fixed prompt, logprobs on."""

    id: str
    prompt: str
    max_tokens: int = DEFAULT_MAX_TOKENS
    top_k: int = DEFAULT_TOP_K

    def request_body(self, model: str) -> dict:
        """The OpenAI /v1/completions body this probe sends. Pinned:
        greedy (temperature 0), non-streaming, logprobs on — the same
        body byte-for-byte every round, so responses are comparable."""
        return {
            "model": model,
            "prompt": self.prompt,
            "max_tokens": self.max_tokens,
            "temperature": 0.0,
            "logprobs": self.top_k,
            "stream": False,
        }


# The pinned default probe set. Changing a prompt here invalidates every
# golden record for that probe id — bump the id instead of editing in
# place.
DEFAULT_PROBES: Tuple[CanaryProbe, ...] = (
    CanaryProbe(id="greedy-prose",
                prompt="The quick brown fox jumps over the lazy"),
    CanaryProbe(id="greedy-count",
                prompt="1 2 3 4 5 6 7"),
)


def probe_by_id(probe_id: str) -> Optional[CanaryProbe]:
    for p in DEFAULT_PROBES:
        if p.id == probe_id:
            return p
    return None


@dataclasses.dataclass
class GoldenRecord:
    """A versioned trusted capture for one (model, probe).

    ``tokens`` are the greedy completion's token strings (identity
    check); ``fingerprint`` is the per-step top-k ``{token: logprob}``
    map (``None`` for steps the capture carried no top-k for).
    ``tolerance`` is the per-record L-infinity logit-error band: 0.0
    demands exact equality (bf16 fleets), a positive band admits a
    quantized fleet's documented drift."""

    model: str
    probe: str
    prompt: str
    tokens: List[str]
    fingerprint: List[Optional[Dict[str, float]]]
    max_tokens: int = DEFAULT_MAX_TOKENS
    top_k: int = DEFAULT_TOP_K
    tolerance: float = 0.0
    version: int = 1
    created: float = 0.0
    source: str = ""
    note: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "GoldenRecord":
        fields = {f.name for f in dataclasses.fields(GoldenRecord)}
        return GoldenRecord(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class CanaryVerdict:
    """Outcome of checking one probe response against its golden.

    ``kind`` is empty on a pass, else one of ``token`` (greedy identity
    broken), ``fingerprint`` (logit error over the record's tolerance),
    ``missing_logprobs`` (response carried no fingerprint to check)."""

    ok: bool
    kind: str = ""
    linf: float = 0.0
    first_divergence: int = -1
    detail: str = ""


def fingerprint_of(logprobs_block: Optional[dict]
                   ) -> Tuple[List[str], List[Optional[Dict[str, float]]]]:
    """OpenAI completions ``logprobs`` block → (token strings, per-step
    top-k maps). Tolerates absent/None blocks (empty fingerprint)."""
    if not isinstance(logprobs_block, dict):
        return [], []
    tokens = [str(t) for t in (logprobs_block.get("tokens") or [])]
    tops = logprobs_block.get("top_logprobs") or []
    fingerprint: List[Optional[Dict[str, float]]] = []
    for entry in tops:
        if isinstance(entry, dict):
            fingerprint.append({str(k): float(v) for k, v in entry.items()})
        else:
            fingerprint.append(None)
    # pad so len(fingerprint) == len(tokens): identity can still be
    # checked for steps the capture carried no top-k for
    while len(fingerprint) < len(tokens):
        fingerprint.append(None)
    return tokens, fingerprint[: len(tokens)]


def compare(record: GoldenRecord, tokens: List[str],
            fingerprint: List[Optional[Dict[str, float]]]) -> CanaryVerdict:
    """Two-part comparison: exact greedy token identity first (any
    divergence is a ``token`` failure at the first differing step),
    then the L-infinity logit-error check over each step's top-k
    intersection against the record's tolerance band."""
    if not tokens:
        return CanaryVerdict(ok=False, kind="missing_logprobs",
                             detail="response carried no logprobs block")
    if tokens != record.tokens:
        first = next((i for i, (a, b) in enumerate(zip(tokens, record.tokens))
                      if a != b), min(len(tokens), len(record.tokens)))
        got = tokens[first] if first < len(tokens) else "<eos>"
        want = (record.tokens[first] if first < len(record.tokens)
                else "<eos>")
        return CanaryVerdict(
            ok=False, kind="token", first_divergence=first,
            detail=f"greedy token {first} diverged: got {got!r}, "
                   f"golden {want!r}")
    linf = 0.0
    worst_step = -1
    compared = 0
    for i, (obs, gold) in enumerate(zip(fingerprint, record.fingerprint)):
        if not obs or not gold:
            continue
        shared = set(obs) & set(gold)
        if not shared:
            # completely disjoint top-k sets are a drift event even
            # before any value comparison — the ranked candidates moved
            return CanaryVerdict(
                ok=False, kind="fingerprint", linf=math.inf,
                first_divergence=i,
                detail=f"step {i}: top-{record.top_k} candidate sets are "
                       "disjoint from the golden capture")
        for tok in shared:
            err = abs(obs[tok] - gold[tok])
            compared += 1
            if err > linf:
                linf, worst_step = err, i
    if record.fingerprint and not compared:
        return CanaryVerdict(ok=False, kind="missing_logprobs",
                             detail="response fingerprint had no "
                                    "comparable top-k entries")
    if linf > record.tolerance:
        return CanaryVerdict(
            ok=False, kind="fingerprint", linf=linf,
            first_divergence=worst_step,
            detail=f"L-inf logit error {linf:.6g} exceeds the record's "
                   f"tolerance {record.tolerance:g} at step {worst_step}")
    return CanaryVerdict(ok=True, linf=linf)


def record_from_response(model: str, probe: CanaryProbe, payload: dict,
                         *, tolerance: float = 0.0, source: str = "",
                         created: float = 0.0, note: str = "",
                         version: int = 1) -> GoldenRecord:
    """Build a golden record from a trusted /v1/completions response."""
    choices = payload.get("choices") or []
    if not choices:
        raise ValueError("response has no choices to capture")
    tokens, fingerprint = fingerprint_of(choices[0].get("logprobs"))
    if not tokens:
        raise ValueError("response carried no logprobs; golden capture "
                         "requires logprobs on (is the probe pinned?)")
    return GoldenRecord(
        model=model, probe=probe.id, prompt=probe.prompt, tokens=tokens,
        fingerprint=fingerprint, max_tokens=probe.max_tokens,
        top_k=probe.top_k, tolerance=float(tolerance), version=version,
        created=created, source=source, note=note,
    )
