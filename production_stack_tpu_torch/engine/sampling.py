"""Sampling: request-level params and the batched sampler.

Ports production_stack_tpu/engine/sampling.py. Greedy decoding, logprobs,
penalties and token controls compute what the reference computes.

Seeded sampling follows this package's own rule, since torch cannot
reproduce JAX's ``fold_in``/``categorical`` stream: after temperature,
top-k and top-p, the token is the candidate (by rank j among the top
``MAX_CONSIDERED`` scaled logits) that maximises ``masked_logit[j] +
Gumbel(U(seed, step, j))``, where ``U`` is a fixed integer hash of (seed,
step, j) mapped to (0, 1) (``uniform_noise``). The same (seed, step,
logits) therefore give the same token on every run and on every device,
up to float rounding of exact ties.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e30


@dataclasses.dataclass
class SamplingParams:
    """The OpenAI/vLLM request knobs the engine honours."""

    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1  # -1 = disabled
    seed: Optional[int] = None
    stop: Sequence[str] = ()
    stop_token_ids: Sequence[int] = ()
    ignore_eos: bool = False
    n: int = 1
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logprobs: Optional[int] = None
    # token id -> additive bias, and an optional whitelist of ids
    logit_bias: Optional[dict] = None
    allowed_token_ids: Sequence[int] = ()
    # constrained decoding (vLLM guided_regex / guided_json): the engine
    # compiles these to a token FSM kept on the device (engine/grammar.py)
    guided_regex: Optional[str] = None
    guided_json: Optional[dict] = None

    def clamped(self, max_model_len: int, prompt_len: int) -> "SamplingParams":
        limit = max(max_model_len - prompt_len, 1)
        return dataclasses.replace(self, max_tokens=min(self.max_tokens, limit))


# -- token controls (logit_bias / allowed_token_ids) -------------------------
# Per-slot (K,) sparse id/value rows + a mode flag (0 = none, 1 = bias,
# 2 = whitelist+bias), as in the reference.

MAX_TOKEN_CONTROLS = 64  # ids per request; above this the server 400s

CTRL_NONE, CTRL_BIAS, CTRL_ALLOW = 0, 1, 2


def make_token_controls(s: SamplingParams, vocab_size: int):
    """Host-side: compact a request's controls to (ids, vals, mode) numpy
    rows, or None. Raises ValueError on overflow/out-of-range ids."""
    bias = {int(k): float(v) for k, v in (s.logit_bias or {}).items()}
    for t, v in bias.items():
        if not math.isfinite(v):
            raise ValueError(f"logit_bias for token {t} must be finite")
    if s.allowed_token_ids:
        ids = list(dict.fromkeys(int(t) for t in s.allowed_token_ids))
        mode = CTRL_ALLOW
    elif bias:
        ids = list(bias)
        mode = CTRL_BIAS
    else:
        return None
    if len(ids) > MAX_TOKEN_CONTROLS:
        raise ValueError(
            f"too many token controls ({len(ids)} > {MAX_TOKEN_CONTROLS})"
        )
    for t in list(ids) + list(bias):
        if not 0 <= t < vocab_size:
            raise ValueError(f"token id {t} out of range [0, {vocab_size})")
    out_ids = np.full(MAX_TOKEN_CONTROLS, -1, np.int32)
    out_vals = np.zeros(MAX_TOKEN_CONTROLS, np.float32)
    out_ids[: len(ids)] = ids
    out_vals[: len(ids)] = [bias.get(t, 0.0) for t in ids]
    return out_ids, out_vals, mode


def apply_token_controls(
    logits: torch.Tensor,  # (B, V) float32
    ctrl_ids: torch.Tensor,  # (B, K) int32, -1 padding
    ctrl_vals: torch.Tensor,  # (B, K) float32
    ctrl_mode: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Additive bias scatter + whitelist mask, batched over slots."""
    B, V = logits.shape
    valid = ctrl_ids >= 0
    ids = torch.clamp(ctrl_ids, 0, V - 1).long()
    biased = logits.scatter_add(
        1, ids, torch.where(valid, ctrl_vals, torch.zeros_like(ctrl_vals)))
    allowed = torch.zeros((B, V), dtype=torch.int32, device=logits.device)
    allowed = allowed.scatter_reduce(1, ids, valid.int(), reduce="amax") > 0
    blocked = (ctrl_mode == CTRL_ALLOW)[:, None] & ~allowed
    return torch.where(blocked, torch.full_like(biased, NEG_INF), biased)


MAX_CONSIDERED = 128  # top-k/top-p truncation window

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser (a bijection with full avalanche)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_noise(seeds: torch.Tensor, steps: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(B, n) float32 uniforms in (0, 1): entry (b, j) = U(seeds[b],
    steps[b], j), a pure function of its three integers."""
    s = seeds.long() & _MASK32
    t = steps.long() & _MASK32
    j = torch.arange(n, dtype=torch.int64, device=seeds.device)
    h = _mix32(_mix32(s ^ 0x9E3779B9) ^ t)
    h = _mix32(h[:, None] ^ j[None, :])
    return ((h >> 8).float() + 0.5) * (2.0 ** -24)


def sample_tokens(
    logits: torch.Tensor,  # (B, V) float32
    temperatures: torch.Tensor,  # (B,)
    top_ps: torch.Tensor,  # (B,)
    top_ks: torch.Tensor,  # (B,) int, <= 0 disables
    seeds: torch.Tensor,  # (B,) uint32 values
    steps: torch.Tensor,  # (B,) int: the row's sample counter
) -> torch.Tensor:
    """Batched temperature / top-k / top-p sampling; temperature 0 = greedy."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperatures, min=1e-6)[:, None]
    C = min(MAX_CONSIDERED, logits.shape[-1])
    vals, idxs = torch.topk(scaled, C, dim=-1)  # (B, C) descending
    ranks = torch.arange(C, device=logits.device)[None, :]
    k = torch.where(top_ks <= 0, torch.full_like(top_ks, C),
                    torch.clamp(top_ks, max=C))
    neg = torch.full_like(vals, NEG_INF)
    # top-k first, renormalise, then top-p over the surviving mass (vLLM
    # order); rank 0 is always kept so top_p=0 degenerates to greedy
    vals_k = torch.where(ranks < k[:, None], vals, neg)
    probs = torch.softmax(vals_k, dim=-1)
    cumsum = torch.cumsum(probs, dim=-1)
    keep_topp = ((cumsum - probs) < top_ps[:, None]) | (ranks == 0)
    masked = torch.where(keep_topp, vals_k, neg)
    u = uniform_noise(seeds, steps, C)
    pos = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    sampled = torch.gather(idxs, -1, pos[:, None])[:, 0]
    return torch.where(temperatures <= 0.0, greedy, sampled).to(torch.int32)


MAX_LOGPROBS = 20  # OpenAI top_logprobs cap


def compute_logprobs(logits: torch.Tensor, sampled: torch.Tensor):
    """Sampled-token logprob + top-MAX_LOGPROBS (ids, logprobs) per row,
    from the RAW model logits (before penalties, controls, temperature).
    logits (B, V) f32, sampled (B,) int ->
    (tok_lp (B,), top_ids (B, N) int32, top_lps (B, N))."""
    lse = torch.logsumexp(logits, dim=-1)
    tok_lp = torch.gather(logits, -1, sampled[:, None].long())[:, 0] - lse
    n = min(MAX_LOGPROBS, logits.shape[-1])
    top_vals, top_ids = torch.topk(logits, n, dim=-1)
    return tok_lp, top_ids.to(torch.int32), top_vals - lse[:, None]


def penalize_logits(
    logits: torch.Tensor,  # (B, V)
    output_counts: torch.Tensor,  # (B, V) int32
    presence: torch.Tensor,  # (B,)
    frequency: torch.Tensor,  # (B,)
) -> torch.Tensor:
    return (
        logits
        - presence[:, None] * (output_counts > 0)
        - frequency[:, None] * output_counts
    )
