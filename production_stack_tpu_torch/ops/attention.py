"""Dense causal attention over whole sequences: the scoring path's.

Ports ``dense_causal_attention`` of production_stack_tpu/ops/attention.py,
which the reference computes in XLA, outside any Pallas kernel, for its
whole-prompt forwards (pooled embeddings, teacher-forced choice and prompt
logprobs). So this is plain PyTorch on either device, with no hand kernel
behind it.

The reference forms the (B, KH, G, S, S) float32 score tensor at once. This
version walks blocks of ``q_block`` queries, so the score buffer is at most
``B * H * q_block * S`` floats. Each block sees its whole causal row: the
keys it stops at are the ones the mask would zero (``exp(-1e30 - max)``
is exactly 0 in float32), so every value is the reference's up to the
order of float32 sums.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dense_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    soft_cap: float = 0.0,
    q_block: Optional[int] = None,
) -> torch.Tensor:
    """Causal multi-head attention with grouped KV (GQA).

    q: (B, S, H, D); k, v: (B, S, KH, D) with H = KH * G. Returns (B, S,
    H, D) in q's dtype. Scores and softmax are float32; ``soft_cap`` > 0
    applies Gemma-2's ``cap * tanh(s / cap)`` before the causal mask.
    ``q_block`` (None: all S) is the number of queries a block."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    blk = S if q_block is None else max(1, min(int(q_block), S))
    kt = k.float().permute(0, 2, 3, 1)  # (B, KH, D, S)
    vf = v.float().transpose(1, 2)  # (B, KH, S, D)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, blk):
        s1 = min(s0 + blk, S)
        b = s1 - s0
        qb = (q[:, s0:s1].float().reshape(B, b, KH, G, D)
              .permute(0, 2, 3, 1, 4).reshape(B, KH, G * b, D))
        scores = torch.matmul(qb, kt[..., :s1]).mul_(scale)
        if soft_cap:
            scores.div_(soft_cap).tanh_().mul_(soft_cap)
        scores = scores.view(B, KH, G, b, s1)
        scores.masked_fill_(pos[None, :s1] > pos[s0:s1, None], NEG_INF)
        scores.sub_(scores.amax(dim=-1, keepdim=True)).exp_()
        scores.div_(scores.sum(dim=-1, keepdim=True))
        o = torch.matmul(scores.view(B, KH, G * b, s1), vf[:, :, :s1])
        out[:, s0:s1] = (o.view(B, KH, G, b, D).permute(0, 3, 1, 2, 4)
                         .reshape(B, b, H, D).to(q.dtype))
    return out
