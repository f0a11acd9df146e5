"""Normalisation ops (plain PyTorch)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
    offset: float = 0.0,
) -> torch.Tensor:
    """RMSNorm in float32, cast back to the input dtype.

    ``offset`` supports the Gemma convention of scaling by (1 + weight)
    with a zero-centred stored weight (offset=1); Llama-style is offset=0.
    """
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if offset:  # a launch saved on the Llama path
        w = w + offset
    return (normed * w).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm in float32, cast back to the input dtype (Whisper)."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                        eps).to(x.dtype)
