"""The fused KV slab of the paged pool.

Pool layout (one fused buffer): ``(L, N, block_size, 2*KH, D)``, the same
as the JAX package's, so a block is byte-compatible with a one-card
(``tp=1``) JAX engine's. A token's K and V for all heads form one
contiguous ``(2*KH, D)`` slab, K heads at ``[0, KH)`` and V heads at
``[KH, 2KH)``; all four kernels read and write that order.

The plain PyTorch versions of the paged-attention ops live beside their
kernels, one per op: ``kv_write.kv_write_plain`` (the reference's
``write_kv``), ``ragged_paged_attention.ragged_paged_attention_plain``,
``paged_decode_attention.paged_decode_attention_plain`` and
``paged_prefill_attention.paged_prefill_attention_plain`` (the reference's
``ragged_paged_attention``, and its ``paged_attention`` at one query a
sequence and over padded chunks). They are the CPU serving path and the
test oracles, and work span by span or chunk by chunk, so they also run at
full width on the card.
"""

from __future__ import annotations

import torch


def combine_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(T, KH, D) k and v -> (T, 2*KH, D) update slab ``[K, V]``."""
    return torch.cat([k, v], dim=1)


def split_kv(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of combine_kv on any (..., 2*KH, D) tensor."""
    KH = kv.shape[-2] // 2
    return kv[..., :KH, :], kv[..., KH:, :]
