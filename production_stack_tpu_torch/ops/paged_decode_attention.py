"""K3: paged decode attention, one query token per sequence.

Counterpart of ``paged_decode_attention_pallas`` (``_decode_kernel``,
production_stack_tpu/ops/paged_attention_pallas.py). The CUDA kernel is
``csrc/paged_decode_attention.cu``; ``paged_decode_attention_plain`` is its
plain PyTorch version.

``q (B, H, D)`` row b attends the first ``context_lens[b]`` tokens of its
paged context; a slot with context 0 outputs 0.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.paged_attention import split_kv

LAUNCHES = _build.LaunchCounter("K3 paged_decode_attention")

_argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def paged_decode_attention_plain(
    q: torch.Tensor, pool: torch.Tensor, block_tables: torch.Tensor,
    context_lens: torch.Tensor, layer: int, soft_cap: float = 0.0,
) -> torch.Tensor:
    """Batched over sequences: the live blocks of every table row are
    gathered, positions at or past each row's context are zeroed (so NaN
    in unwritten blocks cannot leak) and masked with probability exactly 0."""
    B, H, D = q.shape
    _, _, bs, KH2, _ = pool.shape
    KH = KH2 // 2
    G = H // KH
    M = block_tables.shape[1]
    ctx_max = int(context_lens.max()) if B else 0
    if ctx_max <= 0:
        return torch.zeros_like(q)
    nb = min(-(-ctx_max // bs), M)
    gathered = pool[layer][block_tables[:, :nb].long()].reshape(
        B, nb * bs, KH2, D)
    k, v = split_kv(gathered)
    valid = (torch.arange(nb * bs, device=q.device)[None, :]
             < context_lens[:, None])  # (B, C)
    zero = torch.zeros((), device=q.device)
    k = torch.where(valid[..., None, None], k.float(), zero)
    v = torch.where(valid[..., None, None], v.float(), zero)
    scores = torch.einsum(
        "bkgd,bckd->bkgc", q.reshape(B, KH, G, D).float(), k) * D ** -0.5
    if soft_cap:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, zero)  # ctx 0: every lane masked
    p = torch.exp(scores - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgc,bckd->bkgd", p, v) / denom
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor, pool: torch.Tensor, block_tables: torch.Tensor,
    context_lens: torch.Tensor, layer: int, soft_cap: float = 0.0,
) -> torch.Tensor:
    """Decode attention of ``q (B, H, D)`` against layer ``layer`` of
    ``pool (L, N, bs, 2KH, D)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool, block_tables, context_lens, layer, soft_cap)
    what = "paged_decode_attention"
    _build.require_head_dim(what, q.shape[-1])
    _build.require_cuda(what, q, pool, block_tables, context_lens)
    _build.require_int32(what, block_tables, context_lens)
    B, H, D = q.shape
    L, N, bs, KH2, D2 = pool.shape
    KH = KH2 // 2
    if D2 != D or H % KH:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool.shape)}")
    if block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError(f"{what}: block_tables / context_lens do not match "
                         f"{B} sequences")
    if q.dtype != pool.dtype:
        raise TypeError(f"{what}: q {q.dtype} != pool {pool.dtype}")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} out of range [0, {L})")
    _build.require_aligned(what, q, pool)
    M = block_tables.shape[1]
    out = torch.empty_like(q)
    fn = _build.launcher("paged_decode_attention", _argtypes)
    rc = fn(_build.ptr(q), _build.ptr(pool), _build.ptr(out),
            _build.ptr(block_tables), _build.ptr(context_lens),
            B, H, KH, N, bs, M, int(layer), D ** -0.5, float(soft_cap),
            _build.dtype_code(q), D, _build.stream_of(q))
    _build.check("paged_decode_attention", rc, what)
    LAUNCHES.n += 1
    return out
