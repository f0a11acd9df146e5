"""K4: paged prefill attention over P chunks padded to one bucket length.

Counterpart of ``paged_prefill_attention_pallas`` (``_prefill_kernel``,
production_stack_tpu/ops/paged_attention_pallas.py). The CUDA kernel is
``csrc/paged_prefill_attention.cu``; ``paged_prefill_attention_plain`` is
its plain PyTorch version.

``q (P, S, H, D)`` holds P chunks padded to the bucket S. Row s of chunk p
sits at position ``q_starts[p] + s`` and sees the context positions below
``min(q_starts[p] + s + 1, ctx_totals[p])``. Padding rows past the chunk
(``s >= ctx - q_start``) so attend the whole context and are finite, as in
the Pallas kernel (the XLA reference ``paged_attention`` leaves garbage
there instead). An inactive chunk (``ctx_totals[p] == 0``; the engine
passes ``q_starts[p] == -1``) outputs exact zeros.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.paged_attention import split_kv

LAUNCHES = _build.LaunchCounter("K4 paged_prefill_attention")
# tokens of one chunk per CTA (rows per CTA = Q_TILE * H / KH). The TPU
# kernel's 128-token tile does not fit a CTA's shared memory here, and
# short tiles win: more CTAs fit an SM, and the walk is bound by latency.
# chip_smoke.py's q_tile sweep, PERF.md
Q_TILE = 4
_PLAIN_CHUNK = 256  # query rows per score block in the plain version

_argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def paged_prefill_attention_plain(
    q: torch.Tensor, pool: torch.Tensor, block_tables: torch.Tensor,
    q_starts: torch.Tensor, ctx_totals: torch.Tensor, layer: int,
    soft_cap: float = 0.0,
) -> torch.Tensor:
    """Chunk by chunk: each active chunk's context is gathered once (only
    its live blocks, cut at the context length, so unwritten blocks are
    never read) and its rows attend it causally in float32, a block of
    rows at a time. Masked probabilities are exactly 0; inactive chunks
    stay 0."""
    P, S, H, D = q.shape
    _, _, bs, KH2, _ = pool.shape
    KH = KH2 // 2
    G = H // KH
    scale = D ** -0.5
    out = torch.zeros_like(q)
    kv_layer = pool[layer]
    starts = q_starts.tolist()
    for p, ctx in enumerate(ctx_totals.tolist()):
        if ctx <= 0:
            continue
        nb = -(-ctx // bs)
        blocks = block_tables[p, :nb].long()
        k, v = split_kv(kv_layer[blocks].reshape(nb * bs, KH2, D)[:ctx])
        k, v = k.float(), v.float()
        kv_pos = torch.arange(ctx, device=q.device)
        for c0 in range(0, S, _PLAIN_CHUNK):
            c1 = min(c0 + _PLAIN_CHUNK, S)
            qs = q[p, c0:c1].reshape(c1 - c0, KH, G, D).float()
            scores = torch.einsum("tkgd,ckd->tkgc", qs, k) * scale
            if soft_cap:
                scores = soft_cap * torch.tanh(scores / soft_cap)
            qpos = starts[p] + torch.arange(c0, c1, device=q.device)
            mask = kv_pos[None, :] <= qpos[:, None]  # (t, c); position 0 seen
            scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("tkgc,ckd->tkgd", probs, v)
            out[p, c0:c1] = o.reshape(c1 - c0, H, D).to(q.dtype)
    return out


def paged_prefill_attention(
    q: torch.Tensor, pool: torch.Tensor, block_tables: torch.Tensor,
    q_starts: torch.Tensor, ctx_totals: torch.Tensor, layer: int,
    soft_cap: float = 0.0, q_tile: int = Q_TILE,
) -> torch.Tensor:
    """Prefill attention of ``q (P, S, H, D)`` against layer ``layer`` of
    ``pool (L, N, bs, 2KH, D)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, pool, block_tables, q_starts, ctx_totals, layer, soft_cap)
    what = "paged_prefill_attention"
    _build.require_head_dim(what, q.shape[-1])
    _build.require_cuda(what, q, pool, block_tables, q_starts, ctx_totals)
    _build.require_int32(what, block_tables, q_starts, ctx_totals)
    P, S, H, D = q.shape
    L, N, bs, KH2, D2 = pool.shape
    KH = KH2 // 2
    if D2 != D or H % KH:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool.shape)}")
    if (block_tables.shape[0] != P or q_starts.shape != (P,)
            or ctx_totals.shape != (P,)):
        raise ValueError(f"{what}: block_tables / q_starts / ctx_totals do "
                         f"not match {P} chunks")
    if q.dtype != pool.dtype:
        raise TypeError(f"{what}: q {q.dtype} != pool {pool.dtype}")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} out of range [0, {L})")
    if q_tile <= 0:
        raise ValueError(f"{what}: q_tile must be positive, got {q_tile}")
    _build.require_aligned(what, q, pool)
    M = block_tables.shape[1]
    out = torch.empty_like(q)
    fn = _build.launcher("paged_prefill_attention", _argtypes)
    rc = fn(_build.ptr(q), _build.ptr(pool), _build.ptr(out),
            _build.ptr(block_tables), _build.ptr(q_starts),
            _build.ptr(ctx_totals), P, S, H, KH, N, bs, M, int(layer),
            q_tile, D ** -0.5, float(soft_cap), _build.dtype_code(q), D,
            _build.stream_of(q))
    _build.check("paged_prefill_attention", rc, what)
    LAUNCHES.n += 1
    return out
