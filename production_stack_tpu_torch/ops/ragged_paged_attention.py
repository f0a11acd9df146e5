"""K2: ragged paged attention over the packed mixed prefill + decode stream.

Counterpart of ``ragged_paged_attention_pallas`` (``_ragged_kernel`` and
``tile_metadata``, production_stack_tpu/ops/ragged_paged_attention_pallas.py).
The CUDA kernel is ``csrc/ragged_paged_attention.cu``;
``ragged_paged_attention_plain`` is its plain PyTorch version.

The stream ``q (T, H, D)`` concatenates every slot's span: span s is
``[cu_q_lens[s], cu_q_lens[s+1])``, its slot's context holds
``context_lens[s]`` tokens (the span included) in pages
``block_tables[s]``, and token j of a span of ``q_len`` tokens sits at
position ``ctx - q_len + j``. Rows that belong to no span output exactly 0.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.paged_attention import split_kv

LAUNCHES = _build.LaunchCounter("K2 ragged_paged_attention")
# stream tokens per CTA (rows per CTA = Q_TILE * H / KH). A tile of decode
# rows walks its Q_TILE contexts one after another, so short tiles win on
# a mixed stream: chip_smoke.py's q_tile sweep, PERF.md
Q_TILE = 4
_PLAIN_CHUNK = 256  # query rows per score block in the plain version

_argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def tile_metadata(cu_q_lens: torch.Tensor, num_tiles: int,
                  q_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (first overlapping span, overlap count) from the span
    offsets, with one searchsorted each. Tiles past the packed total get
    count 0; empty spans inside an overlap range are counted and walk no
    context."""
    cu = cu_q_lens.to(torch.int32).contiguous()
    S = cu.shape[0] - 1
    total = cu[S]
    starts = torch.arange(num_tiles, dtype=torch.int32,
                          device=cu.device) * q_tile
    g_last = torch.minimum(starts + q_tile, total) - 1
    first = torch.clamp(
        torch.searchsorted(cu, starts, right=True, out_int32=True) - 1,
        0, S - 1)
    last = torch.clamp(
        torch.searchsorted(cu, g_last, right=True, out_int32=True) - 1,
        0, S - 1)
    cnt = torch.where(g_last >= starts, last - first + 1,
                      torch.zeros_like(first))
    return first.to(torch.int32), cnt.to(torch.int32)


def stream_tiles(cu_q_lens: torch.Tensor, T: int,
                 q_tile: int = Q_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """``tile_metadata`` for a stream of ``T`` tokens cut into ``q_tile``
    token tiles. The spans do not change within a step, so a step computes
    this once and passes it to every layer's call."""
    return tile_metadata(cu_q_lens, -(-T // q_tile), q_tile)


def ragged_paged_attention_plain(
    q: torch.Tensor, pool: torch.Tensor, block_tables: torch.Tensor,
    cu_q_lens: torch.Tensor, context_lens: torch.Tensor, layer: int,
    soft_cap: float = 0.0,
) -> torch.Tensor:
    """Span by span: each slot's context is gathered once (only its live
    blocks, cut at the context length, so unwritten blocks are never read)
    and its span attends it causally in float32. Rows of no span stay 0."""
    T, H, D = q.shape
    _, _, bs, KH2, _ = pool.shape
    KH = KH2 // 2
    G = H // KH
    scale = D ** -0.5
    out = torch.zeros_like(q)
    kv_layer = pool[layer]
    cu = cu_q_lens.tolist()
    ctxs = context_lens.tolist()
    for s, ctx in enumerate(ctxs):
        q0, q1 = cu[s], cu[s + 1]
        n = q1 - q0
        if n <= 0 or ctx <= 0:
            continue
        nb = -(-ctx // bs)
        blocks = block_tables[s, :nb].long()
        k, v = split_kv(kv_layer[blocks].reshape(nb * bs, KH2, D)[:ctx])
        k, v = k.float(), v.float()
        kv_pos = torch.arange(ctx, device=q.device)
        for c0 in range(0, n, _PLAIN_CHUNK):
            c1 = min(c0 + _PLAIN_CHUNK, n)
            qs = q[q0 + c0 : q0 + c1].reshape(c1 - c0, KH, G, D).float()
            scores = torch.einsum("tkgd,ckd->tkgc", qs, k) * scale
            if soft_cap:
                scores = soft_cap * torch.tanh(scores / soft_cap)
            qpos = ctx - n + torch.arange(c0, c1, device=q.device)
            mask = kv_pos[None, :] <= qpos[:, None]  # (t, c)
            scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
            probs = torch.softmax(scores, dim=-1)  # >= 1 visible position
            o = torch.einsum("tkgc,ckd->tkgd", probs, v)
            out[q0 + c0 : q0 + c1] = o.reshape(c1 - c0, H, D).to(q.dtype)
    return out


def ragged_paged_attention(
    q: torch.Tensor, pool: torch.Tensor, block_tables: torch.Tensor,
    cu_q_lens: torch.Tensor, context_lens: torch.Tensor, layer: int,
    soft_cap: float = 0.0, q_tile: int = Q_TILE,
    tiles: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Attention of the packed stream ``q (T, H, D)`` against layer
    ``layer`` of ``pool (L, N, bs, 2KH, D)``. CPU tensors take the plain
    version; CUDA tensors launch the kernel. ``tiles`` is the step's
    ``stream_tiles(cu_q_lens, T, q_tile)``, computed here when not given."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, pool, block_tables, cu_q_lens, context_lens, layer, soft_cap)
    what = "ragged_paged_attention"
    _build.require_head_dim(what, q.shape[-1])
    _build.require_cuda(what, q, pool, block_tables, cu_q_lens, context_lens)
    _build.require_int32(what, block_tables, cu_q_lens, context_lens)
    T, H, D = q.shape
    L, N, bs, KH2, D2 = pool.shape
    KH = KH2 // 2
    S, M = block_tables.shape
    if D2 != D or H % KH:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool.shape)}")
    if cu_q_lens.shape != (S + 1,) or context_lens.shape != (S,):
        raise ValueError(f"{what}: cu_q_lens / context_lens do not match "
                         f"{S} block-table rows")
    if q.dtype != pool.dtype:
        raise TypeError(f"{what}: q {q.dtype} != pool {pool.dtype}")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} out of range [0, {L})")
    _build.require_aligned(what, q, pool)
    num_tiles = -(-T // q_tile)
    first, count = (tiles if tiles is not None
                    else stream_tiles(cu_q_lens, T, q_tile))
    _build.require_cuda(what, q, first, count)
    _build.require_int32(what, first, count)
    if first.shape != (num_tiles,) or count.shape != (num_tiles,):
        raise ValueError(f"{what}: the tile map does not cut {T} tokens "
                         f"into tiles of {q_tile}")
    out = torch.empty_like(q)
    fn = _build.launcher("ragged_paged_attention", _argtypes)
    rc = fn(_build.ptr(q), _build.ptr(pool), _build.ptr(out),
            _build.ptr(block_tables), _build.ptr(cu_q_lens),
            _build.ptr(context_lens), _build.ptr(first), _build.ptr(count),
            T, H, KH, N, bs, M, int(layer), q_tile, num_tiles,
            D ** -0.5, float(soft_cap), _build.dtype_code(q), D,
            _build.stream_of(q))
    _build.check("ragged_paged_attention", rc, what)
    LAUNCHES.n += 1
    return out
