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

The kernel works from a work map, ``ragged_work_map``, built once a step
from host copies of the span offsets and context lengths. bf16: spans of
two or more tokens are cut into row tiles of (rows, positions) (the tiles
of K4, ``paged_prefill_attention.TILES``) that run K4's tensor-core walk;
one-token spans are decode items that run K3's split-KV walk with a
``split_plan``; the tail past the last span is cut into tiles that write
zeros. float32 keeps the CUDA-core walk over tiles of ``Q_TILE`` stream
tokens, mapped by ``tile_metadata``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops import paged_prefill_attention as k4
from production_stack_tpu_torch.ops.paged_attention import split_kv
from production_stack_tpu_torch.ops.paged_decode_attention import (
    MAX_GROUP,
    split_plan,
)

LAUNCHES = _build.LaunchCounter("K2 ragged_paged_attention")
# float32: stream tokens per CTA of the CUDA-core walk (rows per CTA =
# Q_TILE * H / KH). A tile of decode rows walks its Q_TILE contexts one
# after another, so short tiles won on a mixed stream (the walk's q_tile
# sweep, PERF.md)
Q_TILE = 4
_PLAIN_CHUNK = 256  # query rows per score block in the plain version

_argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


class RaggedWorkMap(NamedTuple):
    """A step's work map for one stream shape (``T`` tokens, ``G`` query
    heads a KV head, ``dtype``). ``work`` (int32, on the kernel's device)
    holds bf16's ``n_tiles`` (span, first row) pairs, span -1 for a tile of
    the tail, then its ``n_decode`` one-token spans' slots, walked with
    ``plan`` = (n_splits, span); float32's ``n_tiles`` (first span, span
    count) pairs of ``tile_metadata``. ``tile`` is bf16's (rows,
    positions), float32's (Q_TILE tokens, 32 positions)."""
    T: int
    G: int
    dtype: torch.dtype
    tile: tuple[int, int]
    n_tiles: int
    n_decode: int
    plan: tuple[int, int]
    work: torch.Tensor


def ragged_work_map(cu_q_lens, context_lens, T: int, num_heads: int,
                    num_kv_heads: int, head_dim: int, dtype: torch.dtype,
                    device="cuda", tile: Optional[tuple[int, int]] = None,
                    split_span: Optional[int] = None) -> RaggedWorkMap:
    """The work map of a stream of ``T`` tokens from HOST span offsets
    ``cu_q_lens (S+1,)`` and context lengths ``(S,)`` (numpy or lists),
    uploaded to ``device`` in one copy. bf16 takes ``tile`` (rows,
    positions; default ``k4.DEFAULT_TILE``) and ``split_span`` (default
    ``split_plan``'s). The grid's size depends on the span lengths, so
    the map is made on the host, where the runner has them."""
    cu = np.asarray(cu_q_lens, np.int64).reshape(-1)
    ctx = np.asarray(context_lens, np.int64).reshape(-1)
    if cu.shape != (ctx.shape[0] + 1,) or cu[-1] > T:
        raise ValueError(f"ragged_work_map: {cu.shape[0]} span offsets "
                         f"reaching {cu[-1]} do not fit {ctx.shape[0]} "
                         f"slots and {T} tokens")
    G = num_heads // num_kv_heads
    if dtype != torch.bfloat16:
        n = -(-T // Q_TILE)
        first, count = tile_metadata(torch.from_numpy(cu.astype(np.int32)),
                                     n, Q_TILE)
        work = torch.stack([first, count], 1).reshape(-1)
        return RaggedWorkMap(T, G, dtype, (Q_TILE, k4.WALK_POSITIONS), n, 0,
                             (1, 0), work.to(device))
    rows, positions = tile or k4.DEFAULT_TILE[head_dim]
    if (rows, positions) not in k4.TILES.get(head_dim, ()):
        raise ValueError(f"ragged_work_map: tile {(rows, positions)} is not "
                         f"built for head_dim {head_dim} (built: "
                         f"{k4.TILES.get(head_dim, ())})")
    q_lens = np.diff(cu)
    spans = np.flatnonzero(q_lens >= 2)
    per = -(-q_lens[spans] * G // rows)  # tiles a span
    first = np.cumsum(per) - per
    tile_rows = (np.arange(per.sum()) - np.repeat(first, per)) * rows
    n_tail = -(-(T - cu[-1]) * G // rows)
    tiles = np.stack([
        np.concatenate([np.repeat(spans, per), np.full(n_tail, -1)]),
        np.concatenate([tile_rows, np.arange(n_tail) * rows])], 1)
    decode = np.flatnonzero(q_lens == 1)
    plan = split_plan(int(ctx[decode].max()) if decode.size else 0,
                      decode.size, num_kv_heads, split_span)
    work = np.concatenate([tiles.reshape(-1), decode]).astype(np.int32)
    return RaggedWorkMap(T, G, dtype, (rows, positions), len(tiles),
                         decode.size, plan, torch.from_numpy(work).to(device))


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
    soft_cap: float = 0.0, tiles: Optional[RaggedWorkMap] = None,
) -> torch.Tensor:
    """Attention of the packed stream ``q (T, H, D)`` against layer
    ``layer`` of ``pool (L, N, bs, 2KH, D)``. CPU tensors take the plain
    version; CUDA tensors launch the kernel. ``tiles`` is the step's
    ``ragged_work_map``; when not given it is made here from host copies of
    ``cu_q_lens`` and ``context_lens``, a synchronisation that the model
    runner avoids by passing the map it made for the step."""
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
    if q.dtype == torch.bfloat16 and H // KH > MAX_GROUP:
        raise ValueError(f"{what}: {H // KH} query heads a KV head; the "
                         f"split walk takes at most {MAX_GROUP}")
    _build.require_aligned(what, q, pool)
    code = _build.dtype_code(q)
    if tiles is None:
        tiles = ragged_work_map(cu_q_lens.cpu().numpy(),
                                context_lens.cpu().numpy(), T, H, KH, D,
                                q.dtype, q.device)
    if (tiles.T, tiles.G, tiles.dtype) != (T, H // KH, q.dtype):
        raise ValueError(f"{what}: the work map was made for {tiles.T} "
                         f"tokens, G {tiles.G}, {tiles.dtype}; the stream "
                         f"has {T}, G {H // KH}, {q.dtype}")
    _build.require_cuda(what, q, tiles.work)
    _build.require_int32(what, tiles.work)
    n_splits, span = tiles.plan
    part = None
    if tiles.n_decode and n_splits > 1:  # m and l, then acc, of each split
        part = torch.empty(tiles.n_decode * H * n_splits * (D + 2),
                           dtype=torch.float32, device=q.device)
    rows, positions = tiles.tile
    out = torch.empty_like(q)
    fn = _build.launcher("ragged_paged_attention", _argtypes)
    rc = fn(_build.ptr(q), _build.ptr(pool), _build.ptr(out),
            None if part is None else _build.ptr(part),
            _build.ptr(block_tables), _build.ptr(cu_q_lens),
            _build.ptr(context_lens), _build.ptr(tiles.work), T, S, H, KH,
            N, bs, M, int(layer), tiles.n_tiles, tiles.n_decode, n_splits,
            span, rows, positions, D ** -0.5, float(soft_cap), code, D,
            _build.stream_of(q))
    _build.check("ragged_paged_attention", rc, what)
    LAUNCHES.n += 1
    return out
