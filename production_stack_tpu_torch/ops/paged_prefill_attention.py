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

The kernel sees a chunk's queries for one KV head as ``S * G`` rows, row r
= (token r // G, head kh * G + r % G), and a CTA owns ``rows`` consecutive
rows of them. bf16 runs on the tensor cores and stages ``positions``
context positions a step; float32 keeps the CUDA-core walk, which stages
32. ``launch_geometry`` is that arithmetic in Python.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.paged_attention import split_kv

LAUNCHES = _build.LaunchCounter("K4 paged_prefill_attention")
SMEM_LIMIT = 232448  # shared memory a CTA may have on Hopper (227 KB)
PAD = 8  # bf16 after each staged row (mma::kPad, csrc/mma_attention.cuh)
WALK_POSITIONS = 32  # the float32 walk's step (kTileK)
# bf16 (rows, positions) tiles built for each head dim (with_tile in
# csrc/paged_prefill_attention.cu): the sweep's grid at D = 128, 64 rows
# at 32 and 64 positions at every head dim
TILES = {d: ((64, 32), (64, 64)) for d in _build.HEAD_DIMS}
TILES[128] = ((64, 32), (64, 64), (64, 128), (128, 32), (128, 64),
              (128, 128))
# bf16 default, from chip_smoke.py's tile sweep at D = 128 (PERF.md): 128
# rows (8 warps) at 128 positions ran fastest on both batches; of the
# 64-row tiles, 32 positions beat 64, so the head dims built only with 64
# rows take 32 (at D = 256 the float32 accumulator alone holds 128
# registers a lane, which a 32-position score tile leaves room beside)
DEFAULT_TILE = {d: (64, 32) for d in _build.HEAD_DIMS}
DEFAULT_TILE[128] = (128, 128)
# float32: R = 4 G rows, the CUDA-core walk's measured best (its q_tile
# sweep on the card, PERF.md), which keeps its shared memory in bounds at
# every preset
WALK_TOKENS = 4
_PLAIN_CHUNK = 256  # query rows per score block in the plain version

_argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def launch_geometry(P: int, S: int, H: int, KH: int, D: int,
                    dtype: torch.dtype,
                    tile: Optional[tuple[int, int]] = None) -> dict:
    """The launch K4 makes for ``q (P, S, H, D)`` with KH KV heads: the
    tile (rows a CTA, positions a stage), threads a CTA, grid (x, KH, P),
    dynamic shared memory in bytes, and each CTA's (first row, row count)
    along x over the chunk's S * G rows. Raises for a tile that is not
    built or does not fit."""
    G = H // KH
    if dtype == torch.bfloat16:
        rows, positions = tile or DEFAULT_TILE[D]
        if (rows, positions) not in TILES.get(D, ()):
            raise ValueError(
                f"paged_prefill_attention: tile {(rows, positions)} is not "
                f"built for head_dim {D} (built: {TILES.get(D, ())})")
        threads = rows * 2  # one warp per 16 rows
        smem = (rows + 4 * positions) * (D + PAD) * 2
    else:
        rows, positions = tile or (WALK_TOKENS * G, WALK_POSITIONS)
        if rows <= 0 or positions != WALK_POSITIONS:
            raise ValueError(
                f"paged_prefill_attention: the float32 walk takes a positive "
                f"row count and {WALK_POSITIONS} positions, got "
                f"{(rows, positions)}")
        threads = 128
        # smem_bytes in csrc/paged_attention_common.cuh: q and acc, K
        # (padded) and V steps, scores, and m, l, alpha, qpos per row
        smem = (rows * D * 2 + positions * (D + 1) + positions * D
                + rows * (positions + 1) + rows * 3) * 4 + rows * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"paged_prefill_attention: tile {(rows, positions)} needs {smem} "
            f"bytes of shared memory at D={D}, above {SMEM_LIMIT}")
    n = S * G
    blocks = -(-n // rows)
    return {"rows": rows, "positions": positions, "threads": threads,
            "grid": (blocks, KH, P), "smem_bytes": smem,
            "row_spans": [(b * rows, min(rows, n - b * rows))
                          for b in range(blocks)]}


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
    soft_cap: float = 0.0, tile: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Prefill attention of ``q (P, S, H, D)`` against layer ``layer`` of
    ``pool (L, N, bs, 2KH, D)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel, with ``tile`` = (rows a CTA, positions a
    stage), by default ``DEFAULT_TILE`` (bf16) or 4 G rows (float32)."""
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
    code = _build.dtype_code(q)
    geo = launch_geometry(P, S, H, KH, D, q.dtype, tile)
    _build.require_aligned(what, q, pool)
    M = block_tables.shape[1]
    out = torch.empty_like(q)
    fn = _build.launcher("paged_prefill_attention", _argtypes)
    rc = fn(_build.ptr(q), _build.ptr(pool), _build.ptr(out),
            _build.ptr(block_tables), _build.ptr(q_starts),
            _build.ptr(ctx_totals), P, S, H, KH, N, bs, M, int(layer),
            geo["rows"], geo["positions"], D ** -0.5, float(soft_cap), code,
            D, _build.stream_of(q))
    _build.check("paged_prefill_attention", rc, what)
    LAUNCHES.n += 1
    return out
