"""K3: paged decode attention, one query token per sequence.

Counterpart of ``paged_decode_attention_pallas`` (``_decode_kernel``,
production_stack_tpu/ops/paged_attention_pallas.py). The CUDA kernel is
``csrc/paged_decode_attention.cu``; ``paged_decode_attention_plain`` is its
plain PyTorch version.

``q (B, H, D)`` row b attends the first ``context_lens[b]`` tokens of its
paged context; a slot with context 0 outputs 0.

bf16 runs the split-KV walk of ``csrc/split_decode.cuh``: a CTA owns one
(sequence, KV head, split), a split covers ``span`` consecutive positions
of the context, and with more than one split a second launch merges the
splits' float32 partials (scratch allocated here). ``split_plan`` fixes
(n_splits, span) from host context lengths; the model runner calls it once
a step, at the rung of ``plan_ladder`` that holds the step's longest
context and for every slot of the batch, so a step's plan depends on its
rung alone; each CTA reads its own length from ``context_lens`` on the
device. float32 keeps the CUDA-core walk and takes no plan.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.paged_attention import split_kv

LAUNCHES = _build.LaunchCounter("K3 paged_decode_attention")
# the split-KV walk (decode::Tile, csrc/split_decode.cuh): one m16 tile of
# the G query heads of a KV head, 16 positions a warp, four warps (two at
# D = 256), three stages
MAX_GROUP = 16
STAGES = 3
# a split's span is a whole number of every head dim's stage (64 or 32
# positions)
SPAN_GRANULE = 64
MIN_SPAN = 256  # shortest split: below it the merge's share grows
# a wave of the walk: two CTAs fit an SM at D = 128 (106 KB of shared
# memory each), and an H100 has 132 SMs
TARGET_CTAS = 2 * 132
# longest split once the unsplit CTAs already fill a wave: contexts of
# different lengths then finish together (chip_smoke.py's split-span
# sweeps, PERF.md)
BALANCE_SPAN = 512
# the plan ladder's lowest rung (plan_ladder)
LADDER_BASE = 256

_argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def decode_geometry(D: int) -> dict:
    """The bf16 walk's CTA at head dim D: threads, positions a stage,
    stages, and dynamic shared memory in bytes (16 query rows and the K and
    V stages, rows padded by 16 bytes)."""
    warps = 4 if D <= 128 else 2
    positions = 16 * warps
    stride = D + 8
    return {"threads": 32 * warps, "positions": positions, "stages": STAGES,
            "smem_bytes": (16 * stride + 2 * STAGES * positions * stride) * 2}


def split_plan(max_ctx: int, n_items: int, num_kv_heads: int,
               span: Optional[int] = None) -> tuple[int, int]:
    """(n_splits, span) for ``n_items`` query tokens whose contexts reach at
    most ``max_ctx`` positions: split i covers positions [i * span, (i + 1)
    * span), so every context up to n_splits * span is covered once. By
    default, when the unsplit (item, KV head) CTAs fill less than a wave
    (TARGET_CTAS), the longest context is cut into as many splits as keep
    the CTAs within one wave; when they fill a wave or more, no split is
    longer than BALANCE_SPAN. The span is at least MIN_SPAN, a multiple of
    SPAN_GRANULE. Pure host arithmetic: a caller fixes it once a step, from
    host context lengths."""
    if span is None:
        rows = max(n_items * num_kv_heads, 1)
        top = -(-max(max_ctx, 1) // SPAN_GRANULE) * SPAN_GRANULE
        if rows < TARGET_CTAS:  # split up to one wave
            per = -(-max(max_ctx, 1) // (TARGET_CTAS // rows))
            span = -(-per // SPAN_GRANULE) * SPAN_GRANULE
        else:  # a wave already: even out long and short contexts
            span = min(top, BALANCE_SPAN)
        span = max(MIN_SPAN, span)
    if span <= 0 or span % SPAN_GRANULE:
        raise ValueError(f"paged_decode_attention: split span {span} is not "
                         f"a positive multiple of {SPAN_GRANULE}")
    return max(1, -(-max_ctx // span)), span


def plan_ladder(top: int) -> list[int]:
    """The rungs of the decode step's plan ladder for contexts up to
    ``top`` positions: powers of two from LADDER_BASE below ``top``, then
    ``top`` rounded up to SPAN_GRANULE. A decode step runs at the smallest
    rung that holds its longest context, with one split plan a rung
    (``split_plan(rung, ...)``), so a CUDA graph that bakes the plan into
    K3's grid is captured once a rung and not once a plan."""
    rungs = []
    r = LADDER_BASE
    while r < top:
        rungs.append(r)
        r *= 2
    return rungs + [max(-(-top // SPAN_GRANULE) * SPAN_GRANULE, LADDER_BASE)]


def ladder_rung(rungs: list[int], need: int) -> int:
    """The smallest rung of ``rungs`` holding ``need`` positions."""
    for r in rungs:
        if r >= need:
            return r
    raise ValueError(f"paged_decode_attention: a context of {need} "
                     f"positions is past the plan ladder's top {rungs[-1]}")


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
    plan: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Decode attention of ``q (B, H, D)`` against layer ``layer`` of
    ``pool (L, N, bs, 2KH, D)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel. ``plan`` is bf16's ``split_plan`` (n_splits,
    span); when not given it is made here from a host copy of
    ``context_lens``, a synchronisation that the model runner avoids by
    passing the plan it fixed for the step."""
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
    code = _build.dtype_code(q)
    M = block_tables.shape[1]
    n_splits, span, part = 1, 0, None
    if q.dtype == torch.bfloat16:
        if H // KH > MAX_GROUP:
            raise ValueError(f"{what}: {H // KH} query heads a KV head; the "
                             f"split walk takes at most {MAX_GROUP}")
        if plan is None:
            lens = context_lens.cpu()
            plan = split_plan(int(lens.max()) if B else 0,
                              int((lens > 0).sum()), KH)
        n_splits, span = plan
        if n_splits <= 0 or span <= 0 or span % SPAN_GRANULE:
            raise ValueError(f"{what}: bad split plan {plan}")
        if n_splits > 1:  # m and l, then acc, of each (row, head, split)
            part = torch.empty(B * H * n_splits * (D + 2),
                               dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = _build.launcher("paged_decode_attention", _argtypes)
    rc = fn(_build.ptr(q), _build.ptr(pool), _build.ptr(out),
            None if part is None else _build.ptr(part),
            _build.ptr(block_tables), _build.ptr(context_lens),
            B, H, KH, N, bs, M, int(layer), n_splits, span, D ** -0.5,
            float(soft_cap), code, D, _build.stream_of(q))
    _build.check("paged_decode_attention", rc, what)
    LAUNCHES.n += 1
    return out
