"""Ring attention: causal attention of a prompt sharded along the sequence
over the ``seq`` ranks.

Ports ``_ring_attention_local`` and ``ring_causal_attention`` of
production_stack_tpu/parallel/ring_attention.py. Rank ``my`` of ``n``
holds the queries, keys and values of positions ``[my * Sl, (my + 1) *
Sl)``. At ring step ``i`` it holds the K/V shard of rank ``(my - i) %
n``, updates a flash-style running softmax ``(m, l, acc)`` of its queries
against it, and passes the shard on to rank ``(my + 1) % n``
(``RankGroup.ring_rotate``). The maths is the reference's: grouped
queries ``(B, KH, G, Sl, D)`` in float32, queries at their global
positions, Gemma-2's soft cap before the causal mask ``kv_pos <=
q_pos``, and the online softmax.

Three things differ from the reference, none in what comes out:

- The reference rotates once more after its last step and throws that
  shard away; here the last step sends nothing.
- A shard whose every key lies after every local query (``src > my``)
  is skipped: the reference's update there multiplies by ``exp(0)`` and
  adds ``exp(-1e30 - m)``, exactly 0 in float32, so its state is
  unchanged bit for bit. On the diagonal shard a query tile reads only
  the keys up to its last query, for the same reason.
- Queries go in tiles whose float32 scores fit ``ATTN_SCORE_BYTES``
  (``q_tile``), so one rank never holds a whole ``Sl x Sl`` block per
  head: at ``Sl`` = 4096 and 32 heads one such block is 2.15 GB.

The reference's ring body is XLA einsums, not a Pallas kernel, and the
local block here is plain PyTorch on either device. The rotation for the
next step is posted before the current step's blocks are computed, so the
transfer runs beside them.

``ring_causal_attention_plain`` runs the whole ring in one process, a
loop over the ``n`` shards: the tests hold it against the reference's
``ring_causal_attention`` and the ranks' ring against it.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

NEG_INF = -1e30
# the float32 score buffer of one query tile against one K/V shard
ATTN_SCORE_BYTES = 256 << 20


def ring_length(n: int, ranks: int) -> int:
    """The padded length of a ring prefill of ``n`` tokens over ``ranks``
    ranks, as the reference pads it: the next power of two (one size
    class each), at least two tokens a rank, then up to a multiple of
    the ranks."""
    S = max(2 * ranks, 1 << (n - 1).bit_length())
    return -(-S // ranks) * ranks


def q_tile(B: int, H: int, Sl: int) -> int:
    """Queries a tile: as many as keep a tile's float32 scores against a
    whole shard of ``Sl`` keys within ``ATTN_SCORE_BYTES``."""
    return max(1, min(Sl, ATTN_SCORE_BYTES // (B * H * Sl * 4)))


def _update(qt, kt, vt, q_pos, kv_pos, scale, soft_cap, m, l, acc) -> None:
    """One query tile against one K/V shard: the reference's step body.
    qt (B, KH, G, t, D), kt (B, KH, D, s), vt (B, KH, s, D), all float32;
    m, l (B, KH, G, t, 1) and acc (B, KH, G, t, D), updated in place."""
    B, KH, G, t, D = qt.shape
    s = torch.matmul(qt.reshape(B, KH, G * t, D), kt).mul_(scale)
    s = s.view(B, KH, G, t, -1)
    if soft_cap:  # Gemma-2 score capping, before masking
        s.div_(soft_cap).tanh_().mul_(soft_cap)
    s.masked_fill_(kv_pos[None, :] > q_pos[:, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = s.sub_(m_new).exp_()
    l.mul_(alpha).add_(p.sum(dim=-1, keepdim=True))
    pv = torch.matmul(p.view(B, KH, G * t, -1), vt).view(B, KH, G, t, D)
    acc.mul_(alpha).add_(pv)
    m.copy_(m_new)


def ring_attention_local(q: torch.Tensor, shards: Iterable, my: int, n: int,
                         soft_cap: float = 0.0,
                         tile: Optional[int] = None) -> torch.Tensor:
    """Rank ``my``'s output (B, Sl, H, D), in q's dtype, for its queries
    ``q`` (B, Sl, H, D) against the K/V shards ``shards`` yields in ring
    order: ``(src, k, v)`` with k, v (B, Sl, KH, D) the keys and values of
    rank ``src``'s positions, starting with its own."""
    B, Sl, H, D = q.shape
    dev = q.device
    scale = D ** -0.5
    t = tile or q_tile(B, H, Sl)
    q_pos = my * Sl + torch.arange(Sl, device=dev)
    qg = None
    m = l = acc = None
    for src, k, v in shards:
        KH = k.shape[2]
        G = H // KH
        if qg is None:
            qg = q.float().reshape(B, Sl, KH, G, D).permute(0, 2, 3, 1, 4)
            m = torch.full((B, KH, G, Sl, 1), NEG_INF, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((B, KH, G, Sl, 1), dtype=torch.float32,
                            device=dev)
            acc = torch.zeros((B, KH, G, Sl, D), dtype=torch.float32,
                              device=dev)
        if src > my:
            continue  # every key after every query: no update (docstring)
        kt = k.float().permute(0, 2, 3, 1)  # (B, KH, D, Sl)
        vt = v.float().transpose(1, 2)  # (B, KH, Sl, D)
        kv_pos = src * Sl + torch.arange(Sl, device=dev)
        for t0 in range(0, Sl, t):
            t1 = min(t0 + t, Sl)
            # the diagonal shard: keys past the tile's last query are
            # masked for all of it
            s1 = t1 if src == my else Sl
            _update(qg[:, :, :, t0:t1], kt[..., :s1], vt[:, :, :s1],
                    q_pos[t0:t1], kv_pos[:s1], scale, soft_cap,
                    m[:, :, :, t0:t1], l[:, :, :, t0:t1],
                    acc[:, :, :, t0:t1])
    out = acc / torch.clamp(l, min=1e-30)  # (B, KH, G, Sl, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sl, H, D).to(q.dtype)


def rotating(k: torch.Tensor, v: torch.Tensor, group) -> Iterable:
    """The K/V shards rank ``group.rank`` holds at each ring step, its own
    first: each step's rotation to rank ``(r + 1) % n`` is posted before
    the step is yielded and waited for after it; the last step sends
    nothing. K and V travel as one tensor."""
    n, my = group.size, group.rank
    kv = torch.stack((k, v))
    for i in range(n):
        wait = group.ring_rotate(kv) if i < n - 1 else None
        yield (my - i) % n, kv[0], kv[1]
        if wait is not None:
            kv = wait()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   soft_cap: float = 0.0) -> torch.Tensor:
    """Causal attention of this seq rank's slice of the prompt: q (B, Sl,
    H, D), k, v (B, Sl, KH, D) at positions ``[r * Sl, (r + 1) * Sl)``;
    the other ranks' K/V arrive over ``group`` (parallel/distributed.py
    ``RankGroup``). Returns (B, Sl, H, D) in q's dtype."""
    return ring_attention_local(q, rotating(k, v, group), group.rank,
                                group.size, soft_cap)


def ring_causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, n: int,
                                soft_cap: float = 0.0,
                                tile: Optional[int] = None) -> torch.Tensor:
    """The whole ring in one process: q (B, S, H, D), k, v (B, S, KH, D)
    cut into ``n`` shards along S (S a multiple of n), each rank's output
    computed against the shards in its ring order and joined. Returns (B,
    S, H, D) in q's dtype."""
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"ring's {n} shards")
    Sl = S // n

    def cut(x, r):
        return x[:, r * Sl:(r + 1) * Sl]

    outs = []
    for my in range(n):
        shards = (((my - i) % n, cut(k, (my - i) % n), cut(v, (my - i) % n))
                  for i in range(n))
        outs.append(ring_attention_local(cut(q, my), shards, my, n,
                                         soft_cap, tile))
    return torch.cat(outs, dim=1)
