"""Llama-family decoder, Mixtral's MoE block included, as plain functions
on tensors.

Parameters are a dict with the reference's names and shapes
(``param_specs`` in production_stack_tpu/models/llama.py): the decoder
layers are stacked along a leading L axis, so a JAX parameter tree converts
one to one (``engine/weights.params_from_jax``). The reference's
``lax.scan`` over the stack becomes a Python loop over the layer index.

Attention is injected as a callback ``attend(q, k, v, kv_pool, layer_idx)
-> (out, kv_pool)``, so the same stack serves the ragged step, the decode
step and the tests' dense forward.

The dense knobs ride along: ``qkv_bias`` (Qwen2), ``qk_norm`` (Qwen3),
``post_norms``, ``query_scale``, ``embed_scale``, both softcaps and GeGLU
(Gemma). Multi-LoRA adds a per-token low-rank delta on the seven
projections (``_lora_delta``). Every projection and the LM head go
through ``engine/quant.quant_matmul``, so an int8 parameter dict
(``quantize_params``) runs the reference's W8A8 / W8A16 arithmetic, and
``architecture == "mixtral"`` replaces the MLP with the capacity-based
top-k MoE block (``_moe_mlp``).

**Token counts.** The reference runs each step as one compiled program
of a fixed shape, and two of its choices depend on that shape: whether a
quantized product runs W8A8 or W8A16 (its token count against
``quant._a16_threshold()``), and the MoE capacity ``C = max(int(2 T k /
X), k)``. Its ragged stream is always ``max_num_batched_tokens`` wide,
while this engine runs only the live tokens rounded up to 64. So the
forward takes ``ref_tokens``, the rows the reference's same call sees
(ragged: the budget-wide T; bucketed prefill: P * S; decode: S), and
every product and the capacity follow it. The MoE buffer needs only
``min(C, T)`` rows an expert (an expert gets at most one slot a token),
and the reference's extra pad rows come after the live rows in dispatch
order, so they never displace one: the result is the reference's, without
its padding.

**Tensor parallelism.** With a ``group`` (parallel/distributed.RankGroup,
whose ``shard`` says what this rank holds), the parameters are this
rank's shard (``param_specs`` names each leaf's logical axes,
parallel/shardings.py cuts them): attention runs at the rank's own query
and KV heads, the MLP at its share of the intermediate axis, and the
embedding and LM head at its share of the vocabulary. The two
row-parallel products (``wo`` over heads, ``w_down`` over the
intermediate axis) are summed over the ranks right after the product
(``_row_parallel``), before any post-norm and the residual add: a plain
or W8A16 partial is accumulated and summed in float32 and rounded once
to the model dtype, so that a bf16 model rounds the sum where one device
rounds its product; the W8A8 route takes each row's activation scale as
the max over the ranks and sums the int32 products exactly
(engine/quant.py). A LoRA delta on ``wo`` or ``w_down`` is this rank's
share of it, ``(x_r @ A_r) @ B``, and rides the product's float32
all-reduce. Mixtral's expert stacks are cut along F (``_moe_mlp``). The
embedding is vocab-parallel (each rank looks up the tokens its rows
hold, zeros elsewhere, all-reduce); the logits' vocab shards are
all-gathered in rank order. An axis the rules replicate needs no
collective. Every rank then holds the same hidden states and the same
full logits.

**Expert parallelism.** With an ``expert`` group whose shard cuts the
experts (``Shard.experts``), this rank holds the stacks of experts
``[lo, hi)`` of X and runs only their slots; activations stay whole on
every rank, as under the reference's GSPMD, so no all-to-all moves them,
and the MoE block's float32 combine partials are summed over the expert
ranks (``_moe_mlp``). Everything outside the MoE block is the tensor
axis's, or whole.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from production_stack_tpu_torch.engine import quant
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.ops.norms import rms_norm
from production_stack_tpu_torch.ops.rope import rope_tables, rotate
from production_stack_tpu_torch.parallel import shardings as ln

AttendFn = Callable[..., Tuple[torch.Tensor, Any]]


def param_shapes(cfg: ModelConfig) -> dict:
    """Shapes of the parameter dict, mirroring the reference's
    param_specs."""
    E, H, KH, D, F_, L, V = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.intermediate_size,
                             cfg.num_layers, cfg.vocab_size)
    layer = {
        "attn_norm": (L, E),
        "wq": (L, E, H, D),
        "wk": (L, E, KH, D),
        "wv": (L, E, KH, D),
        "wo": (L, H, D, E),
        "mlp_norm": (L, E),
    }
    if cfg.qkv_bias:
        layer.update({"bq": (L, H, D), "bk": (L, KH, D), "bv": (L, KH, D)})
    if cfg.qk_norm:
        layer.update({"q_norm": (L, D), "k_norm": (L, D)})
    if cfg.post_norms:
        layer.update({"post_attn_norm": (L, E), "post_mlp_norm": (L, E)})
    if is_moe(cfg):
        X = cfg.num_experts
        layer.update({"router": (L, E, X), "w_gate": (L, X, E, F_),
                      "w_up": (L, X, E, F_), "w_down": (L, X, F_, E)})
    else:
        layer.update({"w_gate": (L, E, F_), "w_up": (L, E, F_),
                      "w_down": (L, F_, E)})
    shapes = {"embed": (V, E), "layers": layer, "final_norm": (E,)}
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (E, V)
    return shapes


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axes of each leaf of ``param_shapes``, as the reference's
    param_specs (parallel/shardings.py maps them to mesh axes)."""
    layer = {
        "attn_norm": (ln.LAYERS, ln.EMBED),
        "wq": (ln.LAYERS, ln.EMBED, ln.HEADS, ln.HEAD_DIM),
        "wk": (ln.LAYERS, ln.EMBED, ln.KV_HEADS, ln.HEAD_DIM),
        "wv": (ln.LAYERS, ln.EMBED, ln.KV_HEADS, ln.HEAD_DIM),
        "wo": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM, ln.EMBED),
        "mlp_norm": (ln.LAYERS, ln.EMBED),
    }
    if cfg.qkv_bias:
        layer.update({"bq": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM),
                      "bk": (ln.LAYERS, ln.KV_HEADS, ln.HEAD_DIM),
                      "bv": (ln.LAYERS, ln.KV_HEADS, ln.HEAD_DIM)})
    if cfg.qk_norm:
        layer.update({"q_norm": (ln.LAYERS, ln.HEAD_DIM),
                      "k_norm": (ln.LAYERS, ln.HEAD_DIM)})
    if cfg.post_norms:
        layer.update({"post_attn_norm": (ln.LAYERS, ln.EMBED),
                      "post_mlp_norm": (ln.LAYERS, ln.EMBED)})
    if is_moe(cfg):
        layer.update({
            "router": (ln.LAYERS, ln.EMBED, ln.EXPERTS),
            "w_gate": (ln.LAYERS, ln.EXPERTS, ln.EMBED, ln.MLP),
            "w_up": (ln.LAYERS, ln.EXPERTS, ln.EMBED, ln.MLP),
            "w_down": (ln.LAYERS, ln.EXPERTS, ln.MLP, ln.EMBED)})
    else:
        layer.update({"w_gate": (ln.LAYERS, ln.EMBED, ln.MLP),
                      "w_up": (ln.LAYERS, ln.EMBED, ln.MLP),
                      "w_down": (ln.LAYERS, ln.MLP, ln.EMBED)})
    specs = {"embed": (ln.VOCAB, ln.EMBED), "layers": layer,
             "final_norm": (ln.EMBED,)}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (ln.EMBED, ln.VOCAB)
    return specs


def _sharded(group, axis: str) -> bool:
    return group is not None and axis in group.shard.sharded


def _row_parallel(group, axis: str, x: torch.Tensor, w: Any,
                  n_contract: int = 1, tokens: Optional[int] = None,
                  delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` plus a LoRA ``delta``, in ``x``'s dtype. Where ``axis``
    (the contracted one) is sharded over the ranks, ``x`` and ``w`` hold
    this rank's cut of it and ``delta`` this rank's share, and the sum is
    taken over the ranks (engine/quant.py ``row_parallel_matmul``)."""
    if _sharded(group, axis):
        return quant.row_parallel_matmul(x, w, n_contract, tokens, group,
                                         delta)
    y = quant.quant_matmul(x, w, n_contract, tokens=tokens)
    return y if delta is None else y + delta


def is_moe(cfg: ModelConfig) -> bool:
    return cfg.architecture == "mixtral" and cfg.num_experts > 0


def _lora_delta(x: torch.Tensor, onehot: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor) -> torch.Tensor:
    """Per-token LoRA delta from a bank of N adapters.

    x (..., T, in); onehot (..., T, N) (or (..., 1, N), broadcast over T)
    selects each token's adapter; A (in, N, R); B (N, R, *out). The sum is
    the reference's (models/llama.py ``_lora_delta``), but it never forms
    every adapter's (T, N, out) output before selecting: ``xa = x @ A`` is
    (T, N, R), the unselected adapters' ranks are zeroed by the one-hot,
    and one product with B contracts (N, R). A token of adapter 0 (the
    bank's zero slot) gets exactly 0."""
    E, N, R = A.shape
    xa = (x @ A.reshape(E, N * R)).unflatten(-1, (N, R))
    xa = (xa * onehot[..., None]).flatten(-2)
    return (xa @ B.reshape(N * R, -1)).unflatten(-1, B.shape[2:])


def _mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor, lb=None,
         onehot=None, tokens: Optional[int] = None,
         group=None, seq=None, expert=None) -> torch.Tensor:
    """The MLP block; its down-projection summed over the ranks of a
    ``group`` that shards the intermediate axis (``_row_parallel``).
    ``seq``: the seq group a ring prefill's tokens are split over (a MoE
    block ranks its slots across it, ``_moe_mlp``); ``expert``: the
    expert group a MoE block's combine is summed over."""
    if is_moe(cfg):
        # LoRA MLP targets are ignored on a MoE model, as in the reference
        return _moe_mlp(cfg, lp, x, tokens, group, seq, expert)
    x8 = quant.shared_rows(x, lp["w_gate"], tokens=tokens)
    gate = quant.quant_matmul(x, lp["w_gate"], tokens=tokens, x8=x8)
    up = quant.quant_matmul(x, lp["w_up"], tokens=tokens, x8=x8)
    if lb is not None:
        if "w_gate" in lb:
            gate = gate + _lora_delta(x, onehot, *lb["w_gate"])
        if "w_up" in lb:
            up = up + _lora_delta(x, onehot, *lb["w_up"])
    # Gemma is GeGLU (tanh-approximated gelu on the gate); Llama is SwiGLU
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    hidden2 = act * up
    delta = (_lora_delta(hidden2, onehot, *lb["w_down"])
             if lb is not None and "w_down" in lb else None)
    return _row_parallel(group, ln.MLP, hidden2, lp["w_down"],
                         tokens=tokens, delta=delta)


def _mlp_chunked(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                 tokens: Optional[int], rows: int,
                 group=None, expert=None) -> torch.Tensor:
    """The MLP of ``x (..., T, E)`` a chunk of ``rows`` rows at a time.
    A dense MLP is row by row, so this is ``_mlp``'s value. A MoE block
    takes its capacity from ``tokens``, the reference's whole call, and
    ranks slots within the chunk: it drops a slot only where the
    reference's call drops one too."""
    flat = x.reshape(-1, x.shape[-1])
    if flat.shape[0] <= rows:
        return _mlp(cfg, lp, x, tokens=tokens, group=group, expert=expert)
    out = torch.empty_like(flat)
    for r0 in range(0, flat.shape[0], rows):
        out[r0:r0 + rows] = _mlp(cfg, lp, flat[r0:r0 + rows], tokens=tokens,
                                 group=group, expert=expert)
    return out.view(x.shape)


def top_k_lower_first(logits: torch.Tensor, k: int):
    """Top-k along the last dim keeping the lower index on a tie, as
    ``lax.top_k`` does: a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor,
             tokens: Optional[int] = None, group=None,
             seq=None, expert=None) -> torch.Tensor:
    """Mixtral's sparse MoE block: the reference's capacity-based top-k
    dispatch (models/llama.py ``_moe_mlp``) without its (T, X, C) one-hot
    products.

    Router logits in the model dtype, then float32; top-k (ties to the
    lower expert), softmax over the chosen k. ``tokens`` is the reference's
    T (module docstring), which sets the capacity ``C = max(int(2 T k /
    X), k)`` and the int8 route. A slot's position is its rank among its
    expert's slots in token-major, choice-minor order, and slots at ``pos
    >= C`` are dropped. Rows are scattered by index into an ``(X * C_buf +
    1, E)`` buffer (the last row takes the dropped slots), ``C_buf = min(C,
    T_here)``; the experts run one batched product over X; each token sums
    its kept slots' outputs times their weights rounded to the model
    dtype. Shapes are static and nothing syncs with the host. On the W8A8
    route each token is quantized once, before the scatter.

    Under a ``group`` that shards the intermediate axis, each rank holds
    every expert's F cut: routing, top-k and dispatch run on replicated
    inputs with deterministic ops, so every rank keeps and drops the same
    slots; gate and up are the rank's columns, and the down-projection's
    partials of the kept slots' rows (at most ``T k`` of the ``(X,
    C_buf, E)`` buffer; the rest are zero on every rank) are summed over
    the ranks right after the product, before the combine (in int32 on
    the W8A8 route, its scale the max over the ranks; in float32 and
    rounded once otherwise). Summing after the combine would move half
    the bytes at k 2 (``(T, E)`` against ``T k`` rows), but would round
    the expert rows once less than one device does and could not keep
    the int32 sum exact; summed before, the rows are rounded where one
    device rounds them, and the reference's GSPMD likewise reduces the
    product that contracts the cut F, ahead of its combine.

    In a ring prefill (``seq``, the seq group: rank r holds tokens [r Sl,
    (r + 1) Sl) of the whole padded prompt, ``tokens`` = S) the reference
    routes the whole (1, S) prompt at once, so a slot's position counts
    the slots that ranks 0..r-1 routed to its expert. Each rank sends its
    ``(X,)`` routed counts to every seq rank (``RankGroup.moe_counts``)
    and offsets its local positions by the earlier ranks' sum; the
    capacity is S's. The buffer stays ``min(C, T_here)`` rows an expert:
    a kept slot's local position is below both. Routing is replicated
    within a tensor group, so on the seq x tensor grid each tensor rank of
    a seq rank sends and gets the same counts. The prompt's pad tokens
    follow its real ones, in the last ranks' slices, and never displace a
    real slot.

    Under an ``expert`` group whose shard cuts the experts, this rank
    holds experts ``[lo, hi)`` (``Xl`` of them) and every rank routes
    every token with the whole router, so all keep and drop the same
    slots: positions and the capacity are over the global X, as the
    reference's (its ``C`` keeps the global X). Only this rank's experts'
    slots are dispatched, into an ``(Xl, C_buf, E)`` buffer; the others
    go to the sink row. Each rank forms its float32 combine partial
    ``(T, E)``, its slots' rows times their weights with the other
    ranks' slots zero, and the partials are summed over the expert group
    (``RankGroup.moe_combine``) and rounded once to the model dtype. At
    k = 2 one device adds a token's two weighted rows in float32; a
    rank's partial holds at most those terms and zeros, and adding zero
    is exact, so the sum is one device's bit for bit wherever the
    per-expert products are (the int8 routes run one expert at a time).
    On the expert x tensor grid the down-projection's F partials are
    summed over the tensor group first (``quant.expert_matmul``, this
    rank's kept rows), then the combine partial over the expert group.
    With both a ``seq`` and an ``expert`` group (a ring prefill on the seq
    x expert grid) both exchanges run: positions count the earlier seq
    ranks' slots, then the partial is summed over the expert group."""
    shape = x.shape
    E = shape[-1]
    dt = x.dtype
    xt = x.reshape(-1, E)
    T = xt.shape[0]
    T_ref = T if tokens is None else tokens
    X, k = cfg.num_experts, cfg.num_experts_per_tok
    w8a8 = quant.is_quantized(lp["w_gate"]) and not quant.a16(T_ref)
    down_group = group if _sharded(group, ln.MLP) else None
    combine = expert if expert is not None and expert.shard.experts else None
    lo, hi = (0, X) if combine is None else combine.shard.cuts[ln.EXPERTS]
    with quant.profile_range("moe.dispatch"):
        logits = (xt @ lp["router"]).float()
        top_vals, top_idx = top_k_lower_first(logits, k)  # (T, k)
        weights = torch.softmax(top_vals, dim=-1)
        capacity = max(int(2.0 * T_ref * k / X), k)
        c_buf = min(capacity, T)
        choice = top_idx.reshape(-1)  # (T * k,) token-major, choice-minor
        # (X, T * k) one-hot: the running count along the last dim is a
        # row scan, far faster on the card than a scan down 8 columns
        onehot = (choice[None, :] == torch.arange(
            X, device=x.device)[:, None]).to(torch.int32)
        pos = (torch.cumsum(onehot, 1) - onehot).gather(
            0, choice[None, :])[0]
        whole_pos = pos  # the slot's position in the whole prompt
        if seq is not None and seq.size > 1:
            # the slots ranks 0..r-1 routed to each expert come first
            counts = seq.moe_counts(onehot.sum(1, dtype=torch.int32))
            whole_pos = pos + counts[:seq.rank].sum(0)[choice]
        sink = (hi - lo) * c_buf
        kept = whole_pos < capacity
        if combine is not None:  # only this rank's experts' slots
            kept &= (choice >= lo) & (choice < hi)
        dest = torch.where(kept, (choice - lo) * c_buf + pos,
                           torch.full_like(pos, sink))
        src = torch.arange(T, device=x.device).repeat_interleave(k)

    def dispatch(rows: torch.Tensor) -> torch.Tensor:
        with quant.profile_range("moe.dispatch"):
            buf = rows.new_zeros((sink + 1,) + rows.shape[1:])
            buf[dest] = rows[src]
            return buf[:sink].unflatten(0, (hi - lo, c_buf))

    def experts(h: torch.Tensor, w, group=None) -> torch.Tensor:
        """h (Xl, C_buf, in) in the model dtype through one stack; with a
        ``group``, ``in`` is cut over its ranks and the kept slots' rows
        are summed (the others are zero)."""
        rows = None if group is None else dest[dest < sink]
        if not w8a8:
            return quant.expert_matmul(h, w, dt, group=group, rows=rows)
        hq, hs = quant.quantize_rows(h.flatten(0, 1), group)
        return quant.expert_matmul(hq.view(h.shape), w, dt,
                                   sx=hs.view(h.shape[:2]), group=group,
                                   rows=rows)

    if w8a8:
        xq, sx = quant.quantize_rows(xt)
        xb, sxb = dispatch(xq), dispatch(sx)
        gate = quant.expert_matmul(xb, lp["w_gate"], dt, sx=sxb)
        up = quant.expert_matmul(xb, lp["w_up"], dt, sx=sxb)
    else:
        xb = dispatch(xt)
        gate = quant.expert_matmul(xb, lp["w_gate"], dt)
        up = quant.expert_matmul(xb, lp["w_up"], dt)
    down = experts(F.silu(gate) * up, lp["w_down"],
                   down_group)  # (Xl, C_buf, E)
    with quant.profile_range("moe.combine"):
        rows = torch.cat([down.flatten(0, 1), down.new_zeros(1, E)])[dest]
        comb = weights.to(dt).float()[..., None]  # rounded to the model dtype
        out = (rows.view(T, k, E).float() * comb).sum(1)
        if combine is not None:
            out = combine.moe_combine(out)
    return out.to(dt).reshape(shape)


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 group=None) -> torch.Tensor:
    """Token embedding, including Gemma's sqrt(E) scale; vocab-parallel
    under a ``group`` whose shard splits the vocabulary."""
    if not _sharded(group, ln.VOCAB):
        x = quant.embed_lookup(params["embed"], tokens, cfg.torch_dtype)
    else:
        lo, hi = group.shard.cuts[ln.VOCAB]
        mine = (tokens >= lo) & (tokens < hi)
        x = quant.embed_lookup(params["embed"],
                               torch.where(mine, tokens - lo, 0),
                               cfg.torch_dtype)
        # one rank holds each row: the sum adds only zeros to it
        x = group.all_reduce(torch.where(mine[..., None], x, 0))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.torch_dtype)
    return x


def _layer(w: Any, i: int) -> Any:
    """Layer ``i`` of a stacked weight, quantized or not."""
    if quant.is_quantized(w):
        return {"q": w["q"][i], "s": w["s"][i]}
    return w[i]


def forward_hidden(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    attend: AttendFn,
    kv_pool: Any = None,
    lora: Optional[dict] = None,
    ref_tokens: Optional[int] = None,
    mlp_rows: Optional[int] = None,
    group=None,
    seq=None,
    expert=None,
) -> Tuple[torch.Tensor, Any]:
    """Run the decoder stack from embedded activations.

    x: (..., T, E); positions: (..., T). ``attend`` receives q, k, v of
    shape (..., T, heads, D), the KV pool and the layer index, and returns
    the attention output and the (updated) pool. ``lora`` is None or
    ``{"onehot": (..., T, N), "bank": {target: (A (L, in, N, R), B (L, N,
    R, *out))}}`` (engine/model_runner.py ``register_lora``).
    ``ref_tokens`` is the token count of the reference's same call (module
    docstring); None means the rows of ``x``. ``mlp_rows`` runs the MLP
    over chunks of that many rows without LoRA (the dense scoring
    forward's memory bound; None: all rows at once). ``group``: this
    rank's tensor-parallel group (module docstring), None on one device.
    ``seq``: in a ring prefill, the seq group ``x``'s tokens are this
    rank's slice over (``_moe_mlp``), None elsewhere. ``expert``: this
    rank's expert group (module docstring), None without one.
    Returns (hidden (..., T, E), kv_pool)."""
    layers = params["layers"]
    onehot = None if lora is None else lora["onehot"]
    eps, off = cfg.rms_norm_eps, cfg.norm_offset
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    h = x
    for i in range(cfg.num_layers):
        lp = {name: _layer(w, i) for name, w in layers.items()}
        lb = (None if lora is None
              else {t: (A[i], B[i]) for t, (A, B) in lora["bank"].items()})
        normed = rms_norm(h, lp["attn_norm"], eps, off)
        # q, k and v quantize their shared input once
        x8 = quant.shared_rows(normed, lp["wq"], tokens=ref_tokens)
        q = quant.quant_matmul(normed, lp["wq"], tokens=ref_tokens, x8=x8)
        k = quant.quant_matmul(normed, lp["wk"], tokens=ref_tokens, x8=x8)
        v = quant.quant_matmul(normed, lp["wv"], tokens=ref_tokens, x8=x8)
        if lb is not None:
            if "wq" in lb:
                q = q + _lora_delta(normed, onehot, *lb["wq"])
            if "wk" in lb:
                k = k + _lora_delta(normed, onehot, *lb["wk"])
            if "wv" in lb:
                v = v + _lora_delta(normed, onehot, *lb["wv"])
        if cfg.qkv_bias:
            q = q + lp["bq"]
            k = k + lp["bk"]
            v = v + lp["bv"]
        if cfg.qk_norm:  # Qwen3: per-head RMSNorm over head_dim, pre-rope
            q = rms_norm(q, lp["q_norm"], eps, off)
            k = rms_norm(k, lp["k_norm"], eps, off)
        if cfg.query_scale:
            # fold a non-default score scale into q: attention keeps
            # head_dim ** -0.5
            q = q * torch.tensor(cfg.query_scale * cfg.head_dim ** 0.5,
                                 dtype=q.dtype)
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
        attn, kv_pool = attend(q, k, v, kv_pool, i)
        delta = (_lora_delta(attn.flatten(-2), onehot, *lb["wo"])
                 if lb is not None and "wo" in lb else None)
        o = _row_parallel(group, ln.HEADS, attn, lp["wo"], 2, ref_tokens,
                          delta)
        if cfg.post_norms:
            o = rms_norm(o, lp["post_attn_norm"], eps, off)
        h = h + o
        mlp_in = rms_norm(h, lp["mlp_norm"], eps, off)
        if mlp_rows is None or lb is not None:
            mlp_out = _mlp(cfg, lp, mlp_in, lb, onehot, ref_tokens, group,
                           seq, expert)
        else:
            mlp_out = _mlp_chunked(cfg, lp, mlp_in, ref_tokens, mlp_rows,
                                   group, expert)
        if cfg.post_norms:
            mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"], eps, off)
        h = h + mlp_out
    return h, kv_pool


def forward_tokens(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    attend: AttendFn,
    kv_pool: Any = None,
    lora: Optional[dict] = None,
    ref_tokens: Optional[int] = None,
    mlp_rows: Optional[int] = None,
    group=None,
    seq=None,
    expert=None,
) -> Tuple[torch.Tensor, Any]:
    """Embed tokens, then run the decoder stack (see forward_hidden)."""
    x = embed_tokens(cfg, params, tokens, group)
    return forward_hidden(cfg, params, x, positions, attend, kv_pool, lora,
                          ref_tokens, mlp_rows, group, seq, expert)


def logits_from_hidden(cfg: ModelConfig, params: dict,
                       hidden: torch.Tensor,
                       tokens: Optional[int] = None,
                       group=None) -> torch.Tensor:
    """Final norm and LM head; float32 logits (..., T, V). ``tokens`` is
    the reference's row count for the head's int8 route (None: the rows
    of ``hidden``). Under a ``group`` that splits the vocabulary, each
    rank's (..., T, V / tp) shard is gathered into the full logits."""
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps,
                      cfg.norm_offset)
    head = (quant.head_from_embed(params["embed"]) if cfg.tie_word_embeddings
            else params["lm_head"])
    if not quant.is_quantized(head):
        head = head.to(cfg.torch_dtype)
    logits = quant.quant_matmul(hidden, head, out_dtype=torch.float32,
                                tokens=tokens)
    if _sharded(group, ln.VOCAB):
        logits = group.all_gather_last(logits)
    if cfg.final_logit_softcap:  # Gemma-2
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits
