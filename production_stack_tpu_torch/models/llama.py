"""Llama-family decoder (dense path) as plain functions on tensors.

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
projections (``_lora_delta``). Quantization and the MoE block are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.ops.norms import rms_norm
from production_stack_tpu_torch.ops.rope import rope_tables, rotate

AttendFn = Callable[..., Tuple[torch.Tensor, Any]]


def param_shapes(cfg: ModelConfig) -> dict:
    """Shapes of the parameter dict, mirroring the reference's param_specs
    (dense architectures)."""
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
    layer.update({"w_gate": (L, E, F_), "w_up": (L, E, F_),
                  "w_down": (L, F_, E)})
    shapes = {"embed": (V, E), "layers": layer, "final_norm": (E,)}
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (E, V)
    return shapes


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., T, E) @ w (E, H, D) -> (..., T, H, D)."""
    E, H, D = w.shape
    return (x @ w.reshape(E, H * D)).unflatten(-1, (H, D))


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
         onehot=None) -> torch.Tensor:
    gate = x @ lp["w_gate"]
    up = x @ lp["w_up"]
    if lb is not None:
        if "w_gate" in lb:
            gate = gate + _lora_delta(x, onehot, *lb["w_gate"])
        if "w_up" in lb:
            up = up + _lora_delta(x, onehot, *lb["w_up"])
    # Gemma is GeGLU (tanh-approximated gelu on the gate); Llama is SwiGLU
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    hidden2 = act * up
    out = hidden2 @ lp["w_down"]
    if lb is not None and "w_down" in lb:
        out = out + _lora_delta(hidden2, onehot, *lb["w_down"])
    return out


def embed_tokens(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding, including Gemma's sqrt(E) scale."""
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.torch_dtype)
    return x


def forward_hidden(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    attend: AttendFn,
    kv_pool: Any = None,
    lora: Optional[dict] = None,
) -> Tuple[torch.Tensor, Any]:
    """Run the decoder stack from embedded activations.

    x: (..., T, E); positions: (..., T). ``attend`` receives q, k, v of
    shape (..., T, heads, D), the KV pool and the layer index, and returns
    the attention output and the (updated) pool. ``lora`` is None or
    ``{"onehot": (..., T, N), "bank": {target: (A (L, in, N, R), B (L, N,
    R, *out))}}`` (engine/model_runner.py ``register_lora``).
    Returns (hidden (..., T, E), kv_pool)."""
    layers = params["layers"]
    onehot = None if lora is None else lora["onehot"]
    eps, off = cfg.rms_norm_eps, cfg.norm_offset
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    h = x
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        lb = (None if lora is None
              else {t: (A[i], B[i]) for t, (A, B) in lora["bank"].items()})
        normed = rms_norm(h, lp["attn_norm"], eps, off)
        q = _heads(normed, lp["wq"])
        k = _heads(normed, lp["wk"])
        v = _heads(normed, lp["wv"])
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
        flat = attn.flatten(-2)  # (..., T, H*D)
        o = flat @ lp["wo"].flatten(0, 1)
        if lb is not None and "wo" in lb:
            o = o + _lora_delta(flat, onehot, *lb["wo"])
        if cfg.post_norms:
            o = rms_norm(o, lp["post_attn_norm"], eps, off)
        h = h + o
        mlp_out = _mlp(cfg, lp, rms_norm(h, lp["mlp_norm"], eps, off), lb,
                       onehot)
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
) -> Tuple[torch.Tensor, Any]:
    """Embed tokens, then run the decoder stack (see forward_hidden)."""
    x = embed_tokens(cfg, params, tokens)
    return forward_hidden(cfg, params, x, positions, attend, kv_pool, lora)


def logits_from_hidden(cfg: ModelConfig, params: dict,
                       hidden: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head; float32 logits (..., T, V)."""
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps,
                      cfg.norm_offset)
    head = (params["embed"].t() if cfg.tie_word_embeddings
            else params["lm_head"])
    logits = (hidden @ head.to(cfg.torch_dtype)).float()
    if cfg.final_logit_softcap:  # Gemma-2
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits
