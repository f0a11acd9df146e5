"""Whisper-family encoder-decoder as plain functions on tensors (audio
transcription).

Ports production_stack_tpu/models/whisper.py: ``engine/whisper_runner.py``
drives it and ``engine/whisper_server.py`` serves ``/v1/audio/*``.

Parameters are a nested dict with the reference's names (``enc`` and
``dec``, each with its per-layer stacks along a leading L axis under
``layers``), so a JAX parameter tree converts one to one
(``engine/weights.params_from_jax``). One layout differs: the two conv
weights are ``(out, in, k)``, as ``F.conv1d`` and HF checkpoints hold
them, where the reference's feature-last convolution takes ``(k, in,
out)``. The reference's ``lax.scan`` over a stack becomes a Python loop.

Inside, activations are head-major ``(B, H, T, D)`` so each attention
product is one batched matmul without a copy: the cross-attention K/V
``cross_kv`` returns are ``(Ld, B, H, S_enc, D)`` and the dense
self-attention cache ``(Ld, 2, B, H, T_max, D)`` (the reference's are
``(Ld, B, S_enc, H, D)`` and ``(Ld, 2, B, T_max, H, D)``).

Every product runs in the model dtype and is cast afterwards, as a JAX
einsum of bf16 inputs returns bf16 before its ``astype``: attention scores
and logits are rounded to the model dtype before float32, P is cast to
the model dtype before P V, and a bias is added to the rounded product.
Masked scores are -1e30 in float32, as the reference's. Attention keys of
the self-attention cache are read only up to the longest row's
``offset + valid_len``: the keys past it are masked in the reference, so
their weights are exactly 0 there.

**Tensor parallelism.** The leaves carry the reference's logical axes
(``param_specs``), which parallel/shardings.py cuts. With a ``group``
(parallel/distributed.RankGroup) the parameters are this rank's shard:
the Q, K and V projections of self- and cross-attention are cut over
heads and ``fc1`` over the MLP axis (column-parallel), so attention runs
at the rank's own heads and the cross and self K/V a rank holds are its
heads'. ``wo``, ``cwo`` and ``fc2`` contract a cut axis (row-parallel):
each rank's product is a float32 partial, summed over the ranks and
rounded to the model dtype once (``_row_parallel``), and their biases
``bo``, ``cbo`` and ``fc2_b``, whole on every rank, are added once,
after the sum. The decoder's embedding is vocab-parallel (each rank looks
up the rows it holds, zeros elsewhere, all-reduce) and the tied logits
are computed on the rank's rows and all-gathered in rank order. The conv
front end, positions and norms are replicated. An axis the rules
replicate (one whose size the degree does not divide, as
whisper-large-v3-class's 51866-token vocabulary at 4) is whole on every
rank and its products are not summed. Every rank then holds the same
hidden states and the same full logits. A rank's column-parallel heads
are made contiguous, so its attention reads them as a one-device run cut
into the same halves would.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from production_stack_tpu_torch.engine import quant
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.ops.norms import layer_norm
from production_stack_tpu_torch.parallel import shardings as ln

# Whisper's ordered language list (position defines the language token:
# id = lang_base_id + index). First 99 are the multilingual v1/v2 set;
# "yue" is appended in large-v3 vocabularies (n_langs == 100).
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl",
    "ca", "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk",
    "el", "ms", "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr",
    "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn",
    "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne",
    "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn",
    "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi",
    "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my",
    "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su",
    "yue",
)

# leaves made of zeros (biases) and ones (norm scales) by init_params
_ONES = ("attn_norm_w", "mlp_norm_w", "cross_norm_w", "final_norm_w")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _block_shapes(cfg: ModelConfig, n_layers: int, cross: bool) -> dict:
    """One attention + MLP block, stacked on a leading layer axis."""
    L, E, H, D, F_ = (n_layers, cfg.hidden_size, cfg.num_heads,
                      cfg.head_dim, cfg.intermediate_size)
    block = {
        "attn_norm_w": (L, E), "attn_norm_b": (L, E),
        "wq": (L, E, H, D), "bq": (L, H, D),
        "wk": (L, E, H, D),  # no k bias
        "wv": (L, E, H, D), "bv": (L, H, D),
        "wo": (L, H, D, E), "bo": (L, E),
        "mlp_norm_w": (L, E), "mlp_norm_b": (L, E),
        "fc1": (L, E, F_), "fc1_b": (L, F_),
        "fc2": (L, F_, E), "fc2_b": (L, E),
    }
    if cross:  # decoder only: cross-attention, "c" prefix
        block.update({
            "cross_norm_w": (L, E), "cross_norm_b": (L, E),
            "cwq": (L, E, H, D), "cbq": (L, H, D),
            "cwk": (L, E, H, D),
            "cwv": (L, E, H, D), "cbv": (L, H, D),
            "cwo": (L, H, D, E), "cbo": (L, E),
        })
    return block


def param_shapes(cfg: ModelConfig) -> dict:
    """Shapes of the parameter dict (the reference's ``param_specs``
    tree; conv weights ``(out, in, k)``)."""
    E = cfg.hidden_size
    return {
        "enc": {
            "conv1_w": (E, cfg.num_mel_bins, 3), "conv1_b": (E,),
            "conv2_w": (E, E, 3), "conv2_b": (E,),  # stride 2
            "layers": _block_shapes(cfg, cfg.encoder_layers, cross=False),
            "final_norm_w": (E,), "final_norm_b": (E,),
        },
        "dec": {
            "embed": (cfg.vocab_size, E),  # the LM head is tied to this
            "pos": (cfg.max_model_len, E),  # learned positions
            "layers": _block_shapes(cfg, cfg.num_layers, cross=True),
            "final_norm_w": (E,), "final_norm_b": (E,),
        },
    }


def _block_specs() -> dict:
    """Logical axes of one attention + MLP block (stacked on LAYERS)."""
    return {
        "attn_norm_w": (ln.LAYERS, ln.EMBED),
        "attn_norm_b": (ln.LAYERS, ln.EMBED),
        "wq": (ln.LAYERS, ln.EMBED, ln.HEADS, ln.HEAD_DIM),
        "bq": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM),
        "wk": (ln.LAYERS, ln.EMBED, ln.HEADS, ln.HEAD_DIM),  # no k bias
        "wv": (ln.LAYERS, ln.EMBED, ln.HEADS, ln.HEAD_DIM),
        "bv": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM),
        "wo": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM, ln.EMBED),
        "bo": (ln.LAYERS, ln.EMBED),
        "mlp_norm_w": (ln.LAYERS, ln.EMBED),
        "mlp_norm_b": (ln.LAYERS, ln.EMBED),
        "fc1": (ln.LAYERS, ln.EMBED, ln.MLP),
        "fc1_b": (ln.LAYERS, ln.MLP),
        "fc2": (ln.LAYERS, ln.MLP, ln.EMBED),
        "fc2_b": (ln.LAYERS, ln.EMBED),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axes of each leaf of ``param_shapes``: the reference's
    ``param_specs``, with the conv weights' axes in this package's ``(out,
    in, k)`` order."""
    dec_layer = _block_specs()
    dec_layer.update({
        "cross_norm_w": (ln.LAYERS, ln.EMBED),
        "cross_norm_b": (ln.LAYERS, ln.EMBED),
        "cwq": (ln.LAYERS, ln.EMBED, ln.HEADS, ln.HEAD_DIM),
        "cbq": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM),
        "cwk": (ln.LAYERS, ln.EMBED, ln.HEADS, ln.HEAD_DIM),
        "cwv": (ln.LAYERS, ln.EMBED, ln.HEADS, ln.HEAD_DIM),
        "cbv": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM),
        "cwo": (ln.LAYERS, ln.HEADS, ln.HEAD_DIM, ln.EMBED),
        "cbo": (ln.LAYERS, ln.EMBED),
    })
    return {
        "enc": {
            "conv1_w": (ln.EMBED, None, None),  # (E, n_mels, k)
            "conv1_b": (ln.EMBED,),
            "conv2_w": (ln.EMBED, ln.EMBED, None),  # (E, E, k) stride 2
            "conv2_b": (ln.EMBED,),
            "layers": _block_specs(),
            "final_norm_w": (ln.EMBED,),
            "final_norm_b": (ln.EMBED,),
        },
        "dec": {
            "embed": (ln.VOCAB, ln.EMBED),  # the LM head is tied to this
            "pos": (None, ln.EMBED),  # (max_target_positions, E) learned
            "layers": dec_layer,
            "final_norm_w": (ln.EMBED,),
            "final_norm_b": (ln.EMBED,),
        },
    }


def _fan_in(cfg: ModelConfig, name: str) -> int:
    if name == "conv1_w":
        return 3 * cfg.num_mel_bins
    if name == "conv2_w":
        return 3 * cfg.hidden_size
    if name in ("wo", "cwo"):
        return cfg.num_heads * cfg.head_dim
    if name == "fc2":
        return cfg.intermediate_size
    return cfg.hidden_size


def init_params(cfg: ModelConfig, seed: int = 0,
                device: torch.device | str = "cpu") -> dict:
    """Random parameters made on ``device`` from ``seed``: the reference's
    scheme (weights normal / sqrt(fan_in), biases 0, norm scales 1), not
    its random stream."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = cfg.torch_dtype

    def make(tree: dict) -> dict:
        out = {}
        for name, shape in tree.items():
            if isinstance(shape, dict):
                out[name] = make(shape)
            elif name in _ONES:
                out[name] = torch.ones(shape, dtype=dt, device=device)
            elif name.endswith("_b") or name in ("bq", "bv", "bo", "cbq",
                                                 "cbv", "cbo"):
                out[name] = torch.zeros(shape, dtype=dt, device=device)
            else:
                out[name] = torch.empty(shape, dtype=dt, device=device).normal_(
                    0.0, _fan_in(cfg, name) ** -0.5, generator=gen)
        return out

    return make(param_shapes(cfg))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask=None) -> torch.Tensor:
    """(B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D); scores in f32."""
    scale = q.shape[-1] ** -0.5
    s = (q @ k.transpose(-1, -2)).float() * scale
    if mask is not None:
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return p @ v


def _sinusoid_pos(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder position embedding (log-spaced sinusoids)."""
    log_timescale = np.log(10_000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


@functools.lru_cache(maxsize=8)
def _pos_table(length: int, channels: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """``_sinusoid_pos`` on ``device`` in ``dtype``, made once (read-only)."""
    return torch.as_tensor(_sinusoid_pos(length, channels)).to(device, dtype)


def _heads(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """(B, T, E) x (E, H, D) [+ (H, D)] -> (B, H, T, D)."""
    E, H, D = w.shape
    y = x @ w.reshape(E, H * D)
    if b is not None:
        y = y + b.reshape(H * D)
    return y.unflatten(-1, (H, D)).transpose(1, 2)


def _sharded(group, axis: str) -> bool:
    return group is not None and axis in group.shard.sharded


def _col_heads(group, x: torch.Tensor, w: torch.Tensor,
               b=None) -> torch.Tensor:
    """``_heads`` at this rank's heads; contiguous under a ``group``
    (module docstring)."""
    y = _heads(x, w, b)
    return y.contiguous() if _sharded(group, ln.HEADS) else y


def _row_parallel(group, axis: str, x: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` in ``x``'s dtype. Where ``axis`` (K's)
    is sharded, ``x`` and ``w`` hold this rank's cut of K: the float32
    partials are summed over the ranks and rounded once
    (engine/quant.py ``row_parallel_matmul``)."""
    if not _sharded(group, axis):
        return x @ w
    return quant.row_parallel_matmul(x, w, 1, None, group)


def _merge(group, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) x (H, D, E) -> (B, T, E), summed over the ranks where
    heads are cut."""
    H, D, E = w.shape
    return _row_parallel(group, ln.HEADS, a.transpose(1, 2).flatten(2),
                         w.reshape(H * D, E))


def _up(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The MLP's first product and exact (erf) GELU, as the reference (a
    function of its own, as ``_heads`` and ``_attention`` are, so that a
    one-device check can run it in the ranks' halves: chip_smoke.py
    ``_WhisperRankSums``)."""
    return F.gelu(x @ w + b)


def _mlp(lp: dict, i: int, h: torch.Tensor, group=None) -> torch.Tensor:
    n2 = layer_norm(h, lp["mlp_norm_w"][i], lp["mlp_norm_b"][i])
    m = _up(n2, lp["fc1"][i], lp["fc1_b"][i])
    return h + _row_parallel(group, ln.MLP, m, lp["fc2"][i]) + lp["fc2_b"][i]


def _logits(group, h: torch.Tensor, embed: torch.Tensor,
            dt) -> torch.Tensor:
    """Tied float32 logits; the ranks' vocabulary rows gathered in rank
    order where the vocabulary is cut."""
    logits = (h @ embed.to(dt).T).float()
    if _sharded(group, ln.VOCAB):
        logits = group.all_gather_last(logits)
    return logits


def encode(cfg: ModelConfig, params: dict, mel: torch.Tensor,
           group=None) -> torch.Tensor:
    """(B, n_mels, 2 * n_audio_ctx frames) -> (B, n_audio_ctx, E); under a
    ``group``, at this rank's heads and MLP share (module docstring)."""
    p = params["enc"]
    dt = cfg.torch_dtype
    x = mel.to(dt)  # channels-first: conv1d's layout
    x = F.gelu(F.conv1d(x, p["conv1_w"].to(dt), padding=1)
               + p["conv1_b"][:, None])
    x = F.gelu(F.conv1d(x, p["conv2_w"].to(dt), stride=2, padding=1)
               + p["conv2_b"][:, None])
    h = x.transpose(1, 2) + _pos_table(cfg.n_audio_ctx, cfg.hidden_size,
                                       x.device, dt)
    lp = p["layers"]
    for i in range(cfg.encoder_layers):
        n = layer_norm(h, lp["attn_norm_w"][i], lp["attn_norm_b"][i])
        a = _attention(_col_heads(group, n, lp["wq"][i], lp["bq"][i]),
                       _col_heads(group, n, lp["wk"][i]),
                       _col_heads(group, n, lp["wv"][i], lp["bv"][i]))
        h = h + _merge(group, a, lp["wo"][i]) + lp["bo"][i]
        h = _mlp(lp, i, h, group)
    return layer_norm(h, p["final_norm_w"], p["final_norm_b"])


def cross_kv(cfg: ModelConfig, params: dict,
             enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V of the encoder output, (Ld, B, H,
    S_enc, D) each, H the heads the parameters hold (a rank's own under
    tensor parallelism): computed once per request, read every decode
    step."""
    lp = params["dec"]["layers"]
    B, S, _ = enc_out.shape
    shape = (cfg.num_layers, B, lp["cwk"].shape[2], S, cfg.head_dim)
    ck = torch.empty(shape, dtype=enc_out.dtype, device=enc_out.device)
    cv = torch.empty_like(ck)
    for i in range(cfg.num_layers):
        ck[i] = _heads(enc_out, lp["cwk"][i])
        cv[i] = _heads(enc_out, lp["cwv"][i], lp["cbv"][i])
    return ck, cv


def init_self_kv(cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """(Ld, 2, B, H, T_max, D) dense decoder self-attention cache (H:
    ``cfg``'s heads, a rank's own under tensor parallelism)."""
    return torch.zeros(
        (cfg.num_layers, 2, batch, cfg.num_heads, max_len, cfg.head_dim),
        dtype=cfg.torch_dtype, device=device)


def decode_tokens(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,         # (B, T) int: new tokens this call
    offset: Sequence[int],        # (B,): tokens already in the cache
    self_kv: torch.Tensor,        # (Ld, 2, B, H, T_max, D), updated in place
    ck: torch.Tensor,
    cv: torch.Tensor,
    valid_len: Sequence[int],     # (B,): valid prefix of ``tokens``
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the decoder over T new tokens, appending to the cache.

    Right-padded prompts are handled by ``valid_len``: the key mask bounds
    every query's reachable keys at ``offset + valid_len``, so padding K/V
    (though written to cache slots) are never attended to, and later calls
    overwrite those slots (the next call's ``offset`` is ``offset +
    valid_len``). Writes past T_max are dropped, as the reference's
    masked update drops them. ``offset`` and ``valid_len`` are the host's
    integers. Under a ``group`` the cache and ``ck``/``cv`` hold this
    rank's heads (module docstring). Returns (logits (B, T, V) float32,
    self_kv)."""
    p = params["dec"]
    dt = cfg.torch_dtype
    dev = tokens.device
    B, T = tokens.shape
    T_max = self_kv.shape[4]
    offset = [int(o) for o in offset]
    limits = [min(o + int(v), T_max) for o, v in zip(offset, valid_len)]
    kmax = max(max(limits), 1)

    # learned positions, clipped at the table's last row
    pos_idx = torch.tensor(
        [[min(o + t, cfg.max_model_len - 1) for t in range(T)]
         for o in offset], device=dev)
    # vocab-parallel where the vocabulary is cut, as the Llama stack's
    x = llama.embed_tokens(cfg, p, tokens, group) + p["pos"][pos_idx].to(dt)

    # query i may attend keys at absolute positions <= offset + i, and
    # only keys that hold REAL tokens (key_pos < offset + valid_len); one
    # new token per row at one limit sees every key up to kmax
    mask = None
    if T > 1 or len(set(limits)) > 1:
        key_pos = torch.arange(kmax, device=dev)[None, None]
        q_abs = torch.tensor(offset, device=dev)[:, None, None] + \
            torch.arange(T, device=dev)[None, :, None]
        lim = torch.tensor(limits, device=dev)[:, None, None]
        mask = ((key_pos <= q_abs) & (key_pos < lim))[:, None]  # (B,1,T,K)

    lp = p["layers"]
    h = x
    for i in range(cfg.num_layers):
        n = layer_norm(h, lp["attn_norm_w"][i], lp["attn_norm_b"][i])
        q = _col_heads(group, n, lp["wq"][i], lp["bq"][i])
        k = _col_heads(group, n, lp["wk"][i])
        v = _col_heads(group, n, lp["wv"][i], lp["bv"][i])
        # append this call's K/V at [offset, offset + T) per batch row
        for b, o in enumerate(offset):
            m = min(T, T_max - o)
            if m > 0:
                self_kv[i, 0, b, :, o:o + m] = k[b, :, :m]
                self_kv[i, 1, b, :, o:o + m] = v[b, :, :m]
        a = _attention(q, self_kv[i, 0, :, :, :kmax],
                       self_kv[i, 1, :, :, :kmax], mask)
        h = h + _merge(group, a, lp["wo"][i]) + lp["bo"][i]
        # cross-attention over the (static) encoder sequence
        nc = layer_norm(h, lp["cross_norm_w"][i], lp["cross_norm_b"][i])
        ca = _attention(_col_heads(group, nc, lp["cwq"][i], lp["cbq"][i]),
                        ck[i], cv[i])
        h = h + _merge(group, ca, lp["cwo"][i]) + lp["cbo"][i]
        h = _mlp(lp, i, h, group)
    h = layer_norm(h, p["final_norm_w"], p["final_norm_b"])
    return _logits(group, h, p["embed"], dt), self_kv
