"""Model registry: architecture name -> model module.

Every module exposes ``param_shapes(cfg)``. The decoder-only stack
(``llama``) also exposes ``forward_tokens(cfg, params, tokens, positions,
attend, kv_pool)`` and ``logits_from_hidden(cfg, params, hidden)``;
Mixtral, Gemma, Gemma-2 and Phi-3 run it (their deltas are ModelConfig
knobs; Mixtral's MoE block is ``llama._moe_mlp``). Whisper's
encoder-decoder (``whisper``: ``init_params``, ``encode``, ``cross_kv``,
``decode_tokens``) is driven by ``engine/whisper_runner.py``.
"""

from __future__ import annotations

from types import ModuleType

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import llama, whisper

_REGISTRY: dict[str, ModuleType] = {
    "llama": llama,
    "mixtral": llama,
    "gemma": llama,
    "gemma2": llama,
    "phi3": llama,
    "whisper": whisper,
}


def get_model(cfg: ModelConfig) -> ModuleType:
    try:
        return _REGISTRY[cfg.architecture]
    except KeyError:
        raise ValueError(
            f"unknown architecture {cfg.architecture!r}; "
            f"known: {sorted(_REGISTRY)}"
        ) from None
