"""Model registry: architecture name -> model module.

Every module exposes ``param_shapes(cfg)``, ``forward_tokens(cfg, params,
tokens, positions, attend, kv_pool)`` and ``logits_from_hidden(cfg,
params, hidden)``. Mixtral, Gemma, Gemma-2 and Phi-3 run the Llama stack
(their deltas are ModelConfig knobs; Mixtral's MoE block is
``llama._moe_mlp``); Whisper is not ported yet.
"""

from __future__ import annotations

from types import ModuleType

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import llama

_REGISTRY: dict[str, ModuleType] = {
    "llama": llama,
    "mixtral": llama,
    "gemma": llama,
    "gemma2": llama,
    "phi3": llama,
}


def get_model(cfg: ModelConfig) -> ModuleType:
    try:
        return _REGISTRY[cfg.architecture]
    except KeyError:
        raise ValueError(
            f"architecture {cfg.architecture!r} is not ported yet; "
            f"known: {sorted(_REGISTRY)}"
        ) from None
