"""The port's Llama-family stack against the JAX package's, on the dense
tiny presets whose knobs the port carries (Qwen2 biases, Qwen3 QK-norm,
Gemma GeGLU and embed scale, Gemma-2 post-norms, query scale and both
softcaps, Mistral and Phi-3).

Both get the same parameters (``params_from_jax``). The JAX side runs
``forward_dense``; the port runs ``forward_tokens`` with its paged path
(``kv_write`` then ``ragged_paged_attention``, one span) and
``logits_from_hidden``. Logits agree within 1e-4: float32 throughout, the
frameworks differing only in summation order across a few layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.weights import (
    init_random,
    params_from_jax,
)
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.registry import get_model
from production_stack_tpu_torch.ops.kv_write import kv_write
from production_stack_tpu_torch.ops.paged_attention import combine_kv
from production_stack_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention,
)

torch.set_num_threads(2)

PRESETS = ["tiny-llama", "tiny-qwen2", "tiny-qwen3", "tiny-gemma",
           "tiny-gemma2", "tiny-mistral", "tiny-phi3"]
BS = 4


def paged_attend(cfg, S):
    """One span of S tokens through the port's paged path."""
    M = -(-S // BS)
    tables = torch.arange(M, dtype=torch.int32)[None]
    cu = torch.tensor([0, S], dtype=torch.int32)
    ctx = torch.tensor([S], dtype=torch.int32)
    slots = torch.arange(S, dtype=torch.int32)

    def attend(q, k, v, pool, layer):
        kv_write(pool, combine_kv(k, v), slots, layer)
        out = ragged_paged_attention(q, pool, tables, cu, ctx, layer,
                                     soft_cap=cfg.attn_logit_softcap)
        return out, pool

    pool = torch.zeros((cfg.num_layers, M, BS, 2 * cfg.num_kv_heads,
                        cfg.head_dim))
    return attend, pool


@pytest.mark.parametrize("preset", PRESETS)
def test_forward_matches_jax(preset):
    jc = jcfg.ModelConfig.from_pretrained(preset)
    tc = tcfg.ModelConfig.from_pretrained(preset)
    jparams = jllama.init_params(jc, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jax.device_get(jparams))
    # perturb the norm weights so the offset / (1 + w) paths are exercised
    rng = np.random.default_rng(0)
    for tree in (np_params, np_params["layers"]):
        for name, w in tree.items():
            if "norm" in name:
                tree[name] = (w + 0.1 * rng.standard_normal(w.shape)
                              ).astype(np.float32)
    S = 11
    tokens = rng.integers(0, tc.vocab_size, S).astype(np.int32)
    want = np.asarray(jllama.forward_dense(
        jc, jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens[None])))[0]

    params = params_from_jax(np_params, tc, "cpu")
    attend, pool = paged_attend(tc, S)
    hidden, _ = llama.forward_tokens(
        tc, params, torch.from_numpy(tokens), torch.arange(S), attend, pool)
    got = llama.logits_from_hidden(tc, params, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_param_shapes_match_reference_specs():
    for preset in PRESETS:
        jc = jcfg.ModelConfig.from_pretrained(preset)
        tc = tcfg.ModelConfig.from_pretrained(preset)
        specs = jllama.param_specs(jc)
        shapes = llama.param_shapes(tc)
        assert set(shapes) == set(specs)
        assert set(shapes["layers"]) == set(specs["layers"])
        jp = jax.eval_shape(lambda: jllama.init_params(jc, jax.random.key(0)))
        for name, shape in shapes["layers"].items():
            assert tuple(jp["layers"][name].shape) == shape, (preset, name)


def test_init_random_is_seeded_and_scaled():
    cfg = tcfg.ModelConfig.from_pretrained("tiny-gemma")
    a = init_random(cfg, seed=3)
    b = init_random(cfg, seed=3)
    c = init_random(cfg, seed=4)
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    # Gemma stores zero-centred norms: the effective scale (offset + w) is 1
    assert torch.all(a["final_norm"] + cfg.norm_offset == 1)
    std = a["layers"]["wq"].std().item()
    assert std == pytest.approx(cfg.hidden_size ** -0.5, rel=0.1)


def test_registry_refuses_unported_architectures():
    """The registry serves every architecture of the reference: Whisper
    runs its encoder-decoder module, Mixtral the Llama stack with its MoE
    block. An architecture neither package has is refused."""
    from production_stack_tpu.models.registry import _REGISTRY as ref
    from production_stack_tpu_torch.models import whisper

    cfg = tcfg.ModelConfig.from_pretrained("tiny-whisper")
    assert get_model(cfg) is whisper
    assert get_model(tcfg.ModelConfig(architecture="mixtral")) is llama
    for arch in ref:
        assert get_model(tcfg.ModelConfig(architecture=arch)).__name__ \
            .rsplit(".", 1)[1] == ref[arch].__name__.rsplit(".", 1)[1]
    with pytest.raises(ValueError, match="unknown architecture"):
        get_model(tcfg.ModelConfig(architecture="mamba"))
