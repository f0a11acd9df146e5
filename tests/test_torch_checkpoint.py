"""The port's local-checkpoint loader (``engine/weights.py``
``init_or_load``) against the JAX package's, on the CPU.

Each test writes a synthetic HF checkpoint in numpy, a ``config.json``
and two ``*.safetensors`` shards written with ``lora.write_safetensors``,
for tiny-llama, tiny-mixtral, tiny-qwen2, tiny-phi3 (fused qkv and
gate_up) and tiny-gemma2 (post norms, tied head), then:

- ``ModelConfig.from_hf_config`` equals the reference's on every field,
  and ``from_pretrained(dir)`` sets ``weights_path`` and ``tokenizer``;
- the port's loaded tensors equal the reference loader's exactly, in the
  model dtype and quantized on load (int8 q and scales bit for bit against
  the reference's ``maybe_quantize`` of its loaded tree);
- a checkpoint missing a tensor raises, naming it; Orbax directories and
  directories without safetensors raise;
- an engine served from the directory (``--model <dir>``) gives the JAX
  engine's greedy tokens from the same directory.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.quant import maybe_quantize
from production_stack_tpu.engine.weights import init_or_load as jax_load
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import weights as tweights
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import write_safetensors
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import (
    build_parser,
    config_from_args,
)

torch.set_num_threads(2)

HF_ARCH = {"tiny-llama": "LlamaForCausalLM",
           "tiny-mixtral": "MixtralForCausalLM",
           "tiny-qwen2": "Qwen2ForCausalLM",
           "tiny-phi3": "Phi3ForCausalLM",
           "tiny-gemma2": "Gemma2ForCausalLM"}
PRESETS = sorted(HF_ARCH)


def hf_config(preset: str) -> dict:
    """The config.json of a checkpoint with ``preset``'s geometry."""
    c = tcfg.MODEL_PRESETS[preset]
    d = {"architectures": [HF_ARCH[preset]], "hidden_size": c.hidden_size,
         "intermediate_size": c.intermediate_size,
         "num_hidden_layers": c.num_layers,
         "num_attention_heads": c.num_heads,
         "num_key_value_heads": c.num_kv_heads, "head_dim": c.head_dim,
         "vocab_size": c.vocab_size, "rope_theta": c.rope_theta,
         "rms_norm_eps": c.rms_norm_eps,
         "max_position_embeddings": c.max_model_len,
         "tie_word_embeddings": c.tie_word_embeddings}
    if c.num_experts:
        d.update(num_local_experts=c.num_experts,
                 num_experts_per_tok=c.num_experts_per_tok)
    if c.architecture == "gemma2":
        d.update(hidden_activation="gelu_pytorch_tanh",
                 query_pre_attn_scalar=64, attn_logit_softcapping=50.0,
                 final_logit_softcapping=30.0, sliding_window=512)
    return d


def _hf_shape(cfg, name: str) -> tuple:
    E, F, H, KH, D = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    module = name.split(".")[-2]
    if name.endswith(".bias"):
        return (H * D,) if module == "q_proj" else (KH * D,)
    return {"q_proj": (H * D, E), "k_proj": (KH * D, E),
            "v_proj": (KH * D, E), "o_proj": (E, H * D),
            "qkv_proj": ((H + 2 * KH) * D, E), "gate_up_proj": (2 * F, E),
            "gate_proj": (F, E), "up_proj": (F, E), "down_proj": (E, F),
            "w1": (F, E), "w3": (F, E), "w2": (E, F),
            "gate": (cfg.num_experts, E), "q_norm": (D,),
            "k_norm": (D,)}.get(module, (E,))


def write_checkpoint(root, preset: str, seed: int = 0, drop=()) -> str:
    """A synthetic HF checkpoint of ``preset`` in ``root``: every tensor
    the HF layout has, float32 from ``seed``, layers split over two
    shards; names in ``drop`` are left out."""
    cfg = tcfg.MODEL_PRESETS[preset]
    rng = np.random.default_rng(seed)
    d = os.path.join(root, preset)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config(preset), f)
    shards = [{}, {}]

    def put(shard, name, shape, scale=0.2):
        if name not in drop:
            shards[shard][name] = (rng.standard_normal(shape) * scale
                                   ).astype(np.float32)

    V, E = cfg.vocab_size, cfg.hidden_size
    put(0, "model.embed_tokens.weight", (V, E))
    put(1, "model.norm.weight", (E,), 1.0)
    if not cfg.tie_word_embeddings:
        put(1, "lm_head.weight", (V, E))
    for i in range(cfg.num_layers):
        for name in tweights._hf_key_map(cfg, i):
            put(i * 2 // cfg.num_layers, name, _hf_shape(cfg, name))
    for n, tensors in enumerate(shards):
        write_safetensors(os.path.join(
            d, f"model-{n + 1:05d}-of-00002.safetensors"), tensors)
    return d


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    return {p: write_checkpoint(root, p) for p in PRESETS}


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(MeshConfig(data=1, tensor=1))


@pytest.mark.parametrize("preset", PRESETS)
def test_from_hf_config_matches_reference(checkpoints, preset):
    hf = hf_config(preset)
    want = jcfg.ModelConfig.from_hf_config(hf, name="m")
    got = tcfg.ModelConfig.from_hf_config(hf, name="m")
    for f in tcfg.ModelConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    # the checkpoint's geometry is the preset's
    for f in ("architecture", "num_experts", "qkv_bias", "post_norms",
              "tie_word_embeddings", "query_scale", "sliding_window"):
        assert getattr(got, f) == getattr(tcfg.MODEL_PRESETS[preset], f), f
    d = checkpoints[preset]
    cfg = tcfg.ModelConfig.from_pretrained(d, dtype="float32")
    ref = jcfg.ModelConfig.from_pretrained(d, dtype="float32")
    assert cfg.weights_path == cfg.tokenizer == d == ref.weights_path
    assert cfg.name == ref.name == d


@pytest.mark.parametrize("hf", [
    # English-only vocabularies (below 51865) are refused
    {"architectures": ["WhisperForConditionalGeneration"],
     "vocab_size": 51864},
    {"architectures": ["Phi3SmallForCausalLM"], "hidden_size": 8},
    {"architectures": ["Gemma3ForCausalLM"]},
    {"architectures": ["Qwen3MoeForCausalLM"]},
    {"architectures": ["Phi3ForCausalLM"], "rope_scaling": {"type": "longrope"}},
], ids=["whisper", "phi3-small", "gemma3", "qwen3-moe", "phi3-longrope"])
def test_from_hf_config_refusals(hf):
    base = {"hidden_size": 8, "num_attention_heads": 2, "vocab_size": 16,
            "intermediate_size": 16, "num_hidden_layers": 1}
    with pytest.raises(ValueError):
        tcfg.ModelConfig.from_hf_config({**base, **hf})


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and not ("q" in v and "s" in v):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("preset", PRESETS)
def test_loader_matches_reference(checkpoints, mesh, preset, quant):
    d = checkpoints[preset]
    jc = jcfg.ModelConfig.from_pretrained(d, dtype="float32", quant=quant)
    tc = tcfg.ModelConfig.from_pretrained(d, dtype="float32", quant=quant)
    want = dict(_leaves(jax.tree.map(np.asarray, maybe_quantize(
        jc, jax_load(jc, mesh)))))
    got = dict(_leaves(tweights.init_or_load(tc, device="cpu")))
    assert set(got) == set(want)
    for name, w in want.items():
        if isinstance(w, dict):
            assert got[name]["q"].dtype == torch.int8, name
            np.testing.assert_array_equal(got[name]["q"].numpy(), w["q"],
                                          err_msg=name)
            np.testing.assert_array_equal(got[name]["s"].numpy(), w["s"],
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


@pytest.mark.parametrize("preset,missing", [
    ("tiny-llama", "model.layers.1.self_attn.v_proj.weight"),
    ("tiny-mixtral", "model.layers.0.block_sparse_moe.experts.3.w2.weight"),
    ("tiny-phi3", "model.layers.1.mlp.gate_up_proj.weight"),
    ("tiny-llama", "model.norm.weight"),
])
def test_missing_tensor_raises(tmp_path, preset, missing):
    d = write_checkpoint(str(tmp_path), preset, drop=(missing,))
    cfg = tcfg.ModelConfig.from_pretrained(d)
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        tweights.init_or_load(cfg)


def test_unloadable_directories_raise(tmp_path):
    d = write_checkpoint(str(tmp_path), "tiny-llama")
    open(os.path.join(d, "_CHECKPOINT_METADATA"), "w").close()
    with pytest.raises(ValueError, match="Orbax"):
        tweights.init_or_load(tcfg.ModelConfig.from_pretrained(d))
    empty = tmp_path / "config-only"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps(hf_config("tiny-llama")))
    with pytest.raises(ValueError, match="safetensors"):
        tweights.init_or_load(tcfg.ModelConfig.from_pretrained(str(empty)))
    with pytest.raises(ValueError, match="unknown model preset"):
        tcfg.ModelConfig.from_pretrained(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_from_checkpoint_matches_reference(checkpoints, mesh, quant):
    """``--model <dir>`` (with ``--quantization int8``) through the
    server's option parsing, served by the port's engine, against the JAX
    engine loading the same directory: greedy tokens identical up to a
    near-tie."""
    d = checkpoints["tiny-llama"]
    argv = ["--model", d, "--device", "cpu", "--max-num-seqs", "4",
            "--max-num-batched-tokens", "32", "--block-size", "4",
            "--num-blocks", "128", "--dtype", "float32"]
    if quant:
        argv += ["--quantization", quant]
    tconf = config_from_args(build_parser().parse_args(argv))
    assert tconf.model.weights_path == d and tconf.model.quant == quant
    jconf = jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained(d, dtype="float32",
                                               quant=quant),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=jcfg.SchedulerConfig(max_num_seqs=4,
                                       max_num_batched_tokens=32),
        mesh=MeshConfig(data=1, tensor=1), attention_impl="ragged")
    jeng = JaxEngine(jconf, mesh=mesh, num_blocks=128)
    teng = LLMEngine(tconf, device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True,
                        logprobs=2)
    reqs = [("a", [5, 9, 13, 2, 6], sp), ("b", list(range(1, 30)), sp)]
    want, got = drain(jeng, reqs), drain(teng, reqs)
    none = {rid: [] for rid in want[0]}
    gaps = {rid: [top[0][1] - top[1][1] for _, top in e]
            for rid, e in want[1].items()}
    assert_same((want[0], none, want[2]), (got[0], none, got[2]), gaps)
    assert sum(map(len, got[0].values())) == 20
