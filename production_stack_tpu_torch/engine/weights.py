"""Model parameters: seeded random init on the device, local HF
safetensors checkpoints, and conversion of the JAX package's parameters.

Random init allocates every tensor on the target device and fills it
with a seeded ``torch.Generator``, one slice at a time (a layer; a layer's
expert): filling 8B parameters on the host and copying them over would
take tens of seconds. Values follow the reference's scheme (normal /
sqrt(fan_in), norms at an effective scale of 1) but not its random
stream. With ``cfg.quant`` each slice is made in the model dtype and
quantized into a preallocated int8 stack, so the model never exists in
bf16 whole (mixtral-8x7b is 93 GB in bf16, 47 GB in int8), and the int8
model is exactly the quantization of the bf16 one of the same seed.

Checkpoints load through the reference's HF key maps and conversions
(``_hf_key_map``, ``_convert``: the Llama and Mixtral families, Qwen2/3
biases and norms, Gemma-2's norms, Phi-3's fused layouts;
``_whisper_block_map`` for WhisperForConditionalGeneration), read by this
package's own safetensors reader (``lora.SafetensorsFile``). Tensors go
to the device one at a time, into preallocated stacks, quantized on load
when ``cfg.quant`` is set; the reference stacks every layer on the host
first. Orbax checkpoints are not ported.

Under tensor parallelism each entry point takes ``(rank, tp)`` and
returns rank's shard (parallel/shardings.Shard, driven by each leaf's
logical axes, ``models/llama.param_specs``): every slice or tensor is
made, converted or read whole, as at tp = 1, and only the rank's part of
it is kept. With ``cfg.quant`` the whole slice is quantized before the
cut, so a row-parallel weight's scale is the max over its whole
contraction, which no rank's part holds (``Shard.cut_leaf`` keeps the
scale whole along it). So a rank's seeded shard, quantized or not, is
bit for bit the slice of the tp = 1 parameters, and its peak is one
slice above its shard (one layer, or the embedding). On the seq x tensor
grid ``rank`` is the process's tensor rank: the seq ranks of one tensor
rank make, load or cut the same shard.

Under pipeline parallelism each entry point takes ``stage=(s, S)`` and
returns stage s's share (``stage_layers``, ``stage_keeps``): the layers
``[s L/S, (s+1) L/S)``, the embedding at stage 0, the final norm and the
LM head (a tied model's embedding) at the last stage. Seeded init still
draws every slice of the whole model in order, so a stage's share is bit
for bit the slice of the whole; the loader reads only the stage's
tensors; ``stage_params`` cuts a whole dict. ``L % S != 0`` raises.

Whisper's parameters are a nested ``enc`` / ``dec`` tree
(``models/whisper.param_shapes``), made by ``whisper.init_params``; its
conv weights are ``(out, in, k)``, so the reference's ``(k, in, out)``
are transposed on conversion and an HF checkpoint's are taken as they
are. Under tensor parallelism a rank makes or loads the whole tree (3.1
GB at whisper-large-v3-class in bf16) and keeps its cut
(``shard_params``, by ``whisper.param_specs``), so its shard is bit for
bit the slice of the tp = 1 parameters.
"""

from __future__ import annotations

import glob
import itertools
import os

import numpy as np
import torch

from production_stack_tpu_torch.engine import quant
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.lora import SafetensorsFile
from production_stack_tpu_torch.models.registry import get_model
from production_stack_tpu_torch.parallel.shardings import Shard

# fan-in of each weight: the number of inputs one output sums over
_FAN_IN = {
    "wq": "E", "wk": "E", "wv": "E", "wo": "HD", "bq": "E", "bk": "E",
    "bv": "E", "w_gate": "E", "w_up": "E", "w_down": "F", "embed": "E",
    "lm_head": "E", "router": "E",
}
_NORMS = ("attn_norm", "mlp_norm", "q_norm", "k_norm", "post_attn_norm",
          "post_mlp_norm", "final_norm")
# Whisper's convs: (k, in, out) in the reference, (out, in, k) here
_CONV_WEIGHTS = ("conv1_w", "conv2_w")


def _quant_axes(cfg: ModelConfig) -> dict:
    """Leaf name -> contracted axes of each leaf ``cfg.quant`` quantizes
    (none without it), in the stacked layout."""
    if not cfg.quant:
        return {}
    if cfg.quant != "int8":
        raise ValueError(f"unsupported quantization mode: {cfg.quant!r}")
    return {**quant.contract_axes(cfg), **quant.TOP_CONTRACT}


class _Leaf:
    """A parameter under construction on the device: a stack in the model
    dtype, or the int8 and scale stacks of a quantized one, filled a
    slice at a time."""

    def __init__(self, shape: tuple, dtype, device, axes=None):
        self.axes = axes
        self.value = (torch.empty(shape, dtype=dtype, device=device)
                      if axes is None
                      else quant.empty_quantized(shape, axes, device))

    def put(self, idx: tuple, t: torch.Tensor, cut=None) -> None:
        """Write slice ``idx`` (leading indices) from ``t`` in the model
        dtype, quantizing it over the leaf's contracted axes; ``cut``
        (``Shard.cut_leaf`` at the slice's axes) keeps a rank's part of
        ``t``, after the quantization of the whole of it."""
        if self.axes is None:
            self.value[idx] = t if cut is None else cut(t)
        else:
            quant.put_quantized(self.value, idx, t, self.axes, cut)


def _slices(name: str, shape: tuple, layer: bool) -> list:
    """The slices a leaf is made in: each layer, and each layer's expert
    for an expert stack (rank 4 below the layer axis: (L, X, E, F))."""
    if not layer:
        return [()]
    lead = shape[:2] if name in ("w_gate", "w_up", "w_down") and len(
        shape) == 4 else shape[:1]
    return list(itertools.product(*(range(d) for d in lead)))


def _shard(cfg: ModelConfig, rank: int, tp: int):
    """Rank's Shard and the model's logical axes (None, None at tp 1)."""
    if tp == 1:
        return None, None
    return Shard.of(cfg, rank, tp), get_model(cfg).param_specs(cfg)


def _cutter(shard, spec, skip: int = 0):
    """The ``cut`` of ``_Leaf.put`` for a slice that drops the first
    ``skip`` axes of ``spec``; None without a shard."""
    if shard is None:
        return None
    return lambda x: shard.cut_leaf(x, spec[skip:])


def _local_shape(shape: tuple, axes: tuple, shard) -> tuple:
    if shard is None:
        return tuple(shape)
    return tuple(shard.local(a, n) for a, n in zip(axes, shape))


def stage_layers(cfg: ModelConfig, stage: tuple = (0, 1)) -> range:
    """The layers stage ``s`` of ``S`` holds: ``[s L/S, (s+1) L/S)``."""
    s, S = stage
    L = cfg.num_layers
    if L % S:
        raise ValueError(f"{cfg.name}: {L} layers not divisible by {S} "
                         "pipeline stages")
    if not 0 <= s < S:
        raise ValueError(f"stage {s} of {S}")
    n = L // S
    return range(s * n, (s + 1) * n)


def stage_keeps(cfg: ModelConfig, name: str, stage: tuple = (0, 1)) -> bool:
    """Whether stage ``s`` of ``S`` holds the top-level leaf ``name``: the
    embedding at the first stage, the final norm and the LM head (a tied
    model's embedding) at the last."""
    s, S = stage
    if name == "embed":
        return s == 0 or (s == S - 1 and cfg.tie_word_embeddings)
    if name in ("final_norm", "lm_head"):
        return s == S - 1
    return True


def _layer_cut(x, layers: range):
    """Layers ``layers`` of a stacked leaf, quantized or not (views)."""
    if isinstance(x, dict):
        return {k: v[layers.start:layers.stop] for k, v in x.items()}
    return x[layers.start:layers.stop]


def stage_params(params: dict, cfg: ModelConfig,
                 stage: tuple = (0, 1)) -> dict:
    """Stage ``(s, S)``'s share of a whole parameter dict (quantized or
    not), as views of it."""
    layers = stage_layers(cfg, stage)
    out = {name: v for name, v in params.items()
           if name != "layers" and stage_keeps(cfg, name, stage)}
    out["layers"] = {name: _layer_cut(v, layers)
                     for name, v in params["layers"].items()}
    return out


def _check_stage(cfg: ModelConfig, stage: tuple) -> None:
    if stage != (0, 1) and cfg.architecture == "whisper":
        raise ValueError(f"{cfg.name}: Whisper is not served under "
                         "pipeline parallelism")


def init_random(cfg: ModelConfig, seed: int = 0,
                device: torch.device | str = "cpu", rank: int = 0,
                tp: int = 1, stage: tuple = (0, 1)) -> dict:
    """Random parameters, made on ``device`` from ``seed``, quantized
    slice by slice when ``cfg.quant`` is set; rank's shard of them at
    ``tp`` > 1 (each slice made whole, as at tp 1, and cut); ``stage``'s
    share of them (every slice drawn, the stage's kept)."""
    _check_stage(cfg, stage)
    if cfg.architecture == "whisper":
        # the whole tree from one stream, then rank's cut of it
        return shard_params(get_model(cfg).init_params(cfg, seed, device),
                            cfg, rank, tp)
    shard, specs = _shard(cfg, rank, tp)
    shapes = get_model(cfg).param_shapes(cfg)
    dt = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fan = {"E": cfg.hidden_size, "HD": cfg.num_heads * cfg.head_dim,
           "F": cfg.intermediate_size}
    # Gemma stores zero-centred norm weights (the forward adds norm_offset)
    norm_one = 1.0 - cfg.norm_offset
    axes = _quant_axes(cfg)
    kept = stage_layers(cfg, stage)

    def make(name: str, shape: tuple, layer: bool, spec=None, keep=True):
        """The leaf, or None where the stage does not keep it (its slices
        are drawn all the same, so the next leaf's stream is the whole
        model's)."""
        whole = shape
        if layer:
            shape = (len(kept), *shape[1:])
        local = _local_shape(shape, spec, shard)
        if name in _NORMS:
            return (torch.full(local, norm_one, dtype=dt, device=device)
                    if keep else None)
        leaf = _Leaf(local, dt, device, axes.get(name)) if keep else None
        std = fan[_FAN_IN[name]] ** -0.5
        for idx in _slices(name, whole, layer):
            t = torch.empty(whole[len(idx):], dtype=dt, device=device)
            t.normal_(0.0, std, generator=gen)
            if leaf is None or (layer and idx[0] not in kept):
                continue
            if layer:
                idx = (idx[0] - kept.start, *idx[1:])
            leaf.put(idx, t, _cutter(shard, spec, len(idx)))
        return None if leaf is None else leaf.value

    lspecs = specs and specs["layers"]
    params = {name: make(name, shape, False, specs and specs[name],
                         stage_keeps(cfg, name, stage))
              for name, shape in shapes.items() if name != "layers"}
    params = {name: v for name, v in params.items() if v is not None}
    params["layers"] = {name: make(name, shape, True, lspecs and lspecs[name])
                        for name, shape in shapes["layers"].items()}
    return params


def to_device(params: dict, device) -> dict:
    """A parameter dict (quantized leaves included) moved to ``device``."""
    return {k: (to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in params.items()}


def params_from_jax(np_tree: dict, cfg: ModelConfig,
                    device: torch.device | str = "cpu", rank: int = 0,
                    tp: int = 1, stage: tuple = (0, 1)) -> dict:
    """The JAX package's parameter tree, as numpy arrays, to this
    package's parameter dict (same names and shapes), so both compute the
    same function; rank's shard of it at ``tp`` > 1, ``stage``'s share of
    it under pipeline parallelism. Quantized leaves ``{"q": int8, "s":
    float32}`` (the JAX engine's int8 tree) keep their dtypes and are cut
    as ``Shard.cut_leaf`` cuts them; Whisper's conv weights are transposed
    to ``(out, in, k)``."""
    _check_stage(cfg, stage)
    shard, specs = _shard(cfg, rank, tp)
    if stage != (0, 1):
        np_tree = stage_params(np_tree, cfg, stage)

    def conv(name: str, x, shape: tuple, spec=None):
        if isinstance(x, dict):
            q = np.asarray(x["q"])
            s = np.asarray(x["s"], np.float32)
            if q.dtype != np.int8 or q.shape != tuple(shape):
                raise ValueError(f"{name}: quantized {q.dtype} {q.shape} "
                                 f"!= int8 {shape}")
            # laid out as quantize_array lays q out: contracted axes fastest
            axes = quant.scale_axes({"q": q, "s": s})
            if shard is not None:
                cut = shard.cut_leaf({"q": q, "s": s}, spec)
                q, s = cut["q"], cut["s"]
            out = quant.empty_q(q.shape, axes, device)
            out.copy_(torch.from_numpy(np.array(q)))
            return {"q": out, "s": torch.from_numpy(np.array(s)).to(device)}
        a = np.asarray(x, dtype=np.float32)
        if name in _CONV_WEIGHTS:
            a = a.transpose(2, 1, 0)
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape} != expected {shape}")
        if shard is not None:
            a = shard.cut(a, spec)
        return torch.from_numpy(a.copy()).to(device=device,
                                              dtype=cfg.torch_dtype)

    def walk(tree: dict, shapes: dict, spec: dict) -> dict:
        return {name: walk(tree[name], shape, spec and spec[name])
                if isinstance(shape, dict)
                else conv(name, tree[name], shape, spec and spec[name])
                for name, shape in shapes.items()}

    return walk(np_tree, _shapes(cfg, stage), specs)


def _shapes(cfg: ModelConfig, stage: tuple) -> dict:
    """``param_shapes`` of ``stage``'s share: the leaves it keeps, at its
    layer count."""
    shapes = get_model(cfg).param_shapes(cfg)
    if stage == (0, 1):
        return shapes
    n = len(stage_layers(cfg, stage))
    out = {k: v for k, v in shapes.items()
           if k != "layers" and stage_keeps(cfg, k, stage)}
    out["layers"] = {k: (n, *v[1:]) for k, v in shapes["layers"].items()}
    return out


def init_or_load(cfg: ModelConfig, seed: int = 0,
                 device: torch.device | str = "cpu", rank: int = 0,
                 tp: int = 1, stage: tuple = (0, 1)) -> dict:
    """``cfg.weights_path``'s safetensors checkpoint, or random
    parameters from ``seed`` without one; rank's shard at ``tp`` > 1,
    ``stage``'s share under pipeline parallelism."""
    if not cfg.weights_path:
        return init_random(cfg, seed, device, rank, tp, stage)
    path = cfg.weights_path
    if path.startswith("gs://") or os.path.isfile(
            os.path.join(path, "_CHECKPOINT_METADATA")):
        raise ValueError(f"{path}: Orbax checkpoints are not ported yet "
                         "(ROADMAP.md); convert to safetensors")
    if not glob.glob(os.path.join(path, "*.safetensors")):
        raise ValueError(f"{path}: no *.safetensors files to load")
    return load_safetensors(cfg, device, rank, tp, stage)


# --- HF checkpoint mapping (a copy of the reference's) ----------------------

def _hf_key_map(cfg: ModelConfig, i: int) -> dict:
    """HF tensor name -> (our layer param name, reshape rule) for layer i.
    A value may also be a LIST of (name, rule) pairs when one HF tensor
    feeds several of our params (Phi-3's fused projections)."""
    m = {
        f"model.layers.{i}.input_layernorm.weight": ("attn_norm", "copy"),
        f"model.layers.{i}.self_attn.q_proj.weight": ("wq", "proj_q"),
        f"model.layers.{i}.self_attn.k_proj.weight": ("wk", "proj_kv"),
        f"model.layers.{i}.self_attn.v_proj.weight": ("wv", "proj_kv"),
        f"model.layers.{i}.self_attn.o_proj.weight": ("wo", "proj_o"),
        f"model.layers.{i}.post_attention_layernorm.weight": ("mlp_norm", "copy"),
    }
    if cfg.architecture == "phi3":
        # fused layouts: qkv_proj rows are [q | k | v], gate_up_proj rows
        # are [gate | up]
        for key in (f"model.layers.{i}.self_attn.q_proj.weight",
                    f"model.layers.{i}.self_attn.k_proj.weight",
                    f"model.layers.{i}.self_attn.v_proj.weight"):
            del m[key]
        m[f"model.layers.{i}.self_attn.qkv_proj.weight"] = [
            ("wq", "fused_q"), ("wk", "fused_k"), ("wv", "fused_v"),
        ]
        m[f"model.layers.{i}.mlp.gate_up_proj.weight"] = [
            ("w_gate", "fused_gate"), ("w_up", "fused_up"),
        ]
        m[f"model.layers.{i}.mlp.down_proj.weight"] = ("w_down", "t")
    if cfg.qk_norm:  # Qwen3
        m[f"model.layers.{i}.self_attn.q_norm.weight"] = ("q_norm", "copy")
        m[f"model.layers.{i}.self_attn.k_norm.weight"] = ("k_norm", "copy")
    if cfg.post_norms:
        # Gemma-2 block: HF "post_attention_layernorm" is the norm on the
        # attention output (our post_attn_norm); the pre-MLP norm is
        # "pre_feedforward_layernorm" and the MLP output norm
        # "post_feedforward_layernorm"
        m[f"model.layers.{i}.post_attention_layernorm.weight"] = (
            "post_attn_norm", "copy")
        m[f"model.layers.{i}.pre_feedforward_layernorm.weight"] = (
            "mlp_norm", "copy")
        m[f"model.layers.{i}.post_feedforward_layernorm.weight"] = (
            "post_mlp_norm", "copy")
    if cfg.qkv_bias:  # Qwen2 family
        m[f"model.layers.{i}.self_attn.q_proj.bias"] = ("bq", "bias_q")
        m[f"model.layers.{i}.self_attn.k_proj.bias"] = ("bk", "bias_kv")
        m[f"model.layers.{i}.self_attn.v_proj.bias"] = ("bv", "bias_kv")
    if cfg.architecture == "mixtral" and cfg.num_experts > 0:
        m[f"model.layers.{i}.block_sparse_moe.gate.weight"] = ("router", "t")
        for x in range(cfg.num_experts):
            m[f"model.layers.{i}.block_sparse_moe.experts.{x}.w1.weight"] = (f"w_gate.{x}", "t")
            m[f"model.layers.{i}.block_sparse_moe.experts.{x}.w3.weight"] = (f"w_up.{x}", "t")
            m[f"model.layers.{i}.block_sparse_moe.experts.{x}.w2.weight"] = (f"w_down.{x}", "t")
    elif cfg.architecture != "phi3":  # phi3's MLP keys are set above
        m[f"model.layers.{i}.mlp.gate_proj.weight"] = ("w_gate", "t")
        m[f"model.layers.{i}.mlp.up_proj.weight"] = ("w_up", "t")
        m[f"model.layers.{i}.mlp.down_proj.weight"] = ("w_down", "t")
    return m


def _convert(name_rule: str, w: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    H, KH, D, E = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    if name_rule == "copy":
        return w
    if name_rule == "t":  # HF linear stores (out, in); we use (in, out)
        return w.T
    if name_rule == "proj_q":  # (H*D, E) -> (E, H, D)
        return w.reshape(H, D, E).transpose(2, 0, 1)
    if name_rule == "proj_kv":  # (KH*D, E) -> (E, KH, D)
        return w.reshape(KH, D, E).transpose(2, 0, 1)
    if name_rule == "proj_o":  # (E, H*D) -> (H, D, E)
        return w.reshape(E, H, D).transpose(1, 2, 0)
    if name_rule == "bias_q":  # (H*D,) -> (H, D)
        return w.reshape(H, D)
    if name_rule == "bias_kv":  # (KH*D,) -> (KH, D)
        return w.reshape(KH, D)
    # Phi-3 fused layouts: qkv_proj rows [q | k | v], gate_up [gate | up]
    if name_rule == "fused_q":
        return _convert("proj_q", w[: H * D], cfg)
    if name_rule == "fused_k":
        return _convert("proj_kv", w[H * D : H * D + KH * D], cfg)
    if name_rule == "fused_v":
        return _convert("proj_kv", w[H * D + KH * D :], cfg)
    if name_rule == "fused_gate":
        return w[: w.shape[0] // 2].T
    if name_rule == "fused_up":
        return w[w.shape[0] // 2 :].T
    raise ValueError(name_rule)


def load_safetensors(cfg: ModelConfig,
                     device: torch.device | str = "cpu", rank: int = 0,
                     tp: int = 1, stage: tuple = (0, 1)) -> dict:
    """``cfg.weights_path``'s ``*.safetensors`` files to this package's
    parameter dict on ``device``: each tensor is read, converted, moved to
    the device and (with ``cfg.quant``) quantized on its own, into stacks
    allocated up front; at ``tp`` > 1 each converted tensor is cut to
    rank's shard before it moves; under pipeline parallelism only
    ``stage``'s tensors are read. A tensor the model needs and the
    checkpoint lacks raises ``KeyError`` naming it."""
    _check_stage(cfg, stage)
    files = [SafetensorsFile(f) for f in sorted(
        glob.glob(os.path.join(cfg.weights_path, "*.safetensors")))]
    index = {name: f for f in files for name in f.keys()}

    def get(name: str) -> np.ndarray:
        if name not in index:
            raise KeyError(f"{cfg.weights_path}: the checkpoint has no "
                           f"tensor {name!r}")
        return index[name].get(name)

    shapes = get_model(cfg).param_shapes(cfg)
    dt = cfg.torch_dtype
    shard, specs = _shard(cfg, rank, tp)

    def dev(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=dt)

    if cfg.architecture == "whisper":
        return shard_params(_load_whisper(cfg, shapes, get, dev, device),
                            cfg, rank, tp)
    axes = _quant_axes(cfg)

    def whole(name: str, arr: np.ndarray):
        spec = specs and specs[name]
        leaf = _Leaf(_local_shape(shapes[name], spec, shard), dt, device,
                     axes.get(name))
        leaf.put((), dev(arr), _cutter(shard, spec))
        return leaf.value

    params = {}
    if stage_keeps(cfg, "embed", stage):
        params["embed"] = whole("embed", get("model.embed_tokens.weight"))
    if stage_keeps(cfg, "final_norm", stage):
        params["final_norm"] = dev(get("model.norm.weight"))
    if not cfg.tie_word_embeddings and stage_keeps(cfg, "lm_head", stage):
        head = ("lm_head.weight" if "lm_head.weight" in index
                else "model.embed_tokens.weight")
        params["lm_head"] = whole("lm_head", get(head).T)
    lspecs = specs and specs["layers"]
    kept = stage_layers(cfg, stage)
    layers = {name: _Leaf(_local_shape((len(kept), *shape[1:]),
                                       lspecs and lspecs[name], shard),
                          dt, device, axes.get(name))
              for name, shape in shapes["layers"].items()}
    for i in kept:
        for hf_name, targets in _hf_key_map(cfg, i).items():
            src = get(hf_name)
            for ours, rule in (targets if isinstance(targets, list)
                               else [targets]):
                base, _, expert = ours.partition(".")
                j = i - kept.start
                idx = (j, int(expert)) if expert else (j,)
                layers[base].put(idx, dev(_convert(rule, src, cfg)),
                                 _cutter(shard, lspecs and lspecs[base],
                                         len(idx)))
    params["layers"] = {name: leaf.value for name, leaf in layers.items()}
    return params


def _whisper_block_map(prefix: str, i: int, cross: bool) -> dict:
    """HF Whisper layer tensor names -> (ours, rule) for one block.
    ``prefix`` is ``model.encoder.layers`` / ``model.decoder.layers``."""
    b = f"{prefix}.{i}"
    m = {
        f"{b}.self_attn_layer_norm.weight": ("attn_norm_w", "copy"),
        f"{b}.self_attn_layer_norm.bias": ("attn_norm_b", "copy"),
        f"{b}.self_attn.q_proj.weight": ("wq", "proj_q"),
        f"{b}.self_attn.q_proj.bias": ("bq", "bias_q"),
        f"{b}.self_attn.k_proj.weight": ("wk", "proj_q"),  # H == KH
        f"{b}.self_attn.v_proj.weight": ("wv", "proj_q"),
        f"{b}.self_attn.v_proj.bias": ("bv", "bias_q"),
        f"{b}.self_attn.out_proj.weight": ("wo", "proj_o"),
        f"{b}.self_attn.out_proj.bias": ("bo", "copy"),
        f"{b}.final_layer_norm.weight": ("mlp_norm_w", "copy"),
        f"{b}.final_layer_norm.bias": ("mlp_norm_b", "copy"),
        f"{b}.fc1.weight": ("fc1", "t"),
        f"{b}.fc1.bias": ("fc1_b", "copy"),
        f"{b}.fc2.weight": ("fc2", "t"),
        f"{b}.fc2.bias": ("fc2_b", "copy"),
    }
    if cross:
        m.update({
            f"{b}.encoder_attn_layer_norm.weight": ("cross_norm_w", "copy"),
            f"{b}.encoder_attn_layer_norm.bias": ("cross_norm_b", "copy"),
            f"{b}.encoder_attn.q_proj.weight": ("cwq", "proj_q"),
            f"{b}.encoder_attn.q_proj.bias": ("cbq", "bias_q"),
            f"{b}.encoder_attn.k_proj.weight": ("cwk", "proj_q"),
            f"{b}.encoder_attn.v_proj.weight": ("cwv", "proj_q"),
            f"{b}.encoder_attn.v_proj.bias": ("cbv", "bias_q"),
            f"{b}.encoder_attn.out_proj.weight": ("cwo", "proj_o"),
            f"{b}.encoder_attn.out_proj.bias": ("cbo", "copy"),
        })
    return m


def _load_whisper(cfg: ModelConfig, shapes: dict, get, dev, device) -> dict:
    """WhisperForConditionalGeneration safetensors to the nested tree, a
    tensor at a time into stacks allocated on the device. The encoder's
    sinusoidal ``embed_positions`` and the tied ``proj_out`` are not
    loaded (computed and tied in models/whisper.py); HF's conv weights are
    ``(out, in, k)`` already."""

    def stack(prefix: str, n: int, cross: bool, block: dict) -> dict:
        out = {name: torch.empty(shape, dtype=cfg.torch_dtype, device=device)
               for name, shape in block.items()}
        for i in range(n):
            for hf_name, (ours, rule) in _whisper_block_map(
                    prefix, i, cross).items():
                out[ours][i] = dev(_convert(rule, get(hf_name), cfg))
        return out

    def top(tree: dict, ours: str, hf_name: str) -> torch.Tensor:
        arr = get(hf_name)
        if arr.shape != tuple(tree[ours]):
            raise ValueError(f"{cfg.weights_path}: {hf_name} has shape "
                             f"{arr.shape}, the model needs {tree[ours]}")
        return dev(arr)

    enc, dec = shapes["enc"], shapes["dec"]
    e, d = "model.encoder", "model.decoder"
    return {
        "enc": {
            "conv1_w": top(enc, "conv1_w", f"{e}.conv1.weight"),
            "conv1_b": top(enc, "conv1_b", f"{e}.conv1.bias"),
            "conv2_w": top(enc, "conv2_w", f"{e}.conv2.weight"),
            "conv2_b": top(enc, "conv2_b", f"{e}.conv2.bias"),
            "layers": stack(f"{e}.layers", cfg.encoder_layers, False,
                            enc["layers"]),
            "final_norm_w": top(enc, "final_norm_w", f"{e}.layer_norm.weight"),
            "final_norm_b": top(enc, "final_norm_b", f"{e}.layer_norm.bias"),
        },
        "dec": {
            "embed": top(dec, "embed", f"{d}.embed_tokens.weight"),
            "pos": top(dec, "pos", f"{d}.embed_positions.weight"),
            "layers": stack(f"{d}.layers", cfg.num_layers, True,
                            dec["layers"]),
            "final_norm_w": top(dec, "final_norm_w", f"{d}.layer_norm.weight"),
            "final_norm_b": top(dec, "final_norm_b", f"{d}.layer_norm.bias"),
        },
    }


def shard_params(params: dict, cfg: ModelConfig, rank: int, tp: int) -> dict:
    """Rank's shard of a whole parameter dict, as copies (the whole dict
    can go once every rank has cut its own): contiguous, or an int8 q laid
    out as ``quant.empty_q`` lays it out; the dict itself at tp 1. A
    quantized dict is cut as it is (``Shard.cut_leaf``), so quantize the
    whole dict first: a rank's part of a row-parallel weight lacks the
    rest of its scale's max."""
    shard, specs = _shard(cfg, rank, tp)
    if shard is None:
        return params

    def copy(v, spec):
        if not quant.is_quantized(v):
            return shard.cut(v, spec).clone(
                memory_format=torch.contiguous_format)
        cut = shard.cut_leaf(v, spec)
        q = quant.empty_q(cut["q"].shape, quant.scale_axes(v), v["q"].device)
        q.copy_(cut["q"])
        return {"q": q, "s": cut["s"].clone(
            memory_format=torch.contiguous_format)}

    def walk(tree: dict, spec: dict) -> dict:
        return {name: walk(v, spec[name])
                if isinstance(v, dict) and not quant.is_quantized(v)
                else copy(v, spec[name]) for name, v in tree.items()}

    return walk(params, specs)
