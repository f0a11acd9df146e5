"""The port's Mixtral MoE block (``models/llama.py`` ``_moe_mlp``) against
the JAX package's, on the CPU.

- The block on tiny-mixtral's layer 0, float32 and int8 (W8A8 and
  W8A16), at the token count the reference's call sees (``ref_tokens``)
  and below it: the reference runs the ``ref_tokens`` rows (the port's
  rows, then pad rows), the port only its own; the port's rows agree
  within atol 2e-5.
- Forced drops: ``num_experts = 8`` and a router biased so that most
  tokens pick expert 0. The capacity ``C = max(int(2 T k / X), k)``
  follows the reference's T, above the port's rows, and exactly the
  slots the reference drops are dropped.
- Ties between experts go to the lower index, as ``lax.top_k``'s do.
- LoRA on a MoE model: attention targets apply, MLP targets are ignored,
  as in the reference (its ``_mlp`` skips them); the port's engine gives
  the JAX engine's tokens with such an adapter.
- Engines: tiny-mixtral float32, the port against the JAX engine on the
  ragged and the bucketed path: greedy tokens identical up to a near-tie
  (top-2 gap under 1e-4), logprobs within 1e-4.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from _torch_parity import assert_same, drain
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine import quant as jq
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.weights import init_or_load as jax_init
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.models import llama
from test_torch_lora import make_adapter_dir

torch.set_num_threads(2)

ATOL = 2e-5


def _configs(**kw):
    return (dataclasses.replace(
                jcfg.ModelConfig.from_pretrained("tiny-mixtral"), **kw),
            dataclasses.replace(
                tcfg.ModelConfig.from_pretrained("tiny-mixtral"), **kw))


def _layer0(jc, tc, mode, router_bias=0.0):
    """Layer 0's parameters on both sides: (JAX, port)."""
    params = jllama.init_params(jc, jax.random.key(0))
    if router_bias:
        # input feature 0 pushes every token toward expert 0
        params["layers"]["router"] = params["layers"]["router"].at[
            :, 0, 0].add(router_bias)
    if mode == "int8":
        params = jq.quantize_params(jc, params)
    np_params = jax.tree.map(np.asarray, params)
    tp = params_from_jax(np_params, tc)
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["layers"])
    tl = {k: llama._layer(v, 0) for k, v in tp["layers"].items()}
    return jl, tl


def _both(jc, tc, jl, tl, x, rows):
    """The reference's block over all of ``x`` (its ref_tokens rows), the
    port's over the first ``rows`` with ref_tokens = len(x)."""
    want = np.asarray(jax.jit(lambda a: jllama._moe_mlp(jc, jl, a))(
        jnp.asarray(x)))[:rows]
    got = llama._moe_mlp(tc, tl, torch.from_numpy(x[:rows]), len(x))
    return want, got.numpy()


@pytest.mark.parametrize("mode", ["float32", "int8"])
@pytest.mark.parametrize("rows,ref_tokens", [(37, 37), (37, 64), (40, 1024),
                                             (600, 600)])
def test_moe_mlp_matches_reference(mode, rows, ref_tokens):
    jc, tc = _configs()
    jl, tl = _layer0(jc, tc, mode)
    rng = np.random.default_rng(rows + ref_tokens)
    x = rng.standard_normal((ref_tokens, tc.hidden_size)).astype(np.float32)
    want, got = _both(jc, tc, jl, tl, x, rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _drops(tc, tl, x, ref_tokens):
    """(slots routed to expert 0, capacity) of the port's router on x."""
    logits = (torch.from_numpy(x) @ tl["router"]).float()
    _, idx = llama.top_k_lower_first(logits, tc.num_experts_per_tok)
    cap = max(int(2.0 * ref_tokens * tc.num_experts_per_tok
                  / tc.num_experts), tc.num_experts_per_tok)
    return int((idx == 0).sum()), cap


@pytest.mark.parametrize("mode", ["float32", "int8"])
@pytest.mark.parametrize("rows,ref_tokens", [(40, 64), (48, 48), (600, 1024)])
def test_forced_drops_match_reference(mode, rows, ref_tokens):
    """Most tokens pick expert 0, whose capacity is T k / 4 at X = 8: the
    slots past it are dropped in the reference's token-major order, so
    with ``ref_tokens`` above the port's rows the port drops exactly the
    reference's slots."""
    jc, tc = _configs(num_experts=8)
    jl, tl = _layer0(jc, tc, mode, router_bias=20.0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((ref_tokens, tc.hidden_size)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 1.0
    routed, cap = _drops(tc, tl, x[:rows], ref_tokens)
    assert routed > cap, (routed, cap)  # slots really are dropped
    want, got = _both(jc, tc, jl, tl, x, rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the capacity follows the reference's T: with the port's own row
    # count as T, fewer slots fit and the result differs
    if ref_tokens > rows:
        own = llama._moe_mlp(tc, tl, torch.from_numpy(x[:rows])).numpy()
        assert np.abs(own - want).max() > 1e-3


def test_top_k_ties_go_to_the_lower_expert():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]])
    vals, idx = llama.top_k_lower_first(logits, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2], [0, 1]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# -- engines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral():
    mesh = build_mesh(MeshConfig(data=1, tensor=1))
    params = jax_init(jcfg.ModelConfig.from_pretrained("tiny-mixtral"), mesh,
                      seed=0)
    np_params = jax.tree.map(np.asarray, jax.device_get(params))
    return mesh, params, params_from_jax(
        np_params, tcfg.ModelConfig.from_pretrained("tiny-mixtral"))


def _engines(mixtral, impl):
    mesh, params, tparams = mixtral
    sched = dict(max_num_seqs=4, max_num_batched_tokens=32,
                 prefill_buckets=(16, 32), multi_step=2)
    cache = dict(block_size=4, num_blocks=256)
    jeng = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained("tiny-mixtral"),
        cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**sched),
        mesh=MeshConfig(data=1, tensor=1), attention_impl=impl),
        mesh=mesh, params=params, num_blocks=256)
    teng = LLMEngine(tcfg.EngineConfig.for_model(
        "tiny-mixtral", cache=tcfg.CacheConfig(**cache),
        scheduler=tcfg.SchedulerConfig(**sched), attention_impl=impl),
        params=tparams, device="cpu")
    return jeng, teng


def greedy(n=12):
    return SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True,
                          logprobs=2)


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_mixtral_engine_matches_reference(mixtral, impl):
    jeng, teng = _engines(mixtral, impl)
    rng = np.random.default_rng(3)
    reqs = [(f"r{i}", rng.integers(0, 259, n).tolist(), greedy())
            for i, n in enumerate((5, 17, 44, 9, 23, 2))]
    want = drain(jeng, reqs, stagger_at=(1, 2, 3, 5, 6))
    got = drain(teng, reqs, stagger_at=(1, 2, 3, 5, 6))
    assert_same(want, got)
    assert sum(map(len, got[0].values())) == 12 * len(reqs)


def _mlp_only(src: str, dst: str) -> str:
    """A copy of adapter ``src`` with its attention targets removed."""
    os.makedirs(dst)
    tensors = load_file(os.path.join(src, "adapter_model.safetensors"))
    save_file({k: v for k, v in tensors.items() if ".mlp." in k},
              os.path.join(dst, "adapter_model.safetensors"))
    with open(os.path.join(src, "adapter_config.json")) as f:
        acfg = json.load(f)
    with open(os.path.join(dst, "adapter_config.json"), "w") as f:
        json.dump(acfg, f)
    return dst


def test_lora_attention_applies_mlp_ignored_on_moe(mixtral, tmp_path):
    """An adapter on all seven targets: the port's tokens are the JAX
    engine's, and differ from the base model's; the same adapter without
    its attention targets serves exactly the base model's tokens on both
    engines."""
    cfg = tcfg.ModelConfig.from_pretrained("tiny-mixtral")
    full = make_adapter_dir(str(tmp_path), cfg, seed=1)
    mlp = _mlp_only(full, str(tmp_path / "mlp-only"))
    jeng, teng = _engines(mixtral, "ragged")
    manager = tlora.LoraManager(teng)
    jc = jeng.config
    for slot, (name, d) in enumerate((("full", full), ("mlp", mlp)), start=1):
        jeng.runner.register_lora(slot, jlora.load_adapter_raw(
            name, d, jc.model, jc.max_lora_rank))
        manager.load(name, d)
        assert manager.slot_of(name) == slot
    prompt = [5, 9, 13, 2, 6, 11, 40]
    reqs = [(name, prompt, greedy(), slot)
            for slot, name in enumerate(("base", "full", "mlp"))]
    want = drain(jeng, reqs)
    got = drain(teng, reqs)
    assert_same(want, got)
    for toks in (want[0], got[0]):
        assert toks["full"] != toks["base"]
        assert toks["mlp"] == toks["base"]
