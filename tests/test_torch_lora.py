"""The port's multi-LoRA against the JAX package's, on the CPU.

- The port's safetensors reader (the card's machine has no ``safetensors``
  package) equals ``safetensors.numpy.load_file`` on F32, F16 and BF16
  tensors, BF16 exactly as float32.
- ``load_adapter_raw`` gives the reference's bank arrays exactly.
- ``_lora_delta`` equals the reference's within float32 atol = rtol = 1e-5
  (the port contracts (adapter, rank) in one product instead of forming
  every adapter's output), and a token of adapter 0 gets exactly 0.
- A mixed step of base and two adapters: the port's engine gives the JAX
  engine's greedy tokens, logprobs within 1e-4, on the ragged and on the
  bucketed path (cf. ``tests/test_lora.py::test_multi_lora_mixed_batch``);
  unloading returns the slot to the base model's output.
- The server (``device="cpu"``) loads and unloads adapters over HTTP,
  lists them in /v1/models and serves the adapter ``model`` names.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from _torch_parity import (
    assert_same,
    drain,
    engine_configs,
    http_json,
    jax_engine,
    port_engine,
    tiny_weights,
)
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.config import ModelConfig as JaxModelConfig
from production_stack_tpu.models.llama import _lora_delta as jax_delta
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.models.llama import _lora_delta

torch.set_num_threads(2)

MODULES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
           "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
           "mlp.down_proj")


def make_adapter_dir(root, cfg, seed: int, rank: int = 4, alpha: float = 8.0,
                     layers=(0, 1)) -> str:
    """An HF-PEFT-shaped adapter on all seven targets of ``layers``, float32
    tensors written by the ``safetensors`` package."""
    d = os.path.join(root, f"adapter-{seed}")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    E, H, KH, D, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.intermediate_size)
    dims = {"q_proj": (E, H * D), "k_proj": (E, KH * D), "v_proj": (E, KH * D),
            "o_proj": (H * D, E), "gate_proj": (E, F), "up_proj": (E, F),
            "down_proj": (F, E)}
    tensors = {}
    for layer in layers:
        for module in MODULES:
            in_dim, out_dim = dims[module.split(".")[1]]
            base = f"base_model.model.model.layers.{layer}.{module}"
            tensors[f"{base}.lora_A.weight"] = (
                rng.standard_normal((rank, in_dim)) * 0.3).astype(np.float32)
            tensors[f"{base}.lora_B.weight"] = (
                rng.standard_normal((out_dim, rank)) * 0.3).astype(np.float32)
    save_file(tensors, os.path.join(d, "adapter_model.safetensors"))
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha}, f)
    return d


def test_safetensors_reader_matches_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "bf16": rng.standard_normal((4, 2, 3)).astype(ml_dtypes.bfloat16),
        "bf16.special": np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, 3e38],
                                 np.float32).astype(ml_dtypes.bfloat16),
        "scalar": np.array(2.5, np.float32),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want = load_file(path)
    got = tlora.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == np.float32
            w = w.astype(np.float32)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def test_safetensors_writer_matches_package(tmp_path):
    """The port's writer (what chip_smoke.py makes its adapter with) reads
    back through the ``safetensors`` package and through the port."""
    rng = np.random.default_rng(1)
    tensors = {"b.f16": rng.standard_normal((3, 7)).astype(np.float16),
               "a.f32": rng.standard_normal((5,)).astype(np.float32),
               "c.scalar": np.array(-1.5, np.float32)}
    path = str(tmp_path / "w.safetensors")
    tlora.write_safetensors(path, tensors)
    for read in (load_file, tlora.read_safetensors):
        back = read(path)
        assert sorted(back) == sorted(tensors)
        for name, want in tensors.items():
            assert back[name].dtype == want.dtype
            assert back[name].tobytes() == want.tobytes(), name
    with pytest.raises(ValueError, match="float32 or float16"):
        tlora.write_safetensors(path, {"i": np.arange(3)})


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "i.safetensors")
    save_file({"i": np.arange(4, dtype=np.int32)}, path)
    with pytest.raises(ValueError, match="only F32, F16 and BF16"):
        tlora.read_safetensors(path)


@pytest.mark.parametrize("rank,layers", [(4, (0, 1)), (16, (1,))])
def test_load_adapter_raw_matches_reference(tmp_path, rank, layers):
    d = make_adapter_dir(str(tmp_path), ModelConfig.from_pretrained(
        "tiny-llama"), seed=rank, rank=rank, layers=layers)
    want = jlora.load_adapter_raw(
        "a", d, JaxModelConfig.from_pretrained("tiny-llama"), 16)
    got = tlora.load_adapter_raw(
        "a", d, ModelConfig.from_pretrained("tiny-llama"), 16)
    assert sorted(got) == sorted(want)
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype and np.array_equal(g, w), key
    with pytest.raises(ValueError, match="exceeds max_lora_rank"):
        tlora.load_adapter_raw("a", d, ModelConfig.from_pretrained(
            "tiny-llama"), rank - 1)


@pytest.mark.parametrize("out", [(4, 32), (256,)])
def test_lora_delta_matches_reference(out):
    """x (P, T, in), one adapter a token among N = 4 (slot 0 zeros), A
    (N, in, R) in the reference's layout, B (N, R, *out)."""
    rng = np.random.default_rng(len(out))
    P, T, E, N, R = 2, 5, 128, 4, 16
    x = rng.standard_normal((P, T, E)).astype(np.float32)
    A = rng.standard_normal((N, E, R)).astype(np.float32) * 0.2
    B = rng.standard_normal((N, R, *out)).astype(np.float32) * 0.2
    A[0] = 0.0
    B[0] = 0.0
    ids = rng.integers(0, N, (P, T))
    ids[0, 0] = 0
    onehot = np.eye(N, dtype=np.float32)[ids]
    want = np.asarray(jax_delta(jnp.asarray(x), jnp.asarray(onehot),
                                jnp.asarray(A), jnp.asarray(B)))
    got = _lora_delta(torch.from_numpy(x), torch.from_numpy(onehot),
                      torch.from_numpy(A).permute(1, 0, 2).contiguous(),
                      torch.from_numpy(B)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[ids == 0] == 0).all()


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("adapters"))
    cfg = ModelConfig.from_pretrained("tiny-llama")
    return [make_adapter_dir(root, cfg, seed=s) for s in (1, 2)]


def greedy(n=10):
    return SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True,
                          logprobs=2)


# base and both adapters in one step; the long prompt is chunked on both
# paths, and a2 has the base row's prompt under adapter a
MIXED = [("base", [5, 9, 13, 2, 6], 0), ("a", [3, 7, 11], 1),
         ("b", list(range(1, 45)), 2), ("a2", [5, 9, 13, 2, 6], 1)]


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_multi_lora_mixed_batch_matches_reference(weights, adapters, impl):
    jconf, tconf = engine_configs(
        impl, max_num_seqs=4, max_num_batched_tokens=32,
        prefill_buckets=(8, 16, 32), multi_step=2)
    jeng = jax_engine(weights, jconf)
    teng = port_engine(weights, tconf)
    manager = tlora.LoraManager(teng)
    for slot, (name, d) in enumerate(zip(("a", "b"), adapters), start=1):
        jeng.runner.register_lora(slot, jlora.load_adapter_raw(
            name, d, jconf.model, jconf.max_lora_rank))
        manager.load(name, d)
        assert manager.slot_of(name) == slot
    reqs = [(rid, p, greedy(), slot) for rid, p, slot in MIXED]
    want = drain(jeng, reqs)
    got = drain(teng, reqs)
    assert_same(want, got)
    toks = got[0]
    assert toks["base"] != toks["a2"] and toks["a"] != toks["b"]
    # the base row is the base model's, adapters loaded or not
    solo = drain(port_engine(weights, tconf), [("base", MIXED[0][1],
                                                greedy(), 0)])
    assert solo[0]["base"] == toks["base"]
    if impl == "ragged":
        assert teng.ragged_dispatches and teng.decode_dispatches
        # unloading returns the slot to the base model's output (a fresh
        # prompt: the prefix cache keys blocks by tokens alone)
        assert manager.unload("a") and not manager.unload("a")
        fresh = list(range(40, 47))
        after = drain(teng, [("was-a", fresh, greedy(), 1),
                             ("base", fresh, greedy(), 0)])
        assert after[0]["was-a"] == after[0]["base"]
        assert manager.list_adapters() == ["b"]


def test_server_lora_routes(weights, adapters):
    """/v1/load_lora_adapter and /v1/unload_lora_adapter, the adapter
    cards of /v1/models, and ``model`` naming an adapter on completions and
    chat (the reference LoraAdapter operator's contract)."""
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=32)
    server = EngineServer(tconf, engine=port_engine(weights, tconf))
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    req = {"prompt": "hello lora", "max_tokens": 6, "temperature": 0,
           "ignore_eos": True}

    def text(model):
        status, out = http_json(f"{url}/v1/completions", dict(req, model=model))
        assert status == 200, out
        return out["choices"][0]["text"]

    try:
        base = text("tiny-llama")
        for name, d in zip(("adapter-a", "adapter-b"), adapters):
            status, out = http_json(f"{url}/v1/load_lora_adapter",
                                {"lora_name": name, "lora_path": d})
            assert status == 200 and out["status"] == "loaded", out
        assert http_json(f"{url}/v1/load_lora_adapter",
                     {"lora_name": "x"})[0] == 400
        assert http_json(f"{url}/v1/load_lora_adapter",
                     {"lora_name": "x", "lora_path": "/nonexistent"})[0] == 400
        status, out = http_json(f"{url}/v1/models")
        cards = {m["id"]: m for m in out["data"]}
        assert cards["adapter-a"]["parent"] == "tiny-llama"
        assert cards["adapter-b"]["root"] == "tiny-llama"
        a, b = text("adapter-a"), text("adapter-b")
        assert a != base and b != a
        assert text("tiny-llama") == base
        status, out = http_json(f"{url}/v1/chat/completions", {
            "model": "adapter-a", "max_tokens": 3, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        assert status == 200
        assert http_json(f"{url}/v1/unload_lora_adapter",
                     {"lora_name": "adapter-a"})[0] == 200
        assert http_json(f"{url}/v1/unload_lora_adapter",
                     {"lora_name": "adapter-a"})[0] == 404
        # an unloaded name serves the base model, as the reference does
        assert text("adapter-a") == base
    finally:
        server.shutdown()


def test_prefix_cache_never_crosses_adapters(weights, adapters):
    """A finished request's full blocks serve later requests of the same
    adapter (or of the base model) only: KV computed under adapter a must
    not serve the base model, nor a reload of another adapter into a's
    slot. (The reference content-addresses blocks by tokens alone and
    shares them; this is where the two engines differ on purpose.)"""
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=32)
    sp = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True)
    prompt = list(range(50, 62))  # 3 full blocks of 4
    fresh = port_engine(weights, tconf)
    manager = tlora.LoraManager(fresh)
    base = fresh.generate([prompt], sp)["offline-0"]
    manager.load("a", adapters[0])
    on_a = fresh.generate([prompt], sp, adapter_slot=1)["offline-0"]

    eng = port_engine(weights, tconf)
    manager = tlora.LoraManager(eng)
    manager.load("a", adapters[0])
    hits = eng.scheduler.allocator.prefix_hits
    assert eng.generate([prompt], sp, adapter_slot=1)["offline-0"] == on_a
    assert eng.scheduler.allocator.prefix_hits == hits
    # the same adapter again: its own blocks are hits
    assert eng.generate([prompt], sp, adapter_slot=1)["offline-0"] == on_a
    assert eng.scheduler.allocator.prefix_hits > hits
    # the base model after the adapter: no hit, the base model's tokens
    hits = eng.scheduler.allocator.prefix_hits
    assert eng.generate([prompt], sp)["offline-0"] == base
    assert eng.scheduler.allocator.prefix_hits == hits
    # another adapter reloaded into slot 1 does not see a's blocks
    manager.unload("a")
    manager.load("b", adapters[1])
    assert manager.slot_of("b") == 1
    on_b = eng.generate([prompt], sp, adapter_slot=1)["offline-0"]
    assert eng.scheduler.allocator.prefix_hits == hits
    assert on_b != on_a
