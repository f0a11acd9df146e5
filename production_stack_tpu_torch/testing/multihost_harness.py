"""Multi-host serving harness: one process of a group of processes
started on their own, each a rank.

The port's counterpart of the reference's harness
(production_stack_tpu/testing/multihost_harness.py). Process 0 builds the
whole ``LLMEngine`` as the multi-host leader: it waits on the control
port for the others, and its runner mirrors every call over the
authenticated step-plan channel (engine/multihost.py). It generates
greedily, then runs a guided request (the ``TokenFsm`` crosses the
channel) and one request on a rank-4 adapter it registers (each
follower's share rides its own copy of the ``register_lora`` frame),
exports two KV blocks, and prints ``TOKENS <json>``: tokens, logprobs,
finish reasons, every rank's report and the payload bytes each call sent.
Every other process builds its runner shard in the same order, replays
the calls until the channel closes, and prints ``FOLLOWER DONE``.

tiny-llama in float32 (``--model``: another preset, such as
tiny-mixtral) at tensor-parallel size 2 (``--axis tensor``, the
default), at sequence-parallel size 2 (``--axis seq``, with a prompt
above the ring threshold), or on the seq 2 x tp 2 grid (``--axis grid``,
four processes, the same prompts). Run each process by hand, on the
CPU:

    PSTPU_CONTROL_SECRET=dev PSTPU_COORDINATOR=127.0.0.1:19701 \\
    PSTPU_NUM_PROCESSES=2 PSTPU_PROCESS_ID=0 PSTPU_CONTROL_PORT=19702 \\
    python -m production_stack_tpu_torch.testing.multihost_harness \\
        --device cpu

and the same with ``PSTPU_PROCESS_ID=1``. A process runs on the card
unless ``--device cpu`` asks for the CPU (``--device cuda:i`` names a
card; the ranks talk over gloo either way); ``--params FILE`` loads the
weights from an ``.npz`` of the parameter dict (``save_params``) instead
of seeding them, and every process of the group must be given the same
file (``multihost.weights_fingerprint``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8])
MAX_TOKENS = 6
# the seq axis's ring: a prompt of RING_PROMPT's length prefills through it
RING_THRESHOLD = 16
RING_PROMPT = [(7 * i + 3) % 510 + 1 for i in range(45)]
# the adapter request's prompt shares no block with the others (the
# reference's prefix cache crosses adapters; the port's does not)
ADAPTER_PROMPT = [9, 9, 8, 7, 6]
ADAPTER_RANK = 4
GUIDED_REGEX = "[ab]+"


def engine_config(axis: str = "tensor", model: str = "tiny-llama"):
    """``model`` (tiny-llama by default), float32, blocks of 4: at tensor
    size 2, at seq size 2, or on the seq 2 x tp 2 grid, the seq axes with
    ring prefill from ``RING_THRESHOLD`` tokens."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    sched = SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32,
                            prefill_buckets=(16, 32, 64))
    if axis != "tensor":
        sched.ring_prefill_threshold = RING_THRESHOLD
    mesh = MeshConfig(seq=1 if axis == "tensor" else 2,
                      tensor=1 if axis == "seq" else 2)
    return EngineConfig.for_model(
        model, cache=CacheConfig(block_size=4, num_blocks=128),
        scheduler=sched, mesh=mesh)


def save_params(params: dict, path: str) -> None:
    """The parameter dict (nested dicts of tensors) as an ``.npz``, names
    joined by ``/``."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v.detach().cpu().float().numpy()

    walk(params, "")
    np.savez(path, **flat)


def load_params(path: str, dtype: torch.dtype) -> dict:
    """``save_params``' file as the parameter dict (CPU tensors of
    ``dtype``; each rank cuts its shard from the whole)."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as f:
        for name in f.files:
            *parents, leaf = name.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(f[name].copy()).to(dtype)
    return out


def write_adapter(root: str, cfg, seed: int = 4) -> str:
    """A rank-``ADAPTER_RANK`` PEFT adapter on every target of every
    layer, float32 from ``seed``, in ``root``; returns its directory."""
    from production_stack_tpu_torch.engine.lora import write_safetensors

    d = os.path.join(root, f"adapter-{seed}")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    E, H, KH, D, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.intermediate_size)
    dims = {"self_attn.q_proj": (E, H * D), "self_attn.k_proj": (E, KH * D),
            "self_attn.v_proj": (E, KH * D), "self_attn.o_proj": (H * D, E),
            "mlp.gate_proj": (E, F), "mlp.up_proj": (E, F),
            "mlp.down_proj": (F, E)}
    tensors = {}
    for layer in range(cfg.num_layers):
        for module, (n_in, n_out) in dims.items():
            base = f"base_model.model.model.layers.{layer}.{module}"
            tensors[f"{base}.lora_A.weight"] = (rng.standard_normal(
                (ADAPTER_RANK, n_in)) * 0.3).astype(np.float32)
            tensors[f"{base}.lora_B.weight"] = (rng.standard_normal(
                (n_out, ADAPTER_RANK)) * 0.3).astype(np.float32)
    write_safetensors(os.path.join(d, "adapter_model.safetensors"), tensors)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": ADAPTER_RANK, "lora_alpha": 8.0}, f)
    return d


def generate_greedy(engine, load_adapter, sampling=None,
                    ring: bool = False) -> dict:
    """The harness's requests on ``engine`` (the port's, or any engine
    with the same ``add_request``/``step``/``export_kv``): ``PROMPTS``
    (and ``RING_PROMPT`` when ``ring``) greedy with logprobs, then a
    guided request, then one on the adapter ``load_adapter()`` registers
    (it returns the adapter's slot), then two KV blocks exported.
    ``sampling`` builds the engine's SamplingParams (the port's by
    default). Returns tokens, logprob entries and finish reasons by
    request id, and the export's shape."""
    if sampling is None:
        from production_stack_tpu_torch.engine.sampling import (
            SamplingParams as sampling,
        )
    toks: dict = {}
    lps: dict = {}
    reasons: dict = {}

    def drain(what: str) -> None:
        steps = 0
        while engine.has_unfinished() and steps < 256:
            for o in engine.step():
                toks.setdefault(o.request_id, []).extend(o.new_token_ids)
                lps.setdefault(o.request_id, []).extend(
                    [lp, [list(t) for t in top]]
                    for lp, top in (o.new_logprobs or ()))
                if o.finished:
                    reasons[o.request_id] = o.finish_reason
            steps += 1
        assert not engine.has_unfinished(), f"{what} did not finish"

    greedy = sampling(temperature=0.0, max_tokens=MAX_TOKENS,
                      ignore_eos=True, logprobs=2)
    prompts = list(PROMPTS) + ([RING_PROMPT] if ring else [])
    for i, p in enumerate(prompts):
        engine.add_request(f"mh-{i}", prompt_token_ids=list(p),
                           sampling=greedy)
    drain("generation")
    # the TokenFsm crosses the channel with register_grammar, and each
    # step's FSM states with every call after it
    engine.add_request("mh-guided", prompt_token_ids=[5, 3],
                       sampling=sampling(temperature=0.0, max_tokens=4,
                                         guided_regex=GUIDED_REGEX,
                                         logprobs=2))
    drain("guided generation")
    slot = load_adapter()
    engine.add_request("mh-adapter", prompt_token_ids=ADAPTER_PROMPT,
                       sampling=greedy, adapter_slot=slot)
    drain("the adapter's generation")
    blocks = engine.export_kv([0, 1])
    return {"tokens": toks, "logprobs": lps, "reasons": reasons,
            "kv-export-shape": list(blocks.shape)}


def port_adapter(engine, root: str):
    """``load_adapter`` for the port's engine: the adapter written under
    ``root`` and registered through ``LoraManager``."""
    from production_stack_tpu_torch.engine.lora import LoraManager

    def load() -> int:
        manager = LoraManager(engine)
        manager.load("mh-adapter",
                     write_adapter(root, engine.config.model))
        return manager.slot_of("mh-adapter")

    return load


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--axis", choices=["tensor", "seq", "grid"],
                   default="tensor")
    p.add_argument("--device", default="cuda",
                   help="this process's device: cuda (the default; raises "
                        "without a card), cuda:i, or cpu")
    p.add_argument("--model", default="tiny-llama")
    p.add_argument("--params", default=None)
    p.add_argument("--threads", type=int, default=2,
                   help="the leader's thread count; followers take the "
                        "leader's over the channel")
    args = p.parse_args(argv)

    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.multihost import follow_leader
    from production_stack_tpu_torch.parallel.distributed import (
        DistributedConfig,
        Grid,
    )

    dcfg = DistributedConfig.from_env()
    cfg = engine_config(args.axis, args.model)
    params = (load_params(args.params, cfg.model.torch_dtype)
              if args.params else None)
    if dcfg.is_leader:
        torch.set_num_threads(args.threads)
        engine = LLMEngine(cfg, params=params, device=args.device,
                           rank_devices=[args.device], backend="gloo",
                           distributed=dcfg)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                out = generate_greedy(engine, port_adapter(engine, tmp),
                                      ring=args.axis != "tensor")
            out["reports"] = engine.runner.follower_reports()
            out["frame_bytes"] = {
                m: list(b)
                for m, b in engine.runner.channel.frame_bytes.items()}
        finally:
            engine.close()
        print("TOKENS " + json.dumps(out), flush=True)
    else:
        follow_leader(cfg, dcfg, args.device, [args.device], "gloo",
                      Grid.of(cfg.mesh, cfg.mesh.tensor), params=params)
        print("FOLLOWER DONE", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
