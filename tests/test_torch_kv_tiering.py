"""The port's host KV tier against the JAX engine's, on the CPU, and the
adapter root that keys LoRA blocks in every tier.

- The A/B/A drill: tiny-llama on a pool that wave B's admissions evict
  wave A out of, a host tier behind it, wave A served again. The port
  engine and the JAX engine under the same config count the same host
  hits and queries, pool hits, demotions and evictions, commit the same
  prefetched blocks and move the same bytes, and serve the same tokens
  (the port's also equal a tier-less run). The JAX engine demotes an
  evicted block with one export each; the port copies a decision's
  evictions down in one batch before the step's dispatch. Both engines
  look their tiers up on a thread pool, and when a lookup lands decides
  which step admits its sequence, and so which blocks the pool evicts:
  the drill runs each engine's lookups at one fixed point instead, right
  after the step that submitted them (``_settle``), so the counts compare
  the same schedule on a loaded machine too.
- ``adapter_root`` is a digest of the adapter's weights: the same in two
  interpreters with different ``PYTHONHASHSEED``s, never the base seed,
  and an adapter's blocks offloaded to the host tier never prefix-hit a
  base-model request (the reference keys every tier block by the base
  chain and would serve them).
"""

import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_same,
    drain,
    engine_configs,
    jax_engine,
    port_engine,
    tiny_weights,
)
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.kv_cache import HASH_SEED, adapter_root
from production_stack_tpu_torch.engine.sampling import SamplingParams
from test_torch_lora import make_adapter_dir

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BS = 4
GREEDY = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True,
                        logprobs=2)
rng = np.random.default_rng(7)
WAVE_A = [rng.integers(1, 500, 30).tolist() for _ in range(4)]
WAVE_B = [rng.integers(1, 500, 30).tolist() for _ in range(4)]


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def _configs(num_blocks=40, **cache):
    jconf, tconf = engine_configs("ragged", block_size=BS,
                                  num_blocks=num_blocks, max_num_seqs=4,
                                  max_num_batched_tokens=64)
    for c in (jconf.cache, tconf.cache):
        for k, v in cache.items():
            setattr(c, k, v)
    return jconf, tconf


def _counts(eng) -> dict:
    st = eng.stats()
    tier = st["kv_tier"]
    pf = tier["prefetch"]
    return {
        "cpu_hits": st["cpu_prefix_cache_hits_total"],
        "cpu_queries": st["cpu_prefix_cache_queries_total"],
        "hbm": {k: tier["tiers"]["hbm"][k]
                for k in ("hits", "queries", "demotions", "evictions")},
        "host": {k: tier["tiers"]["host"][k]
                 for k in ("hits", "queries", "demotions", "evictions",
                           "bytes_used", "bytes_capacity")},
        "prefetch": {k: pf[k] for k in ("submitted", "committed", "dropped",
                                         "blocks", "count")},
        "bytes": tier["bytes"],
    }


class _StepExecutor:
    """A prefetcher's executor that runs each submitted lookup when told
    (``run``), on the caller's thread."""

    def __init__(self):
        self.queue = []

    def submit(self, fn, *args):
        fut = concurrent.futures.Future()
        self.queue.append((fut, fn, args))
        return fut

    def run(self) -> None:
        queue, self.queue = self.queue, []
        for fut, fn, args in queue:
            try:
                fut.set_result(fn(*args))
            except Exception as e:  # the engine reads it as a miss
                fut.set_exception(e)

    def shutdown(self, wait: bool = True) -> None:
        self.queue = []


def _settle(eng):
    """Run ``eng``'s tier lookups right after the step that submitted
    them, so each lands at the next step's poll whatever the load."""
    pf = eng._prefetcher
    pf._io.shutdown(wait=True)
    pf._io = ex = _StepExecutor()
    step = eng.step

    def settled_step():
        out = step()
        ex.run()
        return out

    eng.step = settled_step


def _waves(eng):
    _settle(eng)
    runs = []
    for tag, wave in (("a1", WAVE_A), ("b", WAVE_B), ("a2", WAVE_A)):
        runs.append(drain(eng, [(f"{tag}-{i}", p, GREEDY)
                                for i, p in enumerate(wave)]))
    return runs


@pytest.mark.parametrize("sizing", [
    {"kv_host_cache_bytes": 10 ** 7},
    {"host_offload_blocks": 64},  # both waves fit exactly
    # a host tier too small for both waves: its own LRU evicts A's blocks
    {"host_offload_blocks": 36},
])
def test_aba_drill_matches_reference(weights, sizing):
    jconf, tconf = _configs(**sizing)
    jeng, teng = jax_engine(weights, jconf), port_engine(weights, tconf)
    try:
        jruns, truns = _waves(jeng), _waves(teng)
        for want, got in zip(jruns, truns):
            assert_same(want, got)
        jc, tc = _counts(jeng), _counts(teng)
        if sizing.get("host_offload_blocks") == 36:
            # the port tests a block's residency when the pool evicts it,
            # the JAX engine when it copies it: when one decision's
            # demotions push each other out of a full host tier, the JAX
            # engine demotes again what the port leaves evicted; hits,
            # queries and prefetches still agree
            for c in (jc, tc):
                del c["bytes"]["host_out"], c["hbm"]["demotions"]
                for k in ("demotions", "evictions"):
                    del c["host"][k]
        assert tc == jc
        usable = len(WAVE_A) * ((30 - 1) // BS)
        if sizing.get("host_offload_blocks") != 36:
            # every usable block of wave A came back from the host tier
            assert tc["prefetch"]["blocks"] == usable
            assert tc["cpu_hits"] == usable
        # the tier changed nothing about the tokens
        _, plain = _configs(num_blocks=40)
        assert_same(truns[2], drain(port_engine(weights, plain), [
            (f"a2-{i}", p, GREEDY) for i, p in enumerate(WAVE_A)]))
        assert teng.scheduler.num_prefetching == 0
    finally:
        jeng._prefetcher.shutdown()
        teng.shutdown_tiers()


def test_demotion_copies_before_the_block_is_reused(weights):
    """A cached pool block whose chain the host tier does not hold is
    copied down when a later step's admission evicts it; the host copy
    equals the KV the block held before the step reused it."""
    _, tconf = _configs(num_blocks=24, host_offload_blocks=64)
    teng = port_engine(weights, tconf)
    try:
        drain(teng, [("a", WAVE_A[0], GREEDY)])
        blocks, _ = teng.scheduler.allocator.match_prefix(WAVE_A[0])
        before = teng.export_kv(blocks).clone()
        # empty the host copy of A, so eviction must demote again
        hashes = teng.host_kv.chain_hashes(WAVE_A[0])
        with teng.host_kv._lock:
            for h in hashes:
                slab = teng.host_kv.store.pop(h, None)
                if slab is not None:
                    teng.host_kv.used_bytes -= slab.nbytes
        drain(teng, [(f"b{i}", p, GREEDY) for i, p in enumerate(WAVE_B)])
        assert teng.hbm_demotions >= len(blocks)
        assert teng.scheduler.allocator.match_prefix(WAVE_A[0])[0] == []
        for i, h in enumerate(hashes[:len(blocks)]):
            assert torch.equal(teng.host_kv.store[h], before[:, i])
    finally:
        teng.shutdown_tiers()


_ROOT_CODE = """
import json, sys
import numpy as np
sys.path.insert(0, {root!r})
from production_stack_tpu_torch.engine.kv_cache import adapter_root, HASH_SEED
from production_stack_tpu_torch.engine.kv_offload import chain_hashes
rng = np.random.default_rng(3)
bank = {{"wq": (rng.standard_normal((2, 8, 4)).astype(np.float32),
               rng.standard_normal((2, 4, 8)).astype(np.float32)),
        "wo": (rng.standard_normal((2, 8, 4)).astype(np.float32),
               rng.standard_normal((2, 4, 8)).astype(np.float32))}}
root = adapter_root(bank)
print(json.dumps([root, chain_hashes(list(range(12)), 4, root),
                  hash("lora")]))
"""


def test_adapter_root_is_the_same_in_every_process():
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        res = subprocess.run([sys.executable, "-c",
                              _ROOT_CODE.format(root=str(ROOT))],
                             env=env, capture_output=True, text=True,
                             timeout=120, check=True)
        outs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    (root1, chain1, salt1), (root2, chain2, salt2) = outs
    assert salt1 != salt2  # the interpreters did salt str hashes apart
    assert root1 == root2 and chain1 == chain2
    assert root1 != HASH_SEED and 0 <= root1 < 2 ** 63


def test_adapter_root_follows_the_weights():
    rng = np.random.default_rng(0)
    a = {"wq": (rng.standard_normal((2, 8, 4)).astype(np.float32),
                rng.standard_normal((2, 4, 8)).astype(np.float32))}
    b = {"wq": (a["wq"][0], a["wq"][1] * 2)}
    same = {"wq": tuple(x.copy() for x in a["wq"])}
    assert adapter_root(a) == adapter_root(same)
    assert adapter_root(a) != adapter_root(b)
    assert adapter_root(a) != HASH_SEED


def test_adapter_blocks_in_the_host_tier_never_serve_base(weights, tmp_path):
    """An adapter's finished sequence is offloaded to the host tier under
    its own chain; after the pool evicts it, a base-model request with the
    same prompt gets no host hit and the base model's tokens, and the
    adapter's own request gets all of them back."""
    _, tconf = _configs(num_blocks=24, host_offload_blocks=64)
    cfg = ModelConfig.from_pretrained("tiny-llama")
    eng = port_engine(weights, tconf)
    base_ref = port_engine(weights, tconf)
    try:
        manager = tlora.LoraManager(eng)
        manager.load("a", make_adapter_dir(str(tmp_path), cfg, seed=1))
        root = eng.runner.lora_roots[1]
        assert root not in (HASH_SEED,) and root == adapter_root(
            tlora.load_adapter_raw("a", str(tmp_path / "adapter-1"), cfg,
                                   eng.config.max_lora_rank))
        prompt = WAVE_A[0]
        sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
        on_a = eng.generate([prompt], sp, adapter_slot=1)["offline-0"]
        assert eng.host_kv.probe_extension(prompt, 0) == 0
        assert eng.host_kv.probe_extension(prompt, 0, root) == 7
        # other prompts push the adapter's blocks out of the pool
        for i, p in enumerate(WAVE_B):
            eng.generate([p], sp)
        assert eng.scheduler.allocator.match_prefix(prompt, root)[0] == []
        hits = eng.host_kv.hits
        base = eng.generate([prompt], sp)["offline-0"]
        assert eng.host_kv.hits == hits  # nothing of the adapter's served
        assert base == base_ref.generate([prompt], sp)["offline-0"]
        assert base != on_a
        # the adapter's own request is served from the tier
        eng.generate([p for p in WAVE_B[:3]], sp)
        hits = eng.host_kv.hits
        assert eng.generate([prompt], sp, adapter_slot=1)["offline-0"] == on_a
        assert eng.host_kv.hits > hits
    finally:
        eng.shutdown_tiers()
        base_ref.shutdown_tiers()
