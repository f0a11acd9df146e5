"""The host and remote KV tiers under tensor parallelism, on the CPU.

At tp 2 the tiers live in rank 0's process and hold whole slabs, every
rank's KV heads joined in the reference's pool layout at ``tensor=2``:

- ``test_torch_kv_tiering``'s drills at tp 2: the A/B/A drill against
  the JAX engine at ``tensor=2`` on the same weights (the same tokens,
  host hits and queries, pool hits, demotions, evictions, prefetches and
  bytes, at each host sizing; and on a remote tier alone, its hits,
  queries and bytes), a demotion copied before the pool reuses the block,
  and an adapter's blocks in the host tier never serving the base model;
- the reference's ``test_abort_mid_prefetch_leaks_nothing`` and
  ``test_corrupt_remote_fetch_is_a_clean_miss`` (its ``ChaosKVServer`` in
  front of the remote tier) at tp 2;
- the remote tier: wave A from one tp 2 engine serves a fresh tp 2
  engine (every usable block a hit, the same tokens); the same slabs are
  a clean miss for a tp 1 engine, whose pool is grouped otherwise: each
  refused fetch counted, none imported, its tokens a cold prefill's.

Every engine with ranks runs under ``rank_limit`` (``_torch_tp``), one at
a time (one torch.distributed group a process).
"""

import asyncio
import contextlib
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain
from _torch_tp import rank_limit
from test_torch_kv_tiering import (
    BS,
    GREEDY,
    WAVE_A,
    WAVE_B,
    _configs,
    _counts,
    _settle,
    _waves,
)
from test_torch_lora import make_adapter_dir
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.sequence import SequenceStatus
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.kv_server import KVServer
from production_stack_tpu_torch.parallel.mesh import MeshConfig

torch.set_num_threads(1)

USABLE = len(WAVE_A) * ((30 - 1) // BS)  # wave A's blocks a tier can give


def _tp2(tconf):
    return dataclasses.replace(tconf, mesh=MeshConfig(tensor=2))


@contextlib.contextmanager
def _engine(tconf, params, seconds: float = 90):
    """A tp 2 engine on the CPU, its tiers and ranks stopped after."""
    with rank_limit(seconds):
        eng = LLMEngine(_tp2(tconf), params=params, device="cpu")
        try:
            yield eng
        finally:
            eng.shutdown_tiers()
            eng.close()


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seeded weights at ``tensor=2``, for the port."""
    jconf, tconf = _configs()
    jeng = _jax_engine(jconf)
    return params_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jeng.runner.params)), tconf.model)


def _jax_engine(jconf):
    jconf = dataclasses.replace(jconf, mesh=jmesh.MeshConfig(data=1,
                                                             tensor=2))
    return JaxEngine(jconf, mesh=jmesh.build_mesh(
        jconf.mesh, devices=jax.devices()[:2]),
        num_blocks=jconf.cache.num_blocks)


@pytest.mark.parametrize("sizing", [
    {"kv_host_cache_bytes": 10 ** 7},
    {"host_offload_blocks": 64},  # both waves fit exactly
    # a host tier too small for both waves: its own LRU evicts A's blocks
    {"host_offload_blocks": 36},
])
def test_aba_drill_matches_reference_at_tp2(params, sizing):
    jconf, tconf = _configs(**sizing)
    jeng = _jax_engine(jconf)
    try:
        jruns, jc = _waves(jeng), _counts(jeng)
    finally:
        jeng._prefetcher.shutdown()
    with _engine(tconf, params) as teng:
        truns, tc = _waves(teng), _counts(teng)
        assert teng.scheduler.num_prefetching == 0
        reports = teng.runner.follower_reports()
    for want, got in zip(jruns, truns):
        assert_same(want, got)
    if sizing.get("host_offload_blocks") == 36:
        # as at tp 1 (test_torch_kv_tiering): one decision's demotions
        # pushing each other out of a full host tier are counted apart
        for c in (jc, tc):
            del c["bytes"]["host_out"], c["hbm"]["demotions"]
            for k in ("demotions", "evictions"):
                del c["host"][k]
    assert tc == jc
    if sizing.get("host_offload_blocks") != 36:
        assert tc["prefetch"]["blocks"] == USABLE
        assert tc["cpu_hits"] == USABLE
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1


def _remote_waves(eng) -> tuple:
    """``_waves`` on a remote tier alone, each wave's puts landed before
    the next wave starts (puts are fire-and-forget); the runs and the
    counts both engines keep."""
    _settle(eng)
    runs = []
    for tag, wave in (("a1", WAVE_A), ("b", WAVE_B), ("a2", WAVE_A)):
        runs.append(drain(eng, [(f"{tag}-{i}", p, GREEDY)
                                for i, p in enumerate(wave)]))
        _wait_puts(lambda: 0 if eng.remote_kv._pending_puts else 1, 1)
    st = eng.stats()
    tier = st["kv_tier"]
    counts = {
        "hbm": {k: tier["tiers"]["hbm"][k]
                for k in ("hits", "queries", "evictions")},
        "remote": {k: tier["tiers"]["remote"][k] for k in ("hits",
                                                           "queries")},
        "prefetch": {k: tier["prefetch"][k] for k in (
            "submitted", "committed", "dropped", "blocks", "count")},
        "bytes": {k: v for k, v in tier["bytes"].items()
                  if k.startswith("remote")}}
    return runs, counts


def test_remote_aba_drill_matches_reference_at_tp2(params):
    """The A/B/A drill with the remote tier alone (a ``kv_server`` in this
    process behind each engine): wave A comes back from it, with the JAX
    engine's counts and tokens."""
    out = {}
    for side in ("jax", "port"):
        store = KVServer()
        url = f"http://127.0.0.1:{store.start('127.0.0.1', 0)}"
        jconf, tconf = _configs()
        jconf.cache.remote_kv_url = tconf.cache.remote_kv_url = url
        try:
            if side == "jax":
                jeng = _jax_engine(jconf)
                try:
                    out[side] = _remote_waves(jeng)
                finally:
                    jeng._prefetcher.shutdown()
            else:
                with _engine(tconf, params) as teng:
                    out[side] = _remote_waves(teng)
        finally:
            store.shutdown()
    (jruns, jc), (truns, tc) = out["jax"], out["port"]
    for want, got in zip(jruns, truns):
        assert_same(want, got)
    assert tc == jc
    assert tc["remote"]["hits"] == tc["prefetch"]["blocks"] == USABLE


def test_demotion_copies_before_the_block_is_reused_at_tp2(params):
    _, tconf = _configs(num_blocks=24, host_offload_blocks=64)
    with _engine(tconf, params) as teng:
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


def test_adapter_blocks_in_the_host_tier_never_serve_base_at_tp2(
        params, tmp_path):
    _, tconf = _configs(num_blocks=24, host_offload_blocks=64)
    cfg = ModelConfig.from_pretrained("tiny-llama")
    prompt = WAVE_A[0]
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    with _engine(tconf, params) as ref:
        base_ref = ref.generate([prompt], sp)["offline-0"]
    with _engine(tconf, params) as eng:
        manager = tlora.LoraManager(eng)
        manager.load("a", make_adapter_dir(str(tmp_path), cfg, seed=1))
        root = eng.runner.lora_roots[1]
        on_a = eng.generate([prompt], sp, adapter_slot=1)["offline-0"]
        assert eng.host_kv.probe_extension(prompt, 0) == 0
        assert eng.host_kv.probe_extension(prompt, 0, root) == 7
        for p in WAVE_B:
            eng.generate([p], sp)
        assert eng.scheduler.allocator.match_prefix(prompt, root)[0] == []
        hits = eng.host_kv.hits
        base = eng.generate([prompt], sp)["offline-0"]
        assert eng.host_kv.hits == hits  # nothing of the adapter's served
        assert base == base_ref and base != on_a
        eng.generate(list(WAVE_B[:3]), sp)
        hits = eng.host_kv.hits
        assert eng.generate([prompt], sp, adapter_slot=1)["offline-0"] == on_a
        assert eng.host_kv.hits > hits


def _churn(eng, n=3, length=24):
    for i in range(n):
        other = np.random.default_rng(100 + i).integers(1, 500, length)
        eng.generate([other.tolist()], GREEDY)


def test_abort_mid_prefetch_leaks_nothing_at_tp2(params):
    _, tconf = _configs(num_blocks=14, kv_host_cache_bytes=1 << 22)
    prompt = np.random.default_rng(6).integers(1, 500, 24).tolist()
    with _engine(tconf, params) as eng:
        eng.generate([prompt], GREEDY)
        _churn(eng)
        orig = eng.host_kv.match_extension

        def slow_match(*a, **kw):
            time.sleep(0.3)
            return orig(*a, **kw)

        eng.host_kv.match_extension = slow_match
        free_before = eng.scheduler.allocator.num_free_blocks
        eng.add_request("park-me", prompt_token_ids=list(prompt),
                        sampling=GREEDY)
        eng.step()  # admission parks the sequence in PREFETCHING
        seq = eng.scheduler.seqs.get("park-me")
        assert seq is not None and seq.status is SequenceStatus.PREFETCHING
        dropped = eng._prefetcher.dropped
        assert eng.abort_request("park-me")
        eng.host_kv.match_extension = orig
        eng._prefetcher.wait_any(5.0)
        eng._poll_prefetches()
        assert eng._prefetcher.dropped == dropped + 1
        assert eng.scheduler.allocator.num_free_blocks == free_before
        assert not eng.has_unfinished()
        out = eng.generate([prompt], GREEDY)["offline-0"]
        assert len(out) == GREEDY.max_tokens


def _chaos_kv():
    from production_stack_tpu.testing.chaos import ChaosKVServer

    srv, holder = ChaosKVServer(capacity_blocks=256), {}

    def serve():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        holder.update(url=srv.url, loop=loop)
        loop.run_forever()

    threading.Thread(target=serve, daemon=True).start()
    t_end = time.monotonic() + 10
    while "url" not in holder and time.monotonic() < t_end:
        time.sleep(0.02)
    assert "url" in holder, "the chaos kv server did not start"
    return srv, holder


def _wait_puts(count, n, seconds=10.0):
    t_end = time.monotonic() + seconds
    while count() < n and time.monotonic() < t_end:
        time.sleep(0.05)
    assert count() >= n


def test_corrupt_remote_fetch_is_a_clean_miss_at_tp2(params):
    """A corrupt, short or absent remote block prefills again, never
    imports garbage: greedy output stays the cold run's in every mode;
    healed, the tier serves again."""
    srv, holder = _chaos_kv()
    _, tconf = _configs(num_blocks=14)
    tconf.cache.remote_kv_url = holder["url"]
    prompt = np.random.default_rng(7).integers(1, 500, 24).tolist()
    try:
        with _engine(tconf, params) as eng:
            first = eng.generate([prompt], GREEDY)["offline-0"]
            _wait_puts(lambda: srv.server.puts, 5)
            for mode in ("corrupt", "truncate", "down"):
                srv.set_mode(mode)
                _churn(eng)
                queries = eng.remote_kv.queries
                assert eng.generate([prompt], GREEDY)["offline-0"] == first, \
                    mode
                if mode != "down":
                    assert eng.remote_kv.queries > queries
            srv.set_mode(None)
            _churn(eng)
            committed = eng._prefetcher.committed
            hits = eng.remote_kv.hits
            assert eng.generate([prompt], GREEDY)["offline-0"] == first
            assert eng.remote_kv.hits > hits
            assert eng._prefetcher.committed > committed
    finally:
        holder["loop"].call_soon_threadsafe(holder["loop"].stop)


_REMOTE: dict = {}


def _remote(params) -> dict:
    """Wave A from a tp 2 engine into a remote store, then again from a
    fresh tp 2 engine and from a fresh tp 1 engine on the same store."""
    if _REMOTE:
        return _REMOTE
    store = KVServer()
    url = f"http://127.0.0.1:{store.start('127.0.0.1', 0)}"
    reqs = [(f"a{i}", p, GREEDY) for i, p in enumerate(WAVE_A)]
    _, tconf = _configs()
    tconf.cache.remote_kv_url = url
    try:
        with _engine(tconf, params) as eng:
            _REMOTE["cold"] = drain(eng, reqs)
            _wait_puts(lambda: store.puts, USABLE)
        with _engine(tconf, params) as eng:
            _REMOTE["tp2"] = (drain(eng, reqs), eng.tier_stats(),
                              eng.prefetch_blocks)
        eng = LLMEngine(tconf, params=params, device="cpu")
        try:
            _REMOTE["tp1"] = (drain(eng, reqs), eng.tier_stats(),
                              eng.prefetch_blocks)
        finally:
            eng.shutdown_tiers()
    finally:
        store.shutdown()
    return _REMOTE


def test_remote_tier_serves_a_fresh_tp2_engine(params):
    out = _remote(params)
    run, stats, blocks = out["tp2"]
    assert_same(out["cold"], run)
    remote = stats["tiers"]["remote"]
    assert remote["hits"] == blocks == USABLE and remote["refused"] == 0
    assert stats["bytes"]["remote_in"] > 0


def test_tp2_remote_slabs_are_a_clean_miss_at_tp1(params):
    """tiny-llama's slabs at tp 2 are grouped (K_0, V_0, K_1, V_1); a tp 1
    engine's pool (K_0, K_1, V_0, V_1) takes none of them."""
    out = _remote(params)
    run, stats, blocks = out["tp1"]
    remote = stats["tiers"]["remote"]
    assert remote["hits"] == blocks == 0
    # each sequence's first fetch is refused and ends its chain
    assert remote["refused"] >= len(WAVE_A)
    assert stats["bytes"]["remote_in"] == 0
    assert_same(out["cold"], run)
