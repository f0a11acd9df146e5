"""The KV plane at a sequence-parallel size above 1, on the CPU: the host
and remote tiers and a disaggregated pair, with seq ranks alone and on the
seq x tensor grid.

Every seq rank holds the whole pool (on the grid, its tensor rank's KV
heads), so the tiers, which live in rank 0's process, hold whole slabs:
an export reads rank 0's own blocks (on the grid, seq rank 0's tensor
shares joined), an import sends every seq rank the whole (on the grid,
each process its tensor share). The grouping of a slab's heads is the
reference pool's at the tensor size (``shardings.kv_head_groups``), so a
seq 2 x tp 1 producer feeds a seq 1 x tp 1 consumer, and a grid producer
at tp 2 feeds only a consumer at tp 2.

- The A/B/A drill (``test_torch_kv_tiering``'s waves of 30-token prompts,
  each above the ring threshold) at seq 2 and at seq 2 x tp 2 against the
  JAX engine at ``seq=4`` (x ``tensor=2``): the same tokens and the same
  tier counts (host hits and queries, pool hits, demotions, evictions,
  prefetches and bytes); wave A's first serve took the ring, its return
  from the host tier the chunked path, as the reference's pick sends a
  prompt with computed tokens.
- The remote tier: wave A from a seq 2 engine serves a fresh seq 2 engine
  and a fresh seq 1 engine (every usable block a hit, the same tokens);
  wave A from a seq 2 x tp 2 engine is a clean miss for a tp 1 engine,
  each refused fetch counted, none imported, its tokens a cold prefill's.
- A seq 2 prefill server (a subprocess: its own torch.distributed group)
  and a seq 1 decode server in this process: pull (``/kv/export``
  streamed into the decode server's prefix cache) and push-and-splice
  (``/kv/recv``, then the decode hop attaches it) of prompts the
  prefill server ran through the ring; the tokens are the prefill
  server's own unified run's (greedy identical up to a near-tie,
  logprobs within 1e-4); the landed blocks are the producer's, bit for
  bit; no rank survives the prefill server's SIGTERM.

Every engine with ranks runs under ``rank_limit`` (``_torch_tp``), one at
a time (one torch.distributed group a process).
"""

import contextlib
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain, engine_configs
from _torch_ring import free_port, spy_lengths
from _torch_tp import alive, kill_pids, rank_limit, wait_gone
from test_torch_disagg import _assert_run_same, _body, _post, _run
from test_torch_kv_tiering import BS, GREEDY, WAVE_A, _counts, _waves
from test_torch_tp_kv_tiers import _wait_puts
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import kv_transfer as tkt
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.kv_server import KVServer
from production_stack_tpu_torch.parallel.mesh import MeshConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
THRESHOLD = 16  # the waves' 30-token prompts take the ring
USABLE = len(WAVE_A) * ((30 - 1) // BS)  # wave A's blocks a tier can give


def _configs(num_blocks=40, **cache):
    jconf, tconf = engine_configs("ragged", block_size=BS,
                                  num_blocks=num_blocks, max_num_seqs=4,
                                  max_num_batched_tokens=64,
                                  ring_prefill_threshold=THRESHOLD)
    for c in (jconf.cache, tconf.cache):
        for k, v in cache.items():
            setattr(c, k, v)
    return jconf, tconf


def _jax_engine(jconf, tp: int):
    jconf = dataclasses.replace(jconf, mesh=jmesh.MeshConfig(
        data=1, seq=4, tensor=tp))
    return JaxEngine(jconf, mesh=jmesh.build_mesh(
        jconf.mesh, devices=jax.devices()[:4 * tp]),
        num_blocks=jconf.cache.num_blocks)


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seeded weights, for the port."""
    jconf, tconf = _configs()
    jeng = _jax_engine(jconf, 1)
    return params_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jeng.runner.params)), tconf.model)


@contextlib.contextmanager
def _engine(tconf, params, seq: int, tp: int = 1, seconds: float = 120):
    """A port engine at ``seq`` x ``tp`` on the CPU, its tiers and ranks
    stopped after."""
    with rank_limit(seconds):
        eng = LLMEngine(dataclasses.replace(
            tconf, mesh=MeshConfig(seq=seq, tensor=tp)), params=params,
            device="cpu")
        try:
            yield eng
        finally:
            eng.shutdown_tiers()
            if seq * tp > 1:
                eng.close()


@pytest.mark.parametrize("tp", [1, 2], ids=["seq2", "seq2-tp2"])
def test_aba_host_drill_matches_reference(params, tp):
    jconf, tconf = _configs(kv_host_cache_bytes=10 ** 7)
    jeng = _jax_engine(jconf, tp)
    try:
        jlengths = spy_lengths(jeng.runner)
        jruns, jc = _waves(jeng), _counts(jeng)
    finally:
        jeng._prefetcher.shutdown()
    with _engine(tconf, params, 2, tp) as teng:
        assert teng.scheduler.ring_enabled
        lengths = spy_lengths(teng.runner)
        truns, tc = _waves(teng), _counts(teng)
        assert teng.scheduler.num_prefetching == 0
        reports = teng.runner.follower_reports()
    for want, got in zip(jruns, truns):
        assert_same(want, got)
    assert tc == jc
    assert tc["prefetch"]["blocks"] == tc["cpu_hits"] == USABLE
    # waves A and B fresh through the ring, A's return from the host tier
    # on the chunked path
    assert lengths == jlengths == [32] * (2 * len(WAVE_A))
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert all(r["diverged_at"] is None for r in reports)


_REMOTE: dict = {}


def _remote(params) -> dict:
    """Wave A from a seq 2 engine into a remote store, then from a fresh
    seq 2 engine and a fresh seq 1 engine on it; wave A from a seq 2 x tp
    2 engine into another store, then from a tp 1 engine on that one."""
    if _REMOTE:
        return _REMOTE
    reqs = [(f"a{i}", p, GREEDY) for i, p in enumerate(WAVE_A)]
    for producer in ((2, 1), (2, 2)):
        store = KVServer()
        url = f"http://127.0.0.1:{store.start('127.0.0.1', 0)}"
        _, tconf = _configs()
        tconf.cache.remote_kv_url = url
        try:
            with _engine(tconf, params, *producer) as eng:
                lengths = spy_lengths(eng.runner)
                _REMOTE[producer] = drain(eng, reqs)
                _REMOTE[producer, "ring"] = lengths
                _wait_puts(lambda: store.puts, USABLE)
            consumers = [(2, 1), (1, 1)] if producer == (2, 1) else [(1, 1)]
            for consumer in consumers:
                with _engine(tconf, params, *consumer) as eng:
                    _REMOTE[producer, consumer] = (
                        drain(eng, reqs), eng.tier_stats(),
                        eng.prefetch_blocks)
        finally:
            store.shutdown()
    return _REMOTE


@pytest.mark.parametrize("consumer", [(2, 1), (1, 1)],
                         ids=["seq2", "seq1"])
def test_remote_tier_serves_a_fresh_engine(params, consumer):
    """Slabs a seq 2 engine offloaded serve a fresh seq 2 engine and a
    fresh seq 1 engine: one grouping at tensor size 1."""
    out = _remote(params)
    assert out[(2, 1), "ring"] == [32] * len(WAVE_A)
    run, stats, blocks = out[(2, 1), consumer]
    assert_same(out[(2, 1)], run)
    remote = stats["tiers"]["remote"]
    assert remote["hits"] == blocks == USABLE and remote["refused"] == 0
    assert stats["bytes"]["remote_in"] > 0


def test_grid_remote_slabs_are_a_clean_miss_at_tp1(params):
    """A seq 2 x tp 2 engine's slabs are grouped as the reference's pool
    at tp 2 (K_0, V_0, K_1, V_1 for tiny-llama's two KV heads); a tp 1
    engine's pool (K_0, K_1, V_0, V_1) takes none of them."""
    out = _remote(params)
    assert out[(2, 2), "ring"] == [32] * len(WAVE_A)
    run, stats, blocks = out[(2, 2), (1, 1)]
    remote = stats["tiers"]["remote"]
    assert remote["hits"] == blocks == 0
    assert remote["refused"] >= len(WAVE_A)
    assert stats["bytes"]["remote_in"] == 0
    assert_same(out[(2, 2)], run)


# -- a seq 2 prefill server and a seq 1 decode server --------------------------

FLAGS = ["--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--block-size", str(BS), "--num-blocks", "128",
         "--max-num-seqs", "4", "--max-num-batched-tokens", "64"]


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def servers():
    """The seq 2 prefill server (a subprocess) and a seq 1 decode server
    (this process)."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         *FLAGS, "--sequence-parallel-size", "2", "--ring-prefill-threshold",
         str(THRESHOLD), "--role", "prefill", "--port", str(port),
         "--host", "127.0.0.1"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    p_url = f"http://127.0.0.1:{port}"
    out = {"proc": proc, "p": p_url, "p_pids": []}
    with rank_limit(240):
        try:
            t_end = time.monotonic() + 90
            while time.monotonic() < t_end:
                try:
                    ranks = _get(f"{p_url}/debug/perf")["ranks"]
                    out["p_pids"] = ranks["pids"][1:]
                    out["p_ranks"] = ranks
                    break
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.3)
            assert out["p_pids"], "the prefill server did not come up"
            server = tserver.server_from_args(tserver.build_parser(
            ).parse_args(FLAGS + ["--role", "decode"]))
            out["D"] = server
            out["d"] = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            yield out
        finally:
            if "D" in out:
                out["D"].shutdown()
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
            kill_pids(out["p_pids"])


def _rings(url, S: int) -> int:
    """Whether the prefill server has run a ring prefill of ``S`` padded
    tokens (the accountant counts a signature's first call)."""
    counts = _get(f"{url}/debug/perf")["compile"]["counts"]
    return counts.get(f"prefill_ring:{S}", 0)


def _export(url, blocks) -> bytes:
    req = urllib.request.Request(
        f"{url}/kv/export", data=json.dumps({"blocks": blocks}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers[tkt.HEAD_GROUPS_HEADER] == "1"
        return r.read()


def _engine_bytes(server, blocks) -> bytes:
    return bytes(tkt.tensor_bytes(server.async_engine.run_on_engine(
        lambda e: e.export_kv(blocks))))


def _unified(url, prompt, n):
    return _run(_post(f"{url}/v1/completions", _body(prompt, n))[1])


def test_pull_from_a_seq2_prefill_server(servers):
    P, D, d = servers["p"], servers["D"], servers["d"]
    assert (servers["p_ranks"]["size"], servers["p_ranks"]["axis"]) == (
        2, "seq")
    prompt = list(range(150, 191))  # 41 tokens: fresh, through the ring
    assert _rings(P, 64) == 0
    status, pre = _post(f"{P}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True}))
    assert status == 200 and _rings(P, 64) == 1
    kv = dict(pre["kv_transfer_params"], remote_host=P)
    status, dec = _post(f"{d}/v1/completions",
                        _body(prompt, 6, kv_transfer_params=kv))
    assert status == 200
    n_full = (len(prompt) - 1) // BS
    assert dec["usage"]["prompt_tokens_details"]["cached_tokens"] == (
        n_full * BS)
    assert D.metrics.transfer_snapshot()["import"]["count"] >= 1
    # the ring-built blocks landed as the producer holds them
    mine, _ = D.engine.scheduler.allocator.match_prefix(prompt)
    assert len(mine) == n_full
    assert _engine_bytes(D, mine) == _export(
        P, kv["remote_block_ids"][:n_full])
    _assert_run_same(_unified(P, prompt, 6), _run(dec))


def test_push_splice_from_a_seq2_prefill_server(servers):
    P, D, d = servers["p"], servers["D"], servers["d"]
    # 70 tokens: 17 full blocks and a partial one, through the ring at 128
    prompt = list(range(60, 130))
    assert _rings(P, 128) == 0
    spliced0 = D.engine.spliced_seqs
    status, pre = _post(f"{P}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True,
                                            "push_url": d,
                                            "transfer_id": "seq-push"}))
    assert status == 200 and _rings(P, 128) == 1
    kv = pre["kv_transfer_params"]
    assert kv["pushed"] is True
    with D._kv_lock:
        landed = list(D._kv_transfers["seq-push"]["blocks"])
    n_full = len(prompt) // BS
    assert _engine_bytes(D, landed[:n_full]) == _export(
        P, kv["remote_block_ids"][:n_full])
    first = _run(pre)
    status, dec = _post(f"{d}/v1/completions", _body(
        prompt + [ord(first[0])], 7, kv_transfer_params={
            "do_remote_prefill": True, "transfer_id": "seq-push",
            "remote_block_ids": kv["remote_block_ids"], "remote_host": P}))
    assert status == 200 and D.engine.spliced_seqs == spliced0 + 1
    rest = _run(dec)
    _assert_run_same(_unified(P, prompt, 8),
                     (first[0] + rest[0], first[1] + rest[1]))


def test_no_rank_survives_the_prefill_servers_stop(servers):
    p_pids = servers["p_pids"]
    assert p_pids and all(alive(p) for p in p_pids)
    servers["proc"].send_signal(signal.SIGTERM)
    assert servers["proc"].wait(30) == 0
    assert wait_gone(p_pids, 10) == []
