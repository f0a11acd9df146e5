"""Sequence x tensor parallelism: the port's engine on the seq x tensor
grid (CPU processes over gloo) against the JAX engine at
``MeshConfig(seq=4, tensor=2)`` on 8 virtual devices and against itself
at seq 1 and the same tensor size, on the same weights
(``params_from_jax``).

The counterpart of ``tests/test_ring_serving.py::
test_ring_prefill_with_tp_token_identical`` (seq 4 x tensor 2 equals seq
1 x tensor 2), widened to the cases of ``test_torch_ring_serving``:

- Long prompts prefill whole through the ring over each tensor rank's seq
  ranks, short ones stay on the chunked path: at seq 2 x tp 2 on both
  attention paths, at seq 4 x tp 2 and at seq 2 x tp 4 (tiny-llama's two
  KV heads replicated: each process holds the one its query head reads)
  on the ragged path. Greedy tokens identical to the JAX engine's and to
  the port's at seq 1 up to a near-tie, logprobs within 1e-4
  (``_torch_parity.assert_same``); the ring calls padded as the
  reference pads them; every process's digest, calls and launches rank
  0's; decode graphs off.
- On one seq 2 x tp 2 engine (``_grid``): the ring and tensor groups'
  wire bytes of one ring prefill by formula and its accounting, prefix
  reuse after a ring prefill, a seeded sampled request (against the port
  at seq 1 x tp 2: JAX's threefry and torch draw different streams), an
  adapter (the ring = the JAX ring = seq 1 x tp 2, not the base model's),
  and the KV plane: rank 0's export equals the JAX engine's at
  ``tensor=2`` and each process holds its tensor rank's share of an
  import.
- Each process makes its tensor shard itself, seeded or loaded from a
  checkpoint: seq 2 x tp 2 against one device on the same seed or files.
- Gemma-2's soft cap through the ring at seq 2 x tp 2 against the JAX
  engine.
- ``-1`` tensor size resolves over the cards left to each seq rank.
- The server at ``--sequence-parallel-size 2 --tensor-parallel-size 2``:
  its flags, a long completion, its ranks gone after its stop and after
  SIGTERM.

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``);
two engines with ranks never live at once (one torch.distributed group a
process).
"""

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import urllib.error

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain, engine_configs
from _torch_ring import free_port, http, serve_one, spy_lengths
from _torch_tp import kill_pids, rank_limit, wait_gone
from test_torch_lora import make_adapter_dir
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.parallel import mesh as tmesh
from production_stack_tpu_torch.parallel import shardings as tshard
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from production_stack_tpu_torch.parallel.ring_attention import ring_length

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
THRESHOLD = 16
BS = 4
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=32,
             prefill_buckets=(16, 32, 64), ring_prefill_threshold=THRESHOLD)
NUM_BLOCKS = 256
GREEDY = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True,
                        logprobs=2)
LONG_PROMPT = [(7 * i + 3) % 510 + 1 for i in range(45)]  # > threshold 16
rng = np.random.default_rng(21)
# two ring prefills (the oldest first) around a short prompt that stays
# on the chunked path, then decode rows together
REQS = [("long", LONG_PROMPT, GREEDY),
        ("short", [1, 5, 9, 13, 2], GREEDY),
        ("long2", rng.integers(1, 500, 37).tolist(), GREEDY)]


def _configs(impl: str, model: str = "tiny-llama"):
    jconf, tconf = engine_configs(impl, block_size=BS, num_blocks=NUM_BLOCKS,
                                  **SCHED)
    if model != "tiny-llama":
        jconf.model = jcfg.ModelConfig.from_pretrained(model)
        tconf.model = ModelConfig.from_pretrained(model)
    jconf.mesh = jmesh.MeshConfig(data=1, seq=4, tensor=2)
    return jconf, tconf


def _jax_engine(jconf):
    return JaxEngine(jconf, mesh=jmesh.build_mesh(
        jconf.mesh, devices=jax.devices()[:8]), num_blocks=NUM_BLOCKS)


def _params(jeng, tconf):
    return params_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jeng.runner.params)), tconf.model)


def _mesh(tconf, seq: int, tp: int):
    return dataclasses.replace(tconf, mesh=MeshConfig(seq=seq, tensor=tp))


_JAX: dict = {}


def _jax_run(impl: str) -> dict:
    """The JAX engine at seq 4 x tensor 2 on REQS, its ring lengths and
    its weights as the port's; cached for the module."""
    if impl not in _JAX:
        jconf, tconf = _configs(impl)
        jeng = _jax_engine(jconf)
        lengths = spy_lengths(jeng.runner)
        _JAX[impl] = {"run": drain(jeng, REQS), "lengths": lengths,
                      "params": _params(jeng, tconf)}
    return _JAX[impl]


_RUNS: dict = {}


def _run(seq: int, tp: int, impl: str) -> dict:
    """The port at seq 1 x ``tp`` and at ``seq`` x ``tp`` on REQS with the
    JAX engine's weights; cached for the module."""
    key = (seq, tp, impl)
    if key in _RUNS:
        return _RUNS[key]
    ref = _jax_run(impl)
    _, tconf = _configs(impl)
    params = ref["params"]
    out = {"jax": ref["run"], "jax_lengths": ref["lengths"]}
    with rank_limit(120):
        one = LLMEngine(_mesh(tconf, 1, tp), params=params, device="cpu")
        try:
            out["seq1"] = drain(one, REQS)
        finally:
            one.close()
    with rank_limit(150):
        eng = LLMEngine(_mesh(tconf, seq, tp), params=params, device="cpu")
        try:
            assert eng.scheduler.ring_enabled
            out["lengths"] = spy_lengths(eng.runner)
            out["got"] = drain(eng, REQS)
            out["reports"] = eng.runner.follower_reports()
            out["ranks"] = eng.rank_info()
        finally:
            eng.close()
    _RUNS[key] = out
    return out


CASES = [(2, 2, "ragged"), (2, 2, "bucketed"), (4, 2, "ragged"),
         (2, 4, "ragged")]
IDS = [f"seq{n}-tp{tp}-{impl}" for n, tp, impl in CASES]


@pytest.mark.parametrize("seq,tp,impl", CASES, ids=IDS)
def test_grid_ring_prefill_token_identical(seq, tp, impl):
    out = _run(seq, tp, impl)
    assert_same(out["jax"], out["got"])


@pytest.mark.parametrize("seq,tp,impl", CASES, ids=IDS)
def test_grid_matches_seq1_at_the_same_tp(seq, tp, impl):
    """The reference's own check: seq N x tensor T equals seq 1 x tensor
    T."""
    out = _run(seq, tp, impl)
    assert_same(out["seq1"], out["got"])


@pytest.mark.parametrize("seq,tp,impl", CASES, ids=IDS)
def test_grid_pads_as_the_reference(seq, tp, impl):
    """Both long prompts took the ring, alone, at the reference's padded
    length (a power of two and a multiple of the seq ranks: 64 here)."""
    out = _run(seq, tp, impl)
    assert out["lengths"] == out["jax_lengths"] == [
        ring_length(45, seq), ring_length(37, seq)] == [64, 64]


@pytest.mark.parametrize("seq,tp,impl", CASES, ids=IDS)
def test_every_process_samples_what_rank0_samples(seq, tp, impl):
    out = _run(seq, tp, impl)
    reports = out["reports"]
    assert [r["rank"] for r in reports] == list(range(seq * tp))
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)
    assert len({tuple(sorted(r["launches"].items()))
                for r in reports}) == 1
    ranks = out["ranks"]
    assert (ranks["size"], ranks["axis"], ranks["shape"],
            ranks["decode_graphs"]) == (seq * tp, "seq,tensor",
                                        {"seq": seq, "tensor": tp}, False)
    assert len(ranks["pids"]) == len(set(ranks["pids"])) == seq * tp


# -- one seq 2 x tp 2 engine, scenario after scenario --------------------------

SAMPLED = SamplingParams(temperature=0.9, top_k=30, seed=7, max_tokens=5,
                         ignore_eos=True)
GREEDY4 = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
# a distinct long prompt a scenario: a prompt seen before is cached and
# leaves the ring
PROMPTS = {name: rng.integers(1, 500, n).tolist()
           for name, n in (("pick", 40), ("reuse", 45), ("sampled", 41),
                           ("adapter", 43), ("wire", 33), ("kv", 38))}


def _grid_scenarios(eng, adapter_dir: str) -> dict:
    out = {}
    sched = eng.scheduler
    eng.add_request("pick", prompt_token_ids=PROMPTS["pick"],
                    sampling=GREEDY4)
    out["pick"] = [(p.ring, p.chunk_start, p.chunk_len)
                   for p in sched.schedule().prefills]
    while eng.has_unfinished():
        eng.step()
    out["reuse"] = [serve_one(eng, PROMPTS["reuse"], GREEDY4, rid=rid)
                    for rid in ("first", "again")]
    # the KV plane: the ring-built blocks of a prompt, then an import of
    # them into free blocks
    serve_one(eng, PROMPTS["kv"], dataclasses.replace(GREEDY4, max_tokens=1))
    blocks, _ = sched.allocator.match_prefix(PROMPTS["kv"])
    data = eng.export_kv(blocks)
    free = sched.allocator.take_free_blocks(len(blocks))
    eng.runner.import_blocks(free, data)
    out["kv"] = {"blocks": list(blocks), "export": data.numpy(),
                 "landed": eng.runner.gather("export_blocks", free)}
    sched.allocator.free_blocks(free)
    out["sampled"] = serve_one(eng, PROMPTS["sampled"], SAMPLED)[0]
    # the wire bytes and the accounting of one ring prefill
    wire = eng.runner.ranks.wire
    wire0 = dict(wire)
    billed0 = dict(eng.perf.stats_fields()["collective_bytes"])
    n_prefill = eng.perf.snapshot()["totals"]["prefill_tokens"]
    out["wire_tokens"] = serve_one(eng, PROMPTS["wire"],
                                   dataclasses.replace(GREEDY4, max_tokens=1))
    out["wire"] = {op: n - wire0.get(op, 0.0) for op, n in wire.items()
                   if n != wire0.get(op, 0.0)}
    out["billed"] = {op: n - billed0.get(op, 0.0) for op, n in
                     eng.perf.stats_fields()["collective_bytes"].items()
                     if n != billed0.get(op, 0.0)}
    out["perf_prefill"] = (eng.perf.snapshot()["totals"]["prefill_tokens"]
                           - n_prefill)
    manager = tlora.LoraManager(eng)
    manager.load("a", adapter_dir)
    out["adapter"] = serve_one(eng, PROMPTS["adapter"], GREEDY4,
                               manager.slot_of("a"))[0]
    out["base"] = serve_one(eng, PROMPTS["adapter"] + [7], GREEDY4)[0]
    out["reports"] = eng.runner.follower_reports()
    return out


_GRID: dict = {}


def _grid(tmp_path_factory) -> dict:
    if _GRID:
        return _GRID
    root = str(tmp_path_factory.mktemp("grid-adapter"))
    adapter_dir = make_adapter_dir(root, ModelConfig.from_pretrained(
        "tiny-llama"), seed=5)
    jconf, tconf = _configs("ragged")
    jeng = _jax_engine(jconf)
    params = _params(jeng, tconf)
    drain(jeng, [("kv", PROMPTS["kv"], dataclasses.replace(
        GREEDY4, max_tokens=1))])
    blocks, _ = jeng.scheduler.allocator.match_prefix(PROMPTS["kv"])
    _GRID["jax_kv"] = (list(blocks), np.asarray(jeng.export_kv(blocks)))
    jeng.runner.register_lora(1, jlora.load_adapter_raw(
        "a", adapter_dir, jconf.model, jconf.max_lora_rank))
    _GRID["jax_adapter"] = drain(jeng, [("r0", PROMPTS["adapter"], GREEDY4,
                                         1)])[0]["r0"]
    del jeng
    with rank_limit(120):
        one = LLMEngine(_mesh(tconf, 1, 2), params=params, device="cpu")
        try:
            _GRID["seq1_sampled"] = serve_one(one, PROMPTS["sampled"],
                                              SAMPLED)[0]
            tlora.LoraManager(one).load("a", adapter_dir)
            _GRID["seq1_adapter"] = serve_one(one, PROMPTS["adapter"],
                                              GREEDY4, 1)[0]
        finally:
            one.close()
    with rank_limit(150):
        eng = LLMEngine(_mesh(tconf, 2, 2), params=params, device="cpu")
        try:
            _GRID.update(_grid_scenarios(eng, adapter_dir))
            _GRID["cfg"] = eng.config.model
        finally:
            eng.close()
    return _GRID


def test_grid_scheduler_takes_the_ring(tmp_path_factory):
    out = _grid(tmp_path_factory)
    assert out["pick"] == [(True, 0, len(PROMPTS["pick"]))]


def test_grid_then_prefix_cache_reuse(tmp_path_factory):
    """The ring-built blocks are the paged blocks a chunked prefill would
    have built on every process: the same prompt again hits the cache for
    every full block but the last token's and decodes identically."""
    (first, cached0), (again, cached) = _grid(tmp_path_factory)["reuse"]
    assert again == first and cached0 == 0
    assert cached == (len(PROMPTS["reuse"]) - 1) // BS * BS


def test_grid_sampled_seeded_matches_seq1(tmp_path_factory):
    out = _grid(tmp_path_factory)
    assert out["sampled"] == out["seq1_sampled"]


def test_grid_lora_matches_dense(tmp_path_factory):
    """The ring applies each process's share of the adapter: the port's
    ring equals the JAX engine's ring and the port's chunked prefill at
    seq 1 x tp 2 under the adapter, and the base model's output
    differs."""
    out = _grid(tmp_path_factory)
    assert out["adapter"] == out["jax_adapter"] == out["seq1_adapter"]
    assert out["adapter"] != out["base"]


def test_grid_kv_export_equals_the_jax_engines(tmp_path_factory):
    """Rank 0's export of ring-built blocks joins seq rank 0's tensor
    shares into the reference's pool layout at tensor 2: the JAX engine's
    export of the same blocks, within 1e-5."""
    out = _grid(tmp_path_factory)
    jblocks, jdata = out["jax_kv"]
    assert len(out["kv"]["blocks"]) == len(jblocks) == len(
        PROMPTS["kv"]) // BS
    np.testing.assert_allclose(out["kv"]["export"], jdata, rtol=1e-5,
                               atol=1e-5)


def test_grid_kv_import_lands_each_tensor_share(tmp_path_factory):
    """An import sends each process its tensor rank's share, every seq
    rank the same: process g's blocks are tensor rank g % 2's cut of the
    whole, exactly."""
    out = _grid(tmp_path_factory)
    whole = torch.from_numpy(out["kv"]["export"])
    landed = out["kv"]["landed"]
    assert len(landed) == 4
    for g, share in enumerate(landed):
        want = tshard.split_kv_share(whole, out["cfg"], g % 2, 2)
        assert np.array_equal(share, want.numpy()), g


def test_grid_wire_bytes_of_one_prefill(tmp_path_factory):
    """One ring prefill of 33 tokens (padded to 64, 32 a seq rank) at seq
    2 x tp 2, float32, read on rank 0: each layer one rotation of its
    slice's K and V at its one KV head and the gather of the other seq
    rank's; the last token's row sent to the other seq rank; the tensor
    group's all-reduces over the slice (the embedding's and two a layer,
    2 (T - 1) / T of each from a card) and the logits' all-gather. The
    ring ops are billed to no dispatch, the tensor group's are the
    prefill's, and the accountant counts a prefill of the 33 tokens."""
    out = _grid(tmp_path_factory)
    cfg = out["cfg"]
    n, T, L, E = 2, 2, cfg.num_layers, cfg.hidden_size
    Sl = ring_length(33, n) // n
    kv = 2 * Sl * (cfg.num_kv_heads // T) * cfg.head_dim * 4
    tensor = {"all_reduce": (1 + 2 * L) * Sl * E * 4 * 2 * (T - 1) / T,
              "all_gather": cfg.vocab_size * 4 * (T - 1) / T}
    assert out["wire"] == {"ring_rotate": L * (n - 1) * kv,
                           "ring_gather": L * (n - 1) * kv,
                           "ring_last": E * 4 * (n - 1) / n, **tensor}
    assert out["billed"] == tensor
    assert out["perf_prefill"] == 33
    assert len(out["wire_tokens"][0]) == 1


def test_grid_followers_agree_after_the_scenarios(tmp_path_factory):
    reports = _grid(tmp_path_factory)["reports"]
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert all(r["diverged_at"] is None for r in reports)
    assert len({tuple(sorted(r["launches"].items()))
                for r in reports}) == 1


@pytest.mark.parametrize("source", ["seeded", "loaded"])
def test_each_process_makes_its_tensor_shard(source, tmp_path):
    """Without a whole dict each process makes its tensor rank's shard
    itself, seeded (every slice drawn, its cut kept) or loaded from a
    checkpoint: seq 2 x tp 2 serves what one device serves from the same
    seed or files."""
    from test_torch_checkpoint import write_checkpoint

    _, tconf = _configs("ragged")
    if source == "loaded":
        tconf = dataclasses.replace(tconf, model=dataclasses.replace(
            tconf.model, weights_path=write_checkpoint(tmp_path,
                                                       "tiny-llama")))
    want = drain(LLMEngine(tconf, device="cpu"), REQS)
    with rank_limit(120):
        eng = LLMEngine(_mesh(tconf, 2, 2), device="cpu")
        try:
            lengths = spy_lengths(eng.runner)
            got = drain(eng, REQS)
        finally:
            eng.close()
    assert lengths == [64, 64]
    assert_same(want, got)


# -- Gemma-2 ------------------------------------------------------------------

def test_gemma2_grid_ring_prefill_token_identical():
    """Gemma-2's score soft cap rides the ring on each tensor rank's
    heads: a 40-token prompt at seq 2 x tp 2 equals the JAX engine's ring
    at seq 4 x tensor 2."""
    prompt = [(7 * i + 3) % 500 + 1 for i in range(40)]
    sp = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True,
                        logprobs=2)
    jconf, tconf = _configs("ragged", "tiny-gemma2")
    assert tconf.model.attn_logit_softcap
    jeng = _jax_engine(jconf)
    want = drain(jeng, [("r", prompt, sp)])
    params = _params(jeng, tconf)
    del jeng
    with rank_limit(120):
        eng = LLMEngine(_mesh(tconf, 2, 2), params=params, device="cpu")
        try:
            lengths = spy_lengths(eng.runner)
            got = drain(eng, [("r", prompt, sp)])
        finally:
            eng.close()
    assert lengths == [64]
    assert_same(want, got)


# -- sizes and the server ---------------------------------------------------------

def test_tensor_size_resolves_over_the_cards_left_to_each_seq_rank(
        monkeypatch):
    """``-1`` takes the cards a seq rank is left: 8 cards at seq 2 give
    tensor 4, at seq 4 tensor 2, at seq 8 tensor 1; a size given is
    kept."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    got = [tmesh.tensor_size(MeshConfig(seq=n, tensor=-1), "cuda")
           for n in (1, 2, 4, 8)]
    assert got == [8, 4, 2, 1]
    assert tmesh.tensor_size(MeshConfig(seq=2, tensor=2), "cuda") == 2
    assert tmesh.tensor_size(MeshConfig(seq=2, tensor=-1), "cpu") == 1


def _args(*extra):
    return tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cpu", *extra])


def test_grid_flags_resolve():
    conf = tserver.config_from_args(_args(
        "--sequence-parallel-size", "2", "--tensor-parallel-size", "2"))
    assert conf.mesh == MeshConfig(seq=2, tensor=2)
    assert conf.scheduler.ring_prefill_threshold == 4096
    conf = tserver.config_from_args(_args(
        "--sequence-parallel-size", "2", "--tensor-parallel-size", "4",
        "--ring-prefill-threshold", "100"))
    assert (conf.mesh, conf.scheduler.ring_prefill_threshold) == (
        MeshConfig(seq=2, tensor=4), 100)


def test_grid_refuses_a_card_it_lacks():
    """Every process's device is checked before any rank starts: four
    processes on cuda:0..3 of a machine without them exit."""
    args = tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cuda",
         "--sequence-parallel-size", "2", "--tensor-parallel-size", "2"])
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"has {n} CUDA card") as e:
        tserver.server_from_args(args)
    assert "--sequence-parallel-size 2 --tensor-parallel-size 2" in str(
        e.value)
    import multiprocessing

    assert multiprocessing.active_children() == []


def test_server_serves_under_seq2_tp2_and_leaves_no_rank():
    """A long completion takes the ring and answers what the seq 1 x tp 1
    engine gives; the three followers leave at the server's stop."""
    extra = ["--skip-warmup", "--num-blocks", "64", "--max-num-seqs", "4",
             "--ring-prefill-threshold", "16"]
    body = {"model": "tiny-llama", "prompt": LONG_PROMPT, "max_tokens": 6,
            "temperature": 0.0, "ignore_eos": True, "logprobs": 1}
    one = tserver.server_from_args(_args(*extra))
    try:
        base = f"http://127.0.0.1:{one.start('127.0.0.1', 0)}"
        status, raw = http(base, "/v1/completions", body)
        assert status == 200
        want = json.loads(raw)["choices"][0]["logprobs"]["tokens"]
    finally:
        one.shutdown()
    with rank_limit(150):
        server = tserver.server_from_args(_args(
            *extra, "--sequence-parallel-size", "2",
            "--tensor-parallel-size", "2"))
        try:
            base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            ranks = json.loads(http(base, "/debug/perf")[1])["ranks"]
            assert (ranks["size"], ranks["axis"], ranks["shape"]) == (
                4, "seq,tensor", {"seq": 2, "tensor": 2})
            pids = ranks["pids"][1:]
            status, raw = http(base, "/v1/completions", body)
            assert status == 200
            out = json.loads(raw)
            assert out["usage"]["completion_tokens"] == 6
            assert out["choices"][0]["logprobs"]["tokens"] == want
            wire = server.async_engine.run_on_engine(
                lambda e: dict(e.runner.ranks.wire))
            assert wire["ring_rotate"] > 0 and wire["all_reduce"] > 0
        finally:
            server.shutdown()
        assert wait_gone(pids, 10) == []


def test_grid_sigterm_leaves_no_rank():
    """The CLI at seq 2 x tp 2: SIGTERM drains, the server exits 0 and its
    three followers are gone."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--num-blocks", "64", "--sequence-parallel-size", "2",
         "--tensor-parallel-size", "2", "--port", str(port), "--host",
         "127.0.0.1"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    pids = []
    try:
        base = f"http://127.0.0.1:{port}"
        t_end = time.monotonic() + 90
        while time.monotonic() < t_end:
            try:
                pids = json.loads(http(base, "/debug/perf")[1])["ranks"][
                    "pids"][1:]
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.3)
        assert len(pids) == 3, "the server did not come up"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        assert wait_gone(pids, 10) == []
    finally:
        proc.kill()
        proc.wait(10)
        kill_pids(pids)
