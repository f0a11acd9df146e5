"""Sequence-parallel serving: the port's engine at seq 2 and 4 (CPU ranks
over gloo) against the JAX engine at ``MeshConfig(seq=4)`` and against
itself at seq 1, on the same weights (``params_from_jax``).

The counterparts of ``tests/test_ring_serving.py`` and of
``tests/test_gemma.py::test_gemma2_ring_prefill_token_identical``:

- Long prompts prefill whole through the ring, short ones stay on the
  chunked path, on both attention paths: greedy tokens identical to the
  JAX engine's, logprobs within 1e-4 (``_torch_parity.assert_same``), and
  to the port's at seq 1; every rank samples what rank 0 samples; each
  ring prefill is padded to the reference's length.
- The scheduler's pick, the short prompt that stays chunked, the prefix
  reuse after a ring prefill (the cached count), a seeded sampled request
  (judged within the port, ring against seq 1: JAX's threefry and torch
  draw different streams), an adapter (ring = the JAX ring = seq 1, and
  not the base model's), warmup's ring size classes, and the wire bytes
  and accounting of one ring prefill: all on one seq 4 engine
  (``_seq4``), since a process belongs to one rank group at a time.
- Gemma-2's soft cap through the ring at seq 2 against the JAX engine.
- The server at ``--sequence-parallel-size 2``: its flags, a long
  completion, its ranks gone after its stop and after SIGTERM; MoE and
  int8 models (int8 on the seq x tensor grid too), each role and each KV
  tier start and serve a long completion through the ring; Whisper and
  pipeline stages at seq 2 exit at start with a message (seq x tensor
  itself: ``test_torch_ring_tp``; the features through the ring against
  the JAX engine: ``test_torch_ring_features``, ``test_torch_ring_kv``).

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``).
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
from _torch_tp import rank_limit, wait_gone
from test_torch_lora import make_adapter_dir
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from production_stack_tpu_torch.parallel.ring_attention import ring_length

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
THRESHOLD = 16
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=32,
             prefill_buckets=(16, 32, 64), ring_prefill_threshold=THRESHOLD)
NUM_BLOCKS = 256
GREEDY = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True,
                        logprobs=2)
LONG_PROMPT = [(7 * i + 3) % 510 + 1 for i in range(45)]  # > threshold 16
rng = np.random.default_rng(20)
# two ring prefills (the oldest first) around a short prompt that stays
# on the chunked path, then decode rows together
REQS = [("long", LONG_PROMPT, GREEDY),
        ("short", [1, 5, 9, 13, 2], GREEDY),
        ("long2", rng.integers(1, 500, 37).tolist(), GREEDY)]


def _configs(impl: str, model: str = "tiny-llama"):
    jconf, tconf = engine_configs(impl, block_size=4, num_blocks=NUM_BLOCKS,
                                  **SCHED)
    if model != "tiny-llama":
        jconf.model = jcfg.ModelConfig.from_pretrained(model)
        tconf.model = ModelConfig.from_pretrained(model)
    jconf.mesh = jmesh.MeshConfig(data=1, seq=4, tensor=1)
    return jconf, tconf


def _jax_engine(jconf):
    return JaxEngine(jconf, mesh=jmesh.build_mesh(
        jconf.mesh, devices=jax.devices()[:4]), num_blocks=NUM_BLOCKS)


def _params(jeng, tconf):
    return params_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jeng.runner.params)), tconf.model)


_RUNS: dict = {}


def _run(seq: int, impl: str) -> dict:
    """The JAX engine at seq 4, the port at seq 1 and at ``seq`` on REQS
    with the JAX engine's weights; cached for the module."""
    key = (seq, impl)
    if key in _RUNS:
        return _RUNS[key]
    jconf, tconf = _configs(impl)
    jeng = _jax_engine(jconf)
    params = _params(jeng, tconf)
    out = {"jax_lengths": spy_lengths(jeng.runner)}
    out["jax"] = drain(jeng, REQS)
    out["seq1"] = drain(LLMEngine(tconf, params=params, device="cpu"), REQS)
    with rank_limit(120):
        eng = LLMEngine(dataclasses.replace(
            tconf, mesh=MeshConfig(seq=seq, tensor=1)), params=params,
            device="cpu")
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


CASES = [(2, "ragged"), (4, "ragged"), (2, "bucketed")]
IDS = [f"seq{n}-{impl}" for n, impl in CASES]


@pytest.mark.parametrize("seq,impl", CASES, ids=IDS)
def test_ring_prefill_token_identical(seq, impl):
    out = _run(seq, impl)
    assert_same(out["jax"], out["got"])


@pytest.mark.parametrize("seq,impl", CASES, ids=IDS)
def test_ring_matches_seq1(seq, impl):
    out = _run(seq, impl)
    assert_same(out["seq1"], out["got"])


@pytest.mark.parametrize("seq,impl", CASES, ids=IDS)
def test_ring_pads_as_the_reference(seq, impl):
    """Both long prompts took the ring, alone, at the reference's padded
    length (the reference pads to a multiple of its 4 seq devices, the
    port of its ranks: both 64 here)."""
    out = _run(seq, impl)
    assert out["lengths"] == out["jax_lengths"] == [
        ring_length(45, seq), ring_length(37, seq)] == [64, 64]


@pytest.mark.parametrize("seq,impl", CASES, ids=IDS)
def test_followers_sample_what_rank0_samples(seq, impl):
    out = _run(seq, impl)
    reports = out["reports"]
    assert [r["rank"] for r in reports] == list(range(seq))
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)
    ranks = out["ranks"]
    assert (ranks["size"], ranks["axis"], ranks["decode_graphs"]) == (
        seq, "seq", False)


# -- one seq 4 engine, scenario after scenario ----------------------------------

SAMPLED = SamplingParams(temperature=0.9, top_k=30, seed=7, max_tokens=5,
                         ignore_eos=True)
GREEDY4 = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
# a distinct long prompt a scenario: a prompt seen before is cached and
# leaves the ring
PROMPTS = {name: rng.integers(1, 500, n).tolist()
           for name, n in (("pick", 40), ("reuse", 45), ("sampled", 41),
                           ("adapter", 43), ("wire", 33))}


def _seq4_scenarios(eng, adapter_dir: str) -> dict:
    out = {}
    sched = eng.scheduler
    # the pick: a long fresh prompt goes whole and alone
    eng.add_request("pick", prompt_token_ids=PROMPTS["pick"],
                    sampling=GREEDY4)
    pick = sched.schedule()
    out["pick"] = [(p.ring, p.chunk_start, p.chunk_len)
                   for p in pick.prefills]
    while eng.has_unfinished():
        eng.step()
    # a short prompt stays on the chunked path
    sched.config.ring_prefill_threshold = 64
    eng.add_request("short", prompt_token_ids=[1, 2, 3], sampling=GREEDY4)
    short = sched.schedule()
    out["short"] = [p.ring for p in short.prefills]
    while eng.has_unfinished():
        eng.step()
    sched.config.ring_prefill_threshold = THRESHOLD
    # prefix reuse: the same prompt again takes the chunked path from
    # the ring-built blocks
    out["reuse"] = [serve_one(eng, PROMPTS["reuse"], GREEDY4, rid=rid)
                    for rid in ("first", "again")]
    # the KV plane: an export is rank 0's own blocks, whole; an import
    # lands whole in every rank's pool
    blocks, _ = sched.allocator.match_prefix(PROMPTS["reuse"])
    data = eng.export_kv(blocks)
    free = sched.allocator.take_free_blocks(len(blocks))
    eng.runner.import_blocks(free, data)
    out["kv"] = (len(blocks), [
        [np.array_equal(p, data.numpy()) for p in eng.runner.gather(
            "export_blocks", ids)] for ids in (list(blocks), free)])
    sched.allocator.free_blocks(free)
    out["sampled"] = serve_one(eng, PROMPTS["sampled"], SAMPLED)[0]
    # the wire bytes and the accounting of one ring prefill
    wire0 = dict(eng.runner.ranks.wire)
    n_prefill = eng.perf.snapshot()["totals"]["prefill_tokens"]
    out["wire_tokens"] = serve_one(eng, PROMPTS["wire"],
                              dataclasses.replace(GREEDY4, max_tokens=1))
    out["wire"] = {op: n - wire0.get(op, 0.0)
                   for op, n in eng.runner.ranks.wire.items()
                   if n != wire0.get(op, 0.0)}
    out["perf_prefill"] = (eng.perf.snapshot()["totals"]["prefill_tokens"]
                           - n_prefill)
    out["collective"] = eng.perf.stats_fields()["collective_bytes"]
    # an adapter through the ring
    manager = tlora.LoraManager(eng)
    manager.load("a", adapter_dir)
    out["adapter"] = serve_one(eng, PROMPTS["adapter"], GREEDY4,
                          manager.slot_of("a"))[0]
    out["base"] = serve_one(eng, PROMPTS["adapter"] + [7], GREEDY4)[0]
    # warmup walks the ring size classes
    lengths = spy_lengths(eng.runner)
    eng.warmup()
    out["warm_lengths"] = sorted(set(lengths))
    out["compiles"] = sorted(
        bucket for kind, bucket in eng.perf.stats_fields()["compile_counts"]
        if kind == "prefill_ring")
    out["reports"] = eng.runner.follower_reports()
    return out


_SEQ4: dict = {}


def _seq4(tmp_path_factory) -> dict:
    if _SEQ4:
        return _SEQ4
    root = str(tmp_path_factory.mktemp("ring-adapter"))
    adapter_dir = make_adapter_dir(root, ModelConfig.from_pretrained(
        "tiny-llama"), seed=5)
    jconf, tconf = _configs("ragged")
    jeng = _jax_engine(jconf)
    params = _params(jeng, tconf)
    jeng.runner.register_lora(1, jlora.load_adapter_raw(
        "a", adapter_dir, jconf.model, jconf.max_lora_rank))
    _SEQ4["jax_adapter"] = drain(jeng, [("r0", PROMPTS["adapter"], GREEDY4,
                                         1)])[0]["r0"]
    one = LLMEngine(tconf, params=params, device="cpu")
    _SEQ4["seq1_sampled"] = serve_one(one, PROMPTS["sampled"], SAMPLED)[0]
    tlora.LoraManager(one).load("a", adapter_dir)
    _SEQ4["seq1_adapter"] = serve_one(one, PROMPTS["adapter"], GREEDY4, 1)[0]
    with rank_limit(150):
        eng = LLMEngine(dataclasses.replace(
            tconf, mesh=MeshConfig(seq=4, tensor=1)), params=params,
            device="cpu")
        try:
            _SEQ4.update(_seq4_scenarios(eng, adapter_dir))
            _SEQ4["cfg"] = eng.config.model
        finally:
            eng.close()
    return _SEQ4


def test_ring_scheduler_takes_ring_path(tmp_path_factory):
    out = _seq4(tmp_path_factory)
    assert out["pick"] == [(True, 0, len(PROMPTS["pick"]))]


def test_short_prompt_stays_on_chunked_path(tmp_path_factory):
    assert _seq4(tmp_path_factory)["short"] == [False]


def test_ring_then_prefix_cache_reuse(tmp_path_factory):
    """The ring-built blocks are the paged blocks a chunked prefill would
    have built: the same prompt again hits the cache for every full
    block but the last token's and decodes identically."""
    (first, cached0), (again, cached) = _seq4(tmp_path_factory)["reuse"]
    assert again == first and cached0 == 0
    assert cached == (len(PROMPTS["reuse"]) - 1) // 4 * 4


def test_kv_export_and_import_at_seq4(tmp_path_factory):
    """Every seq rank holds the ring-built blocks whole: rank 0's export
    is each rank's blocks, and an import lands in every rank's pool."""
    n, (exported, landed) = _seq4(tmp_path_factory)["kv"]
    assert n == len(PROMPTS["reuse"]) // 4
    assert exported == landed == [True] * 4


def test_ring_sampled_seeded_matches_seq1(tmp_path_factory):
    out = _seq4(tmp_path_factory)
    assert out["sampled"] == out["seq1_sampled"]


def test_ring_lora_matches_dense(tmp_path_factory):
    """The ring applies the adapter to every rank's slice: the port's
    ring equals the JAX engine's ring and the port's chunked prefill at
    seq 1 under the adapter, and the base model's output differs."""
    out = _seq4(tmp_path_factory)
    assert out["adapter"] == out["jax_adapter"] == out["seq1_adapter"]
    assert out["adapter"] != out["base"]


def test_ring_warmup_compiles_ring_variants(tmp_path_factory):
    """Warmup runs the reference's ring size classes (each power of two
    from the threshold below max_model_len 512), each a ring signature
    the accountant saw; the ranks still agree after it."""
    out = _seq4(tmp_path_factory)
    assert out["warm_lengths"] == [16, 32, 64, 128, 256]
    assert {"16", "32", "64", "128", "256"} <= set(out["compiles"])
    reports = out["reports"]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert all(r["diverged_at"] is None for r in reports)


def test_ring_wire_bytes_of_one_prefill(tmp_path_factory):
    """One ring prefill of 33 tokens (padded to 64, 16 a rank) over 4
    ranks, float32, each layer: 3 rotations of a rank's K and V, the
    gather of all 64 tokens' K+V (3/4 of it from each card), and the
    last token's hidden row sent to the others. None of it is billed to
    a dispatch, and the accountant counts a prefill of the 33 tokens."""
    out = _seq4(tmp_path_factory)
    cfg = out["cfg"]
    n, Sl, L = 4, ring_length(33, 4) // 4, cfg.num_layers
    kv = 2 * Sl * cfg.num_kv_heads * cfg.head_dim * 4
    assert out["wire"] == {"ring_rotate": L * (n - 1) * kv,
                           "ring_gather": L * (n - 1) * kv,
                           "ring_last": cfg.hidden_size * 4 * (n - 1) / n}
    assert out["perf_prefill"] == 33
    assert not any(out["collective"].values())
    assert len(out["wire_tokens"][0]) == 1


# -- Gemma-2 ------------------------------------------------------------------

def test_gemma2_ring_prefill_token_identical():
    """Gemma-2's score soft cap rides the ring: a 40-token prompt at seq
    2 equals the JAX engine's ring at seq 4."""
    prompt = [(7 * i + 3) % 500 + 1 for i in range(40)]
    sp = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True,
                        logprobs=2)
    jconf, tconf = _configs("ragged", "tiny-gemma2")
    assert tconf.model.attn_logit_softcap
    jeng = _jax_engine(jconf)
    want = drain(jeng, [("r", prompt, sp)])
    with rank_limit(90):
        eng = LLMEngine(dataclasses.replace(
            tconf, mesh=MeshConfig(seq=2, tensor=1)),
            params=_params(jeng, tconf), device="cpu")
        try:
            lengths = spy_lengths(eng.runner)
            got = drain(eng, [("r", prompt, sp)])
        finally:
            eng.close()
    assert lengths == [64]
    assert_same(want, got)


# -- the server -----------------------------------------------------------------

def _args(*extra):
    return tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cpu", *extra])


def test_sequence_parallel_flags_resolve():
    conf = tserver.config_from_args(_args("--sequence-parallel-size", "2"))
    assert conf.mesh == MeshConfig(seq=2, tensor=1)
    assert conf.scheduler.ring_prefill_threshold == 4096
    conf = tserver.config_from_args(_args(
        "--sequence-parallel-size", "4", "--ring-prefill-threshold", "100"))
    assert (conf.mesh.seq, conf.scheduler.ring_prefill_threshold) == (4, 100)
    # the threshold needs seq ranks, as in the reference
    conf = tserver.config_from_args(_args("--ring-prefill-threshold", "100"))
    assert (conf.mesh.seq, conf.scheduler.ring_prefill_threshold) == (1, 0)


@pytest.mark.parametrize("extra,named", [
    (["--model", "tiny-whisper", "--pipeline-parallel-size", "2"],
     "sequence and pipeline parallelism"),
    (["--model", "tiny-whisper"], "Whisper"),
    (["--model", "tiny-whisper", "--tensor-parallel-size", "2",
      "--pipeline-parallel-size", "2"],
     "sequence, pipeline and tensor parallelism"),
])
def test_what_seq_does_not_carry_exits_at_start(extra, named):
    args = _args("--sequence-parallel-size", "2", *extra)
    with pytest.raises(SystemExit, match="later slice") as e:
        tserver.server_from_args(args)
    assert named in str(e.value)
    import multiprocessing

    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("extra", [
    ["--tensor-parallel-size", "2", "--quantization", "int8"],
    ["--model", "tiny-mixtral"],
    ["--quantization", "int8"],
    ["--role", "prefill"],
    ["--role", "decode"],
    ["--kv-host-cache-bytes", "100000"],
    ["--host-offload-blocks", "8"],
    ["--remote-kv-url", "http://127.0.0.1:9"],
], ids=["tp2-int8", "moe", "int8", "prefill", "decode", "host-bytes",
        "host-blocks", "remote"])
def test_seq2_starts_and_serves_one_request(extra):
    """What a later slice was to carry at seq 2 (MoE and int8 models, a
    role, the tiers; int8 on the grid too) starts and serves a long
    completion through the ring; its ranks leave at the server's stop."""
    with rank_limit(120):
        server = tserver.server_from_args(_args(
            "--sequence-parallel-size", "2", "--skip-warmup", "--num-blocks",
            "64", "--max-num-seqs", "4", "--ring-prefill-threshold", "16",
            *extra))
        try:
            base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            perf = json.loads(http(base, "/debug/perf")[1])
            pids = perf["ranks"]["pids"][1:]
            status, raw = http(base, "/v1/completions", {
                "model": server.config.model.name, "prompt": LONG_PROMPT,
                "max_tokens": 2, "temperature": 0.0, "ignore_eos": True})
            assert status == 200
            assert json.loads(raw)["usage"]["completion_tokens"] == 2
            counts = json.loads(http(base, "/debug/perf")[1])["compile"][
                "counts"]
            assert counts.get("prefill_ring:64") == 1
        finally:
            server.shutdown()
        assert wait_gone(pids, 10) == []


def test_engine_refuses_before_starting_ranks():
    conf = EngineConfig.for_model(
        "tiny-whisper", cache=CacheConfig(num_blocks=32),
        mesh=MeshConfig(seq=2, tensor=1))
    with pytest.raises(ValueError, match="Whisper"):
        LLMEngine(conf, device="cpu")
    conf = EngineConfig.for_model(
        "tiny-whisper", cache=CacheConfig(num_blocks=32),
        mesh=MeshConfig(seq=2, stage=2))
    with pytest.raises(ValueError, match="Whisper.*sequence and pipeline "
                       "parallelism"):
        LLMEngine(conf, device="cpu")
    import multiprocessing

    assert multiprocessing.active_children() == []


def test_server_serves_under_seq2_and_leaves_no_rank():
    """A long completion takes the ring and answers what the seq 1 engine
    gives; the ranks leave at the server's stop."""
    extra = ["--skip-warmup", "--num-blocks", "64", "--max-num-seqs", "4",
             "--ring-prefill-threshold", "16"]
    prompt = LONG_PROMPT
    body = {"model": "tiny-llama", "prompt": prompt, "max_tokens": 6,
            "temperature": 0.0, "ignore_eos": True, "logprobs": 1}
    one = tserver.server_from_args(_args(*extra))
    try:
        base = f"http://127.0.0.1:{one.start('127.0.0.1', 0)}"
        status, raw = http(base, "/v1/completions", body)
        assert status == 200
        want = json.loads(raw)["choices"][0]["logprobs"]["tokens"]
    finally:
        one.shutdown()
    with rank_limit(120):
        server = tserver.server_from_args(_args(
            *extra, "--sequence-parallel-size", "2"))
        try:
            base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            ranks = json.loads(http(base, "/debug/perf")[1])["ranks"]
            assert (ranks["size"], ranks["axis"]) == (2, "seq")
            pids = ranks["pids"][1:]
            status, raw = http(base, "/v1/completions", body)
            assert status == 200
            out = json.loads(raw)
            assert out["usage"]["completion_tokens"] == 6
            assert out["choices"][0]["logprobs"]["tokens"] == want
            wire = server.async_engine.run_on_engine(
                lambda e: dict(e.runner.ranks.wire))
            assert wire["ring_rotate"] > 0 and wire["ring_gather"] > 0
            status, raw = http(base, "/v1/completions",
                                {**body, "stream": True})
            assert status == 200 and raw.rstrip().endswith(b"data: [DONE]")
        finally:
            server.shutdown()
        assert wait_gone(pids, 10) == []


def test_sigterm_leaves_no_rank():
    """The CLI at seq 2: SIGTERM drains, the server exits 0 and its
    follower is gone."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--num-blocks", "64", "--sequence-parallel-size", "2",
         "--port", str(port), "--host", "127.0.0.1"],
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
        assert len(pids) == 1, "the server did not come up"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        assert wait_gone(pids, 10) == []
    finally:
        proc.kill()
        proc.wait(10)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
