"""Tensor parallelism in the port against the JAX engine's, on the CPU.

- The reference's rules (``rules_for_model``, ``param_specs``) and mesh
  resolution, copied.
- Weights: a rank's seeded shard is bit for bit the slice of the tp = 1
  init; ``params_from_jax``, ``load_safetensors`` and ``shard_params``
  give the same slices.
- The KV pool: the ranks' pools side by side, in rank order, equal the
  JAX engine's shard-grouped pool at ``MeshConfig(tensor=2)`` after the
  same requests; at tp 4 (tiny-llama's two KV heads replicated) each rank
  holds the KV head its query heads read.
- The engine: tiny-llama in float32 at tp 2 and tp 4 against the JAX
  engine at ``tensor=2/4`` on the suite's 8 CPU devices, and against the
  port at tp 1, on mixed prefill+decode traffic on the ragged path and at
  tp 2 on the bucketed path: greedy tokens identical up to a near-tie
  (top-2 gap under 1e-4) and logprobs within 1e-4. n-gram speculation,
  guided decoding, seeded sampling with penalties and chained decode at
  tp 2 equal tp 1. Every follower's token digest equals rank 0's.
- The server with ``--device cpu --tensor-parallel-size 2``: completions,
  a stream, chat, embeddings, sleep and wake; an adapter loads, serves a
  completion and unloads (200); ``/kv/export`` answers a real block's
  bytes and a push into the server's own ``/kv/recv`` lands them (200);
  no rank survives the stop, nor a killed leader.
- Refusals: data, pipeline and sequence parallel sizes above 1 exit at
  start; ``--quantization int8``, MoE presets, the KV roles and tiers and
  Whisper start; the text engine refuses a Whisper model before any rank
  starts (Whisper's ranks are ``test_torch_tp_whisper.py``'s).
- The accountant counts the collective bytes the device group sent, by
  op (float32 partials: twice the reference's bf16 formula), and they
  equal rank 0's count after an engine run.

The model's features under tensor parallelism (MoE, int8, LoRA) are
``test_torch_tp_features.py``'s.

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``):
its rank processes are killed past its seconds and on its way out.
"""

import dataclasses
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain, engine_configs, tiny_weights
from _torch_tp import alive, kill_pids, rank_limit, wait_gone
from test_torch_lora import make_adapter_dir
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import perf_accounting as jperf
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu.parallel import shardings as jshard
from production_stack_tpu_torch.engine import kv_transfer as tkt
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine import perf_accounting as tperf
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import (
    init_random,
    load_safetensors,
    params_from_jax,
    shard_params,
)
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel import shardings as tshard
from production_stack_tpu_torch.parallel.mesh import MeshConfig, tensor_size

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GREEDY = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True,
                        logprobs=2)
rng = np.random.default_rng(11)
# chunked long prefill, short prefills and staggered arrivals: prefill
# chunks and decode rows share dispatches throughout
MIXED = [("r0", [1, 5, 9, 13, 2, 6], GREEDY),
         ("r1", list(range(1, 70)), GREEDY),
         ("r2", [3, 7, 11], GREEDY),
         ("r3", rng.integers(1, 500, 41).tolist(), GREEDY),
         ("r4", [2, 4], GREEDY)]
STAGGER = (2, 4, 6, 9)
NUM_BLOCKS = 96
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=32,
             prefill_buckets=(16, 32, 64, 128))


# -- rules, specs and the mesh ------------------------------------------------

def _ref_mesh(tp: int):
    """The reference's rules read only ``mesh.shape``."""
    shape = {a: 1 for a in jmesh.MESH_AXES}
    shape[jmesh.AXIS_TENSOR] = tp
    return types.SimpleNamespace(shape=shape)


@pytest.mark.parametrize("name,tp", [
    ("tiny-llama", 1), ("tiny-llama", 2), ("tiny-llama", 4),
    ("llama-3-8b", 2), ("llama-3-8b", 8), ("llama-3-8b", 16)])
def test_rules_match_the_reference(name, tp):
    want = jshard.rules_for_model(jcfg.ModelConfig.from_pretrained(name),
                                  _ref_mesh(tp))
    got = tshard.rules_for_model(ModelConfig.from_pretrained(name), tp)
    assert dict(got.rules) == dict(want.rules)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-qwen2", "tiny-qwen3",
                                  "tiny-gemma2", "tiny-mixtral"])
def test_param_specs_match_the_reference(name):
    assert (tllama.param_specs(ModelConfig.from_pretrained(name))
            == jllama.param_specs(jcfg.ModelConfig.from_pretrained(name)))


@pytest.mark.parametrize("n,sizes", [
    (8, dict(tensor=-1)), (8, dict(data=2, tensor=-1)),
    (4, dict(tensor=4)), (6, dict(data=-1, tensor=3))])
def test_mesh_resolves_as_the_reference(n, sizes):
    assert (dataclasses.asdict(MeshConfig(**sizes).resolved(n))
            == dataclasses.asdict(jmesh.MeshConfig(**sizes).resolved(n)))


def test_tensor_size_on_each_device():
    assert tensor_size(MeshConfig(), "cpu") == 1
    assert tensor_size(MeshConfig(tensor=4), "cpu") == 4
    with pytest.raises(ValueError, match="data"):
        tensor_size(MeshConfig(data=2, tensor=1), "cpu")
    with pytest.raises(ValueError):
        tensor_size(MeshConfig(tensor=0), "cpu")


def test_uneven_kv_share_is_refused():
    cfg = dataclasses.replace(ModelConfig.from_pretrained("tiny-llama"),
                              num_heads=6, num_kv_heads=2)
    with pytest.raises(ValueError, match="KV heads"):
        tshard.Shard.of(cfg, 0, 3)


# -- weights ------------------------------------------------------------------

def _slices_equal(full: dict, shard: dict, specs: dict, cut) -> None:
    for name, leaf in full.items():
        if isinstance(leaf, dict):
            _slices_equal(leaf, shard[name], specs[name], cut)
        else:
            assert torch.equal(cut(leaf, specs[name]), shard[name]), name


@pytest.mark.parametrize("name,tp", [
    ("tiny-llama", 2), ("tiny-llama", 4), ("tiny-gemma", 2),
    ("tiny-qwen2", 2), ("tiny-qwen3", 4)])
def test_seeded_shard_is_the_slice_of_tp1(name, tp):
    cfg = ModelConfig.from_pretrained(name)
    full = init_random(cfg, seed=3)
    specs = tllama.param_specs(cfg)
    for r in range(tp):
        sh = tshard.Shard.of(cfg, r, tp)
        _slices_equal(full, init_random(cfg, 3, "cpu", r, tp), specs, sh.cut)
        _slices_equal(full, shard_params(full, cfg, r, tp), specs, sh.cut)


@pytest.mark.parametrize("tp", [2, 4])
def test_params_from_jax_shards_are_the_slices(tp):
    jc = jcfg.ModelConfig.from_pretrained("tiny-llama")
    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, tensor=1),
                            devices=jax.devices()[:1])
    from production_stack_tpu.engine.weights import init_or_load

    np_params = jax.tree.map(np.asarray, jax.device_get(
        init_or_load(jc, mesh, seed=0)))
    cfg = ModelConfig.from_pretrained("tiny-llama")
    full = params_from_jax(np_params, cfg)
    specs = tllama.param_specs(cfg)
    for r in range(tp):
        _slices_equal(full, params_from_jax(np_params, cfg, "cpu", r, tp),
                      specs, tshard.Shard.of(cfg, r, tp).cut)


def test_checkpoint_shards_are_the_slices(tmp_path):
    from test_torch_checkpoint import write_checkpoint

    path = write_checkpoint(tmp_path, "tiny-llama")
    cfg = dataclasses.replace(ModelConfig.from_pretrained("tiny-llama"),
                              weights_path=path)
    full = load_safetensors(cfg)
    specs = tllama.param_specs(cfg)
    for r in range(2):
        _slices_equal(full, load_safetensors(cfg, "cpu", r, 2), specs,
                      tshard.Shard.of(cfg, r, 2).cut)


# -- engines ------------------------------------------------------------------

def _configs(tp: int, impl: str, **sched):
    jconf, tconf = engine_configs(impl, block_size=4, num_blocks=NUM_BLOCKS,
                                  **{**SCHED, **sched})
    jconf.mesh = jmesh.MeshConfig(data=1, tensor=tp)
    tconf.mesh = MeshConfig(tensor=tp)
    return jconf, tconf


_RUNS: dict = {}


def _run(tp: int, impl: str) -> dict:
    """The JAX engine at ``tensor=tp``, the port at tp and at tp 1, with
    the JAX engine's weights, on MIXED; cached for the module. Returns the
    runs, the follower reports and each engine's pool over the blocks
    the first request's prompt holds."""
    key = (tp, impl)
    if key in _RUNS:
        return _RUNS[key]
    jconf, tconf = _configs(tp, impl)
    jeng = JaxEngine(jconf, mesh=jmesh.build_mesh(
        jconf.mesh, devices=jax.devices()[:tp]), num_blocks=NUM_BLOCKS)
    params = params_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jeng.runner.params)), tconf.model)
    out = {"jax": drain(jeng, MIXED, STAGGER)}
    prompt = MIXED[1][1]
    blocks, _ = jeng.scheduler.allocator.match_prefix(prompt)
    out["jax_pool"] = np.asarray(jax.device_get(jeng.runner.kv))[:, blocks]
    one = LLMEngine(dataclasses.replace(tconf, mesh=MeshConfig(tensor=1)),
                    params=params, device="cpu")
    out["tp1"] = drain(one, MIXED, STAGGER)
    with rank_limit(120):
        eng = LLMEngine(tconf, params=params, device="cpu")
        try:
            out["tp"] = drain(eng, MIXED, STAGGER)
            mine, _ = eng.scheduler.allocator.match_prefix(prompt)
            out["pools"] = eng.runner.gather("export_blocks", mine)
            out["reports"] = eng.runner.follower_reports()
            out["perf"] = (eng.perf.tp, eng.perf.n_chips,
                           eng.perf.stats_fields()["collective_bytes"],
                           dict(eng.runner.ranks.wire))
            out["same_blocks"] = list(mine) == list(blocks)
        finally:
            eng.close()
    _RUNS[key] = out
    return out


CASES = [(2, "ragged"), (4, "ragged"), (2, "bucketed")]
IDS = [f"tp{tp}-{impl}" for tp, impl in CASES]


@pytest.mark.parametrize("tp,impl", CASES, ids=IDS)
def test_engine_matches_the_jax_engine(tp, impl):
    out = _run(tp, impl)
    assert_same(out["jax"], out["tp"])


@pytest.mark.parametrize("tp,impl", CASES, ids=IDS)
def test_engine_matches_one_rank(tp, impl):
    out = _run(tp, impl)
    assert_same(out["tp1"], out["tp"])


@pytest.mark.parametrize("tp,impl", CASES, ids=IDS)
def test_followers_sample_what_rank0_samples(tp, impl):
    reports = _run(tp, impl)["reports"]
    assert [r["rank"] for r in reports] == list(range(tp))
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)


@pytest.mark.parametrize("tp,impl", CASES, ids=IDS)
def test_accountant_reads_the_tensor_parallel_degree(tp, impl):
    deg, chips, coll, wire = _run(tp, impl)["perf"]
    # tiny-llama's heads divide 2 and 4; the ranks share the CPU
    assert (deg, chips) == (tp, 1)
    assert coll["all_reduce"] > 0 and coll["all_gather"] > 0
    # every byte rank 0 sent was billed to a dispatch
    assert coll == pytest.approx(wire)


def test_kv_pools_side_by_side_are_the_shard_grouped_pool():
    """At tp 2 the KV heads shard: rank r holds [K_r, V_r], and the ranks'
    pools in rank order are the reference's ``combine_kv(k, v, tp)``
    layout [K_0, V_0, K_1, V_1] (its pool at tensor=2)."""
    out = _run(2, "ragged")
    assert out["same_blocks"]
    side = np.concatenate(out["pools"], axis=3)
    assert side.shape == out["jax_pool"].shape
    np.testing.assert_allclose(side, out["jax_pool"], rtol=1e-5, atol=1e-5)


def test_replicated_kv_heads_keep_what_the_rank_reads():
    """At tp 4 tiny-llama's two KV heads are replicated (the reference's
    pool keeps them all, in the tp = 1 layout [K_0, K_1, V_0, V_1]): rank
    r, whose query head is r, holds KV head r // 2 alone."""
    out = _run(4, "ragged")
    assert out["same_blocks"]
    ref = out["jax_pool"]
    KH = ref.shape[3] // 2
    for r, pool in enumerate(out["pools"]):
        kv = r // 2
        want = np.stack([ref[:, :, :, kv], ref[:, :, :, KH + kv]], axis=3)
        np.testing.assert_allclose(pool, want, rtol=1e-5, atol=1e-5)


def _serve(eng, reqs):
    toks = {}
    for rid, prompt, sp in reqs:
        eng.add_request(rid, prompt_token_ids=prompt, sampling=sp)
    while eng.has_unfinished():
        for o in eng.step():
            toks.setdefault(o.request_id, []).extend(o.new_token_ids)
    return toks


def test_features_at_tp2_equal_tp1():
    """n-gram speculation, a guided regex, seeded sampling with penalties
    and logprobs at tp 2 give tp 1's tokens exactly, and speculation
    accepts drafts at both."""
    from test_torch_spec import GREEDY as SPEC_GREEDY, REPS, SEMI, WILD

    # test_torch_spec's staggered motif loops, where drafts are accepted
    spec = [("long", list(range(1, 50)), SPEC_GREEDY),
            ("rep", REPS, SPEC_GREEDY),
            ("loop", [31, 32, 33, 34] * 4, SPEC_GREEDY),
            ("semi", SEMI, SPEC_GREEDY), ("wild", WILD, SPEC_GREEDY)]
    rest = [("guided", [5, 6, 7], SamplingParams(
                temperature=0.0, max_tokens=8, guided_regex="[ab]{3}c")),
            ("sampled", [9, 8, 7, 6], SamplingParams(
                temperature=0.8, top_p=0.9, seed=5, max_tokens=10,
                ignore_eos=True, presence_penalty=0.5, logprobs=3))]
    params = tiny_weights()[2]
    runs = {}
    for tp in (1, 2):
        _, conf = _configs(tp, "ragged", spec_ngram_k=4)
        with rank_limit(90):
            eng = LLMEngine(conf, params=params, device="cpu")
            try:
                # a row that cannot speculate keeps its step from it: the
                # greedy loops go first, alone
                runs[tp] = (drain(eng, spec, (2, 3, 4, 5))[0],
                            _serve(eng, rest), eng.spec_accepted)
            finally:
                eng.close()
    assert runs[2][:2] == runs[1][:2]
    assert runs[2][2] == runs[1][2] > 0


def test_chained_decode_at_tp2_equals_tp1():
    """Chained decode dispatches feed each follower its own device-resident
    tokens (the sentinel the leader sends in their place)."""
    reqs = [(f"c{i}", p, SamplingParams(temperature=0.0, max_tokens=12,
                                        ignore_eos=True))
            for i, p in enumerate(([1, 2, 3], [4, 5, 6, 7], [8, 9]))]
    params = init_random(ModelConfig.from_pretrained("tiny-llama"), 2)
    runs = {}
    for tp in (1, 2):
        _, conf = _configs(tp, "bucketed", chain_decode=True)
        with rank_limit(90):
            eng = LLMEngine(conf, params=params, device="cpu")
            try:
                runs[tp] = _serve(eng, reqs)
                if tp == 2:
                    reports = eng.runner.follower_reports()
                    assert len({r["digest"] for r in reports}) == 1
            finally:
                eng.close()
    assert runs[2] == runs[1]


def test_a_follower_that_diverges_is_reported(caplog):
    runner = types.SimpleNamespace(ranks=types.SimpleNamespace(rank=1))
    rep = multihost.FollowerReplayer(runner)
    rep.check(1, multihost._Digest().hex())
    assert rep.diverged_at is None
    rep.check(5, "0" * 32)
    assert rep.diverged_at == 4
    assert "sampled other tokens" in caplog.text
    rep.check(6, "1" * 32)
    assert rep.report()["diverged_at"] == 4


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("extra,named", [
    # carried since the model's features run sharded: they start
    (["--quantization", "int8"], None),
    (["--model", "tiny-mixtral"], None),
    (["--model", "tiny-mixtral", "--quantization", "int8"], None),
    # carried since Whisper runs sharded: it starts
    (["--model", "tiny-whisper"], None),
    # carried since the KV plane runs sharded: they start
    (["--role", "prefill"], None),
    (["--role", "decode"], None),
    (["--kv-host-cache-bytes", "100000"], None),
    (["--host-offload-blocks", "8"], None),
    (["--remote-kv-url", "http://127.0.0.1:9"], None),
])
def test_what_tp_does_not_carry_exits_at_start(extra, named):
    args = tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cpu",
         "--tensor-parallel-size", "2"] + extra)
    if named is None:
        conf = tserver.config_from_args(args)
        assert conf.mesh == MeshConfig(tensor=2)
        assert multihost.refusal(conf) is None
        return
    with pytest.raises(SystemExit, match="tensor parallelism") as e:
        tserver.config_from_args(args)
    assert named in str(e.value)


@pytest.mark.parametrize("flag", ["--data-parallel-size",
                                  "--pipeline-parallel-size",
                                  "--sequence-parallel-size"])
def test_unported_parallel_sizes_exit(flag):
    args = tserver.build_parser().parse_args(
        ["--device", "cpu", flag, "2"])
    with pytest.raises(SystemExit, match=f"{flag} 2: .*not ported"):
        tserver.config_from_args(args)


def test_parallel_flags_resolve_on_the_cpu():
    parse = tserver.build_parser().parse_args
    assert tserver.config_from_args(
        parse(["--device", "cpu"])).mesh == MeshConfig(tensor=1)
    assert tserver.config_from_args(parse(
        ["--device", "cpu", "--tensor-parallel-size", "2",
         "--data-parallel-size", "1"])).mesh == MeshConfig(tensor=2)


def test_a_rank_without_its_card_exits_naming_the_count():
    """Rank r runs on cuda:r: two ranks on a machine with fewer cards
    exit before any process starts."""
    args = tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--tensor-parallel-size", "2"])
    n = torch.cuda.device_count()
    if n >= 2:
        pytest.skip("this machine has two cards")
    with pytest.raises(SystemExit, match=f"has {n} CUDA card"):
        tserver.server_from_args(args)


def test_engine_refuses_before_starting_ranks():
    conf = EngineConfig.for_model(
        "tiny-whisper", cache=CacheConfig(num_blocks=32),
        mesh=MeshConfig(tensor=2))
    with pytest.raises(ValueError, match="Whisper"):
        LLMEngine(conf, device="cpu")
    import multiprocessing

    assert multiprocessing.active_children() == []


# -- the server ---------------------------------------------------------------

def _http(base, path, body=None, method=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_serves_under_tp2_and_leaves_no_rank(tmp_path):
    args = tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--num-blocks", "64", "--max-num-seqs", "4",
         "--tensor-parallel-size", "2"])
    with rank_limit(120):
        server = tserver.server_from_args(args)
        try:
            base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            status, raw = _http(base, "/debug/perf")
            ranks = json.loads(raw)["ranks"]
            assert (status, ranks["size"], ranks["decode_graphs"]) == (
                200, 2, False)
            pids = ranks["pids"][1:]
            body = {"model": "tiny-llama", "prompt": [1, 2, 3, 4],
                    "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
            status, raw = _http(base, "/v1/completions", body)
            assert status == 200
            toks = json.loads(raw)["usage"]["completion_tokens"]
            assert toks == 6
            status, raw = _http(base, "/v1/completions",
                                {**body, "stream": True})
            assert status == 200 and raw.rstrip().endswith(b"data: [DONE]")
            status, _ = _http(base, "/v1/chat/completions", {
                "model": "tiny-llama", "max_tokens": 4,
                "messages": [{"role": "user", "content": "hi"}]})
            assert status == 200
            status, raw = _http(base, "/v1/embeddings",
                                {"model": "tiny-llama", "input": [[5, 6]]})
            assert status == 200
            assert len(json.loads(raw)["data"][0]["embedding"]) == 128
            assert _http(base, "/sleep?level=2", {})[0] == 200
            assert _http(base, "/wake_up", {})[0] == 200
            assert _http(base, "/v1/completions", body)[0] == 200
            adapter = make_adapter_dir(str(tmp_path), ModelConfig.from_pretrained(
                "tiny-llama"), seed=1)
            lora = {"lora_name": "a", "lora_path": adapter}
            assert _http(base, "/v1/load_lora_adapter", lora)[0] == 200
            assert _http(base, "/v1/completions",
                         {**body, "model": "a"})[0] == 200
            assert _http(base, "/v1/unload_lora_adapter", lora)[0] == 200
            # the KV routes: a real block out of /kv/export, and pushed
            # into this server's own /kv/recv
            prompt = list(range(1, 41))  # two full blocks of 16
            status, raw = _http(base, "/v1/completions", {
                **body, "prompt": prompt, "max_tokens": 1,
                "kv_transfer_params": {"do_remote_decode": True}})
            assert status == 200
            ids = json.loads(raw)["kv_transfer_params"]["remote_block_ids"]
            shape = server._kv_shape(2)
            status, raw = _http(base, "/kv/export", {"blocks": ids[:2]})
            assert status == 200
            assert len(raw) == tkt.nbytes_of(shape, "float32")
            want = server.async_engine.run_on_engine(
                lambda e: e.export_kv(ids[:2]))
            assert raw == bytes(tkt.tensor_bytes(want))
            server.async_engine.run_on_engine(
                lambda e: e.scheduler.allocator.pin_blocks(ids[:2]))
            try:
                got = tkt.push_kv(
                    base, server.async_engine.run_on_engine, ids[:2], shape,
                    "float32", {"transfer_id": "own", "prompt_token_ids":
                                prompt[:32], "first_token": 50}, group=1,
                    head_groups=2)
            finally:
                server.async_engine.run_on_engine(
                    lambda e: e.scheduler.allocator.free_blocks(ids[:2]))
            assert got == {"ok": True, "transfer_id": "own", "layers": 2}
            with server._kv_lock:
                landed = server._kv_transfers.pop("own")["blocks"]
            assert torch.equal(server.async_engine.run_on_engine(
                lambda e: e.export_kv(landed)), want)
            server.async_engine.run_on_engine(
                lambda e: e.scheduler.allocator.free_blocks(landed))
        finally:
            server.shutdown()
        assert wait_gone(pids, 10) == []


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_killed_leader_leaves_no_rank():
    """SIGKILL the serving process: its follower leaves within seconds
    (the control group's peer closes; the parent watch besides)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--num-blocks", "64", "--tensor-parallel-size", "2",
         "--port", str(port), "--host", "127.0.0.1"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    pids = []
    try:
        base = f"http://127.0.0.1:{port}"
        t_end = time.monotonic() + 90
        while time.monotonic() < t_end:
            try:
                status, raw = _http(base, "/debug/perf")
                pids = json.loads(raw)["ranks"]["pids"][1:]
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.3)
        assert pids, "the server did not come up"
        assert all(alive(p) for p in pids)
        proc.send_signal(signal.SIGKILL)
        proc.wait(10)
        assert wait_gone(pids, 10) == []
    finally:
        proc.kill()
        proc.wait(10)
        kill_pids(pids)


# -- the accountant -----------------------------------------------------------

def _wire_group(monkeypatch, size: int) -> pdist.RankGroup:
    """Rank 0 of a RankGroup of ``size`` whose collectives send nothing
    (torch.distributed's calls stubbed): only its byte counts move."""
    monkeypatch.setattr(pdist.dist, "all_reduce", lambda *a, **kw: None)
    monkeypatch.setattr(pdist.dist, "all_gather", lambda *a, **kw: None)
    return pdist.RankGroup(0, size, torch.device("cpu"), ("cpu",) * size,
                           "gloo", None)


def _decode_collectives(group, cfg, rows: int) -> None:
    """The collectives of one plain decode step of ``rows`` tokens, as the
    model sends them (models/llama.py): the embedding's all-reduce, two
    float32 row-parallel partials a layer, the logits' all-gather."""
    E, V = cfg.hidden_size, cfg.vocab_size // group.size
    group.all_reduce(torch.zeros(rows, E, dtype=torch.bfloat16))
    for _ in range(2 * cfg.num_layers):
        group.all_reduce(torch.zeros(rows, E))
    group.all_gather_last(torch.zeros(rows, V))


def test_collective_bytes_follow_the_reference_formulas(monkeypatch):
    """The same decode dispatches through both accountants at tp 4: the
    port counts the bytes its device group sent, by op, not the
    reference's formulas. Its row-parallel partials are float32 where the
    formula counts bf16, and the embedding's all-reduce is counted too;
    the logits' all-gather is the formula's."""
    name = "llama-3-8b"
    kw = dict(param_count=1000, param_bytes=2000, window=60.0, n_chips=4,
              tensor_parallel=4)
    ref = jperf.PerfAccountant(jcfg.ModelConfig.from_pretrained(name), **kw)
    cfg = ModelConfig.from_pretrained(name)
    got = tperf.PerfAccountant(cfg, **kw)
    group = _wire_group(monkeypatch, 4)
    got.wire = group.wire
    for ts in (100.0, 130.0):
        _decode_collectives(group, cfg, 8)
        got.record_decode(8, 1, 64, ts=ts)
        ref.record_decode(8, 1, 64, ts=ts)
    coll = got.stats_fields()["collective_bytes"]
    want = ref.stats_fields()["collective_bytes"]
    ring = 2.0 * 3 / 4
    E, L = cfg.hidden_size, cfg.num_layers
    assert coll["all_reduce"] == pytest.approx(
        2 * 8 * (2 * L + 1) * E * 4 * ring)
    assert coll["all_reduce"] == pytest.approx(
        want["all_reduce"] * 2 * (2 * L + 1) / (2 * L))
    assert coll["all_gather"] == pytest.approx(want["all_gather"])
    assert coll == pytest.approx(group.wire)
    assert got.snapshot()["tensor_parallel"] == 4


def test_int8_collectives_are_counted_by_op(monkeypatch):
    """The W8A8 route's collectives have ops of their own: the max of one
    float32 scale a row and the int32 partials' sum."""
    group = _wire_group(monkeypatch, 2)
    cfg = ModelConfig.from_pretrained("llama-3-8b")
    acc = tperf.PerfAccountant(cfg, param_count=1000, param_bytes=2000,
                               n_chips=1, tensor_parallel=2)
    acc.wire = group.wire
    rows, E = 64, cfg.hidden_size
    group.all_reduce_max(torch.zeros(rows))
    group.all_reduce_int32(torch.zeros(rows, E, dtype=torch.int32))
    acc.record_ragged(0, 0, 0, rows, 64 * rows, ts=10.0)
    coll = acc.stats_fields()["collective_bytes"]
    assert coll == {"all_reduce": 0.0, "all_gather": 0.0,
                    "all_reduce_max": rows * 4.0,
                    "all_reduce_int32": rows * E * 4.0}
    with pytest.raises(TypeError):
        group.all_reduce_int32(torch.zeros(2))
