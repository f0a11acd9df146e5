"""Pipeline x tensor parallelism: the port's engine on the stage x tensor
grid (four CPU processes over gloo, pp 2 x tp 2) against the JAX engine
at ``MeshConfig(stage=2, tensor=2)`` on four virtual devices and against
the port's own tp 2 bucketed engine, on the same weights
(``params_from_jax``).

The counterpart of ``tests/test_pp_engine.py::test_pp2_tp2_token_identical``
(pp 2 x tp 2 equals tp 2), widened to the cases of ``test_torch_pp``, at
its configs: tiny-llama in float32, ``block_size=4``,
``prefill_buckets=(16, 32)``, ``max_num_seqs=4``, its prompts.

- The engine: four processes, process g stage g // 2 and tensor rank g %
  2, each a pool of its stage's one layer and its one KV head. Greedy
  tokens equal the JAX engine's at stage 2 x tensor 2 up to a near-tie
  (the gaps from tp 2's run with logprobs), and tp 2's bit for bit at
  multi-step 1 and 4, under seeded sampling and under penalties; every
  process samples what rank 0 samples. The prefix cache serves 8 tokens
  of a repeated 9-token prompt.
- KV: an export (whole, in layer groups, as slabs) equals tp 2's bit for
  bit; an import into another pp 2 x tp 2 engine and into a tp 2 engine
  is a prefix hit; each process holds its stage's layer of its tensor
  share of an import. LoRA: an adapter's tokens equal tp 2's. Sleep level
  2 and wake give the same tokens, seeded shares tp 2's. Scoring: pooled
  embeddings within 2e-3 of tp 2's and the JAX engine's, guided_choice
  scores within 1e-4 of tp 2's. tiny-mixtral matches the JAX engine at
  stage 2 x tensor 2.
- Weights: a process's seeded share (and int8 share) and its
  ``params_from_jax`` share are the stage-then-tensor slice of the whole,
  bit for bit; rank 0 holds its slice.
- Refusals: logprobs and guided regex, as at pp; Whisper before any
  process starts; a card the machine lacks.
- The stage relay's bytes are counted and billed to no dispatch.
- A killed stage-1 follower is ``RankLost`` at the leader's next call.
- The server at ``--pipeline-parallel-size 2 --tensor-parallel-size 2
  --device cpu``: completions, a stream, chat, embeddings, sleep and wake,
  an adapter, ``/kv/export``, ``/debug/perf``; after SIGTERM every
  follower is gone within 3 s.

Every engine with ranks runs under ``rank_limit`` (``_torch_tp``); two
never live at once (one torch.distributed group a process), so the
module's engines run one after another, once (``_runs``).
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

from _torch_parity import assert_same, drain, tiny_weights, top2_gaps
from _torch_ring import free_port, http
from _torch_tp import kill_pids, rank_limit, wait_gone
from test_torch_lora import make_adapter_dir
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.weights import init_or_load as jax_init
from production_stack_tpu.parallel.mesh import MeshConfig as JaxMesh
from production_stack_tpu.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import kv_transfer as tkt
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine import weights as tweights
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import LoraManager
from production_stack_tpu_torch.engine.pp_runner import StageRankRunner
from production_stack_tpu_torch.engine.quant import quantize_params
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel import mesh as tmesh
from production_stack_tpu_torch.parallel import shardings as tshard
from production_stack_tpu_torch.parallel.mesh import MeshConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NUM_BLOCKS = 128
BS = 4
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=64,
             prefill_buckets=(16, 32))
GREEDY = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
LP = dataclasses.replace(GREEDY, logprobs=2)
SEEDED = SamplingParams(temperature=0.8, top_k=40, seed=123, max_tokens=6,
                        ignore_eos=True)
PENALTIES = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True,
                           presence_penalty=1.5, frequency_penalty=0.5)
SHORT = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True)
_rng = np.random.default_rng(19)
# test_torch_pp's: five requests on four slots, one longer than the top
# bucket (chunked)
PROMPTS = [_rng.integers(1, 500, int(n)).tolist() for n in (5, 3, 7, 40, 12)]
PREFIX = list(range(101, 110))  # 9 tokens: two full blocks cached
KV_PROMPT = list(range(201, 213))  # 12 tokens: two full blocks moved
SLOTS = [1, 0, 1, 1, 0]  # the adapter's rows
CHOICES = [[7, 8], [9], [10, 11, 12]]


def reqs(sp, prompts=PROMPTS, adapters=None):
    return [(f"r{i}", p, sp, adapters[i] if adapters else 0)
            for i, p in enumerate(prompts)]


def port_engine(stage: int, tensor: int, params=None, model="tiny-llama",
                multi_step: int = 1) -> LLMEngine:
    cfg = tcfg.EngineConfig.for_model(
        model, cache=tcfg.CacheConfig(block_size=BS, num_blocks=NUM_BLOCKS),
        scheduler=tcfg.SchedulerConfig(multi_step=multi_step, **SCHED),
        attention_impl="bucketed", mesh=MeshConfig(stage=stage,
                                                   tensor=tensor))
    return LLMEngine(cfg, params=params, num_blocks=NUM_BLOCKS, device="cpu")


def jax_engine(params, model="tiny-llama") -> JaxEngine:
    """The reference's ``make_engine(stage=2, tensor=2)`` on four of the
    virtual devices."""
    cfg = jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained(model),
        cache=jcfg.CacheConfig(block_size=BS, num_blocks=NUM_BLOCKS),
        scheduler=jcfg.SchedulerConfig(**SCHED),
        mesh=JaxMesh(data=1, stage=2, tensor=2))
    mesh = build_mesh(cfg.mesh, devices=jax.devices()[:4])
    return JaxEngine(cfg, mesh=mesh, params=params, num_blocks=NUM_BLOCKS)


def serve(eng, prompt, sp, rid="p") -> tuple:
    """One request to its end: (its tokens, the largest cached count)."""
    eng.add_request(rid, prompt_token_ids=prompt, sampling=sp)
    toks, cached = [], 0
    while eng.has_unfinished():
        for o in eng.step():
            toks.extend(o.new_token_ids)
            cached = max(cached, o.num_cached_tokens)
    return toks, cached


def _kv(eng) -> dict:
    """``KV_PROMPT``'s two full blocks out of ``eng``: whole, by layer
    group and as slabs."""
    seq = eng.add_request("kv", prompt_token_ids=KV_PROMPT, sampling=SHORT)
    eng.step()
    blocks = list(seq.block_ids[:2])
    while eng.has_unfinished():
        eng.step()
    L = eng.config.model.num_layers
    return {"blocks": blocks, "whole": eng.export_kv(blocks),
            "groups": torch.cat([eng.runner.export_blocks_range(blocks, lo, 1)
                                 for lo in range(L)]),
            "slabs": eng.runner.export_slabs(blocks)}


def _adapter(root: str) -> str:
    return make_adapter_dir(root, tcfg.ModelConfig.from_pretrained(
        "tiny-llama"), seed=5)


def _common(eng, adapter: str) -> dict:
    """What both the pp 2 x tp 2 and the tp 2 engine run on the JAX
    engine's weights, in one order."""
    out = {"greedy": drain(eng, reqs(GREEDY)),
           "seeded": drain(eng, reqs(SEEDED)),
           "penalties": drain(eng, reqs(PENALTIES)),
           "kv": _kv(eng), "embed": eng.embed(PROMPTS[2]),
           "choice": eng.choice_logprobs(PROMPTS[0], CHOICES)}
    manager = LoraManager(eng)
    manager.load("a", adapter)
    out["lora_root"] = eng.runner.lora_roots[1]
    out["lora"] = drain(eng, reqs(GREEDY, adapters=SLOTS))
    manager.unload("a")
    return out


def _grid_main(eng, adapter: str) -> dict:
    """The pp 2 x tp 2 engine on the JAX engine's weights."""
    out = {"ranks": eng.rank_info(), "params0": eng.runner.params,
           "pools": eng.runner.gather("export_blocks", [0])}
    out.update(_common(eng, adapter))
    out["prefix"] = [serve(eng, PREFIX, SHORT, rid) for rid in ("a", "b")]
    out["base"] = drain(eng, reqs(GREEDY))
    # an import lands each process's part: its stage's layer of its
    # tensor share
    sched = eng.scheduler
    data = out["kv"]["whole"]
    free = sched.allocator.take_free_blocks(2)
    eng.runner.import_blocks(free, data)
    out["landed"] = eng.runner.gather("export_blocks", free)
    eng.runner.import_slabs(free, out["kv"]["slabs"])
    out["slabs_back"] = eng.export_kv(free)
    sched.allocator.free_blocks(free)
    refused = []
    for sp in (SamplingParams(logprobs=2),
               SamplingParams(max_tokens=4, guided_regex="[a-z]+")):
        try:
            eng.add_request("x", prompt_token_ids=[1, 2, 3], sampling=sp)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    wire0 = dict(eng.runner.ranks.wire)
    billed0 = dict(eng.perf.stats_fields()["collective_bytes"])
    serve(eng, [3, 1, 4, 1, 5], SHORT, "wire")
    out["wire"] = {op: n - wire0.get(op, 0.0)
                   for op, n in eng.runner.ranks.wire.items()
                   if n != wire0.get(op, 0.0)}
    out["billed"] = {op: n - billed0.get(op, 0.0) for op, n in
                     eng.perf.stats_fields()["collective_bytes"].items()
                     if n != billed0.get(op, 0.0)}
    out["reports"] = eng.runner.follower_reports()
    return out


_RUNS: dict = {}


def _runs(tmp_path_factory) -> dict:
    """Every engine of the module, one after another, once: the JAX
    engines, the pp 2 x tp 2 engines, the tp 2 engines."""
    if _RUNS:
        return _RUNS
    mesh, jparams, params = tiny_weights()
    adapter = _adapter(str(tmp_path_factory.mktemp("pptp-adapter")))
    jeng = jax_engine(jparams)
    _RUNS["jax"] = {"greedy": drain(jeng, reqs(GREEDY)),
                    "embed": np.asarray(jeng.embed(PROMPTS[2]))}
    del jeng
    mix_cfg = jcfg.ModelConfig.from_pretrained("tiny-mixtral")
    mix_j = jax_init(mix_cfg, build_mesh(JaxMesh(data=1, tensor=1)), seed=0)
    mix = tweights.params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(mix_j)),
        tcfg.ModelConfig.from_pretrained("tiny-mixtral"))
    _RUNS["jax_mixtral"] = drain(jax_engine(mix_j, "tiny-mixtral"),
                                 reqs(GREEDY))
    _RUNS["mixtral_gaps"] = top2_gaps(drain(
        port_engine(1, 1, mix, "tiny-mixtral"), reqs(LP))[1])
    _RUNS["params"] = params
    with rank_limit(240):
        eng = port_engine(2, 2, params)
        try:
            _RUNS["grid"] = _grid_main(eng, adapter)
        finally:
            eng.close()
        data = _RUNS["grid"]["kv"]["whole"]
        eng = port_engine(2, 2, params, multi_step=4)
        try:
            _RUNS["grid_ms4"] = drain(eng, reqs(GREEDY))
            _RUNS["grid_import"] = (eng.import_kv(KV_PROMPT, data),
                                    serve(eng, KV_PROMPT, SHORT))
        finally:
            eng.close()
        eng = port_engine(2, 2)
        try:
            before = drain(eng, reqs(GREEDY, PROMPTS[:2]))
            eng.sleep_mode(2)
            asleep = (eng.runner.kv_alive, eng.runner.params_alive)
            eng.wake_mode()
            _RUNS["sleep"] = {"before": before, "asleep": asleep,
                              "awake": (eng.runner.kv_alive,
                                        eng.runner.params_alive),
                              "after": drain(eng, reqs(GREEDY, PROMPTS[:2]))}
        finally:
            eng.close()
        eng = port_engine(2, 2, mix, "tiny-mixtral")
        try:
            _RUNS["grid_mixtral"] = drain(eng, reqs(GREEDY))
        finally:
            eng.close()
        eng = port_engine(1, 2, params)
        try:
            _RUNS["tp2_lp"] = drain(eng, reqs(LP))
            _RUNS["tp2"] = _common(eng, adapter)
            _RUNS["tp2_import"] = (eng.import_kv(KV_PROMPT, data),
                                   serve(eng, KV_PROMPT, SHORT))
        finally:
            eng.close()
        eng = port_engine(1, 2, params, multi_step=4)
        try:
            _RUNS["tp2_ms4"] = drain(eng, reqs(GREEDY))
        finally:
            eng.close()
        eng = port_engine(1, 2)
        try:
            _RUNS["tp2_seeded"] = drain(eng, reqs(GREEDY, PROMPTS[:2]))
        finally:
            eng.close()
    return _RUNS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(tmp_path_factory)


# -- the engine ---------------------------------------------------------------

def test_four_processes_each_a_stage_and_tensor_rank(runs):
    """Process g is stage g // 2 and tensor rank g % 2; each holds a pool
    of its stage's one layer and its tensor rank's one KV head."""
    grid = runs["grid"]
    ranks = grid["ranks"]
    assert (ranks["size"], ranks["axis"], ranks["shape"],
            ranks["decode_graphs"]) == (4, "stage,tensor",
                                        {"stage": 2, "tensor": 2}, False)
    assert len(set(ranks["pids"])) == 4
    cfg = tcfg.ModelConfig.from_pretrained("tiny-llama")
    want = (1, 1, BS, 2 * cfg.num_kv_heads // 2, cfg.head_dim)
    assert [tuple(p.shape) for p in grid["pools"]] == [want] * 4
    assert [r["place"] for r in grid["reports"]] == [
        {"stage": s, "tensor": t} for s in (0, 1) for t in (0, 1)]


def test_pp2tp2_equals_jax_stage2_tensor2(runs):
    """Greedy tokens equal the JAX engine's at stage 2 x tensor 2 up to a
    near-tie, the gaps from tp 2's run with logprobs (the staged engines
    have none)."""
    assert_same(runs["jax"]["greedy"], runs["grid"]["greedy"],
                top2_gaps(runs["tp2_lp"][1]))


@pytest.mark.parametrize("case", ["greedy", "multi-step-4", "seeded",
                                  "penalties"])
def test_pp2tp2_is_tp2_bit_for_bit(runs, case):
    """The reference's ``test_pp2_tp2_token_identical``: stage after stage
    runs tp 2's operations, so the tokens are tp 2's exactly."""
    if case == "multi-step-4":
        assert runs["grid_ms4"][0] == runs["tp2_ms4"][0]
        assert runs["grid_ms4"][0] == runs["tp2"]["greedy"][0]
    else:
        assert runs["grid"][case] == runs["tp2"][case]
    if case == "greedy":
        assert runs["grid"]["greedy"][0] == runs["tp2_lp"][0]


def test_every_process_samples_what_rank0_samples(runs):
    reports = runs["grid"]["reports"]
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)


def test_prefix_cache_and_decode(runs):
    (first, cached0), (again, cached) = runs["grid"]["prefix"]
    assert again == first and cached0 == 0
    assert cached == 8  # two full blocks of the 9-token prompt


# -- KV -------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["whole", "groups", "slabs"])
def test_kv_export_equals_tp2(runs, form):
    """An export joins the stages' layers and each stage's tensor shares
    into tp 2's pool layout (``X-KV-Head-Groups`` 2): tp 2's export of the
    same prompt, bit for bit, whole, by layer group and as slabs."""
    got, want = runs["grid"]["kv"], runs["tp2"]["kv"]
    if form == "slabs":
        assert len(got["slabs"]) == 2
        assert all(torch.equal(a, b)
                   for a, b in zip(got["slabs"], want["slabs"]))
    else:
        assert tuple(got[form].shape[:2]) == (2, 2)
        assert torch.equal(got[form], want[form])


@pytest.mark.parametrize("into", ["pp2tp2", "tp2"])
def test_kv_import_is_a_prefix_hit(runs, into):
    """pp 2 x tp 2's export imported into a fresh pp 2 x tp 2 engine and
    into a tp 2 engine: 8 tokens cached, and the prompt then decodes as
    tp 2 decodes it."""
    hits, (toks, cached) = runs["grid_import" if into == "pp2tp2"
                                else "tp2_import"]
    assert hits == 8 and cached == 8
    assert toks == runs["tp2_import"][1][0]
    assert len(toks) == SHORT.max_tokens


def test_kv_import_lands_each_process_part(runs):
    """Process g holds stage g // 2's layer of tensor rank g % 2's share of
    an import, exactly; the tiers' slabs go back in as they came out."""
    grid = runs["grid"]
    whole = grid["kv"]["whole"]
    cfg = tcfg.ModelConfig.from_pretrained("tiny-llama")
    for g, part in enumerate(grid["landed"]):
        s, t = divmod(g, 2)
        want = tshard.split_kv_share(whole[s:s + 1], cfg, t, 2)
        assert np.array_equal(part, want.numpy()), g
    assert torch.equal(grid["slabs_back"], whole)


def test_kv_head_groups_are_tp2s(runs):
    """The export names tp 2's head grouping, so a tp 1 consumer refuses
    it as it refuses tp 2's."""
    cfg = tcfg.ModelConfig.from_pretrained("tiny-llama")
    assert tshard.kv_head_groups(cfg, 2) == 2
    assert runs["grid"]["kv"]["whole"].shape[-2] == 2 * cfg.num_kv_heads


# -- LoRA, sleep, scoring, MoE ----------------------------------------------------

def test_lora_matches_tp2(runs):
    """Each process holds its stage's layer of its tensor share of the
    adapter, keyed by the whole adapter's root: tp 2's tokens, not the
    base model's."""
    grid, tp2 = runs["grid"], runs["tp2"]
    assert grid["lora_root"] == tp2["lora_root"]
    assert grid["lora"] == tp2["lora"]
    assert grid["lora"][0]["r0"] != grid["base"][0]["r0"]


def test_sleep_wake_and_seeded_shares(runs):
    """Sleep level 2 drops every process's pool and weights and wake makes
    them again from the seed: the same tokens, which are tp 2's from the
    same seed (each process seeds its own share)."""
    out = runs["sleep"]
    assert out["asleep"] == (False, False) and out["awake"] == (True, True)
    assert out["after"] == out["before"]
    assert out["before"][0] == runs["tp2_seeded"][0]


@pytest.mark.parametrize("against", ["tp2", "jax"])
def test_pooled_embed_matches(runs, against):
    want = (runs["tp2"]["embed"] if against == "tp2"
            else runs["jax"]["embed"])
    np.testing.assert_allclose(runs["grid"]["embed"], want, rtol=2e-3,
                               atol=2e-3)


def test_guided_choice_scores_match_tp2(runs):
    np.testing.assert_allclose(runs["grid"]["choice"], runs["tp2"]["choice"],
                               rtol=0, atol=1e-4)


def test_tiny_mixtral_matches_jax_stage2_tensor2(runs):
    """The MoE block over each stage's tensor group: the JAX engine's
    tokens at stage 2 x tensor 2 up to a near-tie (the gaps from tp 1)."""
    assert_same(runs["jax_mixtral"], runs["grid_mixtral"],
                runs["mixtral_gaps"])


# -- weights -------------------------------------------------------------------

def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _slice(whole, cfg, s: int, t: int):
    """The stage-then-tensor slice of a whole parameter dict."""
    return tweights.shard_params(tweights.stage_params(whole, cfg, (s, 2)),
                                 cfg, t, 2)


@pytest.mark.parametrize("name,quant", [("tiny-llama", None),
                                        ("tiny-gemma", None),
                                        ("tiny-llama", "int8")])
def test_seeded_process_share_is_the_slice(name, quant):
    """A process's seeded share (every slice drawn, its stage's kept and
    cut to its tensor rank; int8 quantized as made) is the slice of the
    whole model made from the same seed."""
    cfg = tcfg.ModelConfig.from_pretrained(name, num_layers=4,
                                           **({"quant": quant} if quant
                                              else {}))
    whole = tweights.init_random(cfg, seed=3)
    for s in (0, 1):
        for t in (0, 1):
            share = tweights.init_random(cfg, 3, rank=t, tp=2, stage=(s, 2))
            assert _equal(share, _slice(whole, cfg, s, t)), (s, t)


def test_jax_share_is_the_slice(runs):
    """``params_from_jax`` at a stage and tensor rank is the slice of its
    whole conversion, as the int8 cut of a quantized whole is; rank 0 of
    the engine holds its slice of the dict it was handed."""
    mesh, jparams, _ = tiny_weights()
    cfg = tcfg.ModelConfig.from_pretrained("tiny-llama")
    np_params = jax.tree.map(np.asarray, jax.device_get(jparams))
    whole = tweights.params_from_jax(np_params, cfg)
    for s in (0, 1):
        for t in (0, 1):
            share = tweights.params_from_jax(np_params, cfg, rank=t, tp=2,
                                             stage=(s, 2))
            assert _equal(share, _slice(whole, cfg, s, t)), (s, t)
    q = quantize_params(cfg, whole)
    share = _slice(q, cfg, 1, 1)
    wq = tweights.shard_params(q, cfg, 1, 2)["layers"]["wq"]
    assert torch.equal(share["layers"]["wq"]["q"], wq["q"][1:])
    assert _equal(runs["grid"]["params0"], _slice(runs["params"], cfg, 0, 0))


# -- refusals, the relay's bytes ------------------------------------------------

def test_refuses_logprobs_and_guided_regex(runs):
    assert [m and "pipeline parallelism" in m
            for m in runs["grid"]["refused"]] == [True, True]


def test_stage_relay_is_counted_and_billed_to_no_dispatch(runs):
    """Rank 0 (stage 0) sends the residual stream on and receives the last
    stage's tokens; both count in ``wire`` under ``STAGE_OPS`` and never
    in a dispatch's collective bytes, which hold stage 0's tensor
    collectives."""
    grid = runs["grid"]
    assert set(pdist.STAGE_OPS) <= set(grid["wire"])
    assert grid["wire"]["stage_relay"] > 0
    assert not set(pdist.STAGE_OPS) & set(grid["billed"])
    assert grid["billed"]["all_reduce"] == grid["wire"]["all_reduce"]


def test_whisper_is_refused_before_any_process_starts():
    import multiprocessing

    cfg = tcfg.EngineConfig.for_model("tiny-whisper",
                                      mesh=MeshConfig(stage=2, tensor=2))
    with pytest.raises(ValueError, match="Whisper.*pipeline and tensor "
                       "parallelism"):
        multihost.start_ranks(cfg, None, None, "cpu",
                              pdist.Grid(stage=2, tensor=2))
    assert multiprocessing.active_children() == []


def test_a_lost_stage1_follower_is_rank_lost(runs):
    """A killed stage-1 follower is ``RankLost`` at the leader's next
    call, named, as a lost tensor-parallel follower is."""
    with rank_limit(90):
        eng = port_engine(2, 2, runs["params"])
        try:
            assert isinstance(eng.runner._inner, StageRankRunner)
            serve(eng, PROMPTS[0], SHORT)
            follower = eng.runner.procs[1]  # global rank 2: stage 1
            follower.kill()
            follower.join(10)
            with pytest.raises(multihost.RankLost, match="rank 2"):
                serve(eng, PROMPTS[1], SHORT)
        finally:
            eng.close()


# -- sizes, flags and the server --------------------------------------------------

def _args(*extra):
    return tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cpu", *extra])


def test_flags_resolve_and_tensor_size_over_each_stage(monkeypatch):
    """The flags make ``MeshConfig(stage=2, tensor=2)``; ``-1`` takes the
    cards left to each stage."""
    conf = tserver.config_from_args(_args("--pipeline-parallel-size", "2",
                                          "--tensor-parallel-size", "2"))
    assert conf.mesh == MeshConfig(stage=2, tensor=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert [tmesh.tensor_size(MeshConfig(stage=n, tensor=-1), "cuda")
            for n in (1, 2, 4)] == [8, 4, 2]
    assert pdist.Grid.of(conf.mesh, 2).label == "stage,tensor"
    with pytest.raises(ValueError, match="no stage x tensor grid"):
        pdist.init_rank(0, 2, 0, ["cpu"] * 2, "gloo",
                        grid=pdist.Grid(stage=2, tensor=2))


def test_grid_refuses_a_card_it_lacks():
    """Every process's device is checked before any starts: four processes
    on cuda:0..3 of a machine without them exit, naming both flags."""
    import multiprocessing

    args = tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cuda",
         "--pipeline-parallel-size", "2", "--tensor-parallel-size", "2"])
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"has {n} CUDA card") as e:
        tserver.server_from_args(args)
    assert "--pipeline-parallel-size 2 --tensor-parallel-size 2" in str(
        e.value)
    assert multiprocessing.active_children() == []


def test_server_serves_at_pp2_tp2(tmp_path):
    with rank_limit(150):
        server = tserver.server_from_args(_args(
            "--skip-warmup", "--num-blocks", "64", "--max-num-seqs", "4",
            "--pipeline-parallel-size", "2", "--tensor-parallel-size", "2"))
        assert server.config.mesh == MeshConfig(stage=2, tensor=2)
        try:
            base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            status, raw = http(base, "/debug/perf")
            ranks = json.loads(raw)["ranks"]
            assert status == 200 and (ranks["size"], ranks["axis"],
                                      ranks["shape"]) == (
                4, "stage,tensor", {"stage": 2, "tensor": 2})
            pids = ranks["pids"][1:]
            body = {"model": "tiny-llama", "prompt": [1, 2, 3, 4],
                    "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
            status, raw = http(base, "/v1/completions", body)
            assert status == 200
            assert json.loads(raw)["usage"]["completion_tokens"] == 6
            status, raw = http(base, "/v1/completions",
                               {**body, "logprobs": 2})
            assert status == 400 and b"pipeline parallelism" in raw
            status, raw = http(base, "/v1/completions",
                               {**body, "guided_regex": "[a-z]+"})
            assert status == 400 and b"pipeline parallelism" in raw
            status, _ = http(base, "/v1/completions",
                             {**body, "guided_choice": ["yes", "no"]})
            assert status == 200
            status, raw = http(base, "/v1/completions",
                               {**body, "stream": True})
            assert status == 200 and raw.rstrip().endswith(b"data: [DONE]")
            status, _ = http(base, "/v1/chat/completions", {
                "model": "tiny-llama", "max_tokens": 4,
                "messages": [{"role": "user", "content": "hi"}]})
            assert status == 200
            status, raw = http(base, "/v1/embeddings",
                               {"model": "tiny-llama", "input": [[5, 6]]})
            assert status == 200
            assert len(json.loads(raw)["data"][0]["embedding"]) == 128
            assert http(base, "/sleep?level=2", {})[0] == 200
            assert http(base, "/wake_up", {})[0] == 200
            assert http(base, "/v1/completions", body)[0] == 200
            lora = {"lora_name": "a", "lora_path": _adapter(str(tmp_path))}
            assert http(base, "/v1/load_lora_adapter", lora)[0] == 200
            assert http(base, "/v1/completions",
                        {**body, "model": "a"})[0] == 200
            assert http(base, "/v1/unload_lora_adapter", lora)[0] == 200
            # a real block out of /kv/export, the engine's joined one
            status, raw = http(base, "/v1/completions", {
                **body, "prompt": list(range(1, 41)), "max_tokens": 1,
                "kv_transfer_params": {"do_remote_decode": True}})
            assert status == 200
            ids = json.loads(raw)["kv_transfer_params"]["remote_block_ids"]
            status, raw = http(base, "/kv/export", {"blocks": ids[:2]})
            want = server.async_engine.run_on_engine(
                lambda e: e.export_kv(ids[:2]))
            assert status == 200 and raw == bytes(tkt.tensor_bytes(want))
            assert tuple(want.shape[:2]) == (2, 2)
            wire = json.loads(http(base, "/debug/perf")[1])
            assert wire["ranks"]["decode_graphs"] is False
        finally:
            server.shutdown()
        assert wait_gone(pids, 10) == []


def test_sigterm_leaves_no_rank():
    """The CLI at pp 2 x tp 2: SIGTERM drains, the server exits 0 and its
    three followers are gone within 3 s of its exit."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--num-blocks", "64", "--pipeline-parallel-size", "2",
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
        assert wait_gone(pids, 3) == []
    finally:
        proc.kill()
        proc.wait(10)
        kill_pids(pids)
