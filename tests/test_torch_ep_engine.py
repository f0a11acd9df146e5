"""The port's engine under expert parallelism, against the JAX engine at
``MeshConfig(expert=2)`` and ``MeshConfig(tensor=2, expert=2)`` and
against the port at expert 1 at the same tensor size, on the CPU.

- Engines on mixed prefill and decode traffic (tiny-mixtral): float32 on
  the ragged and the bucketed path, int8 on the W8A8 route and on the
  W8A16 route (threshold 1), and an adapter on the attention targets,
  each at expert 2 and at expert 2 x tp 2. Against the JAX engine greedy
  tokens are identical up to a near-tie and logprobs within 1e-4 (the
  int8 runs within the tp 1 int8 tests' band, ``assert_int8_same``).
  Against the port at expert 1 the tokens and logprobs are the same bit
  for bit: each rank's combine partial holds at most a token's weighted
  rows and zeros, so their float32 sum is one device's. Every follower's
  token digest equals rank 0's, and each reports its place on both axes.
- The combine's bytes: on every rank ``moe_combine`` is ``L rows E 4 x 2
  (N - 1) / N`` summed over the calls the engine made, rows each call's
  (the ragged stream's live length, the bucketed chunk batch, a decode
  step's ``max_num_seqs`` rows a fused iteration); 0 where the rules
  replicate the experts (a dense model, tiny-mixtral's 4 experts over 3
  ranks), whose tokens are expert 1's bit for bit.
- KV exports and imports at expert 2 x tp 2 equal tp 2's bit for bit
  (blocks and slabs), and at expert 2 equal one device's.
- Refusals: expert ranks multi-host, or for a Whisper model (alone and
  beside seq or pipeline ranks), raise before any process starts.

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``),
one engine at a time (one torch.distributed group a process).
"""

import contextlib
import dataclasses
import multiprocessing
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain
from _torch_tp import rank_limit
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import stream_length
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.parallel.distributed import (
    DistributedConfig,
)
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from test_torch_lora import make_adapter_dir
from test_torch_quant import assert_int8_same

torch.set_num_threads(1)

GREEDY = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True,
                        logprobs=2)
rng = np.random.default_rng(25)
MIXED = [("r0", [1, 5, 9, 13, 2, 6], GREEDY),
         ("r1", list(range(1, 60)), GREEDY),
         ("r2", [3, 7, 11], GREEDY),
         ("r3", rng.integers(1, 500, 37).tolist(), GREEDY)]
STAGGER = (2, 4, 6, 8)
NUM_BLOCKS = 96
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=32,
             prefill_buckets=(16, 32, 64, 128))


@dataclasses.dataclass(frozen=True)
class Case:
    tp: int = 1
    impl: str = "ragged"
    quant: str = None
    a16_threshold: str = None  # PSTPU_QUANT_A16_THRESHOLD; None: default
    lora: bool = False


CASES = {
    "ep2-ragged": Case(),
    "ep2-bucketed": Case(impl="bucketed"),
    "ep2tp2-ragged": Case(tp=2),
    "ep2tp2-bucketed": Case(tp=2, impl="bucketed"),
    "ep2-int8-w8a8": Case(quant="int8"),
    "ep2tp2-int8-w8a8": Case(tp=2, quant="int8"),
    "ep2-int8-w8a16": Case(quant="int8", a16_threshold="1"),
    "ep2-lora": Case(lora=True),
    "ep2tp2-lora-bucketed": Case(tp=2, impl="bucketed", lora=True),
}


@contextlib.contextmanager
def _threshold(value):
    """PSTPU_QUANT_A16_THRESHOLD set for the body (the spawned ranks
    inherit it), restored after."""
    old = os.environ.get("PSTPU_QUANT_A16_THRESHOLD")
    if value is not None:
        os.environ["PSTPU_QUANT_A16_THRESHOLD"] = value
    try:
        yield
    finally:
        os.environ.pop("PSTPU_QUANT_A16_THRESHOLD", None)
        if old is not None:
            os.environ["PSTPU_QUANT_A16_THRESHOLD"] = old


def _tconf(preset="tiny-mixtral", quant=None, impl="ragged", tp=1, ep=1,
           **sched):
    return EngineConfig(
        model=ModelConfig.from_pretrained(preset, quant=quant),
        cache=CacheConfig(block_size=4, num_blocks=NUM_BLOCKS),
        scheduler=SchedulerConfig(**{**SCHED, **sched}),
        attention_impl=impl, mesh=MeshConfig(tensor=tp, expert=ep))


def _requests(case: Case) -> list:
    if not case.lora:
        return MIXED
    # adapter rows and base rows in one wave; r0's prompt twice, once with
    # the adapter and once without
    return ([(rid, p, sp, 1 if rid in ("r0", "r2") else 0)
             for rid, p, sp in MIXED] + [("r0-base", MIXED[0][1], GREEDY, 0)])


def _spy_rows(runner, L: int) -> list:
    """Record, on rank 0's mirrored runner, the rows each step's MoE
    layers run (``L`` layers a step): the ragged stream's live length,
    the bucketed chunks' P x S, ``max_num_seqs`` a fused decode
    iteration."""
    rows = []

    def wrap(name, count):
        inner = getattr(runner, name)

        def spy(*args, **kwargs):
            rows.append(L * count(*args, **kwargs))
            return inner(*args, **kwargs)

        setattr(runner, name, spy)

    wrap("ragged_step", lambda tokens, *a, **kw: stream_length(
        len(tokens), int(a[3][-1])))
    wrap("prefill", lambda tokens, *a, **kw: int(np.prod(tokens.shape)))
    wrap("decode_multi", lambda tokens, *a, **kw: len(tokens)
         * runner.decode_steps)
    return rows


def _combine_bytes(rows: list, E: int, n: int) -> float:
    """``RankGroup.moe_combine``'s count over the calls: each a float32
    (rows, E) all-reduce over n ranks."""
    return float(sum(r * E * 4 * 2.0 * (n - 1) / n for r in rows))


def _port(tconf, params, reqs, adapter=None, spy=False):
    """A port engine's run (and its reports and moe_combine rows where it
    has ranks)."""
    mesh = tconf.mesh
    ranks = mesh.tensor * mesh.expert > 1
    with rank_limit(120) if ranks else contextlib.nullcontext():
        eng = LLMEngine(tconf, params=params, device="cpu")
        try:
            if adapter:
                tlora.LoraManager(eng).load("a", adapter)
            rows = (_spy_rows(eng.runner, tconf.model.num_layers)
                    if spy else None)
            out = {"run": drain(eng, reqs, STAGGER), "rows": rows}
            if ranks:
                out["reports"] = eng.runner.follower_reports()
                out["info"] = eng.rank_info()
                out["held"] = eng.runner.gather("param_bytes")
                out["perf"] = eng.perf.snapshot()
            return out
        finally:
            if ranks:
                eng.close()


_RUNS: dict = {}


def _run(name: str) -> dict:
    """The JAX engine at ``expert=2`` (x ``tensor=tp``), the port at
    expert 1 and at expert 2 at the same tensor size, with the JAX
    engine's weights (quantized by it for an int8 case); cached for the
    module."""
    if name in _RUNS:
        return _RUNS[name]
    case = CASES[name]
    reqs = _requests(case)
    out = {}
    with _threshold(case.a16_threshold), contextlib.ExitStack() as stack:
        jconf = jcfg.EngineConfig(
            model=jcfg.ModelConfig.from_pretrained("tiny-mixtral",
                                                   quant=case.quant),
            cache=jcfg.CacheConfig(block_size=4, num_blocks=NUM_BLOCKS,
                                   enable_prefix_caching=not case.lora),
            scheduler=jcfg.SchedulerConfig(**SCHED),
            mesh=jmesh.MeshConfig(data=1, tensor=case.tp, expert=2),
            attention_impl=case.impl)
        jeng = JaxEngine(jconf, mesh=jmesh.build_mesh(
            jconf.mesh, devices=jax.devices()[:2 * case.tp]),
            num_blocks=NUM_BLOCKS)
        tconf = _tconf(quant=case.quant, impl=case.impl, tp=case.tp)
        params = params_from_jax(jax.tree.map(np.asarray, jax.device_get(
            jeng.runner.params)), tconf.model)
        adapter = None
        if case.lora:
            # the reference's prefix cache keys a block without its
            # adapter (test_torch_lora.py), so it runs with the cache off
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            adapter = make_adapter_dir(tmp, tconf.model, seed=1)
            jeng.runner.register_lora(1, jlora.load_adapter_raw(
                "a", adapter, jconf.model, jconf.max_lora_rank))
        out["jax"] = drain(jeng, reqs, STAGGER)
        out["ep1"] = _port(tconf, params, reqs, adapter)["run"]
        out.update(_port(dataclasses.replace(
            tconf, mesh=MeshConfig(tensor=case.tp, expert=2)), params, reqs,
            adapter, spy=True))
    _RUNS[name] = out
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_the_jax_engine(name):
    out = _run(name)
    if CASES[name].quant:
        assert_int8_same(out["jax"], out["run"])
    else:
        assert_same(out["jax"], out["run"])


@pytest.mark.parametrize("name", list(CASES))
def test_engine_is_expert1_bit_for_bit(name):
    out = _run(name)
    assert out["run"] == out["ep1"]
    assert sum(map(len, out["run"][0].values())) == 8 * len(
        _requests(CASES[name]))


@pytest.mark.parametrize("name", list(CASES))
def test_followers_agree_and_report_their_place(name):
    tp = CASES[name].tp
    reports = _run(name)["reports"]
    assert [r["rank"] for r in reports] == list(range(2 * tp))
    want = [{"expert": g // tp, "tensor": g % tp} if tp > 1
            else {"expert": g} for g in range(2 * tp)]
    assert [r["place"] for r in reports] == want
    info = _run(name)["info"]
    assert info["axis"] == ("expert,tensor" if tp > 1 else "expert")
    assert info["shape"] == ({"expert": 2, "tensor": 2} if tp > 1
                             else {"expert": 2})
    assert len(info["pids"]) == 2 * tp
    # every process holds half the experts (and its tensor cut): the
    # accountant reports rank 0's bytes beside the whole model's
    held, model = _run(name)["held"], _run(name)["perf"]["model"]
    assert len(set(held)) == 1
    assert model["held_param_bytes"] == held[0] < model["param_bytes"]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)


@pytest.mark.parametrize("name", [n for n in CASES if not CASES[n].lora])
def test_combine_bytes_are_the_formula_on_every_rank(name):
    out = _run(name)
    want = _combine_bytes(out["rows"], 128, 2)
    assert want > 0
    for r in out["reports"]:
        assert r["wire"]["moe_combine"] == want
    # a step collective: billed to the dispatches, as the tensor ops are
    assert out["perf"]["collective_bytes_total"]["moe_combine"] == want


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.lora])
def test_the_adapter_changes_its_rows(name):
    for run in ("jax", "ep1", "run"):
        toks = _run(name)[run][0]
        assert toks["r0"] != toks["r0-base"], run


# -- replicated experts ----------------------------------------------------------

@pytest.mark.parametrize("preset,ep", [("tiny-llama", 2),
                                       ("tiny-mixtral", 3)])
def test_replicated_experts_run_no_combine(preset, ep):
    """A dense model at expert 2, and tiny-mixtral's 4 experts over 3
    ranks: the rules replicate the experts, every rank holds the whole
    model, no combine runs and the tokens are one device's bit for
    bit."""
    from production_stack_tpu_torch.engine.weights import init_random

    tconf = _tconf(preset)
    params = init_random(tconf.model, seed=0)
    one = _port(tconf, params, MIXED)["run"]
    out = _port(dataclasses.replace(tconf, mesh=MeshConfig(tensor=1,
                                                           expert=ep)),
                params, MIXED)
    assert out["run"] == one
    for r in out["reports"]:
        assert r["wire"].get("moe_combine", 0.0) == 0.0
        assert r["place"] == {"expert": r["rank"]}


# -- the KV plane ------------------------------------------------------------------

def _kv(tconf, params) -> dict:
    """A run, then the first blocks exported (layer groups and slabs),
    then a pattern imported into them and exported again."""
    ranks = tconf.mesh.tensor * tconf.mesh.expert > 1
    with rank_limit(120) if ranks else contextlib.nullcontext():
        eng = LLMEngine(tconf, params=params, device="cpu")
        try:
            run = drain(eng, MIXED, STAGGER)
            ids = list(range(1, 9))
            out = {"run": run,
                   "blocks": eng.runner.export_blocks(ids).clone(),
                   "slabs": [s.clone() for s in
                             eng.runner.export_slabs(ids)]}
            pattern = torch.randn(out["blocks"].shape,
                                  generator=torch.Generator().manual_seed(3))
            eng.runner.import_blocks_range(ids[:4], 0, pattern[:, :4])
            eng.runner.import_slabs(ids[4:], [pattern[:, i] for i in
                                              range(4, 8)])
            out["imported"] = eng.runner.export_blocks(ids).clone()
            out["pattern"] = pattern
            return out
        finally:
            if ranks:
                eng.close()


@pytest.mark.parametrize("tp", [1, 2], ids=["ep2", "ep2tp2"])
def test_exports_and_imports_are_expert1s(tp):
    from production_stack_tpu_torch.engine.weights import init_random

    tconf = _tconf(tp=tp)
    params = init_random(tconf.model, seed=0)
    want = _kv(tconf, params)
    got = _kv(dataclasses.replace(tconf, mesh=MeshConfig(tensor=tp,
                                                         expert=2)), params)
    assert got["run"] == want["run"]
    assert torch.equal(got["blocks"], want["blocks"])
    assert all(torch.equal(a, b) for a, b in zip(got["slabs"],
                                                 want["slabs"]))
    assert got["blocks"].abs().sum() > 0
    for out in (want, got):
        assert torch.equal(out["imported"], out["pattern"])


# -- refusals ------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,what", [
    (MeshConfig(tensor=1, seq=2, expert=2), "sequence"),
    (MeshConfig(tensor=1, stage=2, expert=2), "pipeline"),
    (MeshConfig(tensor=2, seq=2, expert=2), "sequence"),
])
def test_expert_with_seq_or_stage_raises_before_any_rank(mesh, what):
    """Expert ranks with seq or pipeline ranks serve a text model
    (tests/test_torch_grid_engine.py); a Whisper model there raises,
    naming the grid's parallelism, before any process starts."""
    tconf = dataclasses.replace(_tconf("tiny-whisper"), mesh=mesh)
    with pytest.raises(ValueError, match=f"Whisper.*{what}"):
        LLMEngine(tconf, device="cpu")
    assert not multiprocessing.active_children()


def test_expert_multi_host_raises_before_any_rank():
    dcfg = DistributedConfig(coordinator="127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="multi-host"):
        LLMEngine(_tconf(ep=2), device="cpu", distributed=dcfg)
    with pytest.raises(ValueError, match="expert axis"):
        multihost.check_group(_tconf(ep=2), dcfg, "expert", 1)
    assert not multiprocessing.active_children()


def test_whisper_at_expert2_raises_before_any_rank():
    from production_stack_tpu_torch.engine.whisper_runner import (
        WhisperRunner,
    )

    conf = EngineConfig(model=ModelConfig.from_pretrained("tiny-whisper"),
                        mesh=MeshConfig(tensor=1, expert=2))
    with pytest.raises(ValueError, match="Whisper"):
        LLMEngine(conf, device="cpu")
    with pytest.raises(ValueError, match="expert"):
        WhisperRunner(conf, device="cpu")
    assert multihost.refusal(conf, "expert") is not None
    assert not multiprocessing.active_children()
