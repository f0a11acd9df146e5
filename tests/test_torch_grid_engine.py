"""Engines on the process grid (parallel/distributed.py ``Grid``) against
the JAX engine at the same ``MeshConfig`` and against the port at the
combination's one-axis counterpart, on the same weights
(``params_from_jax``; CPU processes over gloo).

- ``MeshConfig(seq=2, expert=2)`` on tiny-mixtral, float32 and int8 on
  the W8A16 route, ragged: two long prompts take the ring around a short
  one that stays on the chunked path; a MoE layer of a ring prefill ranks
  its slots over the seq view and sums its combine over the expert view.
  Greedy tokens equal the JAX engine's up to a near-tie, logprobs within
  1e-4 (the int8 run within ``test_torch_quant``'s band), and the run is
  seq 2 at expert 1's bit for bit: expert N is expert 1 bit for bit by
  design (each rank's float32 combine partial holds a token's weighted
  rows or zeros).
- ``MeshConfig(stage=2, expert=2)`` on tiny-mixtral and ``MeshConfig(
  stage=2, seq=2)`` on tiny-llama, bucketed (the staged runner's path,
  which returns no logprobs): greedy tokens equal the JAX engine's up to
  a near-tie (the gaps from the one-process run's logprobs), and the run
  is pp 2's in one process bit for bit. Beside stages the seq ranks run
  no ring, as the reference's staged runner has no ``seq_parallel``
  (``ring_enabled`` is false and no ring byte moves); each seq rank is a
  whole pipeline that computes every call, so its digest, calls and
  token-by-token results are rank 0's.
- Every process reports its coordinates on the grid's axes above 1 and
  the same digest; rank 0's wire bytes equal their formulas: the combine
  (``moe_combine``: a float32 all-reduce of each MoE layer's rows), the
  ring's (``ring_rotate``, ``ring_gather``, ``ring_last``,
  ``ring_moe_counts``) and the stage relay's (``stage_relay``: the
  residual stream of stage 0's every prefill chunk batch and decode
  step, ``stage_last``: the sampled tokens from the last stage).
- Three axes: one request at ``MeshConfig(seq=2, expert=2, tensor=2)``,
  eight processes, through the ring, against the JAX engine.
- The server at ``--sequence-parallel-size 2 --pipeline-parallel-size
  2`` starts four processes and serves a completion;
  ``--ring-prefill-threshold`` is accepted and has no effect.

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``),
one engine at a time (one torch.distributed group a process); the JAX
engines get a small ``num_blocks``.
"""

import contextlib
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain, top2_gaps
from _torch_ring import spy_lengths
from _torch_tp import rank_limit, wait_gone
from test_torch_quant import assert_int8_same
from test_torch_tp_features import _threshold
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.weights import init_or_load as jax_init
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import stream_length
from production_stack_tpu_torch.engine.pp_runner import (
    StagedModelRunner,
    StageRankRunner,
)
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from production_stack_tpu_torch.parallel.ring_attention import ring_length

torch.set_num_threads(1)

NUM_BLOCKS = 128
THRESHOLD = 16
GREEDY = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True)
LP = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True,
                    logprobs=2)
rng = np.random.default_rng(26)
# the ring cases: two ring prefills (the oldest first) around a short
# prompt that stays on the chunked path, then decode rows together
RING_REQS = [("long", [(7 * i + 3) % 510 + 1 for i in range(45)], LP),
             ("short", [1, 5, 9, 13, 2], LP),
             ("long2", rng.integers(1, 500, 37).tolist(), LP)]
# the staged cases: five requests on four slots, one chunked
PROMPTS = [rng.integers(1, 500, int(n)).tolist() for n in (5, 3, 7, 40, 12)]


@dataclasses.dataclass(frozen=True)
class Case:
    preset: str
    mesh: dict  # the grid's sizes
    one: dict  # its one-axis counterpart's
    impl: str = "ragged"
    quant: str = None
    a16_threshold: str = None  # PSTPU_QUANT_A16_THRESHOLD; None: default

    @property
    def staged(self) -> bool:
        return self.mesh.get("stage", 1) > 1


CASES = {
    "seq2ep2": Case("tiny-mixtral", dict(seq=2, expert=2), dict(seq=2)),
    "seq2ep2-int8": Case("tiny-mixtral", dict(seq=2, expert=2), dict(seq=2),
                         quant="int8", a16_threshold="1"),
    "pp2ep2": Case("tiny-mixtral", dict(stage=2, expert=2), dict(stage=2),
                   impl="bucketed"),
    "pp2seq2": Case("tiny-llama", dict(stage=2, seq=2), dict(stage=2),
                    impl="bucketed"),
}


def _sched(case: Case) -> dict:
    if case.staged:
        return dict(max_num_seqs=4, max_num_batched_tokens=64,
                    prefill_buckets=(16, 32))
    return dict(max_num_seqs=4, max_num_batched_tokens=32,
                prefill_buckets=(16, 32, 64),
                ring_prefill_threshold=THRESHOLD)


def _tconf(case: Case, mesh: dict) -> EngineConfig:
    return EngineConfig(
        model=ModelConfig.from_pretrained(case.preset, quant=case.quant),
        cache=CacheConfig(block_size=4, num_blocks=NUM_BLOCKS),
        scheduler=SchedulerConfig(**_sched(case)), attention_impl=case.impl,
        mesh=MeshConfig(**{"tensor": 1, **mesh}))


def _jax(case: Case, mesh: dict):
    """The JAX engine at ``mesh`` and the port's params of its weights
    (quantized by it for an int8 case)."""
    jconf = jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained(case.preset,
                                               quant=case.quant),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=NUM_BLOCKS),
        scheduler=jcfg.SchedulerConfig(**_sched(case)),
        mesh=jmesh.MeshConfig(data=1, **{"tensor": 1, **mesh}),
        attention_impl=case.impl)
    n = int(np.prod(list(mesh.values())))
    devices = jax.devices()[:n]
    if case.staged:
        # the staged runner keeps its weights by stage: hand both engines
        # one seeded dict
        jparams = jax_init(jconf.model, jmesh.build_mesh(
            jmesh.MeshConfig(data=1, tensor=1), devices=devices[:1]),
            seed=0)
        jeng = JaxEngine(jconf, mesh=jmesh.build_mesh(jconf.mesh,
                                                      devices=devices),
                         params=jparams, num_blocks=NUM_BLOCKS)
    else:
        jeng = JaxEngine(jconf, mesh=jmesh.build_mesh(jconf.mesh,
                                                      devices=devices),
                         num_blocks=NUM_BLOCKS)
        jparams = jeng.runner.params
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jax.device_get(jparams)),
                             _tconf(case, mesh).model)
    return jeng, params


def _spy(runner, cfg, n_seq: int) -> dict:
    """Record, on rank 0's mirrored runner, what each call sends over the
    views: the rows each of rank 0's MoE layers runs (the ragged
    stream's live length, a bucketed chunk batch's P x S, a decode step's
    ``max_num_seqs`` rows a fused iteration, a ring prefill's slice of
    S / n_seq tokens) and the rows stage 0 relays (a chunk batch's P x S,
    a decode step's rows) and receives the tokens of (P, or the rows)."""
    out = {"moe": [], "relay": [], "last": []}

    def wrap(name, moe, relay=None, last=None):
        if not hasattr(runner, name):  # a staged runner's ragged step
            return
        inner = getattr(runner, name)

        def spy(*args, **kwargs):
            out["moe"].append(moe(*args))
            if relay is not None:
                out["relay"].append(relay(*args))
                out["last"].append(last(*args))
            return inner(*args, **kwargs)

        setattr(runner, name, spy)

    wrap("ragged_step", lambda tokens, *a: stream_length(
        len(tokens), int(a[3][-1])))
    wrap("prefill", lambda tokens, *a: int(np.prod(tokens.shape)),
         lambda tokens, *a: int(np.prod(tokens.shape)),
         lambda tokens, *a: int(tokens.shape[0]))
    steps = runner.decode_steps if hasattr(runner, "decode_steps") else 1
    wrap("decode_multi", lambda tokens, *a: len(tokens) * steps,
         lambda tokens, *a: len(tokens) * steps,
         lambda tokens, *a: len(tokens) * steps)
    wrap("prefill_ring", lambda tokens, *a: int(tokens.shape[1]) // n_seq)
    return out


def _port(case: Case, mesh: dict, params, reqs, spy: bool = False) -> dict:
    tconf = _tconf(case, mesh)
    grid = pdist.Grid.of(tconf.mesh, tconf.mesh.tensor)
    ranks = grid.size > 1 and grid.axes != ("stage",)
    with rank_limit(150) if ranks else contextlib.nullcontext():
        eng = LLMEngine(tconf, params=params, device="cpu")
        try:
            out = {"runner": type(getattr(eng.runner, "_inner", eng.runner)),
                   "ring_enabled": eng.scheduler.ring_enabled}
            if spy:
                out["lengths"] = (spy_lengths(eng.runner)
                                  if hasattr(eng.runner, "prefill_ring")
                                  else [])
                out["spy"] = _spy(eng.runner, tconf.model, grid.seq)
            out["run"] = drain(eng, reqs)
            if ranks:
                out["reports"] = eng.runner.follower_reports()
                out["info"] = eng.rank_info()
                out["wire"] = dict(eng.runner.ranks.wire)
                out["held"] = eng.runner.gather("param_bytes")
            return out
        finally:
            if ranks:
                eng.close()


def _greedy(case: Case) -> list:
    sp = LP if not case.staged else GREEDY
    return ([(rid, p, sp) for rid, p, _ in RING_REQS] if not case.staged
            else [(f"r{i}", p, sp) for i, p in enumerate(PROMPTS)])


_RUNS: dict = {}


def _run(name: str) -> dict:
    """The JAX engine at the case's mesh, the port at its one-axis
    counterpart and on its grid; cached for the module."""
    if name in _RUNS:
        return _RUNS[name]
    case = CASES[name]
    reqs = _greedy(case)
    out = {}
    with _threshold(case.a16_threshold):
        jeng, params = _jax(case, case.mesh)
        if not case.staged:
            out["jax_lengths"] = spy_lengths(jeng.runner)
        out["jax"] = drain(jeng, reqs)
        del jeng
        if case.staged:
            # the one-process run's logprobs give the near-tie gaps
            out["gaps"] = top2_gaps(_port(case, {}, params, [
                (rid, p, LP) for rid, p, _ in reqs])["run"][1])
        out["one"] = _port(case, case.one, params, reqs)
        out.update(_port(case, case.mesh, params, reqs, spy=True))
        out["cfg"] = _tconf(case, case.mesh).model
    _RUNS[name] = out
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_grid_matches_the_jax_engine(name):
    out, case = _run(name), CASES[name]
    if case.quant:
        assert_int8_same(out["jax"], out["run"])
    else:
        assert_same(out["jax"], out["run"], out.get("gaps"))
    assert sum(map(len, out["run"][0].values())) == 6 * len(_greedy(case))


@pytest.mark.parametrize("name", list(CASES))
def test_grid_is_its_one_axis_counterpart_bit_for_bit(name):
    """Expert N is expert 1 bit for bit, and a seq replica beside stages
    changes nothing: seq 2 at expert 1, and pp 2 in one process."""
    out = _run(name)
    assert out["run"] == out["one"]["run"]
    if CASES[name].staged:
        assert out["one"]["runner"] is StagedModelRunner
        assert out["runner"] is StageRankRunner


@pytest.mark.parametrize("name", list(CASES))
def test_grid_processes_agree_and_report_their_place(name):
    out, case = _run(name), CASES[name]
    grid = pdist.Grid(**case.mesh)
    reports = out["reports"]
    assert [r["rank"] for r in reports] == list(range(grid.size))
    assert [r["place"] for r in reports] == [
        {a: grid.coords(g)[a] for a in grid.axes} for g in range(grid.size)]
    assert (out["info"]["axis"], out["info"]["shape"]) == (
        grid.label, {a: grid.shape[a] for a in grid.axes})
    assert len(set(out["info"]["pids"])) == grid.size
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)
    # a seq replica holds what its stage and expert rank hold
    held = out["held"]
    for g in range(grid.size):
        twin = grid.process(**{**grid.coords(g), "seq": 0})
        assert held[g] == held[twin]


@pytest.mark.parametrize("name", list(CASES))
def test_grid_wire_bytes_are_the_formulas(name):
    out, case, cfg = _run(name), CASES[name], _run(name)["cfg"]
    grid = pdist.Grid(**case.mesh)
    E, b = cfg.hidden_size, 4  # float32 activations
    wire, spy = out["wire"], out["spy"]
    want = {}
    if grid.expert > 1:
        layers = cfg.num_layers // grid.stage  # rank 0's stage's
        want["moe_combine"] = float(sum(
            r * layers * E * 4 * 2.0 * (grid.expert - 1) / grid.expert
            for r in spy["moe"]))
    if grid.seq > 1 and not case.staged:
        n, L = grid.seq, cfg.num_layers
        kv = 2 * cfg.num_kv_heads * cfg.head_dim * b
        want["ring_rotate"] = want["ring_gather"] = float(sum(
            L * (n - 1) * (S // n) * kv for S in out["lengths"]))
        want["ring_last"] = len(out["lengths"]) * E * b * (n - 1) / n
        if cfg.num_experts:
            want["ring_moe_counts"] = float(
                len(out["lengths"]) * L * (n - 1) * cfg.num_experts * 4)
    if case.staged:
        S = grid.stage
        want["stage_relay"] = float(sum(spy["relay"]) * E * b)
        want["stage_last"] = sum(spy["last"]) * 4 * (S - 1) / S
    assert all(v > 0 for v in want.values())
    assert {op: wire.get(op, 0.0) for op in want} == want
    moved = {op for op, v in wire.items() if v}
    assert moved == set(want), moved


@pytest.mark.parametrize("name", list(CASES))
def test_grid_ring_runs_only_without_stages(name):
    """Seq ranks without stages take the ring at the reference's padded
    length; beside stages the ring is off and ``--ring-prefill-threshold``
    has no effect, as in the reference's staged runner."""
    out, case = _run(name), CASES[name]
    if case.staged:
        assert not out["ring_enabled"] and out["lengths"] == []
    else:
        assert out["ring_enabled"]
        assert out["lengths"] == out["jax_lengths"] == [
            ring_length(45, 2), ring_length(37, 2)] == [64, 64]


# -- three axes ------------------------------------------------------------------

def test_seq2_expert2_tensor2_serves_against_the_jax_engine():
    """One long request through the ring at seq 2 x expert 2 x tensor 2:
    eight processes, the same calls through the same code."""
    case = Case("tiny-mixtral", dict(seq=2, expert=2, tensor=2), {})
    reqs = [RING_REQS[0]]
    jeng, params = _jax(case, case.mesh)
    want = drain(jeng, reqs)
    del jeng
    out = _port(case, case.mesh, params, reqs, spy=True)
    assert_same(want, out["run"])
    assert out["lengths"] == [64]
    assert out["info"]["axis"] == "seq,expert,tensor"
    assert [r["place"] for r in out["reports"]] == [
        {"seq": s, "expert": e, "tensor": t}
        for s in (0, 1) for e in (0, 1) for t in (0, 1)]
    assert len({(r["calls"], r["digest"]) for r in out["reports"]}) == 1
    for op in ("moe_combine", "ring_moe_counts", "all_reduce", "ring_last"):
        assert out["wire"][op] > 0, op


# -- the server ------------------------------------------------------------------

def test_server_serves_at_seq2_pp2():
    """The flags make ``MeshConfig(stage=2, seq=2)``; four processes
    start, each a stage of a seq rank, and a completion longer than the
    ring threshold is served on the staged path."""
    from _torch_parity import http_json

    args = tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--num-blocks", "64", "--max-num-seqs", "4",
         "--sequence-parallel-size", "2", "--pipeline-parallel-size", "2",
         "--ring-prefill-threshold", "16"])
    with rank_limit(150):
        server = tserver.server_from_args(args)
        assert server.config.mesh == MeshConfig(stage=2, seq=2, tensor=1)
        try:
            base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            status, perf = http_json(base + "/debug/perf")
            ranks = perf["ranks"]
            assert status == 200 and (ranks["size"], ranks["axis"],
                                      ranks["shape"]) == (
                4, "stage,seq", {"stage": 2, "seq": 2})
            assert not server.engine.scheduler.ring_enabled
            pids = ranks["pids"][1:]
            status, body = http_json(base + "/v1/completions", {
                "model": "tiny-llama", "prompt": list(range(1, 41)),
                "max_tokens": 4, "temperature": 0.0, "ignore_eos": True})
            assert status == 200, body
            assert body["usage"]["completion_tokens"] == 4
        finally:
            server.shutdown()
        assert wait_gone(pids, 10) == []
    assert json.dumps(ranks["devices"]) == json.dumps(["cpu"] * 4)


# -- the KV plane -------------------------------------------------------------------

def _kv(case: Case, mesh: dict, params) -> dict:
    """A run, the first blocks exported (every layer, and slabs), a
    pattern imported into them, and the blocks exported again."""
    tconf = _tconf(case, mesh)
    grid = pdist.Grid.of(tconf.mesh, 1)
    ranks = grid.size > 1 and grid.axes != ("stage",)
    with rank_limit(150) if ranks else contextlib.nullcontext():
        eng = LLMEngine(tconf, params=params, device="cpu")
        try:
            out = {"run": drain(eng, _greedy(case))}
            ids = list(range(1, 9))
            out["blocks"] = eng.runner.export_blocks(ids).clone()
            out["slabs"] = [s.clone() for s in eng.runner.export_slabs(ids)]
            pattern = torch.randn(out["blocks"].shape,
                                  generator=torch.Generator().manual_seed(3))
            eng.runner.import_blocks_range(ids[:4], 0, pattern[:, :4])
            eng.runner.import_slabs(ids[4:], [pattern[:, i]
                                              for i in range(4, 8)])
            out["imported"] = eng.runner.export_blocks(ids).clone()
            out["pattern"] = pattern
            if ranks:
                # every replica took the import: each process's own blocks
                out["each"] = eng.runner.gather("export_blocks", ids)
            return out
        finally:
            if ranks:
                eng.close()


@pytest.mark.parametrize("name", ["seq2ep2", "pp2ep2", "pp2seq2"])
def test_grid_kv_moves_are_the_counterparts(name):
    """Exports (layer groups and slabs) equal the one-axis counterpart's
    bit for bit; an import lands in every process, seq and expert
    replicas included, and exports back unchanged."""
    case = CASES[name]
    jeng, params = _jax(case, case.one)
    del jeng
    want = _kv(case, case.one, params)
    got = _kv(case, case.mesh, params)
    assert got["run"] == want["run"]
    assert torch.equal(got["blocks"], want["blocks"])
    assert all(torch.equal(a, b) for a, b in zip(got["slabs"],
                                                 want["slabs"]))
    assert got["blocks"].abs().sum() > 0
    for out in (want, got):
        assert torch.equal(out["imported"], out["pattern"])
    grid = pdist.Grid(**case.mesh)
    layers = case.mesh.get("stage", 1)
    L = got["pattern"].shape[0] // layers
    for g, mine in enumerate(got["each"]):
        s = grid.coords(g)["stage"]
        assert np.array_equal(mine, got["pattern"][s * L:(s + 1) * L]
                              .numpy()), g
