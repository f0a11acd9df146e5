"""The model's features through the ring: MoE and int8 models at seq 2
and on the seq x tensor grid (CPU processes over gloo) against the JAX
engine at ``MeshConfig(seq=4)`` (x ``tensor=2``) and against the port at
seq 1 and the same tensor size, on the same weights (``params_from_jax``;
an int8 case's quantized by the JAX engine).

- Engines: tiny-mixtral float32 and tiny-llama int8 at seq 2 and at seq
  2 x tp 2, on two long prompts that take the ring around a short one
  that stays on the chunked path. Greedy tokens identical up to a
  near-tie (top-2 gap under 1e-4); logprobs within 1e-4 of the port at
  seq 1, and of the JAX engine for tiny-mixtral; the int8 model is held
  to the JAX engine within the int8 band (``test_torch_quant``'s
  ``INT8_LP_BAND``: an activation on a rounding boundary rounds one way
  in one framework, the other in the other). Every case asserts that
  both long prompts took the ring, at the reference's padded length;
  every process's digest, calls and launches equal rank 0's.
- The count exchange: rank 0's ``ring_moe_counts`` bytes are L (n - 1)
  X 4 a ring prefill (an all-gather of each rank's ``(X,)`` int32
  counts a MoE layer), billed to no dispatch.
- The accounting: a ring prefill is recorded as a prefill of its
  prompt's tokens at the model's active parameters and its int8 bytes,
  the counts the seq 1 engine takes from its real weights.
- The int8 route of the whole call: with ``PSTPU_QUANT_A16_THRESHOLD``
  between a rank's slice (Sl = 32) and the padded prompt (S = 64), every
  product of a ring prefill asks for S's route (W8A16), as the JAX
  engine's ring does, whose answers the port's equal within the band.
- Forced drops, after ``test_torch_moe``: ``num_experts = 8`` and a
  router biased to expert 0, the block split over two seq ranks (one
  thread a rank, the count exchange between them): rank 1 drops slots
  only because of rank 0's counts, and both ranks' rows equal the
  reference's block over the whole prompt (``seq = 1``).

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``);
engines with ranks run one at a time (one torch.distributed group a
process).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain, engine_configs
from _torch_ring import spy_lengths
from _torch_tp import rank_limit
from test_torch_moe import _layer0
from test_torch_quant import assert_int8_same
from test_torch_tp_features import _threshold
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import quant as tq
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.parallel.distributed import RING_OPS
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from production_stack_tpu_torch.parallel.ring_attention import ring_length

torch.set_num_threads(1)

THRESHOLD = 16
NUM_BLOCKS = 256
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=32,
             prefill_buckets=(16, 32, 64), ring_prefill_threshold=THRESHOLD)
GREEDY = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True,
                        logprobs=2)
rng = np.random.default_rng(24)
# two ring prefills (the oldest first) around a short prompt that stays
# on the chunked path, then decode rows together
REQS = [("long", [(7 * i + 3) % 510 + 1 for i in range(45)], GREEDY),
        ("short", [1, 5, 9, 13, 2], GREEDY),
        ("long2", rng.integers(1, 500, 37).tolist(), GREEDY)]
RING_LENS = [ring_length(45, 4), ring_length(37, 4)]  # [64, 64]


@dataclasses.dataclass(frozen=True)
class Case:
    preset: str
    quant: str = None
    tp: int = 1
    a16_threshold: str = None  # PSTPU_QUANT_A16_THRESHOLD; None: default


CASES = {
    "mixtral-seq2": Case("tiny-mixtral"),
    "mixtral-seq2-tp2": Case("tiny-mixtral", tp=2),
    "llama-int8-seq2": Case("tiny-llama", "int8"),
    "llama-int8-seq2-tp2": Case("tiny-llama", "int8", tp=2),
}
# the split case: 48 lies between a seq rank's 32 tokens and the ring's 64
SPLIT = Case("tiny-llama", "int8", a16_threshold="48")


def _configs(case: Case):
    jconf, tconf = engine_configs("ragged", block_size=4,
                                  num_blocks=NUM_BLOCKS, **SCHED)
    jconf.model = jcfg.ModelConfig.from_pretrained(case.preset,
                                                   quant=case.quant)
    tconf.model = ModelConfig.from_pretrained(case.preset, quant=case.quant)
    jconf.mesh = jmesh.MeshConfig(data=1, seq=4, tensor=case.tp)
    return jconf, tconf


def _a16_spy(runner, seen: list):
    """Record the token count of every int8 route decision rank 0 makes
    inside its ``prefill_ring`` calls."""
    inner, a16 = runner.prefill_ring, tq.a16
    inside = [False]

    def spy(tokens):
        if inside[0]:
            seen.append(int(tokens))
        return a16(tokens)

    def ring(*args, **kwargs):
        inside[0] = True
        try:
            return inner(*args, **kwargs)
        finally:
            inside[0] = False

    runner.prefill_ring = ring
    return spy


def _perf(eng) -> tuple:
    """The accountant's model (parameters, active parameters, bytes) and
    the prefill tokens it recorded."""
    snap = eng.perf.snapshot()
    return snap["model"], snap["totals"]["prefill_tokens"]


def _run(case: Case) -> dict:
    """The JAX engine at seq 4 (x tp), the port at seq 1 and at seq 2 (x
    tp) on REQS with the JAX engine's weights."""
    out = {}
    with _threshold(case.a16_threshold):
        jconf, tconf = _configs(case)
        jeng = JaxEngine(jconf, mesh=jmesh.build_mesh(
            jconf.mesh, devices=jax.devices()[:4 * case.tp]),
            num_blocks=NUM_BLOCKS)
        out["jax_lengths"] = spy_lengths(jeng.runner)
        out["jax"] = drain(jeng, REQS)
        params = params_from_jax(jax.tree.map(np.asarray, jax.device_get(
            jeng.runner.params)), tconf.model)
        del jeng
        if case.a16_threshold is None:
            with rank_limit(120):
                one = LLMEngine(dataclasses.replace(
                    tconf, mesh=MeshConfig(seq=1, tensor=case.tp)),
                    params=params, device="cpu")
                try:
                    out["seq1"] = drain(one, REQS)
                    out["seq1_perf"] = _perf(one)
                finally:
                    one.close()
        with rank_limit(150):
            eng = LLMEngine(dataclasses.replace(
                tconf, mesh=MeshConfig(seq=2, tensor=case.tp)),
                params=params, device="cpu")
            try:
                assert eng.scheduler.ring_enabled
                seen = []
                spy = _a16_spy(eng.runner, seen)
                out["lengths"] = spy_lengths(eng.runner)
                billed0 = dict(eng.perf.stats_fields()["collective_bytes"])
                a16, tq.a16 = tq.a16, spy
                try:
                    out["got"] = drain(eng, REQS)
                finally:
                    tq.a16 = a16
                out["routes"] = seen
                out["wire"] = dict(eng.runner.ranks.wire)
                out["billed"] = {
                    op: n - billed0.get(op, 0.0) for op, n in
                    eng.perf.stats_fields()["collective_bytes"].items()}
                out["quantized"] = tq.params_quantized(eng.runner.params)
                out["perf"] = _perf(eng)
                out["reports"] = eng.runner.follower_reports()
                out["ranks"] = eng.rank_info()
                out["cfg"] = eng.config.model
            finally:
                eng.close()
    return out


_RUNS: dict = {}


def _cached(name: str) -> dict:
    if name not in _RUNS:
        _RUNS[name] = _run(SPLIT if name == "split" else CASES[name])
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_ring_features_match_the_jax_engine(name):
    out = _cached(name)
    if CASES[name].quant:
        assert out["quantized"]
        assert_int8_same(out["jax"], out["got"])
    else:
        assert_same(out["jax"], out["got"])


@pytest.mark.parametrize("name", list(CASES))
def test_ring_features_match_seq1(name):
    out = _cached(name)
    assert_same(out["seq1"], out["got"])


@pytest.mark.parametrize("name", list(CASES))
def test_ring_features_take_the_ring(name):
    """Both long prompts took the ring, alone, at the reference's padded
    length, whose int8 route each product of the call followed."""
    out = _cached(name)
    assert out["lengths"] == out["jax_lengths"] == RING_LENS == [64, 64]
    if CASES[name].quant:
        # the products over the slice ask for S's route; the head's one
        # row asks for its own
        assert set(out["routes"]) == {64, 1}


@pytest.mark.parametrize("name", list(CASES))
def test_ring_features_every_process_agrees(name):
    out = _cached(name)
    tp = CASES[name].tp
    reports = out["reports"]
    assert [r["rank"] for r in reports] == list(range(2 * tp))
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)
    assert len({tuple(sorted(r["launches"].items()))
                for r in reports}) == 1
    assert out["ranks"]["axis"] == ("seq" if tp == 1 else "seq,tensor")


@pytest.mark.parametrize("name", list(CASES))
def test_ring_prefill_accounted_with_the_models_own_params(name):
    """A ring prefill is recorded as a prefill of its prompt's tokens, at
    the model's active parameters (k / X of the experts) and its bytes
    (int8 values and float32 scales), as the seq 1 engine counts them
    over its real weights."""
    out = _cached(name)
    model, tokens = out["perf"]
    assert (model, tokens) == out["seq1_perf"]
    assert tokens == sum(len(p) for _, p, _ in REQS)
    cfg = out["cfg"]
    if cfg.num_experts:
        assert model["active_param_count"] < model["param_count"]
    if cfg.quant:
        assert model["param_bytes"] < 2 * model["param_count"]


@pytest.mark.parametrize("name", list(CASES))
def test_ring_moe_count_exchange_bytes(name):
    """L (n - 1) X 4 bytes a ring prefill on rank 0's wire for a MoE
    model, none for a dense one; never billed to a dispatch."""
    out = _cached(name)
    cfg = out["cfg"]
    got = out["wire"].get("ring_moe_counts", 0.0)
    if cfg.num_experts:
        assert got == len(RING_LENS) * cfg.num_layers * (2 - 1) * \
            cfg.num_experts * 4
    else:
        assert got == 0.0
    assert "ring_moe_counts" in RING_OPS
    assert not any(op in RING_OPS and n for op, n in out["billed"].items())


def test_int8_ring_takes_the_route_of_the_whole_prompt():
    """Threshold 48 between Sl = 32 and S = 64: the ring's products ask
    for S's route, W8A16, as the JAX engine's ring over the whole prompt
    does, and its answers equal the JAX engine's within the int8 band."""
    out = _cached("split")
    assert out["lengths"] == out["jax_lengths"] == [64, 64]
    assert set(out["routes"]) == {64, 1}
    with _threshold(SPLIT.a16_threshold):
        assert tq.a16(64) and not tq.a16(32)
    assert out["quantized"]
    assert_int8_same(out["jax"], out["got"])


# -- forced drops, the block split over two seq ranks (threads) ---------------

class _SeqThreads:
    """Two seq ranks as threads: ``moe_counts`` stacks both ranks'
    counts, as ``RankGroup.moe_counts`` does over the device group."""

    def __init__(self, n: int):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)

    def rank(self, r: int):
        ex, n = self, len(self.slots)

        class Rank:
            size, rank = n, r

            def moe_counts(self, counts):
                ex.slots[r] = counts.clone()
                ex.barrier.wait()
                out = torch.stack(ex.slots)
                ex.barrier.wait()
                return out

        return Rank()


@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_forced_drops_across_seq_ranks_match_reference(mode):
    jc = dataclasses.replace(jcfg.ModelConfig.from_pretrained(
        "tiny-mixtral"), num_experts=8)
    tc = dataclasses.replace(ModelConfig.from_pretrained("tiny-mixtral"),
                             num_experts=8)
    jl, tl = _layer0(jc, tc, mode, router_bias=20.0)
    S, n = 64, 2
    Sl = S // n
    x = np.random.default_rng(7).standard_normal(
        (S, tc.hidden_size)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 1.0
    want = np.asarray(jax.jit(lambda a: jllama._moe_mlp(jc, jl, a))(
        jnp.asarray(x)))
    # the routing: rank 0 alone fills expert 0's capacity, so every slot
    # rank 1 routes there is dropped, and only because of rank 0's
    logits = (torch.from_numpy(x) @ tl["router"]).float()
    _, idx = llama.top_k_lower_first(logits, tc.num_experts_per_tok)
    to0 = (idx == 0).sum(1)
    cap = max(int(2.0 * S * tc.num_experts_per_tok / tc.num_experts),
              tc.num_experts_per_tok)
    assert int(to0[:Sl].sum()) >= cap >= int(to0[Sl:].sum()) > 0
    ex = _SeqThreads(n)
    got = [None] * n

    def run(r):
        got[r] = llama._moe_mlp(tc, tl, torch.from_numpy(
            x[r * Sl:(r + 1) * Sl]), S, seq=ex.rank(r)).numpy()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    np.testing.assert_allclose(np.concatenate(got), want, rtol=0,
                               atol=2e-5)
    # without rank 0's counts rank 1 keeps the slots the reference drops
    alone = llama._moe_mlp(tc, tl, torch.from_numpy(x[Sl:]), S).numpy()
    assert np.abs(alone - want[Sl:]).max() > 1e-3
