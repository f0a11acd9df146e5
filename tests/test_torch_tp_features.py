"""The model's features under tensor parallelism in the port, against the
JAX engine at ``MeshConfig(tensor=2/4)`` and the port at tp 1, on the CPU.

- Row-parallel products, in one process with one thread a rank
  (``_threads``): on the W8A8 route each row's activation scale is the max
  over the ranks and the int32 partials are summed exactly, so the
  product is one device's bit for bit, for ``wo`` and ``w_down`` alike; a
  rank that took its own max would compute another product, and the test
  data is checked to tell the two apart. The W8A16 route and a plain
  weight sum float32 partials (within 1e-5 of one device). Mixtral's
  block with F cut: float32 within 1e-5, W8A8 bit for bit. A LoRA
  delta's shares on a row-parallel target sum to the whole delta.
- Weights: a rank's int8 shard equals the cut of the tp 1 quantization bit
  for bit, the row-parallel scales included, from seeded init, from a
  checkpoint, from ``shard_params`` and from ``params_from_jax`` of the
  JAX engine's quantized tree; an adapter's shares rebuild it.
- Engines on mixed prefill and decode traffic: tiny-mixtral, tiny-llama
  int8 on the W8A8 route (tp 2 and 4) and the W8A16 route (threshold 1),
  tiny-mixtral int8, and tiny-llama with an adapter on the ragged and the
  bucketed path. Greedy tokens are identical up to a near-tie (top-2 gap
  under 1e-4). Logprobs are within 1e-4 of the port at tp 1 in every
  case, and of the JAX engine for the float32 models; the int8 models
  are held to the JAX engine within ``INT8_LP_BAND``, the band of the tp
  1 int8 tests (test_torch_quant.py: an activation on a rounding boundary
  rounds one way in one framework, the other in the other). Every
  follower's token digest equals rank 0's, and the adapter changes its
  rows' tokens.

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``).
"""

import contextlib
import dataclasses
import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain
from _torch_tp import rank_limit
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine import quant as jq
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine import quant as tq
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
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
from production_stack_tpu_torch.parallel import shardings as tshard
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from test_torch_lora import make_adapter_dir
from test_torch_quant import assert_int8_same

torch.set_num_threads(1)

F32_TOL = 1e-5


# -- ranks as threads -----------------------------------------------------------

class _Exchange:
    """What the ranks' threads share: one slot a rank and a barrier."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def reduce(self, rank: int, x: torch.Tensor, op) -> torch.Tensor:
        self.slots[rank] = x.clone()
        self.barrier.wait()
        out = self.slots[0].clone()
        for y in self.slots[1:]:
            out = op(out, y)
        self.barrier.wait()
        return out


class _ThreadRank:
    """A RankGroup's collectives over threads (the sum in rank order)."""

    def __init__(self, ex: _Exchange, rank: int, shard, own_max=False):
        self.ex, self.rank, self.shard = ex, rank, shard
        self.own_max = own_max

    def all_reduce(self, x):
        y = self.ex.reduce(self.rank, x.float(), torch.add)
        return y.to(x.dtype)

    def all_reduce_int32(self, x):
        assert x.dtype == torch.int32
        return self.ex.reduce(self.rank, x, torch.add)

    def all_reduce_max(self, x):
        if self.own_max:  # the fault: each rank keeps its own absmax
            return x
        return self.ex.reduce(self.rank, x, torch.maximum)


def _threads(cfg, tp: int, fn, own_max=False) -> list:
    """``fn(rank, group)`` on ``tp`` threads, one a rank; the results in
    rank order."""
    ex = _Exchange(tp)
    out, errors = [None] * tp, []

    def run(r):
        try:
            out[r] = fn(r, _ThreadRank(ex, r, tshard.Shard.of(cfg, r, tp),
                                       own_max))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


def _tiny(preset="tiny-llama", **kw) -> ModelConfig:
    return dataclasses.replace(ModelConfig.from_pretrained(preset), **kw)


def _rows(seed: int, n: int, k: int) -> torch.Tensor:
    """Activations whose rows' absmax sits in one half of K or the other,
    so a rank's own max differs from the row's."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    for i in range(n):
        half = slice(0, k // 2) if i % 2 else slice(k // 2, k)
        x[i, half] *= 4.0
    return torch.from_numpy(x)


# -- row-parallel products --------------------------------------------------------

# (name, logical axes of the weight without the layer axis, contracted dims)
ROW_PARALLEL = [("w_down", (tshard.MLP, tshard.EMBED), 1),
                ("wo", (tshard.HEADS, tshard.HEAD_DIM, tshard.EMBED), 2)]


def _row_parallel_case(name, axes, nc, tp, route, own_max=False):
    cfg = _tiny()
    w = init_random(cfg, seed=1)["layers"][name][0]
    if route != "plain":
        w = tq.quantize_array(w, tuple(range(nc)))
    lead = w["q"].shape[:nc] if route != "plain" else w.shape[:nc]
    x = _rows(2, 20, int(np.prod(lead))).reshape(20, *lead)
    x_axes = (None, *axes[:nc])
    # the reference's token count: the default threshold (512) puts it
    # on the W8A16 route, the 20 rows on the W8A8 one
    tokens = 512 if route == "w8a16" else None
    want = tq.quant_matmul(x, w, nc, tokens=tokens)
    got = _threads(cfg, tp, lambda r, g: tllama._row_parallel(
        g, axes[0], g.shard.cut(x, x_axes), g.shard.cut_leaf(w, axes), nc,
        tokens), own_max)
    return want, got


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,axes,nc", ROW_PARALLEL,
                         ids=[c[0] for c in ROW_PARALLEL])
def test_w8a8_row_parallel_is_one_device_bit_for_bit(name, axes, nc, tp):
    want, got = _row_parallel_case(name, axes, nc, tp, "w8a8")
    for y in got:
        assert torch.equal(y, want)


@pytest.mark.parametrize("name,axes,nc", ROW_PARALLEL,
                         ids=[c[0] for c in ROW_PARALLEL])
def test_a_rank_taking_its_own_activation_max_computes_another_product(
        name, axes, nc):
    """The data of the bit-for-bit test tells the two apart: with each
    rank's own absmax the ranks quantize other int8 rows."""
    want, got = _row_parallel_case(name, axes, nc, 2, "w8a8", own_max=True)
    assert not torch.equal(got[0], want)
    assert (got[0] - want).abs().max() > 1e-4


@pytest.mark.parametrize("route", ["plain", "w8a16"])
@pytest.mark.parametrize("name,axes,nc", ROW_PARALLEL,
                         ids=[c[0] for c in ROW_PARALLEL])
def test_float_row_parallel_sums_float32_partials(name, axes, nc, route):
    want, got = _row_parallel_case(name, axes, nc, 2, route)
    for y in got:
        torch.testing.assert_close(y, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_moe_block_with_f_cut_is_one_device(quant, tp):
    """tiny-mixtral's layer 0 with every expert's F cut over ``tp``
    ranks: float32 within 1e-5; int8 (W8A8, the int32 sum before the
    combine) bit for bit."""
    cfg = _tiny("tiny-mixtral", quant=quant)
    params = init_random(cfg, seed=4)
    lp = {n: tllama._layer(w, 0) for n, w in params["layers"].items()}
    specs = {n: s[1:] for n, s in tllama.param_specs(cfg)["layers"].items()}
    x = _rows(5, 24, cfg.hidden_size)
    want = tllama._moe_mlp(cfg, lp, x, tokens=40)
    got = _threads(cfg, tp, lambda r, g: tllama._moe_mlp(
        cfg, {n: g.shard.cut_leaf(w, specs[n]) for n, w in lp.items()},
        x, tokens=40, group=g))
    for y in got:
        if quant:
            assert torch.equal(y, want)
        else:
            torch.testing.assert_close(y, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("target", ["wo", "w_down"])
def test_lora_shares_of_a_row_parallel_target_sum_to_the_delta(target):
    cfg = _tiny()
    rng = np.random.default_rng(6)
    bank = {t: (rng.normal(0, 0.3, (cfg.num_layers, i, 4)).astype(np.float32),
                rng.normal(0, 0.3, (cfg.num_layers, 4, *o)).astype(
                    np.float32))
            for t, (i, o) in tlora.target_shapes(cfg).items()}
    A, B = (torch.from_numpy(a[0]) for a in bank[target])
    x = _rows(7, 9, A.shape[0])
    onehot = torch.ones(9, 1)

    def delta(x_, A_, B_):
        return tllama._lora_delta(x_, onehot, A_[:, None], B_[None])

    want = delta(x, A, B)
    parts = []
    for r in range(2):
        sh = tshard.Shard.of(cfg, r, 2)
        share = tlora.adapter_share(bank, sh, cfg)[target]
        lo, hi = ((sh.cuts[tshard.HEADS][0] * cfg.head_dim,
                   sh.cuts[tshard.HEADS][1] * cfg.head_dim)
                  if target == "wo" else sh.cuts[tshard.MLP])
        parts.append(delta(x[:, lo:hi], torch.from_numpy(share[0][0]),
                           torch.from_numpy(share[1][0])))
    torch.testing.assert_close(parts[0] + parts[1], want, rtol=F32_TOL,
                               atol=F32_TOL)


# -- weights ------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and not tq.is_quantized(v):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _assert_cut(full: dict, shard: dict, cfg, rank: int, tp: int) -> None:
    """``shard`` is rank's cut of ``full`` bit for bit, quantized leaves'
    q and s included."""
    sh = tshard.Shard.of(cfg, rank, tp)
    specs = dict(_leaves(tllama.param_specs(cfg)))
    got = dict(_leaves(shard))
    n_quant = 0
    for name, leaf in _leaves(full):
        want = sh.cut_leaf(leaf, specs[name])
        if tq.is_quantized(leaf):
            n_quant += 1
            for part in ("q", "s"):
                assert torch.equal(got[name][part], want[part]), (name, part)
        else:
            assert torch.equal(got[name], want), name
    assert n_quant > 0


@pytest.mark.parametrize("preset,tp", [("tiny-llama", 2), ("tiny-llama", 4),
                                       ("tiny-mixtral", 2)])
def test_int8_seeded_shard_is_the_cut_of_tp1(preset, tp):
    cfg = _tiny(preset, quant="int8")
    full = init_random(cfg, seed=3)
    for r in range(tp):
        _assert_cut(full, init_random(cfg, 3, "cpu", r, tp), cfg, r, tp)
        _assert_cut(full, shard_params(full, cfg, r, tp), cfg, r, tp)
    # a row-parallel scale is whole on every rank: the max over all of F
    s = init_random(cfg, 3, "cpu", 1, tp)["layers"]["w_down"]["s"]
    assert torch.equal(s, full["layers"]["w_down"]["s"])


def test_int8_checkpoint_shard_is_the_cut_of_tp1(tmp_path):
    from test_torch_checkpoint import write_checkpoint

    cfg = _tiny(quant="int8",
                weights_path=write_checkpoint(tmp_path, "tiny-llama"))
    full = load_safetensors(cfg)
    for r in range(2):
        _assert_cut(full, load_safetensors(cfg, "cpu", r, 2), cfg, r, 2)


@pytest.mark.parametrize("preset,tp", [("tiny-llama", 2),
                                       ("tiny-mixtral", 4)])
def test_params_from_jax_int8_tree_shard_is_the_cut(preset, tp):
    jc = jcfg.ModelConfig.from_pretrained(preset, quant="int8")
    from production_stack_tpu.engine.weights import init_or_load

    mesh = jmesh.build_mesh(jmesh.MeshConfig(data=1, tensor=1),
                            devices=jax.devices()[:1])
    tree = jax.tree.map(np.asarray, jax.device_get(jq.quantize_params(
        jc, init_or_load(dataclasses.replace(jc, quant=None), mesh,
                         seed=0))))
    cfg = _tiny(preset, quant="int8")
    full = params_from_jax(tree, cfg)
    assert tq.params_quantized(full)
    for r in range(tp):
        _assert_cut(full, params_from_jax(tree, cfg, "cpu", r, tp), cfg, r,
                    tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_adapter_shares_rebuild_the_adapter(tp):
    cfg = _tiny()
    rng = np.random.default_rng(8)
    bank = {t: (rng.normal(size=(cfg.num_layers, i, 4)).astype(np.float32),
                rng.normal(size=(cfg.num_layers, 4, *o)).astype(np.float32))
            for t, (i, o) in tlora.target_shapes(cfg).items()}
    shares = [tlora.adapter_share(bank, tshard.Shard.of(cfg, r, tp), cfg)
              for r in range(tp)]
    H = cfg.num_heads
    for t, (A, B) in bank.items():
        ins, outs = tshard.LORA_AXES[t]
        if tshard.HEADS in ins or tshard.MLP in ins:
            # A cut along the input; B whole
            got = np.concatenate([s[t][0] for s in shares], axis=1)
            assert all(np.array_equal(s[t][1], B) for s in shares), t
            np.testing.assert_array_equal(got, A, err_msg=t)
        elif t in ("wk", "wv") and tp > cfg.num_kv_heads:
            # replicated KV heads: each rank keeps the one it reads
            for r, s in enumerate(shares):
                kv = r * (H // tp) // (H // cfg.num_kv_heads)
                np.testing.assert_array_equal(s[t][1], B[:, :, kv:kv + 1])
        else:
            got = np.concatenate([s[t][1] for s in shares], axis=2)
            assert all(np.array_equal(s[t][0], A) for s in shares), t
            np.testing.assert_array_equal(got, B, err_msg=t)


# -- engines ------------------------------------------------------------------------

GREEDY = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True,
                        logprobs=2)
rng = np.random.default_rng(12)
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
    preset: str
    quant: str = None
    tp: int = 2
    impl: str = "ragged"
    a16_threshold: str = None  # PSTPU_QUANT_A16_THRESHOLD; None: default
    lora: bool = False


CASES = {
    "mixtral-tp2": Case("tiny-mixtral"),
    "mixtral-tp4": Case("tiny-mixtral", tp=4),
    "llama-int8-w8a8-tp2": Case("tiny-llama", "int8"),
    "llama-int8-w8a8-tp4": Case("tiny-llama", "int8", tp=4),
    "llama-int8-w8a16-tp2": Case("tiny-llama", "int8", a16_threshold="1"),
    "mixtral-int8-tp2": Case("tiny-mixtral", "int8"),
    "llama-lora-ragged-tp2": Case("tiny-llama", lora=True),
    "llama-lora-bucketed-tp2": Case("tiny-llama", impl="bucketed",
                                    lora=True),
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


def _configs(case: Case, tp: int):
    cache = dict(block_size=4, num_blocks=NUM_BLOCKS)
    # the reference's prefix cache keys a block without its adapter, so
    # r0-base would reuse r0's blocks computed under the adapter; the
    # port's keys it with the adapter's root (test_torch_lora.py)
    jcache = dict(cache, enable_prefix_caching=not case.lora)
    jconf = jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained(case.preset, quant=case.quant),
        cache=jcfg.CacheConfig(**jcache),
        scheduler=jcfg.SchedulerConfig(**SCHED),
        mesh=jmesh.MeshConfig(data=1, tensor=tp), attention_impl=case.impl)
    tconf = EngineConfig(
        model=ModelConfig.from_pretrained(case.preset, quant=case.quant),
        cache=CacheConfig(**cache), scheduler=SchedulerConfig(**SCHED),
        attention_impl=case.impl, mesh=MeshConfig(tensor=tp))
    return jconf, tconf


def _requests(case: Case) -> list:
    if not case.lora:
        return MIXED
    # adapter rows and base rows in one wave; r0's prompt twice, once with
    # the adapter and once without
    return ([(rid, p, sp, 1 if rid in ("r0", "r2") else 0)
             for rid, p, sp in MIXED] + [("r0-base", MIXED[0][1], GREEDY, 0)])


_RUNS: dict = {}


def _run(name: str) -> dict:
    """The JAX engine at ``tensor=tp``, the port at tp 1 and at tp, with the
    JAX engine's weights (quantized by it for an int8 case); cached for
    the module."""
    if name in _RUNS:
        return _RUNS[name]
    case = CASES[name]
    reqs = _requests(case)
    out = {}
    with _threshold(case.a16_threshold), \
            contextlib.ExitStack() as stack:
        jconf, tconf = _configs(case, case.tp)
        jeng = JaxEngine(jconf, mesh=jmesh.build_mesh(
            jconf.mesh, devices=jax.devices()[:case.tp]),
            num_blocks=NUM_BLOCKS)
        params = params_from_jax(jax.tree.map(np.asarray, jax.device_get(
            jeng.runner.params)), tconf.model)
        adapter = None
        if case.lora:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            adapter = make_adapter_dir(tmp, tconf.model, seed=1)
            jeng.runner.register_lora(1, jlora.load_adapter_raw(
                "a", adapter, jconf.model, jconf.max_lora_rank))
        out["jax"] = drain(jeng, reqs, STAGGER)
        one = LLMEngine(dataclasses.replace(tconf, mesh=MeshConfig(tensor=1)),
                        params=params, device="cpu")
        if adapter:
            tlora.LoraManager(one).load("a", adapter)
        out["tp1"] = drain(one, reqs, STAGGER)
        with rank_limit(120):
            eng = LLMEngine(tconf, params=params, device="cpu")
            try:
                if adapter:
                    tlora.LoraManager(eng).load("a", adapter)
                out["tp"] = drain(eng, reqs, STAGGER)
                out["reports"] = eng.runner.follower_reports()
                out["quantized"] = tq.params_quantized(eng.runner.params)
            finally:
                eng.close()
    _RUNS[name] = out
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_the_jax_engine(name):
    out = _run(name)
    if CASES[name].quant:
        assert out["quantized"]
        assert_int8_same(out["jax"], out["tp"])
    else:
        assert_same(out["jax"], out["tp"])


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_one_rank(name):
    out = _run(name)
    assert_same(out["tp1"], out["tp"])


@pytest.mark.parametrize("name", list(CASES))
def test_followers_sample_what_rank0_samples(name):
    reports = _run(name)["reports"]
    assert [r["rank"] for r in reports] == list(range(CASES[name].tp))
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["calls"] > 0
    assert all(r["diverged_at"] is None for r in reports)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.lora])
def test_the_adapter_changes_its_rows_at_tp2(name):
    for run in ("jax", "tp1", "tp"):
        toks = _run(name)[run][0]
        assert toks["r0"] != toks["r0-base"], run

