"""The KV plane under tensor parallelism against the JAX engine's, on the
CPU: the join and split of the ranks' KV heads, and the runner's exports
and imports at tp 2 and 4.

- ``shardings.join_kv_shares`` / ``split_kv_share`` against the
  reference's ``combine_kv`` / ``split_kv`` at tp 1, 2 and 4, with 2 and
  8 KV heads (replicated where tp is a multiple of them), exactly.
- Exports: tiny-llama in float32 at tp 2 and 4 on both attention paths:
  ``export_blocks``, every ``export_blocks_range`` layer group and
  ``export_slabs`` equal the JAX engine's ``export_kv`` at ``tensor=N`` on
  the same prompt (1e-5); at tp 2 also the port's tp 1 export once
  regrouped (``combine_kv(k, v, 2)``).
- Imports at tp 2: the JAX engine's ``tensor=2`` export and the port's
  own, each imported whole (``import_kv``), streamed in layer groups
  (``begin_kv_import`` / ``import_kv_range`` / ``finish_kv_import``) and
  spliced with the producer's first token, continue to the unified run's
  tokens: greedy identical up to a near-tie, logprobs within 1e-4. The
  followers' token digests equal rank 0's after the traffic.
- Accounting: the shares' bytes count under ``kv_gather`` and
  ``kv_scatter`` and never in a dispatch's collective bytes.
- A follower lost before or during a transfer fails it, naming the rank.

Every engine with ranks runs under ``rank_limit`` (``_torch_tp``); two
such engines never live at once (one torch.distributed group a process).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain, engine_configs
from _torch_tp import rank_limit
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSP
from production_stack_tpu.ops import paged_attention as jpa
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu.parallel import shardings as jshard
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.kv_transfer import layer_groups
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.parallel import shardings as tshard
from production_stack_tpu_torch.parallel.mesh import MeshConfig

torch.set_num_threads(1)

BS = 4
NUM_BLOCKS = 256
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=32,
             prefill_buckets=(16, 32, 64, 128))
GREEDY = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True,
                        logprobs=2)
ONE = SamplingParams(temperature=0.0, max_tokens=1, ignore_eos=True)
rng = np.random.default_rng(16)
# the exported prompt: 9 full blocks and a partial one
PROMPT = rng.integers(1, 500, 38).tolist()
# the import cases' prompts, two a case
FORMS = ("whole", "streamed", "spliced")
SOURCES = ("jax", "port")
PROMPTS = {(src, form): [rng.integers(1, 500, int(n)).tolist()
                         for n in rng.integers(13, 40, 2)]
           for src in SOURCES for form in FORMS}


# -- the join and the split against combine_kv / split_kv --------------------

def _cfg(kv_heads: int):
    base = ModelConfig.from_pretrained("tiny-llama")
    return dataclasses.replace(base, num_heads=2 * kv_heads,
                               num_kv_heads=kv_heads)


def _ref_groups(cfg, tp: int) -> int:
    """The reference runner's ``tp`` property: the mesh's tensor size
    where its rules shard KV heads, 1 where they replicate them."""
    shape = {a: 1 for a in jmesh.MESH_AXES}
    shape[jmesh.AXIS_TENSOR] = tp
    rules = jshard.rules_for_model(
        jcfg.ModelConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(jcfg.ModelConfig)
                            if hasattr(cfg, f.name)}),
        type("Mesh", (), {"shape": shape})())
    return tp if rules.rules.get(jshard.KV_HEADS) is not None else 1


@pytest.mark.parametrize("kv_heads", [2, 8])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_join_and_split_are_the_reference_layout(tp, kv_heads):
    cfg = _cfg(kv_heads)
    g = tshard.kv_head_groups(cfg, tp)
    assert g == _ref_groups(cfg, tp)
    r = np.random.default_rng(tp * 10 + kv_heads)
    k, v = (r.standard_normal((3, 5, kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    whole = np.asarray(jpa.combine_kv(k.reshape(15, kv_heads, -1),
                                      v.reshape(15, kv_heads, -1), g)
                       ).reshape(3, 5, 2 * kv_heads, -1)
    shares = []
    for rank in range(tp):
        lo, hi = tshard.Shard.of(cfg, rank, tp).cuts.get(
            tshard.KV_HEADS, (0, kv_heads))
        # a rank's pool holds its heads in the tp = 1 layout
        mine = np.asarray(jpa.combine_kv(
            k[:, :, lo:hi].reshape(15, hi - lo, -1),
            v[:, :, lo:hi].reshape(15, hi - lo, -1), 1)
        ).reshape(3, 5, 2 * (hi - lo), -1)
        shares.append(torch.from_numpy(np.array(mine)))
        got = tshard.split_kv_share(torch.from_numpy(np.array(whole)), cfg,
                                    rank, tp)
        assert torch.equal(got, shares[-1])
    joined = tshard.join_kv_shares(shares, cfg, tp)
    assert torch.equal(joined, torch.from_numpy(whole))
    jk, jv = jpa.split_kv(joined.numpy(), g)
    assert np.array_equal(np.asarray(jk), k)
    assert np.array_equal(np.asarray(jv), v)


# -- engines -------------------------------------------------------------------

def _configs(tp: int, impl: str):
    jconf, tconf = engine_configs(impl, block_size=BS, num_blocks=NUM_BLOCKS,
                                  **SCHED)
    jconf.mesh = jmesh.MeshConfig(data=1, tensor=tp)
    tconf.mesh = MeshConfig(tensor=tp)
    return jconf, tconf


def _jax_engine(jconf, tp: int):
    return JaxEngine(jconf, mesh=jmesh.build_mesh(
        jconf.mesh, devices=jax.devices()[:tp]), num_blocks=NUM_BLOCKS)


def _exports(eng, blocks, jax_side: bool) -> dict:
    """The engine's exports of ``blocks`` as numpy: whole, in layer groups
    of one and of two layers, and as slabs."""
    L = eng.config.model.num_layers
    run = eng.runner
    host = np.asarray if jax_side else (lambda t: t.numpy())
    out = {"whole": host(eng.export_kv(blocks))}
    for group in (1, 2):
        out[f"groups{group}"] = np.concatenate([
            host(run.export_blocks_range(blocks, lo, n))
            for lo, n in layer_groups(L, group)])
    if not jax_side:
        out["slabs"] = np.stack([s.numpy() for s in
                                 run.export_slabs(blocks)], axis=1)
    return out


def _prefill(eng, prompts, jax_side: bool) -> dict:
    """Each prompt prefilled (one token out): (first token, the blocks
    its finished request held)."""
    sp = JaxSP(**dataclasses.asdict(ONE)) if jax_side else ONE
    for i, p in enumerate(prompts):
        eng.add_request(f"p{i}", prompt_token_ids=list(p), sampling=sp)
    finals = {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                finals[o.request_id] = (o.new_token_ids[-1],
                                        list(o.block_ids))
    return [finals[f"p{i}"] for i in range(len(prompts))]


def _produce(eng, jax_side: bool) -> dict:
    """What the import cases need of a producer: for the whole and
    streamed forms each prompt's full blocks as cached KV; for the spliced
    form the first token and the finished request's whole table."""
    out = {}
    for form in FORMS:
        prompts = PROMPTS[("jax" if jax_side else "port", form)]
        finals = _prefill(eng, prompts, jax_side)
        datas = []
        for p, (first, table) in zip(prompts, finals):
            if form == "spliced":
                blocks = table
            else:
                blocks, _ = eng.scheduler.allocator.match_prefix(p)
            data = eng.export_kv(blocks)
            datas.append((first, torch.from_numpy(np.ascontiguousarray(
                data)) if jax_side else data.clone()))
        out[form] = datas
    return out


_RUNS: dict = {}


def _run(tp: int, impl: str) -> dict:
    """The JAX engine at ``tensor=tp`` and the port at tp (and at tp 1 for
    tp 2), with the JAX engine's weights, after ``PROMPT``: their exports
    of its cached blocks. On (2, ragged) also the producers' data for
    the import cases, the JAX engine's unified run of their prompts and
    the accountant's view of a KV export."""
    key = (tp, impl)
    if key in _RUNS:
        return _RUNS[key]
    jconf, tconf = _configs(tp, impl)
    jeng = _jax_engine(jconf, tp)
    params = params_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jeng.runner.params)), tconf.model)
    out = {"params": params}
    drain(jeng, [("a", PROMPT, ONE)])
    blocks, _ = jeng.scheduler.allocator.match_prefix(PROMPT)
    out["jax"] = _exports(jeng, blocks, True)
    importing = key == (2, "ragged")
    if importing:
        out["jax_data"] = _produce(jeng, True)
        out["unified"] = drain(jeng, [
            (f"{src}-{form}-{i}", p, GREEDY)
            for (src, form), ps in PROMPTS.items()
            for i, p in enumerate(ps)])
    del jeng
    if tp == 2:
        one = LLMEngine(dataclasses.replace(tconf, mesh=MeshConfig(tensor=1)),
                        params=params, device="cpu")
        drain(one, [("a", PROMPT, ONE)])
        mine, _ = one.scheduler.allocator.match_prefix(PROMPT)
        out["tp1"] = one.export_kv(mine).numpy()
    with rank_limit(120):
        eng = LLMEngine(tconf, params=params, device="cpu")
        try:
            drain(eng, [("a", PROMPT, ONE)])
            mine, _ = eng.scheduler.allocator.match_prefix(PROMPT)
            out["same_blocks"] = list(mine) == list(blocks)
            out["port"] = _exports(eng, mine, False)
            out["groups"] = eng.runner.kv_head_groups
            if importing:
                out["port_data"] = _produce(eng, False)
                out["accounting"] = _accounting(eng, mine)
        finally:
            eng.close()
    _RUNS[key] = out
    return out


CASES = [(2, "ragged"), (2, "bucketed"), (4, "ragged"), (4, "bucketed")]
IDS = [f"tp{tp}-{impl}" for tp, impl in CASES]


@pytest.mark.parametrize("tp,impl", CASES, ids=IDS)
@pytest.mark.parametrize("kind", ["whole", "groups1", "groups2", "slabs"])
def test_exports_equal_the_jax_engine(tp, impl, kind):
    out = _run(tp, impl)
    assert out["same_blocks"]
    want = out["jax"]["whole"]
    got = out["port"][kind]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kind != "slabs":
        np.testing.assert_allclose(got, out["jax"][kind], rtol=1e-5,
                                   atol=1e-5)


def test_tp2_export_is_tp1_regrouped():
    """tiny-llama's two KV heads shard at tp 2: its export is tp 1's
    ``(K_0, K_1, V_0, V_1)`` rows regrouped as ``(K_0, V_0, K_1, V_1)``."""
    out = _run(2, "ragged")
    assert out["groups"] == 2 and _run(4, "ragged")["groups"] == 1
    k, v = np.split(out["tp1"], 2, axis=3)
    L, n, bs, KH, D = k.shape
    regrouped = np.asarray(jpa.combine_kv(
        k.reshape(-1, KH, D), v.reshape(-1, KH, D), 2)).reshape(
            out["tp1"].shape)
    np.testing.assert_allclose(out["port"]["whole"], regrouped, rtol=1e-5,
                               atol=1e-5)


def _accounting(eng, blocks) -> dict:
    """A KV export and an import between two dispatches: the collective
    bytes every dispatch was billed before and after, the shares' wire
    bytes, and a following decode step's bill against the step's own
    collectives."""
    perf, wire = eng.perf, eng.runner.ranks.wire
    before = dict(perf.stats_fields()["collective_bytes"])
    sent = dict(wire)
    data = eng.export_kv(blocks)
    free = eng.scheduler.allocator.take_free_blocks(len(blocks))
    eng.runner.import_blocks(free, data)
    landed = eng.export_kv(free)
    eng.scheduler.allocator.free_blocks(free)
    after = dict(perf.stats_fields()["collective_bytes"])
    kv_wire = {op: wire[op] - sent.get(op, 0.0) for op in wire
               if wire[op] != sent.get(op, 0.0)}
    sent = dict(wire)
    drain(eng, [("b", [7, 8, 9], ONE)])
    billed = {op: n - after.get(op, 0.0) for op, n in
              perf.stats_fields()["collective_bytes"].items()}
    step_wire = {op: wire[op] - sent.get(op, 0.0) for op in wire}
    return {"before": before, "after": after, "kv_wire": kv_wire,
            "billed": billed, "step_wire": step_wire,
            "round_trip": torch.equal(landed, data),
            "whole_bytes": data.nbytes}


def test_kv_shares_are_never_billed_to_a_dispatch():
    acc = _run(2, "ragged")["accounting"]
    assert acc["round_trip"]
    assert acc["after"] == acc["before"]
    # rank 1's share of two exports and of an import: half the whole each
    assert acc["kv_wire"] == {"kv_gather": acc["whole_bytes"],
                              "kv_scatter": acc["whole_bytes"] / 2}
    assert acc["step_wire"]["kv_gather"] == 0.0
    assert acc["billed"]["all_reduce"] > 0
    assert acc["billed"] == pytest.approx(
        {op: n for op, n in acc["step_wire"].items()
         if not op.startswith("kv_")})


def _import_case(eng, src: str, form: str, datas) -> list:
    """Land ``datas`` (the producer's (first token, KV) a prompt) in
    ``eng`` as ``form`` asks; returns the requests to run after."""
    reqs = []
    for i, (p, (first, data)) in enumerate(zip(PROMPTS[(src, form)],
                                               datas)):
        rid = f"{src}-{form}-{i}"
        n_full = (len(p) - 1) // BS
        if form == "whole":
            assert eng.import_kv(p, data) == n_full * BS
        elif form == "streamed":
            local, n = eng.begin_kv_import(p, int(data.shape[1]))
            assert n == n_full
            for lo, k in layer_groups(int(data.shape[0]), 1):
                eng.import_kv_range(local, lo, data[lo:lo + k, :n])
            assert eng.finish_kv_import(p, local) == n_full * BS
        else:
            local = eng.begin_kv_receive(int(data.shape[1]))
            eng.runner.import_blocks(local, data)
            eng.splice_request(rid, p, first, GREEDY, local)
            continue
        reqs.append((rid, p, GREEDY))
    return reqs


_IMPORTED: dict = {}


def _imported() -> dict:
    """One tp 2 consumer: every import case landed, then their requests
    served; its tokens, the prefix hits the imports gave and the
    followers' reports."""
    if _IMPORTED:
        return _IMPORTED
    run = _run(2, "ragged")
    _, tconf = _configs(2, "ragged")
    with rank_limit(120):
        eng = LLMEngine(tconf, params=run["params"], device="cpu")
        try:
            reqs = []
            for src in SOURCES:
                for form in FORMS:
                    reqs += _import_case(eng, src, form,
                                         run[f"{src}_data"][form])
            hits0 = eng.scheduler.allocator.prefix_hits
            for rid, p, sp in reqs:
                eng.add_request(rid, prompt_token_ids=p, sampling=sp)
            toks, lps = {}, {}
            while eng.has_unfinished():
                for o in eng.step():
                    toks.setdefault(o.request_id, []).extend(o.new_token_ids)
                    lps.setdefault(o.request_id, []).extend(
                        o.new_logprobs or ())
            _IMPORTED.update(
                spliced=eng.spliced_seqs, run=(toks, lps, {}),
                hits=eng.scheduler.allocator.prefix_hits - hits0,
                reports=eng.runner.follower_reports())
        finally:
            eng.close()
    return _IMPORTED


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("form", ["whole", "streamed"])
def test_pulled_kv_continues_as_unified(src, form):
    """A pulled transfer lands as prefix cache: admission computes only
    each prompt's tail, and the tokens are the unified run's."""
    got = _imported()
    want = _run(2, "ragged")["unified"]
    rids = [f"{src}-{form}-{i}" for i in range(2)]
    assert_same(tuple({r: w[r] for r in rids} for w in want[:2]) + ({},),
                tuple({r: g[r] for r in rids} for g in got["run"][:2])
                + ({},))
    # every pulled prompt's full blocks hit (both sources, both forms)
    assert got["hits"] == sum((len(p) - 1) // BS
                              for (s, f), ps in PROMPTS.items()
                              if f != "spliced" for p in ps)


@pytest.mark.parametrize("src", SOURCES)
def test_spliced_kv_continues_as_unified(src):
    """A pushed transfer spliced with the producer's first token decodes
    on, no prefill: its tokens after the first are the unified run's."""
    got = _imported()
    assert got["spliced"] == 2 * len(SOURCES)
    wt, wl, _ = _run(2, "ragged")["unified"]
    gt, gl, _ = got["run"]
    data = _run(2, "ragged")[f"{src}_data"]["spliced"]
    for i, (first, _) in enumerate(data):
        rid = f"{src}-spliced-{i}"
        assert wt[rid][0] == first
        assert len(gt[rid]) == GREEDY.max_tokens - 1
        assert_same(({rid: wt[rid][1:]}, {rid: wl[rid][1:]}, {}),
                    ({rid: gt[rid]}, {rid: gl[rid]}, {}))


def test_followers_agree_after_kv_traffic():
    reports = _imported()["reports"]
    assert [r["rank"] for r in reports] == [0, 1]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert all(r["diverged_at"] is None for r in reports)
    assert len({tuple(sorted(r["launches"].items()))
                for r in reports}) == 1


@pytest.mark.parametrize("when", ["before", "mid"])
def test_a_follower_lost_in_a_transfer_is_named(when):
    """A follower gone before a KV export, or while its share is on the
    way, fails the export naming the rank (``RankLost``), never a quiet
    miss."""
    _, tconf = _configs(2, "ragged")
    with rank_limit(60):
        eng = LLMEngine(tconf, params=_run(2, "ragged")["params"],
                        device="cpu")
        try:
            drain(eng, [("a", PROMPT, ONE)])
            blocks, _ = eng.scheduler.allocator.match_prefix(PROMPT)
            runner = eng.runner
            follower = runner.procs[0]

            def lose():
                follower.kill()
                follower.join(10)

            if when == "before":
                lose()
            else:
                def lost_mid(share):
                    # the group's own error once the peer is gone
                    lose()
                    raise RuntimeError("Connection closed by peer")

                runner.ranks.gather_kv = lost_mid
            with pytest.raises(multihost.RankLost, match="rank 1"):
                eng.export_kv(blocks)
        finally:
            eng.close()


class _CountingRunner:
    """A runner whose one call launches K1 twice and K3 once."""

    ranks = type("Ranks", (), {"rank": 1})()

    def set_count_row(self, row):
        from production_stack_tpu_torch.ops import kv_write as k1
        from production_stack_tpu_torch.ops import paged_decode_attention as k3

        k1.LAUNCHES.n += 2
        k3.LAUNCHES.n += 1


class _ScriptedRanks:
    """A group whose broadcasts give ``script`` in turn; gathers keep what
    they were given."""

    rank = 0

    def __init__(self, script=()):
        self.script, self.gathered = list(script), []

    def broadcast(self, obj=None):
        return self.script.pop(0) if self.script else obj

    def gather(self, obj):
        self.gathered.append(obj)
        return [obj]


def test_reports_count_only_the_launches_inside_the_ranks_calls():
    """What made ``test_followers_agree_after_kv_traffic`` fail now and
    then under xdist: a worker that had run ``test_torch_decode_graphs``
    first held K1 and K3 counts from before its ranks started, and rank
    0's report gave the process's totals where a fresh follower's begin
    at 0. A report counts the launches made inside the ranks' calls, on
    rank 0 and on a follower alike: counts from before the ranks, from
    between calls and a reset of the counters between calls stay out."""
    from production_stack_tpu_torch.ops import _build
    from production_stack_tpu_torch.ops import kv_write as k1
    from production_stack_tpu_torch.ops import paged_decode_attention as k3

    saved = _build.launch_counts()
    try:
        k1.LAUNCHES.n += 5  # an earlier engine in this process
        leader = multihost.MirroredRunner(_CountingRunner(), _ScriptedRanks(),
                                          [])
        leader.set_count_row(0)
        k3.LAUNCHES.n += 7  # between calls, outside the ranks
        _build.restore_counts({c: 0 for c in saved})  # a reset
        leader.set_count_row(1)
        mine = leader.report()["launches"]
        digest = multihost._Digest().hex()  # set_count_row samples nothing
        ranks = _ScriptedRanks([(1, "set_count_row", (0,), {}, digest),
                                (2, "set_count_row", (1,), {}, digest),
                                (3, "_report", (), {}, digest),
                                (4, "_shutdown", (), {}, digest)])
        multihost.follower_loop(_CountingRunner(), ranks)
        theirs = ranks.gathered[0]["launches"]
    finally:
        _build.restore_counts(saved)
    assert mine == theirs
    assert (mine["K1"], mine["K3"], mine["K2"], mine["K4"]) == (4, 2, 0, 0)
