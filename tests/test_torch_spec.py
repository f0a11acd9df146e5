"""The port's n-gram speculative decoding against the JAX package's.

- ``propose_ngram``, ``accept_drafts`` and ``SpecController`` (the port's
  copies) match the reference case for case: the reference tests' cases
  (``tests/test_spec_decode.py``) and random ones.
- The scheduler's draft grants match ``tests/test_spec_ragged.py``: blocks
  appended past a block boundary, the clamp exactly when the pool is dry,
  the budget charged FCFS; and the reference scheduler's grants step for
  step on the same traffic.
- The ragged engine with ``spec_ngram_k = 4`` on motif-loop prompts gives
  the JAX engine's greedy tokens and the same drafted and accepted counts.
- In the port alone: speculation on gives the tokens of speculation off
  (up to a near-tie of the off run), under staggered mixed traffic; warm
  equals cold over a rollback fuzz (rejected drafts' KV never reaches the
  prefix cache); ineligible rows are never granted.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_same,
    drain,
    engine_configs,
    http_json,
    jax_engine,
    port_engine,
    tiny_weights,
    top2_gaps,
)
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import scheduler as jsched
from production_stack_tpu.engine import sequence as jseq
from production_stack_tpu.engine import spec as jspec
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import scheduler as tsched
from production_stack_tpu_torch.engine import sequence as tseq
from production_stack_tpu_torch.engine import spec as tspec
from production_stack_tpu_torch.engine.sampling import SamplingParams

torch.set_num_threads(2)

# repetitive (drafts accept), structured (partial accepts), irregular
REPS = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
SEMI = [1, 2, 3, 4, 1, 2, 5, 6, 1, 2]
WILD = [11, 23, 5, 301, 42, 17]


# ---- proposer, acceptance and controller -------------------------------------

PROPOSE_CASES = [
    ([5, 6, 1, 2, 5, 6, 3, 4, 5, 6], 2, 2, 1, 4096),
    ([1, 2, 3, 9, 7, 2, 3, 8, 1, 2, 3], 1, 3, 1, 4096),
    ([1, 2, 3, 4, 5], 4, 3, 1, 4096),
    ([1, 2, 3, 4, 5], 0, 3, 1, 4096),
    ([7, 8, 1, 2, 7, 8], 5, 2, 1, 4096),
    (REPS, 4, 3, 1, 4096),
    (SEMI, 4, 3, 2, 6),
    ([3], 4, 3, 1, 4096),
]


@pytest.mark.parametrize("case", range(len(PROPOSE_CASES)))
def test_propose_ngram_matches_reference(case):
    toks, k, n_max, n_min, window = PROPOSE_CASES[case]
    assert (tspec.propose_ngram(toks, k, n_max, n_min, window)
            == jspec.propose_ngram(toks, k, n_max, n_min, window))


def test_propose_and_accept_fuzz_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        toks = rng.integers(0, 6, int(rng.integers(1, 40))).tolist()
        args = (int(rng.integers(0, 6)), int(rng.integers(1, 4)), 1,
                int(rng.integers(2, 50)))
        drafts = tspec.propose_ngram(toks, *args)
        assert drafts == jspec.propose_ngram(toks, *args)
        verified = rng.integers(0, 6, len(drafts) + 1)
        assert (tspec.accept_drafts(drafts, verified)
                == jspec.accept_drafts(drafts, verified))
    assert tspec.accept_drafts([10, 11, 99], np.asarray([10, 11, 22, 33])) \
        == ([10, 11, 22], 2)
    assert tspec.accept_drafts([], np.asarray([7])) == ([7], 0)


def test_spec_controller_matches_reference():
    """The same grant/update script on both controllers and on a sequence
    of each package: every grant, EWMA and cold counter agree."""
    rng = np.random.default_rng(1)
    mine, ref = tspec.SpecController(k_max=4), jspec.SpecController(k_max=4)
    sp = SamplingParams()
    a = tseq.Sequence("a", [1], sp)
    b = jseq.Sequence("a", [1], jseq.SamplingParams())
    for _ in range(200):
        g = mine.grant(a)
        assert g == ref.grant(b)
        acc = int(rng.integers(0, g + 1)) if rng.random() < 0.4 else 0
        mine.update(a, g, acc)
        ref.update(b, g, acc)
        assert (a.spec_ewma, a.spec_cold_steps) == (b.spec_ewma,
                                                    b.spec_cold_steps)


# ---- scheduler grants ----------------------------------------------------------

def _sched(mod, cfg_mod, num_blocks, spec_k=4, budget=16, max_seqs=2):
    sched = mod.Scheduler(
        cfg_mod.SchedulerConfig(max_num_seqs=max_seqs,
                                max_num_batched_tokens=budget,
                                prefill_buckets=(4, 8), spec_ngram_k=spec_k),
        cfg_mod.CacheConfig(block_size=4, num_blocks=num_blocks),
        num_blocks=num_blocks, max_model_len=64,
    )
    sched.unified = True
    sched.spec_grant_fn = lambda seq: spec_k
    return sched


def _running_seq(sched, n_prompt):
    seq = tseq.Sequence("r", list(range(1, n_prompt + 1)),
                        SamplingParams(max_tokens=8, ignore_eos=True),
                        arrival_time=1.0)
    sched.add(seq)
    out = sched.schedule()
    assert out.prefills and out.prefills[0].seq is seq
    seq.num_computed_tokens = n_prompt
    seq.status = tseq.SequenceStatus.RUNNING
    return seq


def test_grant_appends_blocks_past_boundary():
    """At a block boundary (8 = 2 blocks of 4) a grant of 4 needs capacity
    through position 12: two more blocks."""
    sched = _sched(tsched, tcfg, num_blocks=128)
    seq = _running_seq(sched, 8)
    assert len(seq.block_ids) == 2
    out = sched.schedule()
    assert out.decodes == [seq]
    assert seq.spec_grant == 4
    assert len(seq.block_ids) * 4 >= seq.num_computed_tokens + 1 + 4


def test_grant_clamps_exactly_when_pool_dry():
    """A pool of 3 blocks: the grant finds nothing to append and clamps to
    the table's remaining slots (12 - 8 - 1 = 3), never preempting."""
    sched = _sched(tsched, tcfg, num_blocks=3)
    seq = _running_seq(sched, 8)
    out = sched.schedule()
    assert out.decodes == [seq] and not out.preempted
    assert len(seq.block_ids) == 3
    assert seq.spec_grant == 3


def test_grant_charges_budget_fcfs():
    """Budget 8, two decode rows asking 4 each: after their guaranteed
    tokens, the older gets 4 and the younger the remaining 2."""
    sched = _sched(tsched, tcfg, num_blocks=128, budget=8)
    a = tseq.Sequence("a", [1, 2, 3, 4],
                      SamplingParams(max_tokens=8, ignore_eos=True),
                      arrival_time=1.0)
    b = tseq.Sequence("b", [5, 6, 7, 8],
                      SamplingParams(max_tokens=8, ignore_eos=True),
                      arrival_time=2.0)
    for s in (a, b):
        sched.add(s)
    out = sched.schedule()
    for sp in out.prefills:
        sp.seq.num_computed_tokens = sp.chunk_len
        sp.seq.status = tseq.SequenceStatus.RUNNING
    out = sched.schedule()
    assert sorted(s.request_id for s in out.decodes) == ["a", "b"]
    assert a.spec_grant == 4 and b.spec_grant == 2


def _grant_trace(mod, cfg_mod, seq_mod, num_blocks):
    """Drive one package's unified scheduler with draft grants of varying
    width over staggered arrivals; record each step's chunks, decode rows,
    grants, table lengths and preemptions. Drafts are all rejected: a row
    advances one token a step."""
    sched = _sched(mod, cfg_mod, num_blocks, budget=12, max_seqs=3)
    widths = iter(np.random.default_rng(2).integers(0, 6, 1000).tolist())
    sched.spec_grant_fn = lambda seq: next(widths)
    arrivals = [(0, "a", 9, 12), (0, "b", 5, 9), (2, "c", 14, 7),
                (3, "d", 3, 10)]
    trace = []
    for step in range(80):
        while arrivals and arrivals[0][0] <= step:
            _, rid, n, max_tokens = arrivals.pop(0)
            sched.add(seq_mod.Sequence(
                rid, list(range(1, n + 1)),
                seq_mod.SamplingParams(max_tokens=max_tokens),
                arrival_time=float(step) + 0.5))
        out = sched.schedule()
        trace.append((
            [(p.seq.request_id, p.chunk_start, p.chunk_len)
             for p in out.prefills],
            [(s.request_id, s.spec_grant, len(s.block_ids))
             for s in out.decodes],
            [s.request_id for s in out.preempted]))
        for p in out.prefills:
            p.seq.num_computed_tokens = p.chunk_start + p.chunk_len
            if p.seq.prefill_done:
                p.seq.status = seq_mod.SequenceStatus.RUNNING
                if not p.seq.output_token_ids:
                    p.seq.output_token_ids.append(7)
        for s in out.decodes:
            s.num_computed_tokens += 1
            s.output_token_ids.append(7)
            if len(s.output_token_ids) >= s.sampling.max_tokens:
                sched.finish(s, seq_mod.SequenceStatus.FINISHED_LENGTH)
        if not arrivals and not sched.has_work():
            break
    return trace


@pytest.mark.parametrize("num_blocks", [64, 14])
def test_grants_match_reference_scheduler(num_blocks):
    want = _grant_trace(jsched, jcfg, jseq, num_blocks)
    got = _grant_trace(tsched, tcfg, tseq, num_blocks)
    assert got == want
    assert any(g for _, rows, _ in got for _, g, _ in rows)


# ---- the engine --------------------------------------------------------------

GREEDY = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def _confs(spec_k):
    return engine_configs("ragged", max_num_seqs=4, max_num_batched_tokens=32,
                          spec_ngram_k=spec_k)


def _port(weights, spec_k=0):
    return port_engine(weights, _confs(spec_k)[1])


def test_spec_engine_matches_reference(weights):
    """Motif loops, a semi-structured and an irregular prompt, staggered
    behind a chunked one: the same tokens and the same drafted and
    accepted counts as the JAX engine with spec_ngram_k = 4."""
    motif = [31, 32, 33, 34]
    reqs = [("long", list(range(1, 50)), GREEDY),
            ("rep", REPS, GREEDY), ("loop", motif * 4, GREEDY),
            ("semi", SEMI, GREEDY), ("wild", WILD, GREEDY)]
    jconf, tconf = _confs(4)
    jeng = jax_engine(weights, jconf)
    teng = port_engine(weights, tconf)
    want = drain(jeng, reqs, stagger_at=(2, 3, 4, 5))
    got = drain(teng, reqs, stagger_at=(2, 3, 4, 5))
    assert got[0] == want[0]
    assert all(len(t) == GREEDY.max_tokens for t in got[0].values())
    assert (teng.spec_drafted, teng.spec_accepted) == (jeng.spec_drafted,
                                                       jeng.spec_accepted)
    assert teng.spec_accepted > 0
    stats = teng.stats()
    assert stats["spec_decode_acceptance_rate"] == pytest.approx(
        teng.spec_accepted / teng.spec_drafted)
    assert stats["spec_decode_tokens_per_step"] > 1.0


def test_spec_on_equals_spec_off(weights):
    """Staggered arrivals mix chunked prefill, plain decode rows and verify
    spans in one dispatch; every greedy token is the spec-free engine's,
    up to a near-tie there (the off run asks for logprobs to know its
    gaps; spec rows never carry logprobs)."""
    reqs = [("long", list(range(1, 50)), GREEDY), ("rep", REPS, GREEDY),
            ("wild", WILD, GREEDY), ("semi", SEMI, GREEDY)]
    off_reqs = [(r, p, dataclasses.replace(s, logprobs=2))
                for r, p, s in reqs]
    off = drain(_port(weights), off_reqs, stagger_at=(2, 3, 4))
    spec = _port(weights, 4)
    on = drain(spec, reqs, stagger_at=(2, 3, 4))
    assert_same((off[0], {r: [] for r in off[1]}, off[2]), on,
                gaps=top2_gaps(off[1]))
    assert spec.spec_drafted > 0 and spec.spec_accepted > 0


@pytest.mark.parametrize("seed", range(4))
def test_spec_rollback_fuzz_warm_matches_cold(weights, seed):
    """Rounds extend earlier context through prefix-cache hits over blocks
    that held rejected drafts' KV past the accepted prefix: any such slot
    committed to the cache shows up as a warm/cold divergence."""
    rng = np.random.default_rng(1000 + seed)
    spec, base = _port(weights, 4), _port(weights)
    motif = rng.integers(1, 64, 3).tolist()
    prompt = (motif * 3 + rng.integers(1, 64, 2).tolist())[:11]
    for rnd in range(3):
        sp = SamplingParams(temperature=0.0, max_tokens=int(rng.integers(4, 10)),
                            ignore_eos=True)
        out_spec = spec.generate([prompt], sp)["offline-0"]
        assert out_spec == base.generate([prompt], sp)["offline-0"], rnd
        splice = rng.integers(1, 64, int(rng.integers(1, 3))).tolist()
        prompt = prompt + out_spec + splice + motif
    assert spec.spec_drafted > 0
    assert spec.spec_accepted < spec.spec_drafted  # rejections happened


def test_rejected_drafts_not_committed_at_finish(weights):
    spec = _port(weights, 4)
    p = list(REPS)
    out1 = spec.generate([p], dataclasses.replace(GREEDY, max_tokens=5))
    ext = p + out1["offline-0"] + [2, 7, 2, 7]
    sp2 = dataclasses.replace(GREEDY, max_tokens=6)
    warm = spec.generate([ext], sp2)["offline-0"]
    assert spec.scheduler.allocator.prefix_hits > 0
    assert warm == _port(weights).generate([ext], sp2)["offline-0"]


def test_ineligible_rows_never_granted(weights):
    spec = _port(weights, 4)
    base = dataclasses.replace(GREEDY, max_tokens=8)
    reqs = [("s1", REPS, dataclasses.replace(base, temperature=0.8, seed=1)),
            ("p1", REPS, dataclasses.replace(base, presence_penalty=0.5)),
            ("l1", REPS, dataclasses.replace(base, logprobs=2)),
            ("c1", REPS, dataclasses.replace(base, logit_bias={3: 1.0}))]
    drain(spec, reqs)
    assert spec.spec_drafted == 0


def test_server_speculative_flags(weights):
    """--speculative-ngram and its knobs reach the scheduler config; the
    server speculates on a greedy request, and a bucketed engine
    ignores the flag (its steps have no verify span)."""
    from production_stack_tpu_torch.engine.server import (
        EngineServer,
        build_parser,
        config_from_args,
    )

    args = build_parser().parse_args([
        "--model", "tiny-llama", "--device", "cpu", "--block-size", "4",
        "--num-blocks", "256", "--max-num-seqs", "4",
        "--max-num-batched-tokens", "32", "--speculative-ngram", "4",
        "--speculative-ngram-max", "2", "--speculative-ngram-min", "1",
        "--speculative-window", "64"])
    cfg = config_from_args(args)
    s = cfg.scheduler
    assert (s.spec_ngram_k, s.spec_ngram_max, s.spec_ngram_min,
            s.spec_window) == (4, 2, 1, 64)
    server = EngineServer(cfg, engine=port_engine(weights, cfg))
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        status, out = http_json(f"{url}/v1/completions", {
            "prompt": SEMI, "max_tokens": 16, "temperature": 0,
            "ignore_eos": True})
        assert status == 200 and out["usage"]["completion_tokens"] == 16
        stats = server.engine.stats()
        assert stats["spec_decode_num_draft_tokens_total"] > 0
    finally:
        server.shutdown()
    bucketed = dataclasses.replace(cfg, attention_impl="bucketed")
    eng = port_engine(weights, bucketed)
    assert eng.scheduler.spec_grant_fn is None
    eng.generate([SEMI], GREEDY)
    assert eng.spec_drafted == 0


def test_ragged_stream_runs_live_tokens(weights, monkeypatch):
    """A ragged step runs its live tokens rounded up to STREAM_ROUND, not
    the whole budget: a verify step of a few rows is a short forward. The
    tokens are those of the spec-free engine with a budget-wide stream."""
    from production_stack_tpu_torch.engine import model_runner

    seen = []
    make_map = model_runner.ragged_work_map

    def counted_map(cu, ctx, T, *a, **kw):
        seen.append((int(cu[-1]), T))
        return make_map(cu, ctx, T, *a, **kw)

    monkeypatch.setattr(model_runner, "ragged_work_map", counted_map)
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=256, spec_ngram_k=4)
    spec = port_engine(weights, tconf)
    reqs = [("semi", SEMI, GREEDY), ("long", list(range(1, 200)), GREEDY)]
    got = drain(spec, reqs)
    R = model_runner.STREAM_ROUND
    assert all(T == min(256, -(-live // R) * R) for live, T in seen)
    assert any(T < 256 for _, T in seen) and spec.spec_drafted > 0
    _, wide = engine_configs("ragged", max_num_seqs=4,
                             max_num_batched_tokens=256)
    monkeypatch.setattr(model_runner, "STREAM_ROUND", 256)
    assert drain(port_engine(weights, wide), reqs)[0] == got[0]
