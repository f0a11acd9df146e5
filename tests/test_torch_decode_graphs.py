"""The decode step over static inputs, its graph cache and K3's plan ladder
(engine/step_graphs.py, engine/model_runner.py ``decode_multi``,
ops/paged_decode_attention.py ``plan_ladder``), on the CPU.

- The static-buffer step (one staged copy, ``_decode_body``) equals the
  eager step it replaced bit for bit, over every variant of the static
  flags: ``eager_decode_multi`` below is that step as it was, one pageable
  upload an input, kept here as the reference. Outputs, the KV pool and
  the penalty counts after the step are compared with ``torch.equal``.
- Every rung of the ladder covers every context up to it plus
  ``multi_step`` exactly once, and llama-3-8b has at most six rungs.
- The graph key follows the LoRA bank's target set.
- ``DecodeGraphs`` with a capture stand-in (``Replaying``, tests only: a
  "capture" runs the body and a replay runs it again into the outputs the
  capture returned, as a graph refills its static outputs) drives the
  graph path of the runner and the engine on the CPU: tokens and logprobs
  equal the eager engine's bit for bit, chained or not; sleep drops the
  cache and wake captures the held keys again; the kernel launch counters
  take back what a capture recorded and add it at each replay.
- The compile tracker reports one event a new key, and warmup registers
  every key without an adapter at every rung.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import drain, engine_configs, port_engine, tiny_weights
from production_stack_tpu_torch.engine import model_runner
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.sampling import (
    SamplingParams,
    apply_token_controls,
    compute_logprobs,
    penalize_logits,
    sample_tokens,
)
from production_stack_tpu_torch.engine.step_graphs import DecodeGraphs
from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops import kv_write as k1
from production_stack_tpu_torch.ops import paged_decode_attention as k3

torch.set_num_threads(2)

S, K = 4, 3


def eager_decode_multi(r, tokens, positions, block_tables, context_lens,
                       slot_mapping, temps, top_ps, top_ks, seeds, steps,
                       greedy_only=False, presence=None, frequency=None,
                       ctrl=None, want_logprobs=False, adapter_ids=None,
                       g_ids=None, g_states=None):
    """The runner's decode step before static inputs: each input uploaded
    on its own, then ``multi_step`` iterations (the reference of the
    static-buffer body; the CPU takes no split plan)."""
    bs = r.config.cache.block_size
    steps_k = max(r.config.scheduler.multi_step, 1)
    bt, ctx = r._dev(block_tables), r._dev(context_lens)
    active = ctx > 0
    tok, pos, slots = r._dev(tokens), r._dev(positions), r._dev(slot_mapping)
    samp = [r._dev(temps, torch.float32), r._dev(top_ps, torch.float32),
            r._dev(top_ks, torch.int64), r._dev(np.asarray(seeds, np.int64)),
            r._dev(steps, torch.int64)]
    lora = r._lora(adapter_ids)
    grammar = r._grammar(g_ids, g_states)
    rows = torch.arange(len(tokens))
    outs = []
    for _ in range(steps_k):
        meta = {"block_tables": bt, "context_lens": ctx,
                "slot_mapping": slots, "plan": None}
        hidden = r._forward(r._attend_decode, tok, pos, meta, lora)
        logits = r.model.logits_from_hidden(r.cfg, r.params, hidden)
        raw = logits
        if presence is not None:
            logits = penalize_logits(logits, r.token_counts,
                                     r._dev(presence, torch.float32),
                                     r._dev(frequency, torch.float32))
        if ctrl is not None:
            logits = apply_token_controls(logits, r._dev(ctrl[0]),
                                          r._dev(ctrl[1]), r._dev(ctrl[2]))
        row_t = None
        if grammar is not None:
            logits, row_t = model_runner.grammar_mask(
                logits, r.grammar_bank, r.grammar_accept, *grammar, r.eos_id)
        if greedy_only:
            sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            sampled = sample_tokens(logits, *samp)
        step_out = [sampled]
        if want_logprobs:
            step_out += compute_logprobs(raw, sampled)
        outs.append(step_out)
        if grammar is not None:
            nxt = row_t.gather(1, sampled.long()[:, None])[:, 0].long()
            grammar[1] = torch.where((grammar[0] >= 0) & active, nxt,
                                     grammar[1])
        new_pos = torch.where(active, pos + 1, pos)
        ctx = torch.where(active, ctx + 1, ctx)
        block = bt[rows, torch.clamp(new_pos, min=0) // bs]
        valid = active & (new_pos < r.cfg.max_model_len)
        slots = torch.where(valid, block * bs + new_pos % bs,
                            torch.full_like(new_pos, -1)).to(torch.int32)
        pos = new_pos
        tok = torch.where(active, sampled, tok)
        samp[4] = samp[4] + 1
        if presence is not None:
            r.token_counts.index_put_((rows, sampled.long()),
                                      active.to(torch.int32), accumulate=True)
    stacked = [torch.stack(col).numpy() for col in zip(*outs)]
    return tuple(stacked) if want_logprobs else stacked[0]


def _runner(multi_step=K, **sched):
    cfg = EngineConfig.for_model(
        "tiny-llama", cache=CacheConfig(block_size=4, num_blocks=64),
        scheduler=SchedulerConfig(max_num_seqs=S, max_num_batched_tokens=32,
                                  multi_step=multi_step, **sched))
    return model_runner.ModelRunner(cfg, device="cpu")


def _adapter(r, rng, targets, rank=4):
    """Random (A, B) pairs for ``targets``, as ``load_adapter_raw`` gives."""
    from production_stack_tpu_torch.engine.lora import target_shapes

    L = r.cfg.num_layers
    return {t: (rng.normal(0, 0.2, (L, i, rank)).astype(np.float32),
                rng.normal(0, 0.2, (L, rank, *o)).astype(np.float32))
            for t, (i, o) in target_shapes(r.cfg).items() if t in targets}


@pytest.fixture(scope="module")
def state():
    """A runner whose pool holds random K/V, a LoRA adapter in slot 1 and
    a random grammar in slot 0; one step's inputs for S rows (three live
    at contexts 9, 14 and 3, one inactive)."""
    rng = np.random.default_rng(0)
    r = _runner()
    r.kv.copy_(torch.from_numpy(rng.normal(size=r.kv.shape).astype(
        np.float32)))
    r.register_lora(1, _adapter(r, rng, ("wq", "wo", "w_up")))
    V = r.cfg.vocab_size
    r.register_grammar(0, SimpleNamespace(
        n_states=3, trans=rng.integers(-1, 3, (3, V)),
        accept=np.array([False, True, False])))
    M = r.max_blocks_per_seq
    ctx = np.array([9, 14, 0, 3], np.int32)
    tables = np.zeros((S, M), np.int32)
    for i in range(S):
        tables[i, :8] = np.arange(8) + 8 * i
    pos = np.maximum(ctx - 1, 0).astype(np.int32)
    slots = np.where(ctx > 0, tables[np.arange(S), pos // 4] * 4 + pos % 4,
                     -1).astype(np.int32)
    c_ids = np.full((S, 64), -1, np.int32)
    c_vals = np.zeros((S, 64), np.float32)
    c_ids[0, :3], c_vals[0, :3] = [5, 9, 11], [3.0, -2.0, 1.5]
    c_ids[1, :4] = [1, 2, 3, 4]
    inputs = dict(
        tokens=rng.integers(0, V, S).astype(np.int32), positions=pos,
        block_tables=tables, context_lens=ctx, slot_mapping=slots,
        temps=np.array([0.0, 0.8, 1.0, 1.3], np.float32),
        top_ps=np.array([1.0, 0.9, 0.5, 1.0], np.float32),
        top_ks=np.array([-1, 30, 5, -1], np.int32),
        seeds=np.array([7, 8, 9, 4000000000], np.uint32),
        steps=np.array([1, 4, 0, 2], np.int32))
    extra = dict(
        presence=np.array([0.5, 0.0, 1.0, 0.2], np.float32),
        frequency=np.array([0.1, 0.3, 0.0, 0.7], np.float32),
        ctrl=(c_ids, c_vals, np.array([1, 2, 0, 0], np.int32)),
        adapter_ids=np.array([1, 0, 0, 1], np.int32),
        g_ids=np.array([0, -1, -1, 0], np.int32),
        g_states=np.array([0, 0, 0, 2], np.int32))
    counts = torch.from_numpy(rng.integers(0, 3, (S, V)).astype(np.int32))
    return r, inputs, extra, counts


FLAGS = ("greedy", "penalties", "controls", "lora", "grammar", "logprobs")


def _kwargs(flags, extra):
    on = dict(zip(FLAGS, flags))
    kw = {"greedy_only": on["greedy"], "want_logprobs": on["logprobs"]}
    if on["penalties"]:
        kw.update(presence=extra["presence"], frequency=extra["frequency"])
    if on["controls"]:
        kw["ctrl"] = extra["ctrl"]
    if on["lora"]:
        kw["adapter_ids"] = extra["adapter_ids"]
    if on["grammar"]:
        kw.update(g_ids=extra["g_ids"], g_states=extra["g_states"])
    return kw


def _run(r, fn, inputs, kw, kv0, counts):
    r.kv.copy_(kv0)
    r.token_counts = counts.clone()
    out = fn(**inputs, **kw)
    return (out if isinstance(out, tuple) else (out,)), r.kv.clone(), \
        r.token_counts.clone()


@pytest.mark.parametrize("flags", list(itertools.product((False, True),
                                                         repeat=6)),
                         ids=lambda f: "".join("x" if v else "-" for v in f))
def test_static_body_equals_the_eager_step(state, flags):
    r, inputs, extra, counts = state
    kw = _kwargs(flags, extra)
    kv0 = r.kv.clone()
    want = _run(r, lambda **a: eager_decode_multi(r, **a), inputs, kw, kv0,
                counts)
    got = _run(r, r.decode_multi, inputs, kw, kv0, counts)
    r.kv.copy_(kv0)
    assert len(want[0]) == len(got[0]) == (4 if flags[-1] else 1)
    for a, b in zip(want[0], got[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert torch.equal(want[1], got[1])  # the KV the step wrote
    assert torch.equal(want[2], got[2])  # the penalty counts


@pytest.mark.parametrize("model,steps", [("llama-3-8b", 1), ("llama-3-8b", 4),
                                         ("tiny-llama", 1), ("tiny-llama", 3)])
def test_every_rung_covers_its_contexts_once(model, steps):
    cfg = ModelConfig.from_pretrained(model)
    rungs = k3.plan_ladder(cfg.max_model_len + steps - 1)
    assert rungs == sorted(set(rungs)) and rungs[0] == k3.LADDER_BASE
    if model == "llama-3-8b" and steps == 1:
        assert rungs == [256, 512, 1024, 2048, 4096, 8192]
    assert len(rungs) <= (cfg.max_model_len // k3.LADDER_BASE).bit_length() + 1
    plans = {}
    for rung in rungs:
        for rows in (64, 4):
            n, span = k3.split_plan(rung, rows, cfg.num_kv_heads)
            # splits [i * span, (i + 1) * span) cover [0, n * span) once,
            # reach past the rung, and none is empty
            assert n * span >= rung > (n - 1) * span
            assert span % k3.SPAN_GRANULE == 0
            plans[rung, rows] = (n, span)
    # a step at context c (c <= max_model_len at dispatch) attends up to
    # c + steps - 1 positions at its last iteration
    for ctx in range(0, cfg.max_model_len + 1):
        need = ctx + steps - 1
        rung = k3.ladder_rung(rungs, need)
        assert rung >= need
        assert rung == rungs[0] or need > rungs[rungs.index(rung) - 1]
    with pytest.raises(ValueError):
        k3.ladder_rung(rungs, rungs[-1] + 1)


def test_runner_key_takes_the_ladder_rung():
    r = _runner()
    assert r.decode_rungs == [256, 512, 576]  # 512 + 3 - 1 rounds to 576
    for top, want in ((0, 256), (254, 256), (255, 512), (510, 512),
                      (511, 576), (512, 576)):
        key = r.decode_key(np.array([3, top, 0, 1]))
        assert key.rung == want and key.steps == K


def test_graph_key_follows_the_lora_bank_targets():
    rng = np.random.default_rng(1)
    r = _runner()
    ctx = np.array([5, 0, 0, 0])
    plain = r.decode_key(ctx)
    r.register_lora(1, _adapter(r, rng, ("wq",)))
    one = r.decode_key(ctx, lora=True)
    assert one.lora == ("wq",) and one != plain
    r.register_lora(2, _adapter(r, rng, ("wq",)))
    assert r.decode_key(ctx, lora=True) == one  # no new target
    r.register_lora(3, _adapter(r, rng, ("wv", "wq")))
    grown = r.decode_key(ctx, lora=True)
    assert grown.lora == ("wq", "wv") and grown != one
    assert r.decode_key(ctx) == plain


class Replaying:
    """A CPU stand-in for CUDA's capture (tests only): the capture runs the
    warm-up and the recorded body once each, and a replay runs the body
    again and copies what it returns into the outputs of the capture."""

    def __init__(self):
        self.captured = 0

    def __call__(self, warm, record):
        warm()
        outputs = record()
        self.captured += 1

        class Graph:
            replays = 0

            def replay(self):
                Graph.replays += 1
                for o, n in zip(outputs, warm()):
                    o.copy_(n)

        return Graph(), outputs


def _graphed(eng, stand_in=None):
    eng.runner.graphs = DecodeGraphs(capture=stand_in or Replaying())
    return eng


MIXED = [
    SamplingParams(temperature=0.0, max_tokens=11, ignore_eos=True),
    SamplingParams(temperature=0.8, top_k=30, seed=7, max_tokens=9,
                   ignore_eos=True, presence_penalty=0.5),
    SamplingParams(temperature=0.7, seed=3, max_tokens=7, ignore_eos=True,
                   logit_bias={3: 2.0, 7: -1.0}),
    SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True,
                   logprobs=2),
    SamplingParams(temperature=0.0, max_tokens=8, guided_regex="[a-z]{3,9}"),
]


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
@pytest.mark.parametrize("chain", [False, True])
def test_graphed_engine_equals_eager(weights, impl, chain):
    rng = np.random.default_rng(5)
    reqs = [(f"r{i}", rng.integers(1, 500, n).tolist(), sp)
            for i, (n, sp) in enumerate(zip((5, 17, 9, 30, 3), MIXED))]
    _, conf = engine_configs(impl, max_num_seqs=4, max_num_batched_tokens=32,
                             prefill_buckets=(16, 32), multi_step=2,
                             chain_decode=chain)
    want = drain(port_engine(weights, conf), reqs, stagger_at=(1, 2, 3, 6))
    stand_in = Replaying()
    eng = _graphed(port_engine(weights, conf), stand_in)
    got = drain(eng, reqs, stagger_at=(1, 2, 3, 6))
    assert got == want
    graphs = eng.runner.graphs
    assert stand_in.captured == graphs.captures == len(graphs) > 1
    assert {k.steps for k in graphs.entries} == {2}


def test_sleep_drops_the_graphs_and_wake_captures_them_again():
    from production_stack_tpu_torch.engine.engine import LLMEngine

    _, conf = engine_configs("ragged", max_num_seqs=4,
                             max_num_batched_tokens=32, multi_step=2)
    # seeded weights, which level 2's wake makes again
    eng = _graphed(LLMEngine(conf, device="cpu"))
    sp = SamplingParams(temperature=0.0, max_tokens=5, ignore_eos=True)
    before = drain(eng, [("a", [1, 2, 3], sp), ("b", [4, 5], sp)])
    graphs = eng.runner.graphs
    held = set(graphs.entries)
    assert held and graphs.captures == len(held)
    for level in (1, 2):
        eng.sleep_mode(level)
        assert len(graphs) == 0 and eng.runner._graphed_kv is None
        assert set(eng.runner._held_keys) == held
        eng.wake_mode()
        assert set(graphs.entries) == held and not eng.runner._held_keys
        assert eng.runner._graphed_kv is eng.runner.kv
    assert graphs.captures == 3 * len(held)
    assert drain(eng, [("a", [1, 2, 3], sp), ("b", [4, 5], sp)]) == before
    assert graphs.captures == 3 * len(held)  # live traffic captured nothing


def test_launch_counts_move_by_a_graphs_launches_each_replay():
    def body():
        k1.LAUNCHES.n += 2  # as two wrapper calls would while captured
        k3.LAUNCHES.n += 1
        return [torch.zeros(1)]

    class Graph:
        def replay(self):
            pass

    def stand_in(warm, record):
        warm()  # a real eager run: its launches stay counted
        return Graph(), record()

    graphs = DecodeGraphs(capture=stand_in)
    base = _build.launch_counts()
    entry = graphs.capture("key", body)
    assert entry.launches == {k1.LAUNCHES: 2, k3.LAUNCHES: 1}
    assert k1.LAUNCHES.n == base[k1.LAUNCHES] + 2  # the warm-up's
    assert k3.LAUNCHES.n == base[k3.LAUNCHES] + 1
    for _ in range(3):
        entry.replay()
    assert k1.LAUNCHES.n == base[k1.LAUNCHES] + 2 + 3 * 2
    assert k3.LAUNCHES.n == base[k3.LAUNCHES] + 1 + 3 * 1
    assert all(c.n == n for c, n in base.items()
               if c not in (k1.LAUNCHES, k3.LAUNCHES))
    assert graphs.drop_all() == ["key"] and len(graphs) == 0


@pytest.mark.parametrize("graphed", [False, True])
def test_one_compile_event_a_new_key(graphed):
    events = []
    r = _runner(multi_step=1)
    if graphed:
        r.graphs = DecodeGraphs(capture=Replaying())
    r.install_compile_observer(lambda *e: events.append(e))
    rng = np.random.default_rng(2)
    M = r.max_blocks_per_seq

    def step(ctx, **kw):
        ctx = np.asarray(ctx, np.int32)
        pos = np.maximum(ctx - 1, 0).astype(np.int32)
        tables = np.arange(S * M, dtype=np.int32).reshape(S, M) % 64
        r.decode_multi(
            rng.integers(0, 500, S).astype(np.int32), pos, tables, ctx,
            np.where(ctx > 0, pos, -1).astype(np.int32),
            np.zeros(S, np.float32), np.ones(S, np.float32),
            np.full(S, -1, np.int32), np.zeros(S, np.uint32),
            np.zeros(S, np.int32), **kw)

    step([3, 0, 0, 0], greedy_only=True)
    step([9, 4, 0, 0], greedy_only=True)  # same key
    step([300, 4, 0, 0], greedy_only=True)  # the next rung
    step([9, 4, 0, 0])  # sampled
    step([9, 4, 0, 0], want_logprobs=True)
    step([9, 4, 0, 0], want_logprobs=True)
    assert [e[1] for e in events] == ["4@256", "4@512", "4@256", "4@256"]
    assert all(e[0] == "decode_multi" for e in events)
    if graphed:
        assert r.graphs.captures == len(events) == len(r.graphs)
    n = r.warm_decode_graphs()
    assert n == 32 * len(r.decode_rungs)
    assert len(events) == n  # warmup registered the rest, and only those
    step([9, 4, 0, 0], presence=np.zeros(S, np.float32),
         frequency=np.zeros(S, np.float32))
    assert len(events) == n


def test_warmup_leaves_no_decode_key_for_live_traffic(weights):
    """After warmup every decode key without an adapter is registered: the
    accountant, steady, sees no compile on a wave of every flag."""
    _, conf = engine_configs("ragged", max_num_seqs=4,
                             max_num_batched_tokens=64, multi_step=2)
    eng = _graphed(port_engine(weights, conf))
    eng.warmup()
    rungs = eng.runner.decode_rungs
    assert len(eng.runner.graphs) == 32 * len(rungs)
    rng = np.random.default_rng(6)
    reqs = [(f"w{i}", rng.integers(1, 500, int(rng.integers(2, 300))
                                   ).tolist(), sp)
            for i, sp in enumerate(MIXED)]
    drain(eng, reqs, stagger_at=(1, 2, 3, 4))
    perf = eng.perf.stats_fields()
    assert perf["unexpected_recompiles"] == 0
    assert eng.runner.graphs.captures == 32 * len(rungs)


def test_config_only_yaml_keys(tmp_path):
    """``chain_decode`` and ``decode_graphs`` come from a --config file
    alone: the command line has no flag for either."""
    pytest.importorskip("yaml")
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        config_from_args,
    )
    from production_stack_tpu_torch.yaml_args import parse_with_yaml_config

    sched = config_from_args(build_parser().parse_args(
        ["--model", "tiny-llama"])).scheduler
    assert (sched.chain_decode, sched.decode_graphs) == (False, True)
    path = tmp_path / "engine.yaml"
    path.write_text("model: tiny-llama\nchain_decode: true\n"
                    "decode_graphs: false\nmax_num_seqs: 8\n")
    sched = config_from_args(parse_with_yaml_config(
        build_parser(), ["--config", str(path)])).scheduler
    assert (sched.chain_decode, sched.decode_graphs,
            sched.max_num_seqs) == (True, False, 8)
    for flag in ("--chain-decode", "--decode-graphs", "--no-decode-graphs"):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["--model", "tiny-llama", flag])
    path.write_text("chain_decode: 1\n")
    with pytest.raises(SystemExit):
        parse_with_yaml_config(build_parser(), ["--config", str(path)])
