"""The port's perf accountant against the JAX package's, on the CPU.

- One scripted sequence of ``record_*`` calls (fixed timestamps, explicit
  peaks, a drift band that opens episodes) goes into both accountants:
  ``stats_fields()`` and ``snapshot()`` agree on every shared key within a
  relative 1e-12.
- One sequence of signatures goes into both ``CompileTracker``s: the same
  compile events, and the same unexpected count after ``mark_steady``.
- Both engines serving the same prompts, on either attention path, count
  the same parameters and the same FLOPs, HBM bytes, prefill and decode
  tokens and dispatches.
- The port's tracker sees one ragged signature per stream length the card
  runs (``STREAM_ROUND`` multiples), not one for the budget-wide arrays;
  after ``warmup()`` traffic of random lengths raises no unexpected
  compile, on either path.
"""

import time

import numpy as np
import pytest
import torch

from _torch_parity import drain, engine_configs, jax_engine, port_engine, \
    tiny_weights
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import perf_accounting as jperf
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import perf_accounting as tperf
from production_stack_tpu_torch.engine.model_runner import STREAM_ROUND
from production_stack_tpu_torch.engine.sampling import SamplingParams

torch.set_num_threads(2)

T0 = 1000.0
PEAKS = dict(peak_tflops=100.0, peak_hbm_gbps=1000.0, peak_ici_gbps=50.0)


def _accountants():
    kw = dict(param_count=123_456_789, param_bytes=246_913_578, window=60.0,
              **PEAKS)
    ref = jperf.PerfAccountant(jcfg.ModelConfig.from_pretrained("tiny-llama"),
                               **kw)
    port = tperf.PerfAccountant(
        tcfg.ModelConfig.from_pretrained("tiny-llama"), **kw)
    for a in (ref, port):
        a.costmodel_drift_band = 2.0
    return ref, port


def _script(acct):
    """Dispatches of every kind, compile events before and after warmup,
    then a steady window whose measured seconds jump past the band."""
    acct.on_compile("ragged", "64", 0.5)
    acct.on_compile("decode_multi", "4", 0.25)
    acct.record_prefill(300, 900, 3, ts=T0 + 1, seconds=0.02)
    acct.record_decode(4, 2, 700, ts=T0 + 2, seconds=0.01)
    acct.record_ragged(100, 400, 2, 3, 450, ts=T0 + 3, spec_tokens=6,
                       spec_ctx=200, spec_rows=2, seconds=0.03)
    acct.record_spec_accepted(4, ts=T0 + 3.5)
    acct.mark_steady()
    for i in range(12):
        slow = 1.0 if i < 8 else 9.0  # past the band after the baseline
        acct.record_ragged(50 + i, 500 + i, 2, 4, 800 + i, ts=T0 + 10 + i,
                           seconds=0.002 * slow)
        acct.record_decode(4, 1, 900 + i, ts=T0 + 10.5 + i,
                           seconds=0.001 * slow)
    acct.record_ragged(0, 0, 0, 0, 0, ts=T0 + 30)  # nothing to record
    acct.on_compile("prefill", "2x128", 0.125)  # after warmup
    acct.record_spec_accepted(2, ts=T0 + 31)


def _assert_close(a, b, path=""):
    if isinstance(a, dict):
        for k in set(a) & set(b):
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        assert b == pytest.approx(a, rel=1e-12, abs=0.0), path
    else:
        assert a == b, path


def test_scripted_records_match_reference(monkeypatch):
    ref, port = _accountants()
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    for acct in (ref, port):
        _script(acct)
    monkeypatch.setattr(time, "monotonic", lambda: T0 + 40.0)
    want, got = ref.stats_fields(), port.stats_fields()
    assert set(got) == set(want)
    _assert_close(want, got)
    assert got["costmodel"]["episodes"] >= 1
    assert got["unexpected_recompiles"] == 1
    assert got["mfu"] > 0 and got["hbm_bw_util"] > 0
    want, got = ref.snapshot(), port.snapshot()
    assert set(got) == set(want)
    _assert_close(want, got)
    assert got["totals"]["dispatches"] == want["totals"]["dispatches"] > 0


def test_window_trims_like_reference(monkeypatch):
    ref, port = _accountants()
    for acct in (ref, port):
        _script(acct)
    # past the window: only the last events remain
    monkeypatch.setattr(time, "monotonic", lambda: T0 + 85.0)
    _assert_close(ref.stats_fields(), port.stats_fields())
    assert port.stats_fields()["decode_tps"] > 0


def test_compile_trackers_match_reference():
    ref, port = _accountants()
    events = {"ref": [], "port": []}

    def observer(side, acct):
        def note(kind, bucket, seconds):
            events[side].append((kind, bucket))
            acct.on_compile(kind, bucket, 0.0)
        return note

    jt = jperf.CompileTracker("prefill", lambda *a, **k: None,
                              observer("ref", ref))
    tt = tperf.CompileTracker("prefill", lambda *a, **k: None,
                              observer("port", port))
    rng = np.random.default_rng(0)
    calls = []
    for i in range(40):
        P, S = int(rng.choice([1, 2, 4])), int(rng.choice([8, 16, 32]))
        args = (np.zeros((P, S), np.int32), np.zeros((P, S), np.int32),
                np.zeros((P, 8), np.int32), np.zeros(P, np.int32))
        kw = {"greedy_only": bool(rng.integers(2)),
              "ctrl": None if rng.integers(2) else (np.zeros((P, 4)),),
              "mode": "x" if rng.integers(2) else 3}
        calls.append((args, kw))
    for i, (args, kw) in enumerate(calls):
        if i == 20:
            ref.mark_steady()
            port.mark_steady()
        jt(*args, **kw)
        tt(*args, **kw)
    assert events["port"] == events["ref"] and len(events["ref"]) > 4
    assert (port.stats_fields()["unexpected_recompiles"]
            == ref.stats_fields()["unexpected_recompiles"])


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


PROMPTS = [("a", list(range(1, 40))), ("b", [5, 9, 13, 2, 6]),
           ("c", list(range(100, 170))), ("d", [7] * 11)]


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_engine_totals_match_reference(weights, impl):
    jconf, tconf = engine_configs(impl, max_num_seqs=4,
                                  max_num_batched_tokens=64,
                                  prefill_buckets=(16, 32, 64), multi_step=2)
    jeng = jax_engine(weights, jconf)
    teng = port_engine(weights, tconf)
    sp = SamplingParams(temperature=0.0, max_tokens=9, ignore_eos=True)
    reqs = [(rid, p, sp) for rid, p in PROMPTS]
    want = drain(jeng, reqs, stagger_at=(1, 2, 4))
    got = drain(teng, reqs, stagger_at=(1, 2, 4))
    assert got[0] == want[0]
    assert teng.perf.param_count == jeng.perf.param_count
    assert teng.perf.param_bytes == jeng.perf.param_bytes
    jt, tt = jeng.perf.snapshot()["totals"], teng.perf.snapshot()["totals"]
    for key in ("flops", "hbm_bytes", "prefill_tokens", "decode_tokens",
                "dispatches"):
        assert tt[key] == pytest.approx(jt[key], rel=1e-12), key
    assert tt["dispatches"] > 0 and tt["decode_tokens"] > 0


def _ragged_keys(eng):
    return sorted(int(b) for (k, b) in
                  eng.perf.stats_fields()["compile_counts"] if k == "ragged")


def test_one_ragged_signature_per_stream_length(weights):
    _, tconf = engine_configs("ragged", max_num_seqs=4,
                              max_num_batched_tokens=256)
    eng = port_engine(weights, tconf)
    assert eng.runner.ragged_lengths() == [64, 128, 192, 256]
    sp = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True)
    rng = np.random.default_rng(1)
    for n in (10, 70, 20, 130, 64, 200):  # no prefix shared across them
        drain(eng, [(f"r{n}", rng.integers(1, 500, n).tolist(), sp)])
    # 10, 20 and 64 live tokens run at 64; one signature each length
    assert _ragged_keys(eng) == [64, 128, 192, 256]
    counts = eng.perf.stats_fields()["compile_counts"]
    assert all(n == 1 for (k, _), n in counts.items() if k == "ragged")
    # the wrapped step is the runner's own, keyed on what it ran
    assert eng.runner.ragged_step.kind == "ragged"
    assert STREAM_ROUND == 64


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_no_unexpected_compile_after_warmup(weights, impl):
    _, tconf = engine_configs(impl, max_num_seqs=4,
                              max_num_batched_tokens=256,
                              prefill_buckets=(32, 64, 128, 256))
    eng = port_engine(weights, tconf)
    eng.warmup()
    perf = eng.perf.stats_fields()
    warm_events = sum(perf["compile_counts"].values())
    assert perf["unexpected_recompiles"] == 0 and warm_events > 0
    if impl == "ragged":
        assert _ragged_keys(eng) == eng.runner.ragged_lengths()
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(12):
        n = int(rng.integers(1, 300))
        sp = SamplingParams(
            temperature=float(rng.choice([0.0, 0.8])), seed=i,
            max_tokens=int(rng.integers(1, 12)), ignore_eos=True,
            logprobs=int(rng.choice([0, 3])) if rng.integers(2) else None)
        reqs.append((f"t{i}", rng.integers(1, 500, n).tolist(), sp))
    drain(eng, reqs, stagger_at=tuple(range(1, 12)))
    perf = eng.perf.stats_fields()
    assert perf["unexpected_recompiles"] == 0, [
        e for e in eng.perf.snapshot()["compile"]["recent"]
        if e["unexpected"]]
    assert sum(perf["compile_counts"].values()) == warm_events


def test_moe_and_int8_counts():
    """On a MoE model FLOPs count a token's active parameters: everything
    outside the expert stacks plus k/X of them (the reference counts every
    expert, ROADMAP Queue 3). Bytes count each leaf at its element size,
    int8 weights with their float32 scales. A dense model's active count
    is its parameter count."""
    import dataclasses

    from production_stack_tpu_torch.engine.quant import quantize_params
    from production_stack_tpu_torch.engine.weights import init_random

    cfg = tcfg.ModelConfig.from_pretrained("tiny-mixtral")
    params = init_random(cfg)
    count, active, nbytes = tperf.param_counts(params, cfg)
    lay = params["layers"]
    expert = sum(lay[n].numel() for n in ("w_gate", "w_up", "w_down"))
    total = sum(t.numel() for t in tperf._tensors(params))
    assert count == total and nbytes == 4 * total
    assert active == total - expert + expert * 2 // 4
    qcfg = dataclasses.replace(cfg, quant="int8")
    qp = quantize_params(qcfg, params)
    qcount, qactive, qbytes = tperf.param_counts(qp, qcfg)
    assert (qcount, qactive) == (count, active)
    scales = sum(v["s"].numel() for v in [qp["embed"], qp["lm_head"]]
                 + [lay_q for lay_q in qp["layers"].values()
                    if isinstance(lay_q, dict)])
    quantized = sum(v["q"].numel() for v in [qp["embed"], qp["lm_head"]]
                    + [lay_q for lay_q in qp["layers"].values()
                       if isinstance(lay_q, dict)])
    assert qbytes == quantized + 4 * scales + 4 * (total - quantized)
    dense = tcfg.ModelConfig.from_pretrained("tiny-llama")
    c, a, _ = tperf.param_counts(init_random(dense), dense)
    assert c == a

    class Runner:
        pass

    runner = Runner()
    runner.params = params
    acct = tperf.PerfAccountant.from_runner(
        tcfg.EngineConfig(model=cfg), runner)
    assert acct.param_count == count and acct.active_param_count == active
    acct.record_prefill(100, 100, 1, ts=T0)
    flops = acct.snapshot()["totals"]["flops"]
    assert flops == pytest.approx(2.0 * active * 100
                                  + acct._attn_per_tok_ctx * 100 * 100)
