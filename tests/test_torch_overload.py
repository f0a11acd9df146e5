"""The port's overload plane against the JAX package's, unit by unit, on
the CPU.

- ``BrownoutController``: the same random signal sequences on a virtual
  clock give the same stage, snapshot and stage actions after every
  evaluation; ``overweight_tenants`` gives the same shed set on random
  loads and weights.
- ``FaultSpec.parse`` accepts and refuses the same specs, with the same
  message; ``inject_faults`` draws the same verdicts from a seeded spec as
  the reference's aiohttp middleware (error, drop, stream abort, pass).
- The schedulers: on one multi-tenant arrival trace with fair share on,
  the same admission order, the same ``ScheduledPrefill`` lists a step,
  the same DRR deficits and stride passes, and the same
  ``retry_after_hint`` at an injected ``now``; with one tenant, fair share
  on gives exactly the schedule with it off; the stage-1 spec shed zeroes
  the same grants.
- The accountants: the same ``record_*`` calls with ``tenants=`` give the
  same ``tenant_fields()`` (floats within 1e-12), including the fold past
  the cap and the idle expiry.
"""

import asyncio
import time

import numpy as np
import pytest

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import overload as jover
from production_stack_tpu.engine import perf_accounting as jperf
from production_stack_tpu.engine import scheduler as jsched
from production_stack_tpu.engine import sequence as jseq
from production_stack_tpu.testing import faults as jfaults
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import overload as tover
from production_stack_tpu_torch.engine import perf_accounting as tperf
from production_stack_tpu_torch.engine import scheduler as tsched
from production_stack_tpu_torch.engine import sequence as tseq
from production_stack_tpu_torch.testing import faults as tfaults


def _close(a, b, path="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=1e-12, abs=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---- the brownout controller -------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_brownout_controller_matches_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(enabled=True, queue_high=float(rng.uniform(0.2, 0.8)),
              hbm_high=float(rng.uniform(0.5, 0.95)),
              up_evals=int(rng.integers(1, 4)),
              calm_evals=int(rng.integers(1, 5)),
              max_stage=int(rng.integers(1, 4)),
              max_tokens_clamp=int(rng.integers(8, 300)))
    ref = jover.BrownoutController(jover.BrownoutConfig(**kw))
    mine = tover.BrownoutController(tover.BrownoutConfig(**kw))
    now = 1000.0
    stages = set()
    # bursts of pressure then calm, so the ladder goes up and comes down
    hot_phase = rng.random(400) < np.repeat(rng.random(20), 20)
    for hot in hot_phase:
        now += float(rng.uniform(0.1, 3.0))
        sig = dict(queue_fraction=float(rng.uniform(0.6, 1.5) if hot
                                        else rng.uniform(0, 0.2)),
                   hbm_fraction=float(rng.uniform(0, 1.0)),
                   watchdog_stalled=bool(hot and rng.random() < 0.1),
                   burn_page=bool(rng.random() < 0.02))
        a = ref.evaluate(jover.PressureSignals(**sig), now)
        b = mine.evaluate(tover.PressureSignals(**sig), now)
        assert a == b
        if rng.random() < 0.3:
            reason = str(rng.choice([jover.SHED_SPEC, jover.SHED_TENANT,
                                     jover.SHED_MAX_TOKENS]))
            ref.record_shed(reason, 2)
            mine.record_shed(reason, 2)
        _close(ref.snapshot(), mine.snapshot())
        stages.add(b)
    assert len(stages) >= 2 and mine.transitions == ref.transitions >= 2


def test_brownout_disabled_stays_at_zero():
    mine = tover.BrownoutController()
    ref = jover.BrownoutController()
    hot = dict(queue_fraction=5.0, watchdog_stalled=True)
    for i in range(10):
        assert mine.evaluate(tover.PressureSignals(**hot), i) == 0
        assert ref.evaluate(jover.PressureSignals(**hot), i) == 0
    _close(ref.snapshot(), mine.snapshot())
    assert (tover.SHED_SPEC, tover.SHED_MAX_TOKENS, tover.SHED_PREFETCH,
            tover.SHED_TENANT, tover.MAX_STAGE) == (
        jover.SHED_SPEC, jover.SHED_MAX_TOKENS, jover.SHED_PREFETCH,
        jover.SHED_TENANT, jover.MAX_STAGE)


@pytest.mark.parametrize("seed", range(8))
def test_overweight_tenants_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(50):
        n = int(rng.integers(0, 7))
        loads = {f"t{i}": float(rng.choice([0.0, rng.uniform(0, 20)]))
                 for i in range(n)}
        weights = ({f"t{i}": float(rng.uniform(-0.5, 4))
                    for i in range(n) if rng.random() < 0.7}
                   if rng.random() < 0.7 else None)
        slack = float(rng.uniform(1.0, 2.0))
        assert (tover.overweight_tenants(loads, weights, slack)
                == jover.overweight_tenants(loads, weights, slack))


# ---- fault specs and the roll order ------------------------------------------

SPECS = [
    "", "error_rate=0.3,latency_ms=250,drop_rate=0.05,stall_ms=500,seed=7",
    "stream_abort_rate=0.1,stream_abort_after_ms=20,hang_after_ms=5",
    "logit_noise_scale=0.5,wrong_token_at_step=3", " error_rate = 1 ,",
    "bogus=1", "error_rate=1.5", "drop_rate=-0.1", "error_rate=0.6,drop_rate=0.5",
    "stream_abort_rate=2", "stall_ms=-1", "logit_noise_scale=-1",
    "wrong_token_at_step=-2", "seed=x", "error_rate=abc",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parse_matches_reference(spec):
    try:
        want = jfaults.FaultSpec.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.FaultSpec.parse(spec)
        assert str(got.value) == str(e)
        return
    got = tfaults.FaultSpec.parse(spec)
    assert vars(got) == vars(want)
    assert got.active == want.active
    ref_state, state = jfaults.FaultState(want), tfaults.FaultState(got)
    assert (state.spec is None) == (ref_state.spec is None)


class _Transport:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


class _Request:
    method = "POST"
    path = "/v1/completions"

    def __init__(self):
        self.transport = _Transport()


class _Conn:
    def __init__(self):
        self.closed = False

    def shutdown(self, how):
        self.closed = True


def _reference_verdicts(spec: str, n: int) -> list:
    from aiohttp import web

    state = jfaults.FaultState(jfaults.FaultSpec.parse(spec))
    mw = jfaults.fault_middleware(state)

    async def handler(request):
        await asyncio.sleep(0.01)  # outlives a 1 ms stream-abort timer
        return "passed"

    async def run():
        out = []
        for _ in range(n):
            req = _Request()
            try:
                resp = await mw(req, handler)
            except web.HTTPInternalServerError:
                out.append(tfaults.DROP)
                continue
            if resp != "passed":
                assert resp.status == 500
                out.append(tfaults.ERROR)
            else:
                out.append("abort" if req.transport.closed else tfaults.PASS)
        return out

    return asyncio.run(run())


def _port_verdicts(spec: str, n: int) -> list:
    state = tfaults.FaultState(tfaults.FaultSpec.parse(spec))
    out = []
    for _ in range(n):
        conn = _Conn()
        verdict, timer = tfaults.inject_faults(state, "POST",
                                               "/v1/completions", conn)
        if timer is not None:
            timer.join(1)
            assert conn.closed
            verdict = "abort"
        out.append(verdict)
    return out


@pytest.mark.parametrize("spec", [
    "error_rate=0.5,seed=7",
    "error_rate=0.3,drop_rate=0.2,stream_abort_rate=0.5,"
    "stream_abort_after_ms=1,seed=11",
    "drop_rate=0.4,stream_abort_rate=0.3,stream_abort_after_ms=1,seed=3",
])
def test_fault_rolls_match_reference_middleware(spec):
    want = _reference_verdicts(spec, 40)
    assert _port_verdicts(spec, 40) == want
    assert len(set(want)) >= 2


def test_faults_touch_only_post_v1():
    state = tfaults.FaultState(tfaults.FaultSpec.parse("error_rate=1"))
    assert tfaults.inject_faults(state, "GET", "/v1/models")[0] == \
        tfaults.PASS
    assert tfaults.inject_faults(state, "POST", "/debug/faults")[0] == \
        tfaults.PASS
    assert tfaults.inject_faults(state, "POST", "/v1/chat/completions")[
        0] == tfaults.ERROR
    assert tfaults.ERROR_BODY == {"error": {"message": "injected fault",
                                            "type": "fault_injection"}}


def test_hang_is_released_by_stop():
    import threading

    state = tfaults.FaultState(tfaults.FaultSpec.parse("hang_after_ms=1"))
    stop = threading.Event()
    got = []
    t = threading.Thread(target=lambda: got.append(tfaults.inject_faults(
        state, "POST", "/v1/completions", None, stop)))
    t.start()
    time.sleep(0.05)
    assert t.is_alive() and state.last_hang_t is not None
    stop.set()
    t.join(5)
    assert got == [(tfaults.DROP, None)]


# ---- the schedulers ----------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


def _sched(mod, cfg_mod, fair, weights=None, budget=24, max_seqs=3,
           num_blocks=64):
    sched = mod.Scheduler(
        cfg_mod.SchedulerConfig(max_num_seqs=max_seqs,
                                max_num_batched_tokens=budget,
                                max_queue_len=64, fair_share=fair,
                                tenant_weights=dict(weights or {})),
        cfg_mod.CacheConfig(block_size=4, num_blocks=num_blocks),
        num_blocks=num_blocks, max_model_len=128)
    sched.unified = True
    return sched


def _arrivals(seed, tenants):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(14, 22))):
        step = int(rng.integers(0, 30))
        t = str(rng.choice(tenants))
        out.append((step, f"r{i}", int(rng.integers(3, 40)),
                    int(rng.integers(2, 9)), t))
    return sorted(out, key=lambda a: (a[0], a[1]))


def _trace(mod, cfg_mod, seq_mod, arrivals, fair, clock, weights=None,
           **kw):
    """Drive one package's unified scheduler over staggered arrivals on
    the virtual ``clock`` (time.monotonic, which stamps admissions);
    record each step's admissions, chunks, decode rows, preemptions,
    deficits, passes, retry hint and per-tenant loads."""
    sched = _sched(mod, cfg_mod, fair, weights, **kw)
    pending = list(arrivals)
    trace = []
    for step in range(300):
        clock.t += 0.25
        while pending and pending[0][0] <= step:
            _, rid, n, max_tokens, tenant = pending.pop(0)
            sched.add(seq_mod.Sequence(
                rid, list(range(1, n + 1)),
                seq_mod.SamplingParams(max_tokens=max_tokens),
                arrival_time=float(step) + 0.5, tenant=tenant))
        before = set(sched.seqs)
        out = sched.schedule()
        snap = sched.fair_share_snapshot()
        trace.append((
            sorted(set(sched.seqs) - before),
            [(p.seq.request_id, p.chunk_start, p.chunk_len)
             for p in out.prefills],
            [(s.request_id, len(s.block_ids)) for s in out.decodes],
            [s.request_id for s in out.preempted],
            snap["deficits"], snap["admit_pass"],
            sched.retry_after_hint(floor=0.5, now=clock.t + 1.0),
            sched.tenant_loads()))
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
        if not pending and not sched.has_work():
            break
    return trace


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


def _run_both(clock, arrivals, fair, weights=None, **kw):
    out = []
    for mod, cfg_mod, seq_mod in ((jsched, jcfg, jseq),
                                  (tsched, tcfg, tseq)):
        clock.t = 5000.0
        out.append(_trace(mod, cfg_mod, seq_mod, arrivals, fair, clock,
                          weights, **kw))
    return out


@pytest.mark.parametrize("seed, weights, budget, max_seqs, num_blocks", [
    (0, None, 24, 3, 64),
    (1, {"heavy": 1, "light": 4}, 24, 3, 64),
    (2, {"heavy": 2, "light": 1, "mid": 3}, 16, 4, 40),
    (3, None, 32, 2, 24),
    (4, {"light": 0.5}, 12, 5, 64),
])
def test_fair_share_schedule_matches_reference(clock, seed,
                                               weights, budget, max_seqs,
                                               num_blocks):
    arrivals = _arrivals(seed, ["heavy", "light", "mid"])
    want, got = _run_both(clock, arrivals, True, weights, budget=budget,
                          max_seqs=max_seqs, num_blocks=num_blocks)
    for i, (a, b) in enumerate(zip(want, got)):
        _close(a, b, f"step {i}")
    assert len(want) == len(got)
    # the trace exercised the fair paths: deficits carried and passes kept
    assert any(step[4] for step in got) and any(step[5] for step in got)


def test_fair_share_differs_from_fcfs_with_two_tenants(clock):
    arrivals = [(0, f"h{i}", 30, 3, "heavy") for i in range(6)] + [
        (1, "l0", 8, 3, "light"), (1, "l1", 8, 3, "light")]
    fair = _run_both(clock, arrivals, True, budget=16, max_seqs=2)[1]
    fcfs = _run_both(clock, arrivals, False, budget=16, max_seqs=2)[1]

    def admitted(trace):
        return [rid for step in trace for rid in step[0]]

    assert admitted(fair).index("l0") < admitted(fcfs).index("l0")


@pytest.mark.parametrize("seed", range(4))
def test_one_tenant_fair_share_is_fcfs_exactly(clock, seed):
    arrivals = _arrivals(50 + seed, ["solo"])
    on = _run_both(clock, arrivals, True, budget=20, max_seqs=3,
                   num_blocks=32)
    off = _run_both(clock, arrivals, False, budget=20, max_seqs=3,
                    num_blocks=32)
    for pkg_on, pkg_off in zip(on, off):
        # everything but the fair-share bookkeeping itself
        assert [s[:4] + s[6:] for s in pkg_on] == \
            [s[:4] + s[6:] for s in pkg_off]
        assert all(not s[4] for s in pkg_on)


def test_retry_after_hint_matches_reference(clock):
    for mod, cfg_mod, seq_mod in ((jsched, jcfg, jseq),
                                  (tsched, tcfg, tseq)):
        clock.t = 100.0
        sched = _sched(mod, cfg_mod, False, max_seqs=2)
        assert sched.retry_after_hint(floor=1.5) == 1.5  # no history
        for i in range(12):
            sched.add(seq_mod.Sequence(f"r{i}", [1, 2, 3],
                                       seq_mod.SamplingParams(max_tokens=2),
                                       arrival_time=float(i)))
        for _ in range(3):
            clock.t += 0.5
            out = sched.schedule()
            for p in out.prefills:
                sched.finish(p.seq, seq_mod.SequenceStatus.FINISHED_LENGTH)
        hints = [sched.retry_after_hint(floor=f, ceiling=c, now=n)
                 for f, c, n in ((0.1, 60.0, 102.0), (1.0, 60.0, 110.0),
                                 (0.1, 2.0, 130.0), (5.0, 60.0, 101.6))]
        rate = sched.admission_drain_rate(now=103.0)
        if mod is jsched:
            want = (hints, rate)
    assert (hints, rate) == want
    assert max(hints) > 0.1


def test_spec_shed_zeroes_grants_like_reference():
    out = []
    for mod, cfg_mod, seq_mod in ((jsched, jcfg, jseq),
                                  (tsched, tcfg, tseq)):
        sched = _sched(mod, cfg_mod, False, budget=16, max_seqs=2)
        sched.spec_grant_fn = lambda seq: 3
        seqs = [seq_mod.Sequence(r, [1, 2, 3, 4],
                                 seq_mod.SamplingParams(max_tokens=20),
                                 arrival_time=float(i))
                for i, r in enumerate("ab")]
        for s in seqs:
            sched.add(s)
        o = sched.schedule()
        for p in o.prefills:
            p.seq.num_computed_tokens = p.chunk_len
            p.seq.status = seq_mod.SequenceStatus.RUNNING
        grants = []
        for shed in (False, True, True, False):
            sched.spec_shed = shed
            o = sched.schedule()
            grants.append([s.spec_grant for s in o.decodes])
            for s in o.decodes:
                s.num_computed_tokens += 1
                s.output_token_ids.append(5)
        out.append((grants, sched.spec_shed_count))
    assert out[0] == out[1]
    assert out[1][0][1] == [0, 0] and out[1][1] == 4


# ---- the accountants ---------------------------------------------------------

def _accountants(**kw):
    args = dict(param_count=1_000_000, param_bytes=2_000_000, window=60.0,
                peak_tflops=100.0, peak_hbm_gbps=1000.0, **kw)
    return (jperf.PerfAccountant(jcfg.ModelConfig.from_pretrained(
                "tiny-llama"), **args),
            tperf.PerfAccountant(tcfg.ModelConfig.from_pretrained(
                "tiny-llama"), **args))


def _tenant_script(acct, rng, clock, n_tenants):
    for i in range(120):
        clock.t += float(rng.uniform(0.01, 200.0))
        names = [f"t{j}" for j in rng.choice(
            n_tenants, size=int(rng.integers(1, 4)), replace=False)]
        tenants = {t: {"prefill": int(rng.integers(0, 50)),
                       "decode": int(rng.integers(0, 5)),
                       "live": int(rng.integers(0, 60))} for t in names}
        kind = i % 4
        secs = float(rng.uniform(0.0001, 0.05))
        if kind == 0:
            acct.record_prefill(100, 300, 2, seconds=secs, tenants=tenants)
        elif kind == 1:
            acct.record_decode(4, 1, 200, seconds=secs, tenants=tenants)
        elif kind == 2:
            acct.record_ragged(30, 90, 2, 3, 120, seconds=secs,
                               tenants=tenants)
            acct.record_spec_accepted(2, tenant=names[0])
        else:
            acct.note_request(names[0], float(rng.uniform(0, 2)))
            acct.attribute_seconds({names[-1]: 3}, secs)


@pytest.mark.parametrize("n_tenants, top_k", [(3, 8), (12, 2), (90, 4)])
def test_tenant_accounting_matches_reference(clock, n_tenants, top_k):
    ref, mine = _accountants(tenant_top_k=top_k)
    for acct in (ref, mine):
        clock.t = 1000.0
        _tenant_script(acct, np.random.default_rng(n_tenants), clock,
                       n_tenants)
    kv = {"t0": 5, "t1": 2, "zz": 1}
    want, got = ref.tenant_fields(kv_blocks=kv), mine.tenant_fields(
        kv_blocks=kv)
    _close(want, got)
    rows = got["tenants"]
    assert len(rows) <= top_k + 2
    # conservation: the rows' chip-seconds sum to the attributed total
    assert sum(r["chip_seconds"] for r in rows.values()) == pytest.approx(
        got["dispatch_seconds_total"], rel=1e-12)
    assert mine.expire_idle_tenants(clock.t + 1e9) == \
        ref.expire_idle_tenants(clock.t + 1e9)
    _close(ref.tenant_fields(), mine.tenant_fields())


def test_metering_off_attributes_nothing(clock):
    ref, mine = _accountants(tenant_metering=False)
    for acct in (ref, mine):
        _tenant_script(acct, np.random.default_rng(0), clock, 3)
    _close(ref.tenant_fields(), mine.tenant_fields())
    assert mine.tenant_fields()["tenants"] == {}
    assert mine.tenant_fields()["enabled"] is False
