"""The port's bucketed path against the JAX package's, on the CPU.

- The bucketed scheduler (``unified = False``) against the reference
  ``Scheduler``: the same ``(request, chunk_start, chunk_len)`` lists, decode
  rows and preemptions step by step; and ``bucket_for`` against the
  reference's rounding.
- ``LLMEngine(attention_impl="bucketed", device="cpu")`` against the JAX
  ``LLMEngine`` with ``attention_impl="bucketed"`` (its XLA path on the
  CPU, at tensor=1, where the fused KV slab is plain ``[K, V]`` as in the
  port). Both get the same ``params_from_jax`` weights and requests. Greedy
  tokens must be identical, except after an argmax near-tie (a step where
  the JAX run's top-2 logprob gap is under 1e-4, where float rounding may
  pick either token; the comparison stops there). Token logprobs agree
  within 1e-4: both run float32, and the frameworks sum matmuls in
  different orders.
- The port's server with ``--attention-impl bucketed --device cpu``.
"""

import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import scheduler as jsched
from production_stack_tpu.engine import sequence as jseq
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSP
from production_stack_tpu.engine.weights import init_or_load
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import scheduler as tsched
from production_stack_tpu_torch.engine import sequence as tseq
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import (
    EngineServer,
    build_parser,
    config_from_args,
)
from production_stack_tpu_torch.engine.weights import params_from_jax

torch.set_num_threads(2)

LP_TOL = 1e-4
TIE_GAP = 1e-4
BUCKETS = (8, 16, 32)  # prompts longer than 32 tokens are chunked


# ---- scheduler ----------------------------------------------------------------

@pytest.mark.parametrize("buckets", [(128, 256, 512, 1024, 2048, 4096, 8192),
                                     (8, 16, 32), (5, 12, 100)])
@pytest.mark.parametrize("max_model_len", [None, 20, 3000])
def test_bucket_for_matches_reference(buckets, max_model_len):
    mine = tcfg.SchedulerConfig(prefill_buckets=buckets)
    ref = jcfg.SchedulerConfig(prefill_buckets=buckets)
    for n in range(0, 9000, 7):
        assert (mine.bucket_for(n, max_model_len)
                == ref.bucket_for(n, max_model_len)), n


def _schedule_trace(mod, cfg_mod, seq_mod, arrivals, num_blocks, steps=200):
    """Drive one package's bucketed scheduler (``seq_mod`` is its sequence
    module, which also names its SamplingParams) as its engine would (chunks
    advance the computed count; a finished prompt gets its first token and
    decodes one token a step until max_tokens) and record each decision."""
    sched = mod.Scheduler(
        cfg_mod.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=24,
                                prefill_buckets=BUCKETS, prefill_batch=4),
        cfg_mod.CacheConfig(block_size=4, num_blocks=num_blocks),
        num_blocks, max_model_len=128)
    assert sched.unified is False
    Status = seq_mod.SequenceStatus
    pending = list(arrivals)
    trace = []
    for step in range(steps):
        while pending and pending[0][0] <= step:
            _, rid, n, max_tokens = pending.pop(0)
            sp = seq_mod.SamplingParams(temperature=0.0, max_tokens=max_tokens)
            sched.add(seq_mod.Sequence(rid, list(range(1, n + 1)), sp,
                                       arrival_time=float(len(trace)) + 0.5))
        out = sched.schedule()
        trace.append((
            [(p.seq.request_id, p.chunk_start, p.chunk_len)
             for p in out.prefills],
            [s.request_id for s in out.decodes],
            [s.request_id for s in out.preempted],
        ))
        for p in out.prefills:
            seq = p.seq
            seq.num_computed_tokens = p.chunk_start + p.chunk_len
            if seq.prefill_done:
                seq.status = Status.RUNNING
                if not seq.output_token_ids:
                    seq.output_token_ids.append(7)
        for seq in out.decodes:
            seq.num_computed_tokens += 1
            seq.output_token_ids.append(7)
            if len(seq.output_token_ids) >= seq.sampling.max_tokens:
                sched.finish(seq, Status.FINISHED_LENGTH)
        if not pending and not sched.has_work():
            break
    return trace


SCHEDULE_CASES = {
    # staggered arrivals, prompts longer than the largest bucket and than
    # the budget, more chunks than prefill_batch
    "staggered": ([(0, "a", 70, 5), (0, "b", 5, 3), (0, "c", 13, 4),
                   (1, "d", 3, 6), (1, "e", 40, 2), (4, "f", 9, 8),
                   (6, "g", 33, 3), (6, "h", 2, 1)], 64),
    # long decodes in a 12-block pool: decode rows preempt the youngest,
    # which recomputes through prefill chunks on re-admission
    "preempt": ([(0, "a", 5, 20), (0, "b", 13, 20), (1, "c", 3, 20),
                 (2, "d", 9, 20)], 12),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_bucketed_scheduler_matches_reference(case):
    arrivals, num_blocks = SCHEDULE_CASES[case]
    want = _schedule_trace(jsched, jcfg, jseq, arrivals, num_blocks)
    got = _schedule_trace(tsched, tcfg, tseq, arrivals, num_blocks)
    assert got == want
    assert any(len(p) > 1 for p, _, _ in got)  # batched chunks
    if case == "staggered":
        assert any(p and p[0][1] > 0 for p, _, _ in got)  # continuations
    else:
        assert any(pre for _, _, pre in got)


# ---- engine -------------------------------------------------------------------

def _jax_config(model="tiny-llama", **sched):
    s = dict(max_num_seqs=8, max_num_batched_tokens=32,
             prefill_buckets=BUCKETS, prefill_batch=4)
    s.update(sched)
    return jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained(model),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=jcfg.SchedulerConfig(**s),
        mesh=MeshConfig(data=1, tensor=1),
        attention_impl="bucketed",
    )


@pytest.fixture(scope="module")
def weights():
    """JAX params and their port conversion, one pair per preset."""
    made = {}

    def get(model):
        if model not in made:
            cfg = _jax_config(model)
            mesh = build_mesh(cfg.mesh)
            params = init_or_load(cfg.model, mesh, seed=0)
            np_params = jax.tree.map(np.asarray, jax.device_get(params))
            made[model] = (mesh, params, params_from_jax(
                np_params, tcfg.ModelConfig.from_pretrained(model), "cpu"))
        return made[model]

    return get


def _engines(weights, model="tiny-llama", cache=None, **sched):
    cfg = _jax_config(model, **sched)
    if cache is not None:
        cfg = dataclasses.replace(cfg, cache=cache)
    mesh, params, tparams = weights(model)
    jeng = JaxEngine(cfg, mesh=mesh, params=params,
                     num_blocks=cfg.cache.num_blocks)
    s = cfg.scheduler
    tconf = tcfg.EngineConfig.for_model(
        model,
        cache=tcfg.CacheConfig(block_size=cfg.cache.block_size,
                               num_blocks=cfg.cache.num_blocks),
        scheduler=tcfg.SchedulerConfig(
            max_num_seqs=s.max_num_seqs,
            max_num_batched_tokens=s.max_num_batched_tokens,
            multi_step=s.multi_step, prefill_buckets=s.prefill_buckets,
            prefill_batch=s.prefill_batch),
        attention_impl="bucketed",
    )
    teng = LLMEngine(tconf, params=tparams, device="cpu")
    assert jeng.attention_impl == teng.attention_impl == "bucketed"
    return jeng, teng


def _drain(eng, reqs, stagger_at=()):
    """Submit (rid, prompt, sampling) requests, the first at once and the
    rest at the named step numbers (all at once without ``stagger_at``).
    Returns per-request tokens, logprob entries and cached-token counts."""
    toks = {rid: [] for rid, _, _ in reqs}
    lps = {rid: [] for rid, _, _ in reqs}
    cached = {}
    queue = list(reqs)
    for r, pr, s in (queue[:1] if stagger_at else queue):
        eng.add_request(r, prompt_token_ids=pr, sampling=s)
    queue = queue[1:] if stagger_at else []
    n = 0
    while True:
        outs = eng.step()
        n += 1
        if queue and n in stagger_at:
            r, pr, s = queue.pop(0)
            eng.add_request(r, prompt_token_ids=pr, sampling=s)
        for o in outs:
            toks[o.request_id].extend(o.new_token_ids)
            lps[o.request_id].extend(o.new_logprobs or ())
            if o.finished:
                cached[o.request_id] = o.num_cached_tokens
        if not eng.has_unfinished() and not queue:
            break
    return toks, lps, cached


def _both(weights, reqs, stagger_at=(), model="tiny-llama", cache=None,
          **sched):
    jeng, teng = _engines(weights, model, cache, **sched)
    jax_reqs = [(r, p, JaxSP(**dataclasses.asdict(s))) for r, p, s in reqs]
    want = _drain(jeng, jax_reqs, stagger_at)
    got = _drain(teng, reqs, stagger_at)
    return want, got, teng


def _assert_same(want, got):
    """Tokens identical up to any near-tie; logprobs within LP_TOL."""
    (wt, wl, wc), (gt, gl, gc) = want, got
    assert wc == gc  # prefix-cache hits agree
    for rid in wt:
        n = len(wt[rid])
        for i, (a, b) in enumerate(zip(wt[rid], gt[rid])):
            if a != b:
                top = wl[rid][i][1] if i < len(wl[rid]) else []
                gap = top[0][1] - top[1][1] if len(top) > 1 else np.inf
                assert gap < TIE_GAP, (rid, i, a, b, gap)
                n = i  # near-tie: later tokens follow other contexts
                break
        else:
            assert len(wt[rid]) == len(gt[rid]), rid
        assert len(wl[rid]) == len(gl[rid]), rid
        for (la, _), (lb, _) in list(zip(wl[rid], gl[rid]))[:n]:
            assert la == pytest.approx(lb, abs=LP_TOL)


def greedy(max_tokens=12, **kw):
    return SamplingParams(temperature=0.0, max_tokens=max_tokens,
                          ignore_eos=True, logprobs=2, **kw)


def test_mixed_lengths_chunked_prefill_and_batch_padding(weights,
                                                         monkeypatch):
    """Three chunks in the first step run at P = 4 (one inactive row), in
    the 6-token first chunk's bucket of 8, which cuts the 69-token prompt's
    first chunk to 8; that prompt continues over several steps."""
    reqs = [
        ("r0", [1, 5, 9, 13, 2, 6], greedy()),
        ("r1", [3, 7, 11], greedy()),
        ("r2", list(range(1, 70)), greedy()),
    ]
    jeng, teng = _engines(weights)
    shapes = []
    orig = teng.runner.prefill

    def recording(tokens, positions, tables, context_lens, *a, **kw):
        shapes.append((tokens.shape, int((context_lens > 0).sum())))
        return orig(tokens, positions, tables, context_lens, *a, **kw)

    monkeypatch.setattr(teng.runner, "prefill", recording)
    jax_reqs = [(r, p, JaxSP(**dataclasses.asdict(s))) for r, p, s in reqs]
    _assert_same(_drain(jeng, jax_reqs), _drain(teng, reqs))
    assert shapes[0] == ((4, 8), 3)  # P = 3 chunks padded to 4
    assert len(shapes) >= 3  # r2 continues in later chunks
    stats = teng.stats()
    assert stats["ragged_dispatches_total"] == 0
    assert stats["prefill_dispatches_total"] == len(shapes)
    assert stats["decode_dispatches_total"] > 0
    assert 0 < stats["prefill_bucket_utilization"] < 1


def test_staggered_arrivals_penalties_logprobs(weights):
    reqs = [
        ("long", list(range(1, 60)), greedy(8)),
        ("pen", [5, 6, 7, 8],
         greedy(8, presence_penalty=0.8, frequency_penalty=0.3)),
        ("lp", [9, 10, 11], greedy(6)),
        ("short", [2, 3], greedy(10)),
    ]
    want, got, teng = _both(weights, reqs, stagger_at=(2, 3, 4))
    _assert_same(want, got)
    assert teng.prefill_dispatches > 0 and teng.decode_dispatches > 0


def test_prefix_cache_hit(weights):
    prefix = list(range(10, 42))  # 8 full blocks at block_size 4
    reqs = [
        ("first", prefix + [1, 2, 3], greedy(6)),
        ("again", prefix + [7, 8], greedy(6)),
    ]
    want, got, _ = _both(weights, reqs, stagger_at=(12,))
    _assert_same(want, got)
    assert got[2]["again"] >= len(prefix)


def test_decode_multi_step_and_token_controls(weights):
    reqs = [
        ("bias", [4, 5, 6], greedy(7, logit_bias={7: 5.0, 9: -3.0})),
        ("allow", [8, 9], greedy(7, allowed_token_ids=(11, 12, 13))),
        ("plain", list(range(1, 40)), greedy(9)),
    ]
    want, got, _ = _both(weights, reqs, stagger_at=(2, 3), multi_step=3)
    _assert_same(want, got)
    assert set(got[0]["allow"]) <= {11, 12, 13}


def test_preemption_recompute(weights, monkeypatch):
    """A pool of 24 four-token blocks cannot hold four 32-token sequences:
    a decode row preempts the youngest sequence, which recomputes its
    prompt and output on re-admission and continues identically."""
    preempted = []
    orig = tsched.Scheduler._preempt

    def counting(self, victim):
        preempted.append(victim.request_id)
        return orig(self, victim)

    monkeypatch.setattr(tsched.Scheduler, "_preempt", counting)
    reqs = [(f"r{i}", list(range(1 + i, 21 + i)), greedy()) for i in range(4)]
    want, got, _ = _both(weights, reqs,
                         cache=jcfg.CacheConfig(block_size=4, num_blocks=24))
    _assert_same(want, got)
    assert preempted


def test_soft_capped_preset(weights):
    """tiny-gemma2: attention and final-logit soft caps, query scale, post
    norms, GeGLU; K4's plain version caps the scores before the mask."""
    reqs = [
        ("a", list(range(3, 50)), greedy(6)),
        ("b", [7, 8, 9, 10, 11], greedy(6)),
    ]
    want, got, _ = _both(weights, reqs, stagger_at=(2,), model="tiny-gemma2")
    _assert_same(want, got)


# ---- server -------------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def test_server_bucketed_completion_and_stream():
    args = build_parser().parse_args([
        "--model", "tiny-llama", "--device", "cpu", "--attention-impl",
        "bucketed", "--prefill-batch", "2", "--prefill-buckets", "16,64",
        "--block-size", "4", "--num-blocks", "512", "--max-num-seqs", "4",
        "--max-num-batched-tokens", "64"])
    cfg = config_from_args(args)
    assert cfg.attention_impl == "bucketed"
    assert cfg.scheduler.prefill_batch == 2
    assert cfg.scheduler.prefill_buckets == (16, 64)
    server = EngineServer(cfg, device=args.device)
    port = server.start("127.0.0.1", 0)
    url = f"http://127.0.0.1:{port}"
    try:
        status, body = _post(f"{url}/v1/completions", {
            "model": "tiny-llama", "prompt": "hello bucketed path",
            "max_tokens": 5, "temperature": 0, "ignore_eos": True,
            "logprobs": 2})
        out = json.loads(body)
        assert status == 200 and out["usage"]["completion_tokens"] == 5
        assert len(out["choices"][0]["logprobs"]["token_logprobs"]) == 5

        status, body = _post(f"{url}/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0.8, "top_p": 0.95, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}})
        assert status == 200
        events = [ln[len("data: "):] for ln in body.split("\n")
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert chunks[-1]["usage"]["completion_tokens"] == 4
        stats = server.engine.stats()
        assert stats["prefill_dispatches_total"] == 2
        assert stats["ragged_dispatches_total"] == 0
    finally:
        server.shutdown()
