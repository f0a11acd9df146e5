"""Helpers of the port's engine-level parity tests (``test_torch_guided``,
``test_torch_lora``, ``test_torch_spec``): one tiny-llama weight set for
both engines, both engines built from one set of options, requests drained
to the end, the comparison of two runs, and JSON over HTTP.

Greedy tokens must be identical except after an argmax near-tie, a step
where the reference run's top-2 logprob gap is under ``TIE_GAP`` and float
rounding may pick either token; the comparison of that request stops
there. Token logprobs agree within ``LP_TOL``: both engines run float32,
and the two frameworks sum matmuls in different orders.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import numpy as np

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSP
from production_stack_tpu.engine.weights import init_or_load
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.engine import LLMEngine

LP_TOL = 1e-4
TIE_GAP = 1e-4


def tiny_weights():
    """(mesh, JAX params, the same params as the port's tensors)."""
    from production_stack_tpu_torch.engine.weights import params_from_jax

    mesh = build_mesh(MeshConfig(data=1, tensor=1))
    params = init_or_load(jcfg.ModelConfig.from_pretrained("tiny-llama"),
                          mesh, seed=0)
    np_params = jax.tree.map(np.asarray, jax.device_get(params))
    return mesh, params, params_from_jax(
        np_params, tcfg.ModelConfig.from_pretrained("tiny-llama"), "cpu")


def engine_configs(impl="ragged", block_size=4, num_blocks=256,
                   enable_prefix_caching=True, engine_kw=None, **sched):
    """The JAX and the port's EngineConfig with the same options: ``sched``
    sets SchedulerConfig fields, ``engine_kw`` EngineConfig fields."""
    engine_kw = engine_kw or {}
    cache = dict(block_size=block_size, num_blocks=num_blocks,
                 enable_prefix_caching=enable_prefix_caching)
    jconf = jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained("tiny-llama"),
        cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**sched),
        mesh=MeshConfig(data=1, tensor=1), attention_impl=impl, **engine_kw)
    tconf = tcfg.EngineConfig.for_model(
        "tiny-llama", cache=tcfg.CacheConfig(**cache),
        scheduler=tcfg.SchedulerConfig(**sched), attention_impl=impl,
        **engine_kw)
    return jconf, tconf


def jax_engine(weights, jconf):
    mesh, params, _ = weights
    return JaxEngine(jconf, mesh=mesh, params=params,
                     num_blocks=jconf.cache.num_blocks)


def port_engine(weights, tconf):
    return LLMEngine(tconf, params=weights[2], device="cpu")


def drain(eng, reqs, stagger_at=()):
    """Submit requests ``(rid, prompt ids, port SamplingParams[,
    adapter_slot[, tenant]])``, all at once or, with ``stagger_at``, the
    first at once and each next one after the named step; step to the end.
    The JAX engine gets the same SamplingParams fields. Returns (tokens,
    logprob entries, finish reasons), each by request id."""
    jax_side = isinstance(eng, JaxEngine)
    toks = {r[0]: [] for r in reqs}
    lps = {r[0]: [] for r in reqs}
    reasons = {}

    def add(rid, prompt, sp, adapter=0, tenant="anonymous"):
        if jax_side:
            sp = JaxSP(**dataclasses.asdict(sp))
        eng.add_request(rid, prompt_token_ids=list(prompt), sampling=sp,
                        adapter_slot=adapter, tenant=tenant)

    queue = list(reqs)
    for r in (queue[:1] if stagger_at else queue):
        add(*r)
    queue = queue[1:] if stagger_at else []
    n = 0
    while True:
        outs = eng.step()
        n += 1
        if queue and n in stagger_at:
            add(*queue.pop(0))
        for o in outs:
            toks[o.request_id].extend(o.new_token_ids)
            lps[o.request_id].extend(o.new_logprobs or ())
            if o.finished:
                reasons[o.request_id] = o.finish_reason
        if not eng.has_unfinished() and not queue:
            return toks, lps, reasons


def assert_same(want, got, gaps=None):
    """Tokens identical up to a near-tie; logprobs, where both runs have
    them, within LP_TOL; finish reasons equal where no near-tie cut the
    comparison. ``gaps`` (request id -> top-2 gap per step) stands in for
    the reference run's logprobs where it has none."""
    (wt, wl, wr), (gt, gl, gr) = want, got
    for rid in wt:
        n = len(wt[rid])
        for i, (a, b) in enumerate(zip(wt[rid], gt[rid])):
            if a != b:
                if gaps is not None:
                    gap = gaps[rid][i]
                else:
                    top = wl[rid][i][1] if i < len(wl[rid]) else []
                    gap = top[0][1] - top[1][1] if len(top) > 1 else np.inf
                assert gap < TIE_GAP, (rid, i, a, b, gap)
                n = i  # near-tie: later tokens follow other contexts
                break
        else:
            assert len(wt[rid]) == len(gt[rid]), rid
            assert wr.get(rid) == gr.get(rid), rid
        for (la, _), (lb, _) in list(zip(wl[rid], gl[rid]))[:n]:
            assert abs(la - lb) <= LP_TOL, (rid, la, lb)


def top2_gaps(lps):
    """Request id -> the top-2 logprob gap at each step of a run that
    asked for at least 2 logprobs."""
    return {rid: [top[0][1] - top[1][1] for _, top in entries]
            for rid, entries in lps.items()}


def http_json(url, body=None):
    """(status, JSON body) of a GET, or of a POST of ``body``; an HTTP
    error status is returned, not raised."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
