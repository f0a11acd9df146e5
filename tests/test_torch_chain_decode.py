"""Chained decode (``SchedulerConfig.chain_decode``) in the port against the
JAX engine, on tiny-llama float32 on both attention paths.

The scenario is the reference's own (``tests/test_deferred_prefill.py``,
``test_chained_decode_token_identical``): two prompts with staggered
``max_tokens`` (9 and 5), so the decode rows change membership mid-stream,
``multi_step=2``. Seeded sampling follows each package's own rule
(engine/sampling.py in the port), so the sampled run (temperature 0.8,
top_k 30, seed 7) is compared chain on against chain off within the port;
the greedy run is compared across the packages, the port with chain off
and on against the JAX engine with it off and on, token for token (a
near-tie of the JAX run's top-2 logprobs, from a run that asks for them,
stops the comparison, as in ``_torch_parity``).

Beside it: an abort while a chained dispatch is in flight drops the
surplus and frees the blocks; a prefill that arrives mid-chain lands the
pending dispatch first; rows with logprobs or a grammar never chain.
"""

import dataclasses

import pytest
import torch

from _torch_parity import (
    assert_same,
    drain,
    engine_configs,
    jax_engine,
    port_engine,
    tiny_weights,
    top2_gaps,
)
from production_stack_tpu_torch.engine.sampling import SamplingParams

torch.set_num_threads(2)

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def _configs(impl, chain):
    return engine_configs(impl, block_size=4, num_blocks=128,
                          max_num_seqs=4, max_num_batched_tokens=64,
                          prefill_buckets=(16, 32), multi_step=2,
                          chain_decode=chain)


def _reqs(sp):
    """The reference's staggered requests: max_tokens 9 and 5."""
    return [(f"r{i}", p, dataclasses.replace(
        sp, max_tokens=sp.max_tokens - 4 * i)) for i, p in enumerate(PROMPTS)]


def _spy_chained(eng) -> list:
    """Record, for each decode dispatch, whether it took its tokens from
    the device (a chained dispatch) or deferred its fetch."""
    calls = []
    inner = eng.runner.decode_multi

    def spy(*a, **kw):
        calls.append(kw.get("tokens_dev") is not None
                     or not kw.get("fetch", True))
        return inner(*a, **kw)

    eng.runner.decode_multi = spy
    return calls


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_sampled_chain_on_equals_off(weights, impl):
    sp = SamplingParams(temperature=0.8, top_k=30, seed=7, max_tokens=9,
                        ignore_eos=True)
    runs = {}
    for chain in (False, True):
        eng = port_engine(weights, _configs(impl, chain)[1])
        chained = _spy_chained(eng)
        runs[chain] = drain(eng, _reqs(sp))
        assert any(chained) == chain
        assert eng._pending_decode is None
    assert runs[True] == runs[False]
    assert [len(runs[True][0][f"r{i}"]) for i in range(2)] == [9, 5]


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_greedy_chain_against_the_jax_engine(weights, impl):
    sp = SamplingParams(temperature=0.0, max_tokens=9, ignore_eos=True)
    # the JAX run with chain off asks for logprobs (which never chain) for
    # the near-tie gaps
    want = drain(jax_engine(weights, _configs(impl, False)[0]),
                 _reqs(dataclasses.replace(sp, logprobs=2)))
    gaps = top2_gaps(want[1])
    want = (want[0], {rid: [] for rid in want[1]}, want[2])
    jax_on = drain(jax_engine(weights, _configs(impl, True)[0]), _reqs(sp))
    assert_same(want, jax_on, gaps)
    for chain in (False, True):
        eng = port_engine(weights, _configs(impl, chain)[1])
        chained = _spy_chained(eng)
        got = drain(eng, _reqs(sp))
        assert any(chained) == chain
        assert_same(want, got, gaps)
        assert_same(jax_on, got, gaps)


def _decoding(eng, sp, n_steps):
    """Both requests admitted and stepped ``n_steps`` times; returns the
    tokens each has emitted."""
    toks = {f"r{i}": [] for i in range(len(PROMPTS))}
    for rid, p, s in _reqs(sp):
        eng.add_request(rid, prompt_token_ids=p, sampling=s)
    for _ in range(n_steps):
        for o in eng.step():
            toks[o.request_id].extend(o.new_token_ids)
    return toks


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_abort_in_flight_drops_surplus_and_frees_blocks(weights, impl):
    sp = SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True)
    eng = port_engine(weights, _configs(impl, True)[1])
    total = eng.scheduler.num_free_blocks
    toks = _decoding(eng, sp, 4)
    pending = eng._pending_decode
    assert pending is not None and "r0" in pending["rids"]
    assert eng.abort_request("r0")
    after_abort = len(toks["r0"])
    while eng.has_unfinished():
        for o in eng.step():
            toks[o.request_id].extend(o.new_token_ids)
    assert len(toks["r0"]) == after_abort  # the in-flight surplus dropped
    assert len(toks["r1"]) == 36
    assert eng._pending_decode is None
    assert eng.scheduler.num_free_blocks == total


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_prefill_mid_chain_lands_the_chain_first(weights, impl):
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    runs = {}
    for chain in (False, True):
        eng = port_engine(weights, _configs(impl, chain)[1])
        toks = _decoding(eng, sp, 4)
        if chain:
            assert eng._pending_decode is not None
            before = {rid: len(t) for rid, t in toks.items()}
        eng.add_request("late", prompt_token_ids=[4, 4, 2, 7],
                        sampling=dataclasses.replace(sp, max_tokens=6))
        toks["late"] = []
        outs = eng.step()  # schedules the late prompt's prefill
        for o in outs:
            toks[o.request_id].extend(o.new_token_ids)
        if chain:
            # the chain's samples landed in this step, before the prefill
            landed = {o.request_id for o in outs if o.new_token_ids}
            assert {"r0", "r1"} <= landed, outs
            assert all(len(toks[r]) > before[r] for r in before)
            assert eng._pending_decode is None
        while eng.has_unfinished():
            for o in eng.step():
                toks[o.request_id].extend(o.new_token_ids)
        runs[chain] = toks
    assert runs[True] == runs[False]
    assert [len(runs[True][r]) for r in ("r0", "r1", "late")] == [12, 8, 6]


@pytest.mark.parametrize("extra", [{"logprobs": 1},
                                   {"guided_regex": "[a-z]{20,30}"}])
def test_logprob_and_grammar_rows_never_chain(weights, extra):
    sp = SamplingParams(temperature=0.0, max_tokens=9, ignore_eos=True)
    runs = {}
    for chain in (False, True):
        eng = port_engine(weights, _configs("ragged", chain)[1])
        chained = _spy_chained(eng)
        reqs = _reqs(sp)
        rid, p, s = reqs[0]
        reqs[0] = (rid, p, dataclasses.replace(s, **extra))
        runs[chain] = drain(eng, reqs)
        # the row rides every decode dispatch (it outlives the other), and
        # each of them fetches at once
        assert chained and not any(chained), chained
    assert runs[True][0] == runs[False][0]
