"""The port's guided decoding (guided_regex / guided_json) against the JAX
package's, on the CPU.

- On each path (ragged and bucketed, multi_step 2), one mixed step of
  guided regex rows (one of them needing ~8 tokens, so its FSM state
  crosses several multi-step dispatches, as in
  ``tests/test_guided_decoding.py::test_guided_spans_multiple_dispatches``),
  a guided JSON row and an unguided row gives the JAX engine's greedy
  tokens, logprobs within 1e-4 and finish reasons.
- Each guided output ``re.fullmatch``es its pattern or ``json.loads`` to
  its schema; a pattern with nothing after a full match finishes by stop
  at its accepting state; the unguided row equals its solo run.
- The server (``device="cpu"``) takes both fields and answers 400 to an
  invalid grammar, to both fields at once, to ``guided_choice`` beside a
  grammar and to the reference's own ``echo`` and ``guided_choice``
  refusals (echo streamed or beside ``guided_choice``, ``guided_choice``
  with n = 2 or 65 choices), and 429 when the grammar bank is full (a
  cached grammar still passes).
"""

import dataclasses
import json
import re

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
)
from production_stack_tpu_torch.engine.engine import GrammarBankFull
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import EngineServer

torch.set_num_threads(2)

SCHEMA = {"type": "object", "properties": {
    "sentiment": {"enum": ["pos", "neg"]}, "ok": {"type": "boolean"}}}


def greedy(max_tokens=24, **kw):
    return SamplingParams(temperature=0.0, max_tokens=max_tokens, logprobs=2,
                          **kw)


REQS = [
    ("yesno", [5, 6, 7], greedy(guided_regex=r"(yes|no)( indeed)?")),
    ("long", [3, 4], greedy(guided_regex=r"abcdefgh(ij)?")),
    # a finite language: greedy output must reach the closing brace
    ("json", [9, 8, 7, 6], greedy(100, guided_json=SCHEMA)),
    ("ok", [7, 7], greedy(guided_regex=r"ok")),
    ("free", list(range(1, 40)), greedy(12, ignore_eos=True)),
]


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def _confs(impl):
    return engine_configs(impl, max_num_seqs=8, max_num_batched_tokens=64,
                          prefill_buckets=(16, 32, 64), multi_step=2,
                          engine_kw={"max_grammars": 4})


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_guided_matches_reference(weights, impl):
    jconf, tconf = _confs(impl)
    want = drain(jax_engine(weights, jconf), REQS)
    teng = port_engine(weights, tconf)
    got = drain(teng, REQS)
    assert_same(want, got)
    toks, _, reasons = got
    text = {rid: teng.tokenizer.decode(t) for rid, t in toks.items()}
    for rid, _, sp in REQS:
        if sp.guided_regex is not None:
            assert re.fullmatch(sp.guided_regex, text[rid]), (rid, text[rid])
    obj = json.loads(text["json"])
    assert obj["sentiment"] in ("pos", "neg") and isinstance(obj["ok"], bool)
    # the FSM crossed dispatches: 8+ tokens at 2 a decode step
    assert len(toks["long"]) >= 8
    # a full match with no continuation forces EOS: stop, not length
    assert text["ok"] == "ok" and reasons["ok"] == "stop"
    assert reasons["json"] == "stop"
    solo = drain(port_engine(weights, tconf), [REQS[-1]])
    assert solo[0]["free"] == toks["free"]
    # every grammar's slot was released at finish
    assert all(e["refs"] == 0 for e in teng._grammar_cache.values())


def test_grammar_bank_full_and_cache(weights):
    tconf = dataclasses.replace(_confs("ragged")[1], max_grammars=2)
    eng = port_engine(weights, tconf)
    sp = SamplingParams(temperature=0.0, max_tokens=4, guided_regex="[ab]+")
    eng.generate([[1, 2]], sp)
    eng.generate([[3, 4]], sp)  # the same pattern reuses its slot
    assert len(eng._grammar_cache) == 1
    eng.add_request("g1", prompt_token_ids=[1],
                    sampling=dataclasses.replace(sp, guided_regex="[gh]+"))
    eng.add_request("g2", prompt_token_ids=[2],
                    sampling=dataclasses.replace(sp, guided_regex="[ij]+"))
    assert eng.grammar_slot_available(guided_regex="[gh]+")
    assert not eng.grammar_slot_available(guided_regex="[kl]+")
    with pytest.raises(GrammarBankFull, match="guided grammars"):
        eng.add_request("g3", prompt_token_ids=[3], sampling=dataclasses
                        .replace(sp, guided_regex="[kl]+"))
    while eng.has_unfinished():
        eng.step()
    # both finished: a cold slot is evicted for a new grammar
    eng.generate([[5]], dataclasses.replace(sp, guided_regex="[kl]+"))


def test_server_guided_fields_400_and_429(weights):
    tconf = dataclasses.replace(_confs("ragged")[1], max_grammars=2)
    server = EngineServer(tconf, engine=port_engine(weights, tconf))
    eng = server.engine
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        status, out = http_json(f"{url}/v1/completions", {
            "model": "tiny-llama", "prompt": "q: proceed? a:",
            "max_tokens": 12, "temperature": 0, "guided_regex": "(yes|no)"})
        assert status == 200 and out["choices"][0]["text"] in ("yes", "no")
        status, out = http_json(f"{url}/v1/chat/completions", {
            "messages": [{"role": "user", "content": "classify"}],
            "max_tokens": 40, "temperature": 0.8, "seed": 5,
            "guided_json": SCHEMA})
        assert status == 200
        json.loads(out["choices"][0]["message"]["content"])
        for bad in ({"guided_regex": "(unclosed"},
                    {"guided_regex": "a", "guided_json": SCHEMA},
                    {"guided_regex": "a", "guided_choice": ["b"]},
                    {"echo": True, "stream": True},
                    {"echo": True, "guided_choice": ["b"]},
                    {"guided_choice": ["b", "c"], "n": 2},
                    {"guided_choice": [f"c{i}" for i in range(65)]},
                    {"guided_json": {"type": "object", "properties": {}}},
                    {"guided_regex": 5}):
            status, out = http_json(f"{url}/v1/completions",
                                {"prompt": "x", "max_tokens": 4, **bad})
            assert status == 400, (bad, out)
        # both slots held, as two live guided requests hold them
        held = [server.async_engine.run_on_engine(
            lambda e, p=p: e._acquire_grammar(SamplingParams(guided_regex=p)))
            for p in ("[ab]+", "[cd]+")]
        assert not eng.grammar_slot_available(guided_regex="[xy]+")
        status, out = http_json(f"{url}/v1/completions", {
            "prompt": "x", "max_tokens": 4, "guided_regex": "[xy]+"})
        assert status == 429 and out["error"]["type"] == "rate_limit_error"
        # a cached grammar is still admissible while the slots are full
        status, out = http_json(f"{url}/v1/completions", {
            "prompt": "go", "max_tokens": 4, "temperature": 0,
            "guided_regex": "[ab]+"})
        assert status == 200 and re.fullmatch("[ab]+",
                                              out["choices"][0]["text"])
        assert [e["refs"] for e in held] == [1, 1]
    finally:
        server.shutdown()
    assert not eng.has_unfinished()
