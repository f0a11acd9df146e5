"""The port's grammar compiler and grammar mask against the JAX package's.

``production_stack_tpu_torch/engine/grammar.py`` is the port's own copy of
the reference compiler: on the same patterns it must build the same byte
DFA and the same token FSM, and ``schema_to_regex`` the same regex, array
for array. ``grammar_mask`` (the model runner's mask) must equal the
reference's ``_grammar_mask`` bit for bit on the same random logits: guided
and unguided rows, accepting states (where EOS opens) and a dead-end row
(no allowed token, where EOS opens as the guard).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import grammar as jg
from production_stack_tpu.engine.model_runner import _grammar_mask
from production_stack_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from production_stack_tpu_torch.engine import grammar as tg
from production_stack_tpu_torch.engine.model_runner import grammar_mask
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

# classes, anchors of fixed length, repetition, alternation, escapes and
# the JSON-schema leaves (tests/test_guided_decoding.py,
# tests/test_grammar_tokenizers.py)
PATTERNS = [
    r"\d{3}-\d{4}", r"(foo|bar)+", r"[a-c]*z", r"a{2,4}", r"a{2,}",
    r"a{0,2}b", r"yes|no", r"[^0-9]+", r"-?(0|[1-9]\d*)(\.\d+)?",
    r"\.x\\", r"(ab|a)*b", r"a(b|c){1,3}d?", r"[ab]{2}c*", r"(a|b)+c",
    r"(yes|no)( indeed)?", r"abcdefgh(ij)?", r"[xyz]{3}", r"ok",
    r"(ab|cd)*e?f", r" Hello", r"ab|cd", r"abc", r"\w+@\w+\.com",
    r"[\s\S]{1,3}", r"\x41\x42?",
]

SCHEMAS = [
    {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"},
                 "maxItems": 3}}},
    {"type": "object", "properties": {
        "sentiment": {"enum": ["pos", "neg"]}, "score": {"type": "integer"}}},
    {"type": "object", "properties": {
        "label": {"enum": ["a", "b"]}, "ok": {"type": "boolean"},
        "x": {"type": "number"}, "n": {"type": "null"}}},
]


def _same_dfa(a, b):
    assert np.array_equal(a.trans, b.trans)
    assert np.array_equal(a.accept, b.accept)


@pytest.mark.parametrize("pat", PATTERNS)
def test_regex_tables_match_reference(pat):
    want = jg.compile_regex(pat)
    got = tg.compile_regex(pat)
    _same_dfa(got, want)
    imgs = tg.token_byte_images(ByteTokenizer(), 300)
    assert imgs == jg.token_byte_images(JaxBytes(), 300)
    _same_dfa(tg.build_token_fsm(got, imgs), jg.build_token_fsm(want, imgs))


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_regex_and_tables_match_reference(i):
    pat = tg.schema_to_regex(SCHEMAS[i])
    assert pat == jg.schema_to_regex(SCHEMAS[i])
    imgs = tg.token_byte_images(ByteTokenizer(), 512)
    _same_dfa(tg.build_token_fsm(tg.compile_regex(pat), imgs),
              jg.build_token_fsm(jg.compile_regex(pat), imgs))


@pytest.mark.parametrize("pat", ["abc\\", "a{2", "a{x}", r"\x4", r"ab\x",
                                 r"[a\ ", "(unclosed"])
def test_malformed_patterns_raise_as_reference(pat):
    with pytest.raises(jg.RegexError):
        jg.compile_regex(pat)
    with pytest.raises(tg.RegexError):
        tg.compile_regex(pat)


def test_budget_and_unsatisfiable_raise_as_reference():
    for mod in (jg, tg):
        with pytest.raises(mod.RegexError, match="DFA states"):
            mod.compile_regex("a{200}b{200}", max_states=64)
        with pytest.raises(mod.RegexError, match="no token sequence"):
            mod.build_token_fsm(mod.compile_regex("ab"), [b"a", b"x"])
        with pytest.raises(mod.RegexError):
            mod.schema_to_regex({"type": "object", "properties": {}})


def test_byte_tokenizer_images_match_reference():
    for V in (259, 512, 1000):
        got = tg.token_byte_images(ByteTokenizer(), V)
        assert got == jg.token_byte_images(JaxBytes(), V)
    assert got[0x80] == b"\x80" and got[257] == b""


def _bank(V):
    """Two grammars in a bank of 3 slots x 16 states, padded with -1 as the
    runner pads them, and their accept flags."""
    G, S = 3, 16
    bank = np.full((G, S, V), -1, np.int16)
    accept = np.zeros((G, S), bool)
    imgs = tg.token_byte_images(ByteTokenizer(), V)
    for g, pat in enumerate([r"(yes|no)( indeed)?", r"x[ab]{1,3}"]):
        fsm = tg.build_token_fsm(tg.compile_regex(pat), imgs)
        bank[g, : fsm.n_states] = fsm.trans
        accept[g, : fsm.n_states] = fsm.accept
    # slot 2: a row with no allowed token at all (the dead-end guard)
    bank[2, 0] = -1
    return bank, accept


def test_grammar_mask_bit_identical_to_reference():
    rng = np.random.default_rng(0)
    V, B, eos = 300, 12, 257
    bank, accept = _bank(V)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 4
    # unguided, both grammars at several states (accepting ones included),
    # the dead-end row, and a negative (finished) state
    g_ids = np.array([-1, 0, 0, 0, 0, 1, 1, 1, 2, -1, 0, 1], np.int32)
    g_states = np.array([0, 0, 1, 3, 5, 0, 2, 3, 0, 4, -1, 7], np.int32)
    assert accept[g_ids.clip(0), g_states.clip(0)].any()
    want_l, want_r = _grammar_mask(
        jnp.asarray(logits), jnp.asarray(bank), jnp.asarray(accept),
        jnp.asarray(g_ids), jnp.asarray(g_states), eos)
    got_l, got_r = grammar_mask(
        torch.from_numpy(logits), torch.from_numpy(bank),
        torch.from_numpy(accept), torch.from_numpy(g_ids).long(),
        torch.from_numpy(g_states).long(), eos)
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    # the dead-end row may take EOS and nothing else; unguided rows pass
    assert (got_l[8] > -1e29).nonzero().flatten().tolist() == [eos]
    assert torch.equal(got_l[0], torch.from_numpy(logits[0]))
