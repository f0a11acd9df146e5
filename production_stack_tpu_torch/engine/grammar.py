"""Constrained decoding: regex/JSON-schema -> byte DFA -> token tables.

A copy of production_stack_tpu/engine/grammar.py, which is numpy only: the
grammar compiles once on the host to a token-level transition table, the
model runner keeps that table on the device, and the FSM advances inside
the multi-step decode loop there (mask logits where ``trans[state] < 0``,
sample, ``state = trans[state, token]``), with no host round trip per
token (engine/model_runner.py applies it; this module is host-side
compilation only).

Pipeline:
1. parse a practical regex subset (literals, escapes, ``.``, ``[...]``
   classes, ``| ( ) * + ? {m,n}``) -> Thompson NFA over BYTES,
2. subset-construct a DFA over byte equivalence classes,
3. for every vocab token, walk its UTF-8 bytes through the DFA from every
   state -> ``trans (n_states, V) int32`` (-1 = rejected) + per-state
   accept flags (EOS is allowed exactly in accepting states).

JSON schemas compile by lowering to a regex: non-recursive schemas
(objects with fixed properties, arrays, enums, string/number/integer/
boolean/null leaves) describe REGULAR languages, so the same DFA machinery
serves them exactly.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

EPS = -1  # NFA epsilon edge label


class RegexError(ValueError):
    pass


# --------------------------------------------------------------------------
# regex parsing → NFA (Thompson construction, byte alphabet)
# --------------------------------------------------------------------------

_CLASS_ESCAPES = {
    "d": set(range(0x30, 0x3A)),
    "w": set(range(0x30, 0x3A)) | set(range(0x41, 0x5B))
    | set(range(0x61, 0x7B)) | {0x5F},
    "s": {0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B},
}
_CLASS_ESCAPES["D"] = set(range(256)) - _CLASS_ESCAPES["d"]
_CLASS_ESCAPES["W"] = set(range(256)) - _CLASS_ESCAPES["w"]
_CLASS_ESCAPES["S"] = set(range(256)) - _CLASS_ESCAPES["s"]

_LITERAL_ESCAPES = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
                    "0": 0x00}


@dataclasses.dataclass
class _Nfa:
    """Fragment: transitions[state] = list of (byte_set | EPS, target)."""

    transitions: list  # list[list[tuple[frozenset|int, int]]]
    start: int
    accept: int


class _Parser:
    """Recursive-descent over the regex; builds one big transition list."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.trans: list = []

    def _state(self) -> int:
        self.trans.append([])
        return len(self.trans) - 1

    def _edge(self, src: int, label, dst: int) -> None:
        self.trans[src].append((label, dst))

    def parse(self) -> _Nfa:
        frag = self._alt()
        if self.i < len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return _Nfa(self.trans, frag[0], frag[1])

    def _alt(self):
        frags = [self._concat()]
        while self.i < len(self.p) and self.p[self.i] == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, a = self._state(), self._state()
        for fs, fa in frags:
            self._edge(s, EPS, fs)
            self._edge(fa, EPS, a)
        return s, a

    def _concat(self):
        frags = []
        while self.i < len(self.p) and self.p[self.i] not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self._state()
            return s, s  # empty match
        cur = frags[0]
        for nxt in frags[1:]:
            self._edge(cur[1], EPS, nxt[0])
            cur = (cur[0], nxt[1])
        return cur

    def _repeat(self):
        mark = len(self.trans)  # the atom's states are trans[mark:]
        frag = self._atom()
        while self.i < len(self.p) and self.p[self.i] in "*+?{":
            c = self.p[self.i]
            if c == "{":
                lo, hi = self._parse_counts()
                frag = self._apply_counts(frag, mark, lo, hi)
                continue
            self.i += 1
            s, a = self._state(), self._state()
            fs, fa = frag
            self._edge(s, EPS, fs)
            if c in "*?":
                self._edge(s, EPS, a)
            if c in "*+":
                self._edge(fa, EPS, fs)
            self._edge(fa, EPS, a)
            frag = (s, a)
        return frag

    def _parse_counts(self):
        j = self.p.find("}", self.i)
        if j < 0:
            raise RegexError(f"unbalanced {{ at {self.i}")
        body = self.p[self.i + 1 : j]
        self.i = j + 1
        try:
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s or 0)
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(body)
        except ValueError:
            raise RegexError(f"bad counts {{{body}}}") from None
        if hi is not None and hi < lo:
            raise RegexError(f"bad counts {{{body}}}")
        if (hi if hi is not None else lo) > 256:
            raise RegexError("count bound too large (max 256)")
        return lo, hi

    def _apply_counts(self, frag, mark: int, lo: int, hi: Optional[int]):
        """Expand {m}/{m,}/{m,n} by chaining bounded copies.

        Copies k < lo are mandatory; copies k >= lo can be skipped
        straight to the accept. {m,} appends one extra looping copy."""
        # snapshot the fragment subgraph NOW: chaining below adds epsilon
        # edges to the original accept state, which must not leak into
        # later copies
        template_end = len(self.trans)
        template = [list(t) for t in self.trans[mark:template_end]]
        n_copies = hi if hi is not None else lo
        s, a = self._state(), self._state()
        if n_copies == 0:
            self._edge(s, EPS, a)
            if hi is None:  # {0,} == *
                fs, fa = frag
                self._edge(s, EPS, fs)
                self._edge(fa, EPS, fs)
                self._edge(fa, EPS, a)
            return s, a

        def clone():
            offset = len(self.trans) - mark
            for t in template:
                self.trans.append(
                    [(lbl, dst + offset) for lbl, dst in t]
                )
            return frag[0] + offset, frag[1] + offset

        cur = s
        for k in range(n_copies):
            fs, fa = frag if k == 0 else clone()
            if k >= lo:
                self._edge(cur, EPS, a)  # optional tail copy: skip out
            self._edge(cur, EPS, fs)
            cur = fa
        self._edge(cur, EPS, a)
        if hi is None:  # {m,}: loop one extra copy
            fs, fa = clone()
            self._edge(cur, EPS, fs)
            self._edge(fa, EPS, fs)
            self._edge(fa, EPS, a)
        return s, a

    def _atom(self):
        c = self.p[self.i]
        if c == "(":
            self.i += 1
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2  # non-capturing — groups never capture here
            frag = self._alt()
            if self.i >= len(self.p) or self.p[self.i] != ")":
                raise RegexError("unbalanced (")
            self.i += 1
            return frag
        if c == "[":
            byte_set = self._char_class()
            return self._single(byte_set)
        if c == ".":
            self.i += 1
            return self._single(frozenset(range(256)) - {0x0A})
        if c == "\\":
            self.i += 1
            return self._single(self._escape())
        if c in "*+?{)|":
            raise RegexError(f"unexpected {c!r} at {self.i}")
        self.i += 1
        return self._multibyte(c.encode())

    def _single(self, byte_set):
        s, a = self._state(), self._state()
        self._edge(s, frozenset(byte_set), a)
        return s, a

    def _multibyte(self, bs: bytes):
        s = self._state()
        cur = s
        for b in bs:
            nxt = self._state()
            self._edge(cur, frozenset({b}), nxt)
            cur = nxt
        return s, cur

    def _escape(self):
        if self.i >= len(self.p):
            # a pattern ending in a bare backslash must be a 400-able
            # RegexError, not an IndexError 500
            raise RegexError("truncated escape at end of pattern")
        e = self.p[self.i]
        self.i += 1
        if e in _CLASS_ESCAPES:
            return frozenset(_CLASS_ESCAPES[e])
        if e in _LITERAL_ESCAPES:
            return frozenset({_LITERAL_ESCAPES[e]})
        if e == "x":
            hex_part = self.p[self.i : self.i + 2]
            try:
                if len(hex_part) != 2:
                    raise ValueError
                v = int(hex_part, 16)
            except ValueError:
                raise RegexError(
                    f"bad \\x escape at {self.i}"
                ) from None
            self.i += 2
            return frozenset({v})
        return frozenset(e.encode())  # \. \[ \\ etc (utf-8 single byte ok)

    def _char_class(self):
        assert self.p[self.i] == "["
        self.i += 1
        negate = self.p[self.i] == "^"
        if negate:
            self.i += 1
        out: set = set()
        first = True
        while self.i < len(self.p) and (self.p[self.i] != "]" or first):
            first = False
            if self.p[self.i] == "\\":
                self.i += 1
                out |= self._escape()
                continue
            lo = self.p[self.i].encode()
            self.i += 1
            if (self.p[self.i : self.i + 1] == "-"
                    and self.p[self.i + 1 : self.i + 2] not in ("]", "")):
                hi = self.p[self.i + 1].encode()
                self.i += 2
                if len(lo) > 1 or len(hi) > 1 or hi[0] < lo[0]:
                    raise RegexError("bad class range")
                out |= set(range(lo[0], hi[0] + 1))
            else:
                out |= set(lo)
        if self.i >= len(self.p):
            raise RegexError("unbalanced [")
        self.i += 1  # ]
        return frozenset(range(256)) - out if negate else frozenset(out)


# --------------------------------------------------------------------------
# NFA → DFA (subset construction over byte equivalence classes)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ByteDfa:
    """trans[state][byte] = next state or -1; state 0 is the start."""

    trans: np.ndarray  # (n_states, 256) int32
    accept: np.ndarray  # (n_states,) bool

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def walk(self, state: int, data: bytes) -> int:
        for b in data:
            if state < 0:
                return -1
            state = int(self.trans[state, b])
        return state


def compile_regex(pattern: str, max_states: int = 512) -> ByteDfa:
    nfa = _Parser(pattern).parse()

    def eclose(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for lbl, dst in nfa.transitions[s]:
                if lbl == EPS and dst not in seen:
                    seen.add(dst)
                    stack.append(dst)
        return frozenset(seen)

    start = eclose(frozenset({nfa.start}))
    index = {start: 0}
    rows = []
    accepts = []
    work = [start]
    while work:
        cur = work.pop(0)
        row = np.full(256, -1, np.int32)
        # group reachable byte sets
        by_byte: dict[int, set] = {}
        for s in cur:
            for lbl, dst in nfa.transitions[s]:
                if lbl == EPS:
                    continue
                for b in lbl:
                    by_byte.setdefault(b, set()).add(dst)
        # canonicalise target sets so equal sets share a DFA state
        for b, dsts in by_byte.items():
            target = eclose(frozenset(dsts))
            if target not in index:
                if len(index) >= max_states:
                    raise RegexError(
                        f"regex needs more than {max_states} DFA states"
                    )
                index[target] = len(index)
                work.append(target)
            row[b] = index[target]
        rows.append(row)
        accepts.append(nfa.accept in cur)
    # rows were appended in pop order == index order
    return ByteDfa(np.stack(rows), np.asarray(accepts, bool))


# --------------------------------------------------------------------------
# token-level table
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TokenFsm:
    """Vocabulary-projected DFA for one grammar.

    trans (n_states, V) int32: next state after emitting token v from
    state s, or -1 when any byte of v is rejected. accept (n_states,):
    EOS is permitted exactly here. Tokens with no byte image (specials,
    padding ids) are always rejected — only EOS may end the match."""

    trans: np.ndarray
    accept: np.ndarray

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def build_token_fsm(dfa: ByteDfa, token_bytes: list[bytes]) -> TokenFsm:
    """Vectorised: all tokens walk the DFA together, one byte position at
    a time per start state (states x max_token_len numpy gathers over the
    vocab — milliseconds at 128k vocab, vs tens of seconds per-token)."""
    V = len(token_bytes)
    lens = np.asarray([len(b) for b in token_bytes], np.int32)
    L = int(lens.max(initial=0))
    mat = np.zeros((V, max(L, 1)), np.uint8)
    for v, bs in enumerate(token_bytes):
        if bs:
            mat[v, : len(bs)] = np.frombuffer(bs, np.uint8)
    trans = np.full((dfa.n_states, V), -1, np.int32)
    # pad the byte table with a dead row so state -1 gathers stay -1
    padded = np.concatenate(
        [dfa.trans, np.full((1, 256), -1, np.int32)], axis=0
    )
    for s in range(dfa.n_states):
        cur = np.full(V, s, np.int32)
        for j in range(L):
            alive = j < lens
            cur = np.where(alive, padded[cur, mat[:, j]], cur)
        cur[lens == 0] = -1  # specials never advance a grammar
        trans[s] = cur
    accept = dfa.accept.copy()
    # Prune token-level dead ends: with a real vocabulary a
    # byte-DFA state can be reachable yet have NO whole token continuing
    # toward acceptance — sampling would mask every logit and argmax would
    # silently emit token 0, violating the grammar. A state is live iff it
    # accepts or some token leads to a live state (greatest fixpoint);
    # edges into dead states are cut, so every reachable state always has
    # an admissible token or EOS.
    valid = trans >= 0
    tgt = np.where(valid, trans, 0)
    live = accept.copy()
    while True:
        new_live = live | (valid & live[tgt]).any(axis=1)
        if bool((new_live == live).all()):
            break
        live = new_live
    if not live[0]:
        raise RegexError(
            "grammar admits no token sequence under this vocabulary"
        )
    trans[valid & ~live[tgt]] = -1
    return TokenFsm(trans, accept)


def _gpt2_unicode_to_byte() -> dict:
    """Inverse of the GPT-2 byte→printable-unicode alphabet.

    Byte-level BPE tokenizers (GPT-2, Llama-3, Qwen, …) store vocab pieces
    over a 256-char printable alphabet: bytes that are already printable
    ASCII/latin map to themselves, the rest shift up past U+0100. This is
    the standard published mapping (the approach outlines/xgrammar use to
    recover exact byte images); rebuilt here rather than decoding ids one
    by one, which loses word-leading spaces and mangles partial UTF-8."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    chars = list(keep)
    n = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(keep, chars)}


def _hf_token_byte_images(tk, vocab_size: int) -> list[bytes]:
    """Byte image per id from the RAW vocab pieces of a HF tokenizer.

    Why not ``decode([i])`` per id: SentencePiece/Metaspace tokenizers
    strip the word-leading space when a piece is decoded alone
    (decode('▁Hello') == 'Hello'), and byte-fallback / partial-UTF-8
    byte-level pieces decode to U+FFFD — either desynchronizes the token
    FSM from the actually-emitted text. Instead read
    ``convert_ids_to_tokens`` and undo the piece encoding directly:
    Metaspace '▁'→' ', byte-level via the GPT-2 unicode↔byte alphabet,
    ``<0xNN>`` byte-fallback pieces → that raw byte."""
    n = len(tk)
    special = set(getattr(tk, "all_special_ids", None) or [])
    added = {}
    for i, t in (getattr(tk, "added_tokens_decoder", None) or {}).items():
        added[int(i)] = getattr(t, "content", str(t))
        # tokens flagged special=True in added_tokens_decoder (Llama-3-style
        # <|reserved_...|> control tokens) are dropped by
        # decode(skip_special_tokens=True) even when they're missing from
        # all_special_ids — a literal byte image would advance the FSM with
        # text that never appears in output
        if getattr(t, "special", False):
            special.add(int(i))
    vocab = tk.get_vocab()
    metaspace = any("▁" in p for p in vocab)
    byte_level = not metaspace and any("Ġ" in p for p in vocab)
    u2b = _gpt2_unicode_to_byte() if byte_level else None

    pieces = tk.convert_ids_to_tokens(list(range(n)))
    images: list[bytes] = []
    for i in range(vocab_size):
        if i >= n or i in special:
            # padded-vocab ids (e.g. phi-3's 32064 vs 32011 real) and
            # specials never advance a grammar
            images.append(b"")
            continue
        if i in added:
            # added tokens are stored literally, not piece-encoded
            images.append(added[i].encode("utf-8"))
            continue
        p = pieces[i]
        if p is None:
            images.append(b"")
            continue
        if (len(p) == 6 and p.startswith("<0x") and p.endswith(">")):
            try:
                images.append(bytes([int(p[3:5], 16)]))  # byte fallback
                continue
            except ValueError:
                pass
        if byte_level:
            images.append(bytes(u2b[ch] for ch in p if ch in u2b))
        elif metaspace:
            images.append(p.replace("▁", " ").encode("utf-8"))
        else:
            images.append(p.encode("utf-8"))
    return images


def token_byte_images(tokenizer, vocab_size: int) -> list[bytes]:
    """Each id's byte contribution to emitted text.

    HF tokenizers take the raw-vocab-piece path (exact, incl. leading
    spaces and byte fallback). The dependency-free ByteTokenizer's
    id-by-id decode is exact by construction (ids ARE bytes)."""
    from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

    if isinstance(tokenizer, ByteTokenizer):
        # ids ARE bytes; going through decode() would mangle 0x80-0xFF
        # into U+FFFD. Specials (bos/eos/pad and any padding) are b''.
        return ([bytes([i]) for i in range(min(256, vocab_size))]
                + [b""] * max(0, vocab_size - 256))
    tk = getattr(tokenizer, "tk", None)
    if tk is not None and hasattr(tk, "convert_ids_to_tokens"):
        return _hf_token_byte_images(tk, vocab_size)
    return [
        tokenizer.decode([i]).encode("utf-8", errors="ignore")
        for i in range(vocab_size)
    ]


# --------------------------------------------------------------------------
# JSON schema → regex (non-recursive schemas are regular)
# --------------------------------------------------------------------------

# unbounded loops for VALUE contents ({0,n} expands to n NFA copies and
# the DFA states follow — shape is the constraint, max_tokens bounds
# length); inter-token whitespace IS bounded, or a sampling model can
# free-run newlines forever inside the schema (outlines bounds it the
# same way via whitespace_pattern)
_WS = r"[ \n\t]{0,2}"
_STRING_RE = r'"[^"\\\x00-\x1f]*"'
_NUMBER_RE = r"-?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?"
_INTEGER_RE = r"-?(0|[1-9]\d*)"


def _esc_literal(s: str) -> str:
    out = []
    for ch in s:
        if ch in r"\.[]{}()*+?|^$/-":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def schema_to_regex(schema: dict, depth: int = 0) -> str:
    """Lower a (non-recursive) JSON schema to a regex the DFA compiler
    accepts. Supported: object (fixed ``properties``, all required),
    array (items, optional min/maxItems up to 16), string (optional
    enum/pattern... pattern NOT supported inside schemas), number,
    integer, boolean, null, enum/const of scalars."""
    if depth > 8:
        raise RegexError("schema nesting too deep (max 8)")
    if not isinstance(schema, dict):
        raise RegexError("schema must be an object")
    if "enum" in schema:
        opts = [_json_scalar_regex(v) for v in schema["enum"]]
        return "(" + "|".join(opts) + ")"
    if "const" in schema:
        return _json_scalar_regex(schema["const"])
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties") or {}
        if not props:
            raise RegexError("object schema needs properties")
        parts = []
        for name, sub in props.items():
            parts.append(
                f'"{_esc_literal(name)}"{_WS}:{_WS}'
                + schema_to_regex(sub, depth + 1)
            )
        body = (_WS + "," + _WS).join(parts)
        return r"\{" + _WS + body + _WS + r"\}"
    if t == "array":
        item = schema_to_regex(schema.get("items") or {"type": "string"},
                               depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 16))
        if hi > 16 or lo > hi:
            raise RegexError("array bounds must satisfy 0<=min<=max<=16")
        one = item
        more = "(" + _WS + "," + _WS + item + ")"
        if lo == 0:
            body = f"({one}{more}{{0,{hi - 1}}})?" if hi > 0 else ""
        else:
            body = one + more + f"{{{lo - 1},{hi - 1}}}"
        return r"\[" + _WS + body + _WS + r"\]"
    if t == "string":
        return _STRING_RE
    if t == "number":
        return _NUMBER_RE
    if t == "integer":
        return _INTEGER_RE
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    raise RegexError(f"unsupported schema: {json.dumps(schema)[:80]}")


def _json_scalar_regex(v) -> str:
    if isinstance(v, str):
        return '"' + _esc_literal(v) + '"'
    if v is True:
        return "true"
    if v is False:
        return "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return _esc_literal(json.dumps(v))
    raise RegexError(f"unsupported enum value {v!r}")
