"""Whisper execution on one card: an encoder pass, a bucketed decoder
prefill and chunks of single-token decoder steps.

Ports production_stack_tpu/engine/whisper_runner.py, which drives
models/whisper.py for ``/v1/audio/transcriptions`` and ``/translations``.

- ``_encode``: the encoder over the fixed 30 s mel window, then the cross
  K/V of every decoder layer, once a request.
- ``_dec_prefill``: the decoder over the forced tokens, right-padded to a
  prompt bucket.
- ``_chunk``: up to ``DECODE_CHUNK`` tokens. The reference runs a chunk
  as one ``lax.while_loop`` on the device; here it is a host loop of
  single-token decoder steps at B = 1, which reads each token back to
  stop at ``eot``. Its tokens, count, ``cur``, ``last_ts`` and
  ``ts_run`` are the reference's, step for step.
- Token suppression at every step: special tokens above ``eot_id`` are
  masked; in timestamp mode the ``<|t.tt|>`` tokens (above
  ``notimestamps_id``) are re-admitted under the timestamp rules, as the
  segment boundaries srt/vtt/verbose_json are built from; ``eot`` itself
  is masked until at least one TEXT token has been emitted.

Greedy decoding takes the argmax of the suppressed logits. Sampling with
a temperature draws from a device ``torch.Generator`` seeded by the
request (a stream other than JAX's threefry).

A request's device state is kept by handle: ``encode_request`` puts its
cross K/V in the runner's table of live requests, ``prefill_request``
adds its ``_Decode`` (self-attention cache, logits, generator, counters),
``sot_request`` and ``chunk_request`` read them, and ``free`` drops them.
These five calls take only host arguments and return only host values,
so under tensor parallelism (``config.mesh``'s tensor size above 1) each
is mirrored to the follower ranks (engine/multihost.py), which hold their
own heads' share of the same state in their own tables. The runner then
starts the ranks itself, holds no parameters of its own, and runs its
device work on rank 0's runner (``dev``); every call is sent inside
``lock``, so the followers replay in the order rank 0 runs, and a
request's ``free`` runs under it on every way out of ``transcribe_stream``
(its end, ``close()``, an exception).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import zlib
from typing import Iterator, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import audio as audio_fe
from production_stack_tpu_torch.engine.config import EngineConfig, resolve_device
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.engine.weights import (
    init_or_load,
    shard_params,
    to_device,
)
from production_stack_tpu_torch.models import whisper as W
from production_stack_tpu_torch.models.whisper import LANGUAGES
from production_stack_tpu_torch.parallel import shardings as ln
from production_stack_tpu_torch.parallel.mesh import tensor_size

# tokens a chunk: the device lock is taken per chunk, so admitted
# requests interleave at this granularity, and a stream sends text as
# often
DECODE_CHUNK = 32
PROMPT_BUCKETS = (8, 32, 128)


def timestamp_suppress_mask(cfg, ids: torch.Tensor, timestamps: bool,
                            last_ts: int, ts_run: int) -> torch.Tensor:
    """The timestamp-rule part of the suppression mask (pure; unit-
    tested directly). Upstream ApplyTimestampRules distilled:

    - timestamps are non-decreasing (ids below ``last_ts`` masked);
    - an EQUAL timestamp is allowed only as the immediate second half
      of a boundary pair (``ts_run == 1``); after text, the next
      timestamp must be strictly greater (no zero-length segments);
    - after two consecutive timestamps (``ts_run >= 2``) the whole
      timestamp range is masked: text or eot must follow, so a
      degenerate decode can never loop on one timestamp forever.

    ``ids`` is the vocabulary's ids on the device; the decode state
    (``timestamps``, ``last_ts``, ``ts_run``) is the host's."""
    is_ts = ids > cfg.notimestamps_id
    below = ids < last_ts if ts_run == 1 else ids <= last_ts
    return is_ts & (below | (ts_run >= 2)) & timestamps


@dataclasses.dataclass
class _Decode:
    """One request's decode state between chunks: its self-attention
    cache, the logits the next token is drawn from, and the host's
    counters."""
    kv: torch.Tensor
    logits: torch.Tensor  # (V,) float32
    cur: int              # tokens in the cache
    gen: torch.Generator
    n_gen: int = 0        # TEXT tokens emitted (the eot-release guard)
    last_ts: int = 0      # highest timestamp id emitted (0 = none)
    ts_run: int = 0       # consecutive timestamps ending here


@dataclasses.dataclass
class _Live:
    """A live request's device state on this rank: its cross K/V, and its
    decode state once prefilled."""
    ck: torch.Tensor
    cv: torch.Tensor
    st: Optional[_Decode] = None


class WhisperRunner:
    """Single-model transcription runner.

    Concurrency, as the reference's: B = 1 per device call; an ADMISSION
    semaphore sized by ``scheduler.max_num_seqs`` bounds how many requests
    may hold live decode state (each admitted request owns its cross-KV
    and self-KV buffers on the card: 245.8 MB + 73.4 MB at
    whisper-large-v3 in bf16), and within the admitted set the device lock
    is taken per decode chunk, so concurrent requests interleave instead
    of waiting for whole clips. ``params`` (a ``whisper.param_shapes``
    tree) replaces the seeded or checkpoint weights; under tensor
    parallelism every rank cuts its share of it.

    At ``config.mesh``'s tensor size above 1 the runner starts the ranks
    (``rank_devices`` and ``backend`` place them, as for ``LLMEngine``)
    and ``close`` stops them. A runner given ``ranks`` is one rank's
    share (``engine/multihost.py`` builds them)."""

    def __init__(self, config: EngineConfig, device="cuda",
                 params: Optional[dict] = None,
                 rank_devices: Optional[list] = None,
                 backend: Optional[str] = None, ranks=None):
        cfg = config.model
        if cfg.architecture != "whisper":
            raise ValueError(f"not a whisper model: {cfg.architecture}")
        if cfg.quant:
            raise ValueError(
                f"quantization {cfg.quant!r} is not served for Whisper: "
                "its weights are made and served in the model dtype")
        if config.mesh.stage > 1:
            raise ValueError(
                f"{cfg.name}: Whisper under pipeline parallelism is not "
                f"ported yet (stage {config.mesh.stage})")
        if config.mesh.expert > 1:
            raise ValueError(
                f"{cfg.name}: Whisper under expert parallelism is not "
                f"ported (expert {config.mesh.expert}): it has no experts "
                "to split")
        self.cfg = cfg
        # the mirrored rank 0 runner where this one started the ranks
        self._mirror = None
        tp = tensor_size(config.mesh, device) if ranks is None else ranks.size
        if ranks is None and tp > 1:
            from production_stack_tpu_torch.engine.multihost import (
                start_ranks,
            )
            from production_stack_tpu_torch.parallel.distributed import Grid

            self._mirror = start_ranks(config, params, None, device,
                                       Grid(tensor=tp), rank_devices,
                                       backend, whisper=True)
            self.device = self._mirror.device
            self.params = None  # the ranks hold the shards
        else:
            self._init_shard(config, device, params, ranks)
        self.tokenizer = get_tokenizer(cfg.tokenizer)
        # reentrant: a stream dropped without close() is finalized where
        # its last reference goes, which may be inside this lock, and its
        # finally frees under it
        self.lock = threading.RLock()
        self._handles = itertools.count(1)
        # bound on LIVE decode states (per-request KV buffers on the
        # card): without it a burst of uploads would each allocate cross-
        # KV + self-KV before queueing on the chunk lock
        self.admit = threading.BoundedSemaphore(
            max(config.scheduler.max_num_seqs, 1))
        self.chunk_frames = cfg.n_audio_ctx * 2
        # langs actually present in this vocab
        self.languages = LANGUAGES[: cfg.n_langs]

    def _init_shard(self, config: EngineConfig, device, params, ranks):
        """The device side: this rank's parameters (all of them on one
        device), its heads (``local``), the suppression masks and the
        table of live requests."""
        cfg = self.cfg
        self.ranks = ranks
        self.local = cfg
        rank, tp = 0, 1
        if ranks is not None:
            device = ranks.device
            rank, tp = ranks.rank, ranks.size
            ranks.shard = ln.Shard.of(cfg, rank, tp)
            self.local = dataclasses.replace(
                cfg, num_heads=ranks.shard.local(ln.HEADS, cfg.num_heads),
                num_kv_heads=ranks.shard.local(ln.KV_HEADS,
                                               cfg.num_kv_heads))
        self.device = resolve_device(device)
        if params is not None and ranks is not None:
            # every rank gets the whole tree (on the CPU) and keeps its cut
            params = to_device(shard_params(params, cfg, rank, tp),
                               self.device)
        self.params = params if params is not None else init_or_load(
            cfg, config.seed, self.device, rank, tp)
        # vocab layout: eot < sot < langs < tasks < ... < notimestamps <
        # timestamps. Default mode suppresses everything above eot;
        # timestamp mode re-admits the timestamp tokens
        self._ids = torch.arange(cfg.vocab_size, device=self.device)
        self._special = self._ids > cfg.eot_id
        self._non_ts_special = self._special & (
            self._ids <= cfg.notimestamps_id)
        self._live: dict[int, _Live] = {}

    @property
    def dev(self):
        """What runs the handle calls: rank 0's mirrored runner where this
        runner started the ranks, else this runner."""
        return self._mirror if self._mirror is not None else self

    def close(self) -> None:
        """Stop the ranks this runner started (nothing at tp 1)."""
        if self._mirror is not None:
            with self.lock:
                self._mirror.close()

    def held_by_rank(self) -> list[dict]:
        """Every rank's ``held_bytes``, rank 0's first (this runner's own
        at tp 1)."""
        if self._mirror is None:
            return [self.held_bytes()]
        with self.lock:
            return self._mirror.gather("held_bytes")

    def follower_reports(self) -> list[dict]:
        """Every rank's agreement report (``MirroredRunner``): digest,
        calls, live handles and kernel launches, rank 0's first."""
        if self._mirror is None:
            raise RuntimeError("no tensor-parallel ranks: tp 1")
        with self.lock:
            return self._mirror.follower_reports()

    # -- device programs ----------------------------------------------------

    @torch.inference_mode()
    def _encode(self, features: np.ndarray):
        """Encoder and every layer's cross K/V of one clip's features."""
        mel = torch.as_tensor(np.asarray(features, np.float32),
                              device=self.device)[None]
        enc = W.encode(self.cfg, self.params, mel, self.ranks)
        return W.cross_kv(self.cfg, self.params, enc)

    @torch.inference_mode()
    def _dec_prefill(self, ck, cv, tokens: list[int], valid: int):
        """Decoder prefill over the (bucketed) forced tokens into a fresh
        self-attention cache; returns (cache, logits (V,) at the LAST REAL
        position, which seed generation)."""
        cfg = self.cfg
        kv = W.init_self_kv(self.local, 1, cfg.max_model_len, self.device)
        logits, kv = W.decode_tokens(
            cfg, self.params, torch.tensor([tokens], device=self.device),
            [0], kv, ck, cv, [valid], self.ranks)
        return kv, logits[0, valid - 1]

    def _suppress(self, logits: torch.Tensor, n_gen: int, timestamps: bool,
                  last_ts: int, ts_run: int) -> torch.Tensor:
        cfg = self.cfg
        mask = self._non_ts_special if timestamps else self._special
        mask = mask | timestamp_suppress_mask(cfg, self._ids, timestamps,
                                              last_ts, ts_run)
        logits = logits.masked_fill(mask, -torch.inf)
        if n_gen < 1:
            logits[cfg.eot_id] = -torch.inf
        return logits

    def _sample(self, st: _Decode, temperature: float, timestamps: bool):
        """-> (token (device scalar), its log-probability under the
        suppressed distribution: verbose_json's avg_logprob input)."""
        logits = self._suppress(st.logits, st.n_gen, timestamps,
                                st.last_ts, st.ts_run)
        if temperature > 0.0:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            tok = torch.multinomial(probs, 1, generator=st.gen)[0]
        else:
            tok = torch.argmax(logits)
        return tok, torch.log_softmax(logits, dim=-1)[tok]

    @torch.inference_mode()
    def _chunk(self, st: _Decode, ck, cv, limit: int, temperature: float,
               timestamps: bool, n: Optional[int] = None,
               ) -> tuple[list[int], list[float], bool]:
        """Generate up to ``n`` (default ``DECODE_CHUNK``) tokens from
        ``st.logits``; returns (tokens, their logprobs, whether eot ended
        it). A step whose logits no later step reads (after eot or at
        ``limit``) skips the decoder."""
        n = DECODE_CHUNK if n is None else n
        cfg = self.cfg
        toks: list[int] = []
        lps: list[torch.Tensor] = []
        done = False
        while not done and len(toks) < n and st.cur < limit:
            tok_t, logp = self._sample(st, temperature, timestamps)
            tok = int(tok_t)
            toks.append(tok)
            lps.append(logp)
            done = tok == cfg.eot_id
            if not done and st.cur + 1 < limit:
                logits, st.kv = W.decode_tokens(
                    cfg, self.params, tok_t.view(1, 1), [st.cur], st.kv,
                    ck, cv, [1], self.ranks)
                st.logits = logits[0, 0]
            st.cur += 1
            # n_gen counts TEXT tokens: a leading <|0.00|> must not
            # satisfy "at least one text token"
            if tok < cfg.eot_id:
                st.n_gen += 1
            if tok > cfg.notimestamps_id:
                st.last_ts = max(st.last_ts, tok)
                st.ts_run += 1
            else:
                st.ts_run = 0
        out_lp = torch.stack(lps).tolist() if lps else []
        return toks, out_lp, done

    # -- a request's device state, by handle (module docstring) -------------

    def encode_request(self, handle: int, features: np.ndarray) -> None:
        """Encode one clip's features into ``handle``'s cross K/V."""
        ck, cv = self._encode(features)
        self._live[handle] = _Live(ck, cv)

    def sot_request(self, handle: int) -> np.ndarray:
        """``_sot_logits`` of ``handle``'s clip."""
        req = self._live[handle]
        return self._sot_logits(req.ck, req.cv)

    def prefill_request(self, handle: int, tokens: list[int], valid: int,
                        seed: int) -> None:
        """Prefill ``handle``'s forced tokens (``valid`` of them real) and
        seed its generator."""
        req = self._live[handle]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        kv, last = self._dec_prefill(req.ck, req.cv, tokens, valid)
        req.st = _Decode(kv=kv, logits=last, cur=valid, gen=gen)

    def chunk_request(self, handle: int, limit: int, temperature: float,
                      timestamps: bool, n: int,
                      ) -> tuple[list[int], list[float], bool]:
        """``_chunk`` of ``handle``'s decode state, up to ``n`` tokens (the
        leader's chunk size, sent with the call)."""
        req = self._live[handle]
        return self._chunk(req.st, req.ck, req.cv, limit, temperature,
                           timestamps, n)

    def free(self, handle: int) -> None:
        """Drop ``handle``'s device state (none held is no fault: a
        request may end before its encode)."""
        self._live.pop(handle, None)

    def live_handles(self) -> list[int]:
        """The handles whose device state this rank holds."""
        return sorted(self._live)

    def held_bytes(self) -> dict:
        """Device bytes this rank holds: its parameters, and each live
        request's cross K/V and self-attention cache."""
        def leaves(tree):
            for v in tree.values():
                yield from leaves(v) if isinstance(v, dict) else (v,)

        return {"params": sum(t.nbytes for t in leaves(self.params)),
                "requests": {h: r.ck.nbytes + r.cv.nbytes
                             + (r.st.kv.nbytes if r.st is not None else 0)
                             for h, r in self._live.items()}}

    # -- host-side API ------------------------------------------------------

    def _usable_buckets(self) -> list[int]:
        # a bucket must leave at least one decode slot in the context
        return [b for b in PROMPT_BUCKETS if b < self.cfg.max_model_len]

    def _bucket(self, n: int) -> int:
        for b in self._usable_buckets():
            if n <= b:
                return b
        raise audio_fe.AudioError(
            f"prompt of {n} tokens exceeds the decoder context "
            f"({self.cfg.max_model_len})"
        )

    def _forced_tokens(self, language: Optional[str], task: str,
                       prompt: Optional[str],
                       timestamps: bool = False) -> list[int]:
        cfg = self.cfg
        forced: list[int] = []
        if prompt:
            ids = self.tokenizer.encode(prompt, add_bos=False)
            # truncate from the LEFT (keep recent context, as upstream)
            # to the largest prompt bucket this model can serve; with none
            # (max_model_len <= 8) ``_bucket`` refuses every request
            keep = max((self._usable_buckets() or [0])[-1] - 5, 1)
            forced += [cfg.sot_prev_id] + ids[-keep:]
        forced.append(cfg.sot_id)
        if language is not None:
            try:
                lang_idx = self.languages.index(language)
            except ValueError:
                raise audio_fe.AudioError(
                    f"unsupported language {language!r}; supported: "
                    f"{', '.join(self.languages)}"
                ) from None
            forced.append(cfg.lang_base_id + lang_idx)
        forced.append(cfg.translate_id if task == "translate"
                      else cfg.transcribe_id)
        if not timestamps:  # timestamp mode lets the model emit <|t.tt|>
            forced.append(cfg.notimestamps_id)
        return forced

    def strip_timestamps(self, tokens: list[int]) -> list[int]:
        """Drop <|t.tt|> tokens before plain-text decoding."""
        return [t for t in tokens if t <= self.cfg.notimestamps_id]

    def segments_from_tokens(self, tokens: list[int], duration: float,
                             logprobs: Optional[list[float]] = None,
                             ) -> list[dict]:
        """Split a timestamp-mode token stream into segments.

        Timestamp tokens encode ``(id - notimestamps_id - 1) * 0.02``
        seconds; text between a start and end timestamp is one segment.
        Lenient parse (the decoder is not grammar-constrained): an
        unclosed final segment ends at the clip duration. ``logprobs``
        (aligned with ``tokens``) adds per-segment ``avg_logprob``;
        ``compression_ratio`` (OpenAI schema: gzip-incompressibility of
        the text, the repetition-loop detector) is always computed."""
        cfg = self.cfg
        base = cfg.notimestamps_id + 1
        lps = logprobs if logprobs and len(logprobs) == len(tokens) \
            else [0.0] * len(tokens)

        def ts(tok):
            return (tok - base) * 0.02

        def emit(start, end, text_toks, text_lps):
            text = self.tokenizer.decode(text_toks)
            raw = text.encode() or b" "
            return {
                "start": round(start, 2), "end": round(end, 2),
                "tokens": text_toks, "text": text,
                "avg_logprob": round(
                    sum(text_lps) / max(len(text_lps), 1), 4),
                "compression_ratio": round(
                    len(raw) / max(len(zlib.compress(raw)), 1), 3),
            }

        segments: list[dict] = []
        start = 0.0
        text_toks: list[int] = []
        text_lps: list[float] = []
        for t, lp in zip(tokens, lps):
            if t > cfg.notimestamps_id:  # timestamp token
                if text_toks:
                    # ungrammatical decodes can emit a smaller timestamp
                    # after a larger one: clamp so no cue ever has
                    # start > end (subtitle players reject those)
                    segments.append(
                        emit(start, max(ts(t), start), text_toks,
                             text_lps))
                    text_toks, text_lps = [], []
                start = ts(t)
            elif t != cfg.eot_id:
                text_toks.append(t)
                text_lps.append(lp)
        if text_toks:
            segments.append(
                emit(start, max(duration, start), text_toks, text_lps))
        return segments

    def _sot_logits(self, ck, cv) -> np.ndarray:
        """Next-token logits at the <|startoftranscript|> position
        (prefill of the bare SOT token). Caller holds the lock and
        supplies the shared cross K/V. Feeds both language detection and
        ``no_speech_prob``: Whisper defines the no-speech probability
        here, before the forced task/language tokens condition the model
        toward text."""
        P = PROMPT_BUCKETS[0]
        tokens = [self.cfg.sot_id] + [0] * (P - 1)
        _, last = self._dec_prefill(ck, cv, tokens, 1)
        return last.cpu().numpy()

    def _language_of(self, sot_logits: np.ndarray) -> str:
        """argmax over the language tokens after <|startoftranscript|>."""
        cfg = self.cfg
        lang_logits = sot_logits[cfg.lang_base_id:cfg.lang_base_id
                                 + cfg.n_langs]
        return self.languages[int(np.argmax(lang_logits))]

    def detect_language(self, features: np.ndarray) -> str:
        handle = next(self._handles)
        with self.lock:
            try:
                self.dev.encode_request(handle, features)
                return self._language_of(self.dev.sot_request(handle))
            finally:
                self.dev.free(handle)

    def validate_request(self, language: Optional[str], task: str,
                         prompt: Optional[str]) -> None:
        """Raise AudioError for bad language/oversized prompt BEFORE any
        device work (the server maps it to 400: after the SSE stream has
        started a late error can only kill the connection)."""
        self._bucket(len(self._forced_tokens(
            language if language is not None else
            (self.languages[0] if self.languages else None),
            task, prompt)))

    def transcribe_stream(
        self,
        features: np.ndarray,           # (n_mels, chunk_frames)
        language: Optional[str] = None,
        task: str = "transcribe",
        prompt: Optional[str] = None,
        temperature: float = 0.0,
        max_tokens: Optional[int] = None,
        seed: int = 0,
        info: Optional[dict] = None,
        timestamps: bool = False,
    ) -> Iterator[list[int]]:
        """Yields lists of newly generated token ids (eot stripped; with
        ``timestamps`` the stream includes <|t.tt|> tokens: see
        ``segments_from_tokens``). ``info`` (if given) receives the used
        or detected ``language`` and ``no_speech_prob`` before the first
        yield, and ``logprobs`` aligned with every yielded token."""
        cfg = self.cfg
        dev = self.dev
        # admission: bound the number of requests holding live device
        # buffers; the finally frees them and releases the slot when the
        # generator finishes or is closed
        self.admit.acquire()
        handle = next(self._handles)
        try:
            with self.lock:
                # ONE encoder pass shared by detection and transcription,
                # and ONE SOT prefill shared by language detection and
                # the no-speech probability
                dev.encode_request(handle, features)
                sot_logits = None
                if (language is None and cfg.n_langs) or info is not None:
                    sot_logits = dev.sot_request(handle)
                if language is None and cfg.n_langs:
                    language = self._language_of(sot_logits)
            if info is not None:
                info["language"] = language
                # Whisper's VAD signal: P(<|nospeech|>) at the SOT
                # position (nospeech sits right below notimestamps)
                z = sot_logits.astype(np.float64)
                e = np.exp(z - z.max())
                info["no_speech_prob"] = float(
                    e[cfg.notimestamps_id - 1] / e.sum())
            forced = self._forced_tokens(language, task, prompt,
                                         timestamps=timestamps)
            P = self._bucket(len(forced))
            n_forced = len(forced)
            limit = cfg.max_model_len
            if max_tokens is not None:
                limit = min(limit, n_forced + max(int(max_tokens), 1))
            with self.lock:
                dev.prefill_request(handle, forced + [0] * (P - n_forced),
                                    n_forced, seed)
            done = False
            while not done:
                # lock per CHUNK, not per request: every request's decode
                # state is its own tensors, so admitted transcriptions
                # interleave at chunk granularity
                n = DECODE_CHUNK
                with self.lock:
                    out, out_lp, eot = dev.chunk_request(
                        handle, limit, temperature, timestamps, n)
                done = eot or len(out) < n
                kept = [(t, lp) for t, lp in zip(out, out_lp)
                        if t != cfg.eot_id]
                if info is not None:  # aligned with every yielded token
                    info.setdefault("logprobs", []).extend(
                        lp for _, lp in kept)
                yield [t for t, _ in kept]
        finally:
            try:
                with self.lock:  # the request's cross and self K/V
                    dev.free(handle)
            finally:
                self.admit.release()

    def transcribe(self, features: np.ndarray, **kw) -> list[int]:
        out: list[int] = []
        for piece in self.transcribe_stream(features, **kw):
            out.extend(piece)
        return out
