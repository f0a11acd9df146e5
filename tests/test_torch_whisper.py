"""The port's Whisper path against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and the port's: ``layer_norm`` within 1e-5; the audio front end bit for
bit (it is the same numpy); ``encode``, ``cross_kv`` and ``decode_tokens``
on float32 tiny-whisper with the JAX ``init_params`` exported through
``params_from_jax``: hidden states within 1e-5, logits within 1e-4;
``timestamp_suppress_mask`` bit for bit; the two ``WhisperRunner``s on the
same features: greedy tokens identical up to an argmax near-tie (a step
whose top-2 logprob gap is under ``TIE_GAP``), ``no_speech_prob`` and
token logprobs within 1e-4, the detected language and the segments
equal. Then the runner's admission bound and chunk interleave, as the
reference's tests hold them (tests/test_whisper.py), and the HF loader on
a checkpoint written here in numpy.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import audio as JA
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.whisper_runner import WhisperRunner as JaxRunner
from production_stack_tpu.engine.whisper_runner import (
    timestamp_suppress_mask as jax_ts_mask,
)
from production_stack_tpu.models import whisper as JW
from production_stack_tpu.ops.norms import layer_norm as jax_layer_norm
from production_stack_tpu_torch.engine import audio as TA
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import whisper_runner as TWR
from production_stack_tpu_torch.engine.weights import (
    init_or_load,
    init_random,
    params_from_jax,
)
from production_stack_tpu_torch.models import whisper as TW
from production_stack_tpu_torch.ops.norms import layer_norm
from _torch_whisper import TIE_GAP, WAVS, features, make_wav, top2_gap

torch.set_num_threads(2)

HIDDEN_TOL = 1e-5
LOGIT_TOL = 1e-4
LP_TOL = 1e-4


# --- ops and the audio front end ---------------------------------------------

@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 1280), (1, 7, 20)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(2.0, 3.0, shape).astype(np.float32)
    w = rng.normal(1.0, 0.2, shape[-1:]).astype(np.float32)
    b = rng.normal(0.0, 0.2, shape[-1:]).astype(np.float32)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=HIDDEN_TOL, rtol=0)
    # bf16 in, bf16 out, computed in float32
    xb = torch.from_numpy(x).bfloat16()
    assert layer_norm(xb, torch.from_numpy(w).bfloat16(),
                      torch.from_numpy(b).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("width,channels,rate", [
    (1, 1, 8000), (2, 1, 8000), (4, 1, 22050), (2, 2, 44100), (4, 2, 16000)])
def test_audio_front_end_bit_for_bit(width, channels, rate):
    wav = make_wav(seconds=0.4, rate=rate, channels=channels, width=width)
    xa, ra = JA.decode_wav(wav)
    xb, rb = TA.decode_wav(wav)
    assert ra == rb and np.array_equal(xa, xb) and xa.dtype == xb.dtype
    assert np.array_equal(JA.resample(xa, ra), TA.resample(xb, rb))
    for n_mels, frames in ((20, 100), (80, 3000), (128, 3000)):
        fa, da = JA.wav_to_features(wav, n_mels, frames)
        fb, db = TA.wav_to_features(wav, n_mels, frames)
        assert da == db and fa.shape == fb.shape == (n_mels, frames)
        assert np.array_equal(fa, fb)
        assert np.array_equal(JA.mel_filterbank(n_mels),
                              TA.mel_filterbank(n_mels))


@pytest.mark.parametrize("payload", [b"ID3\x04not audio at all", b""])
def test_audio_front_end_refuses_garbage(payload):
    with pytest.raises(TA.AudioError, match="WAV"):
        TA.decode_wav(payload)
    with pytest.raises(JA.AudioError, match="WAV"):
        JA.decode_wav(payload)


# --- config -------------------------------------------------------------------

def _hf_whisper(vocab=51865, mels=80, **extra):
    return {"architectures": ["WhisperForConditionalGeneration"],
            "vocab_size": vocab, "d_model": 768, "decoder_layers": 12,
            "encoder_layers": 12, "decoder_attention_heads": 12,
            "encoder_attention_heads": 12, "decoder_ffn_dim": 3072,
            "num_mel_bins": mels, "max_source_positions": 1500,
            "max_target_positions": 448, **extra}


@pytest.mark.parametrize("hf", [
    _hf_whisper(),
    _hf_whisper(decoder_start_token_id=50258, eos_token_id=50257),
    _hf_whisper(vocab=51866, mels=128, d_model=1280,
                decoder_attention_heads=20, decoder_ffn_dim=5120),
    {k: v for k, v in _hf_whisper().items()
     if k not in ("decoder_ffn_dim", "num_mel_bins", "max_source_positions",
                  "max_target_positions")},
], ids=["v2", "v2-ids", "large-v3", "defaults"])
def test_from_hf_config_matches_reference(hf):
    mine = tcfg.ModelConfig.from_hf_config(hf, name="w")
    ref = jcfg.ModelConfig.from_hf_config(hf, name="w")
    for f in tcfg.ModelConfig.__dataclass_fields__:
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.architecture == "whisper"


def test_presets_are_the_references():
    for name in ("tiny-whisper", "whisper-small-class",
                 "whisper-large-v3-class"):
        mine = tcfg.ModelConfig.from_pretrained(name)
        ref = jcfg.ModelConfig.from_pretrained(name)
        assert dataclasses.asdict(mine) == {
            f: getattr(ref, f) for f in tcfg.ModelConfig.__dataclass_fields__}


# --- the model ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """float32 tiny-whisper: the JAX init and the same weights as the
    port's tensors."""
    jc = jcfg.ModelConfig.from_pretrained("tiny-whisper")
    tc = tcfg.ModelConfig.from_pretrained("tiny-whisper")
    jp = JW.init_params(jc, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jax.device_get(jp))
    return jc, jp, tc, params_from_jax(np_params, tc, "cpu")


def _mel(cfg, seed=0):
    return np.random.default_rng(seed).normal(
        size=(1, cfg.num_mel_bins, cfg.n_audio_ctx * 2)).astype(np.float32)


def _ref_kv(kv):
    """The reference's (Ld, 2, B, T_max, H, D) cache in the port's
    (Ld, 2, B, H, T_max, D) layout."""
    return np.asarray(kv).transpose(0, 1, 2, 4, 3, 5)


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_and_cross_kv_match_reference(tiny, seed):
    jc, jp, tc, tp = tiny
    mel = _mel(tc, seed)
    enc_j = JW.encode(jc, jp, jnp.asarray(mel))
    enc_t = TW.encode(tc, tp, torch.from_numpy(mel))
    assert enc_t.shape == (1, tc.n_audio_ctx, tc.hidden_size)
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j),
                               atol=HIDDEN_TOL, rtol=0)
    ck_j, cv_j = JW.cross_kv(jc, jp, enc_j)
    ck_t, cv_t = TW.cross_kv(tc, tp, enc_t)
    for got, want in ((ck_t, ck_j), (cv_t, cv_j)):  # (Ld, B, H, S, D)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want).transpose(0, 1, 3, 2, 4),
            atol=HIDDEN_TOL, rtol=0)


def _forced(cfg):
    return [cfg.sot_id, cfg.lang_base_id, cfg.transcribe_id,
            cfg.notimestamps_id]


@pytest.mark.parametrize("pad", [0, 4])
def test_decode_tokens_matches_reference(tiny, pad):
    """A (padded) prefill, then one incremental step, against the JAX
    decoder: logits and the cache's written slots."""
    jc, jp, tc, tp = tiny
    mel = _mel(tc, 2)
    ck_j, cv_j = JW.cross_kv(jc, jp, JW.encode(jc, jp, jnp.asarray(mel)))
    enc_t = TW.encode(tc, tp, torch.from_numpy(mel))
    ck_t, cv_t = TW.cross_kv(tc, tp, enc_t)
    toks = _forced(tc) + [0] * pad
    lj, kv_j = JW.decode_tokens(
        jc, jp, jnp.array([toks], jnp.int32), jnp.zeros((1,), jnp.int32),
        JW.init_self_kv(jc, 1, jc.max_model_len), ck_j, cv_j,
        jnp.array([4], jnp.int32))
    lt, kv_t = TW.decode_tokens(
        tc, tp, torch.tensor([toks]), [0],
        TW.init_self_kv(tc, 1, tc.max_model_len), ck_t, cv_t, [4])
    assert lt.dtype == torch.float32 and lt.shape == (1, len(toks),
                                                      tc.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(kv_t.numpy(), _ref_kv(kv_j),
                               atol=HIDDEN_TOL, rtol=0)
    nxt = int(np.argmax(np.asarray(lj)[0, 3]))
    lj2, _ = JW.decode_tokens(jc, jp, jnp.array([[nxt]], jnp.int32),
                              jnp.array([4], jnp.int32), kv_j, ck_j, cv_j,
                              jnp.array([1], jnp.int32))
    lt2, _ = TW.decode_tokens(tc, tp, torch.tensor([[nxt]]), [4], kv_t,
                              ck_t, cv_t, [1])
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2),
                               atol=LOGIT_TOL, rtol=0)


def test_decode_tokens_batch_of_two_offsets(tiny):
    """B = 2 rows at different offsets and valid lengths (the key mask of
    each row bounds at its own offset + valid_len) against JAX."""
    jc, jp, tc, tp = tiny
    mel = np.concatenate([_mel(tc, 4), _mel(tc, 5)])
    ck_j, cv_j = JW.cross_kv(jc, jp, JW.encode(jc, jp, jnp.asarray(mel)))
    ck_t, cv_t = TW.cross_kv(tc, tp, TW.encode(tc, tp, torch.from_numpy(mel)))
    kv_j = JW.init_self_kv(jc, 2, jc.max_model_len)
    kv_t = TW.init_self_kv(tc, 2, tc.max_model_len)
    steps = [([_forced(tc), _forced(tc)[:2] + [0, 0]], [0, 0], [4, 2]),
             ([[5, 6], [7, 8]], [4, 2], [2, 1]),
             ([[9, 10], [11, 0]], [6, 3], [1, 2])]
    for toks, off, valid in steps:
        lj, kv_j = JW.decode_tokens(
            jc, jp, jnp.array(toks, jnp.int32), jnp.array(off, jnp.int32),
            kv_j, ck_j, cv_j, jnp.array(valid, jnp.int32))
        lt, kv_t = TW.decode_tokens(tc, tp, torch.tensor(toks), off, kv_t,
                                    ck_t, cv_t, valid)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(kv_t.numpy(), _ref_kv(kv_j), atol=HIDDEN_TOL,
                               rtol=0)


def test_incremental_matches_dense(tiny):
    """Mirrors tests/test_whisper.py: a token decoded against the cache
    equals the same token in a dense pass."""
    _, _, tc, tp = tiny
    ck, cv = TW.cross_kv(tc, tp, TW.encode(tc, tp, torch.from_numpy(
        _mel(tc))))
    kv = TW.init_self_kv(tc, 1, tc.max_model_len)
    toks = torch.tensor([_forced(tc)])
    logits, kv = TW.decode_tokens(tc, tp, toks, [0], kv, ck, cv, [4])
    nxt = logits[0, 3].argmax().view(1, 1)
    inc, _ = TW.decode_tokens(tc, tp, nxt, [4], kv, ck, cv, [1])
    dense, _ = TW.decode_tokens(
        tc, tp, torch.cat([toks, nxt], 1), [0],
        TW.init_self_kv(tc, 1, tc.max_model_len), ck, cv, [5])
    assert float((inc[0, 0] - dense[0, 4]).abs().max()) < LOGIT_TOL


def test_padded_prefill_matches_exact(tiny):
    _, _, tc, tp = tiny
    ck, cv = TW.cross_kv(tc, tp, TW.encode(
        tc, tp, torch.zeros(1, tc.num_mel_bins, tc.n_audio_ctx * 2)))
    forced = _forced(tc)
    exact, _ = TW.decode_tokens(tc, tp, torch.tensor([forced]), [0],
                                TW.init_self_kv(tc, 1, tc.max_model_len),
                                ck, cv, [4])
    padded, _ = TW.decode_tokens(tc, tp, torch.tensor([forced + [0] * 4]),
                                 [0], TW.init_self_kv(tc, 1, tc.max_model_len),
                                 ck, cv, [4])
    assert float((padded[0, 3] - exact[0, 3]).abs().max()) < HIDDEN_TOL


def test_decode_positions_clip_and_writes_past_the_cache_drop(tiny):
    """Learned positions clip at max_model_len - 1 and cache writes past
    T_max are dropped, as the reference's masked update drops them."""
    jc, jp, tc, tp = tiny
    mel = _mel(tc, 6)
    ck_j, cv_j = JW.cross_kv(jc, jp, JW.encode(jc, jp, jnp.asarray(mel)))
    ck_t, cv_t = TW.cross_kv(tc, tp, TW.encode(tc, tp, torch.from_numpy(mel)))
    T_max = tc.max_model_len
    toks = [[3, 4, 5, 6]]
    lj, kv_j = JW.decode_tokens(
        jc, jp, jnp.array(toks, jnp.int32), jnp.array([T_max - 2], jnp.int32),
        JW.init_self_kv(jc, 1, T_max), ck_j, cv_j, jnp.array([4], jnp.int32))
    lt, kv_t = TW.decode_tokens(tc, tp, torch.tensor(toks), [T_max - 2],
                                TW.init_self_kv(tc, 1, T_max), ck_t, cv_t,
                                [4])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(kv_t.numpy(), _ref_kv(kv_j), atol=HIDDEN_TOL,
                               rtol=0)


def test_init_params_follows_the_reference_scheme():
    cfg = tcfg.ModelConfig.from_pretrained("tiny-whisper")
    a = init_random(cfg, seed=3)
    b = init_random(cfg, seed=3)
    c = init_random(cfg, seed=4)
    shapes = TW.param_shapes(cfg)
    for part in ("enc", "dec"):
        for name, shape in shapes[part]["layers"].items():
            t = a[part]["layers"][name]
            assert tuple(t.shape) == shape and t.dtype == torch.float32
            if name.endswith("norm_w"):
                assert torch.all(t == 1)
            elif name.endswith("_b") or name in ("bq", "bv", "bo", "cbq",
                                                 "cbv", "cbo"):
                assert torch.all(t == 0)
    assert torch.equal(a["dec"]["layers"]["fc1"], b["dec"]["layers"]["fc1"])
    assert not torch.equal(a["dec"]["layers"]["fc1"],
                           c["dec"]["layers"]["fc1"])
    assert tuple(a["enc"]["conv1_w"].shape) == (cfg.hidden_size,
                                                cfg.num_mel_bins, 3)
    assert a["enc"]["conv1_w"].std().item() == pytest.approx(
        (3 * cfg.num_mel_bins) ** -0.5, rel=0.1)
    assert a["dec"]["layers"]["fc2"].std().item() == pytest.approx(
        cfg.intermediate_size ** -0.5, rel=0.1)


def test_params_from_jax_transposes_the_convs(tiny):
    jc, jp, tc, tp = tiny
    np.testing.assert_array_equal(
        tp["enc"]["conv1_w"].numpy(),
        np.asarray(jp["enc"]["conv1_w"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(tp["dec"]["layers"]["cwo"].numpy(),
                                  np.asarray(jp["dec"]["layers"]["cwo"]))


# --- suppression ------------------------------------------------------------------

@pytest.mark.parametrize("ts_run", [0, 1, 2, 3])
@pytest.mark.parametrize("timestamps", [True, False])
def test_timestamp_suppress_mask_bit_for_bit(ts_run, timestamps):
    cfg = tcfg.ModelConfig.from_pretrained("tiny-whisper")
    jc = jcfg.ModelConfig.from_pretrained("tiny-whisper")
    base = cfg.notimestamps_id + 1
    ids_t = torch.arange(cfg.vocab_size)
    ids_j = jnp.arange(cfg.vocab_size, dtype=jnp.int32)
    for last_ts in (0, base, base + 2, cfg.vocab_size - 1):
        want = np.asarray(jax_ts_mask(jc, ids_j, jnp.bool_(timestamps),
                                      jnp.int32(last_ts), jnp.int32(ts_run)))
        got = TWR.timestamp_suppress_mask(cfg, ids_t, timestamps, last_ts,
                                          ts_run).numpy()
        assert np.array_equal(got, want), last_ts


# --- the runner -----------------------------------------------------------------

@pytest.fixture(scope="module")
def runners():
    """The JAX runner (its seed-0 init) and the port's on its weights."""
    jr = JaxRunner(jcfg.EngineConfig.for_model("tiny-whisper"))
    np_params = jax.tree.map(np.asarray, jax.device_get(jr.params))
    tc = tcfg.EngineConfig.for_model("tiny-whisper")
    tr = TWR.WhisperRunner(tc, device="cpu",
                           params=params_from_jax(np_params, tc.model, "cpu"))
    return jr, tr


def assert_same_run(tr, feats, kw, want, got, want_info, got_info):
    """Tokens identical up to a near-tie; the logprobs before it within
    LP_TOL; language and no_speech_prob as the reference's."""
    n = len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            gap = top2_gap(tr, feats, kw, want[:i])
            assert gap < TIE_GAP, (i, a, b, gap)
            n = i
            break
    else:
        assert len(want) == len(got)
    assert got_info["language"] == want_info["language"]
    assert abs(got_info["no_speech_prob"]
               - want_info["no_speech_prob"]) <= LP_TOL
    assert len(got_info["logprobs"]) == len(got)
    np.testing.assert_allclose(got_info["logprobs"][:n],
                               want_info["logprobs"][:n], atol=LP_TOL, rtol=0)


CASES = {
    "detect": dict(),
    "transcribe": dict(language="en"),
    "translate": dict(language="en", task="translate"),
    "prompt": dict(language="en", prompt="hello context"),
    "timestamps": dict(language="en", timestamps=True),
    "max-tokens": dict(language="en", max_tokens=3),
    "other-language": dict(language=None, task="translate", prompt="x"),
}


@pytest.mark.parametrize("wav", list(WAVS))
@pytest.mark.parametrize("case", list(CASES))
def test_runner_greedy_matches_reference(runners, wav, case):
    jr, tr = runners
    feats = features(tr, wav)
    kw = CASES[case]
    want_info, got_info = {}, {}
    want = jr.transcribe(feats, info=want_info, **kw)
    got = tr.transcribe(feats, info=got_info, **kw)
    assert got, "nothing generated"
    assert_same_run(tr, feats, kw, want, got, want_info, got_info)
    if case == "max-tokens":
        assert len(got) <= 3
    if kw.get("timestamps"):
        cfg = tr.cfg
        assert all(t < cfg.eot_id or t > cfg.notimestamps_id for t in got)
        assert tr.segments_from_tokens(got, 0.5, got_info["logprobs"]) == \
            jr.segments_from_tokens(got, 0.5, got_info["logprobs"])
    else:
        assert all(t < tr.cfg.eot_id for t in got)


@pytest.mark.parametrize("wav", list(WAVS))
def test_detect_language_matches_reference(runners, wav):
    jr, tr = runners
    assert tr.detect_language(features(tr, wav)) == \
        jr.detect_language(features(jr, wav))


def test_segments_from_tokens_equal(runners):
    jr, tr = runners
    cfg = tr.cfg
    base = cfg.notimestamps_id + 1
    lists = [
        [base + 0, 10, 11, base + 2, base + 2, 12, 13],
        [10, 11, cfg.eot_id],
        [base + 5, 10, base + 3, 11, 12],  # a smaller timestamp: clamped
        [base, base + 1, 65, 66, base + 4],
        [],
    ]
    for toks in lists:
        lps = [-0.1 * (i + 1) for i in range(len(toks))]
        for lp in (None, lps):
            assert tr.segments_from_tokens(toks, 1.0, lp) == \
                jr.segments_from_tokens(toks, 1.0, lp)
    assert tr.strip_timestamps(lists[0]) == jr.strip_timestamps(lists[0])


def test_sampled_decode_is_seeded_and_suppressed(runners):
    """Sampling draws from the request's own generator (a stream other
    than JAX's): the same seed gives the same tokens, and suppression
    holds."""
    _, tr = runners
    feats = features(tr, "noise-44k-stereo")
    a = tr.transcribe(feats, language="en", temperature=1.0, seed=7)
    b = tr.transcribe(feats, language="en", temperature=1.0, seed=7)
    c = tr.transcribe(feats, language="en", temperature=1.0, seed=8)
    assert a == b and a != c
    assert all(t < tr.cfg.eot_id for t in a + c)


@pytest.mark.parametrize("kw,match", [
    (dict(language="xx"), "unsupported language"),
    (dict(language="klingon", task="translate"), "unsupported language"),
])
def test_validate_request_refuses_as_reference(runners, kw, match):
    jr, tr = runners
    for r in (jr, tr):
        with pytest.raises(ValueError, match=match):
            r.validate_request(kw["language"], kw.get("task", "transcribe"),
                               None)


def test_no_bucket_refuses_a_prompt_cleanly():
    """With max_model_len <= 8 no prompt bucket is usable: every request
    is refused with AudioError (a 400). The reference raises IndexError
    (a 500) when the request also carries a prompt."""
    cfg = tcfg.EngineConfig.for_model("tiny-whisper", max_model_len=8)
    tr = TWR.WhisperRunner(cfg, device="cpu")
    for prompt in (None, "a prompt"):
        with pytest.raises(TA.AudioError, match="exceeds the decoder"):
            tr.validate_request("en", "transcribe", prompt)
    jr = JaxRunner(jcfg.EngineConfig.for_model("tiny-whisper",
                                               max_model_len=8))
    with pytest.raises(JA.AudioError, match="exceeds the decoder"):
        jr.validate_request("en", "transcribe", None)
    with pytest.raises(IndexError):
        jr.validate_request("en", "transcribe", "a prompt")


def test_runner_refuses_what_it_cannot_serve():
    with pytest.raises(ValueError, match="not a whisper model"):
        TWR.WhisperRunner(tcfg.EngineConfig.for_model("tiny-llama"),
                          device="cpu")
    with pytest.raises(ValueError, match="not served for Whisper"):
        TWR.WhisperRunner(tcfg.EngineConfig.for_model("tiny-whisper",
                                                      quant="int8"),
                          device="cpu")
    from production_stack_tpu_torch.engine.model_runner import ModelRunner

    with pytest.raises(ValueError, match="WhisperRunner"):
        ModelRunner(tcfg.EngineConfig.for_model("tiny-whisper"),
                    device="cpu")


def test_runner_concurrent_transcriptions_interleave(runners):
    """The chunk-granular lock lets concurrent requests make progress
    together and keeps results identical to sequential runs."""
    _, tr = runners
    feats = features(tr)
    expected = tr.transcribe(feats, language="en")
    results = {}

    def worker(i):
        results[i] = tr.transcribe(feats, language="en")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    [t.start() for t in threads]
    [t.join(60) for t in threads]
    assert not any(t.is_alive() for t in threads)
    assert all(results[i] == expected for i in range(3))


def test_runner_no_head_of_line_blocking(monkeypatch):
    """A slow-consuming stream must not block a second request: with
    4-token chunks, request B completes while A sits mid-stream."""
    monkeypatch.setattr(TWR, "DECODE_CHUNK", 4)
    r = TWR.WhisperRunner(tcfg.EngineConfig.for_model("tiny-whisper"),
                          device="cpu")
    feats = features(r)
    a_stream = r.transcribe_stream(feats, language="en")
    first = next(a_stream)
    assert len(first) == 4
    done_b = threading.Event()

    def b():
        r.transcribe(feats, language="en")
        done_b.set()

    t = threading.Thread(target=b)
    t.start()
    assert done_b.wait(timeout=60), "B never completed while A was parked"
    rest = [tok for piece in a_stream for tok in piece]
    t.join(60)
    assert first + rest == r.transcribe(feats, language="en")


def test_runner_admission_bound():
    """The admission semaphore bounds live decode states to
    scheduler.max_num_seqs; closing a stream frees its slot."""
    cfg = tcfg.EngineConfig.for_model(
        "tiny-whisper", scheduler=tcfg.SchedulerConfig(max_num_seqs=1))
    r = TWR.WhisperRunner(cfg, device="cpu")
    feats = features(r)
    a = r.transcribe_stream(feats, language="en")
    next(a)  # holds the single admission slot
    b = r.transcribe_stream(feats, language="en")
    started = threading.Event()

    def try_b():
        next(b)
        started.set()

    t = threading.Thread(target=try_b, daemon=True)
    t.start()
    assert not started.wait(timeout=1.0), "admitted past max_num_seqs=1"
    a.close()  # releases the slot
    assert started.wait(timeout=60), "slot never released on close"
    b.close()
    t.join(10)
    # both slots are back: a third request runs to the end
    assert r.transcribe(feats, language="en", max_tokens=2)


# --- the HF loader ----------------------------------------------------------------

def _hf_tensors(cfg, params) -> dict:
    """The JAX tree in the WhisperForConditionalGeneration layout."""
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim

    def proj(w):  # (E, H, D) -> (H*D, E)
        return np.asarray(w).transpose(1, 2, 0).reshape(H * D, E)

    def out(w):  # (H, D, E) -> (E, H*D)
        return np.asarray(w).reshape(H * D, E).T

    t = {}
    enc, dec = params["enc"], params["dec"]
    for which in ("conv1", "conv2"):
        t[f"model.encoder.{which}.weight"] = np.asarray(
            enc[f"{which}_w"]).transpose(2, 1, 0)
        t[f"model.encoder.{which}.bias"] = np.asarray(enc[f"{which}_b"])
    t["model.encoder.layer_norm.weight"] = np.asarray(enc["final_norm_w"])
    t["model.encoder.layer_norm.bias"] = np.asarray(enc["final_norm_b"])
    t["model.decoder.embed_tokens.weight"] = np.asarray(dec["embed"])
    t["model.decoder.embed_positions.weight"] = np.asarray(dec["pos"])
    t["model.decoder.layer_norm.weight"] = np.asarray(dec["final_norm_w"])
    t["model.decoder.layer_norm.bias"] = np.asarray(dec["final_norm_b"])
    # HF also stores these two, which neither loader reads
    t["model.encoder.embed_positions.weight"] = np.zeros(
        (cfg.n_audio_ctx, E), np.float32)
    t["proj_out.weight"] = np.asarray(dec["embed"])

    def block(prefix, L, n, cross):
        names = [("self_attn", ""), ("encoder_attn", "c")] if cross else [
            ("self_attn", "")]
        for i in range(n):
            b = f"{prefix}.{i}"
            for attn, c in names:
                ln = ("self_attn_layer_norm" if not c
                      else "encoder_attn_layer_norm")
                norm = "attn_norm" if not c else "cross_norm"
                t[f"{b}.{ln}.weight"] = np.asarray(L[f"{norm}_w"][i])
                t[f"{b}.{ln}.bias"] = np.asarray(L[f"{norm}_b"][i])
                for p in ("q", "k", "v"):
                    t[f"{b}.{attn}.{p}_proj.weight"] = proj(L[f"{c}w{p}"][i])
                for p in ("q", "v"):
                    t[f"{b}.{attn}.{p}_proj.bias"] = np.asarray(
                        L[f"{c}b{p}"][i]).reshape(-1)
                t[f"{b}.{attn}.out_proj.weight"] = out(L[f"{c}wo"][i])
                t[f"{b}.{attn}.out_proj.bias"] = np.asarray(L[f"{c}bo"][i])
            t[f"{b}.final_layer_norm.weight"] = np.asarray(L["mlp_norm_w"][i])
            t[f"{b}.final_layer_norm.bias"] = np.asarray(L["mlp_norm_b"][i])
            t[f"{b}.fc1.weight"] = np.asarray(L["fc1"][i]).T
            t[f"{b}.fc1.bias"] = np.asarray(L["fc1_b"][i])
            t[f"{b}.fc2.weight"] = np.asarray(L["fc2"][i]).T
            t[f"{b}.fc2.bias"] = np.asarray(L["fc2_b"][i])

    block("model.encoder.layers", enc["layers"], cfg.encoder_layers, False)
    block("model.decoder.layers", dec["layers"], cfg.num_layers, True)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in t.items()}


HF_CONFIG = {
    "architectures": ["WhisperForConditionalGeneration"],
    "vocab_size": 51865, "d_model": 64, "decoder_layers": 2,
    "encoder_layers": 2, "decoder_attention_heads": 4,
    "encoder_attention_heads": 4, "decoder_ffn_dim": 128,
    "num_mel_bins": 20, "max_source_positions": 50,
    "max_target_positions": 32}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny multilingual Whisper checkpoint (tiny-whisper's geometry,
    the 51865-token vocabulary) in the HF layout, written in numpy from
    the JAX init of seed 7, with its config.json."""
    import json

    from production_stack_tpu_torch.engine.lora import write_safetensors

    cfg = jcfg.ModelConfig.from_hf_config(HF_CONFIG)
    params = jax.tree.map(np.asarray, JW.init_params(
        dataclasses.replace(cfg, dtype="float32"), jax.random.PRNGKey(7)))
    d = tmp_path_factory.mktemp("whisper-ckpt")
    write_safetensors(str(d / "model.safetensors"), _hf_tensors(cfg, params))
    (d / "config.json").write_text(json.dumps(HF_CONFIG))
    return str(d), params


def test_hf_loader_matches_reference_loader(checkpoint):
    """``--model <dir>``: both packages read the same config.json to the
    same ModelConfig and load the checkpoint to the same parameters (the
    port's convs in its own layout), which are the source tree's."""
    from production_stack_tpu.engine.weights import init_or_load as jax_load
    from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh

    d, src = checkpoint
    tc = tcfg.ModelConfig.from_pretrained(d, dtype="float32")
    jc = jcfg.ModelConfig.from_pretrained(d, dtype="float32")
    for f in tcfg.ModelConfig.__dataclass_fields__:
        assert getattr(tc, f) == getattr(jc, f), f
    mine = init_or_load(tc, device="cpu")
    ref = jax.tree.map(np.asarray, jax_load(
        jc, build_mesh(MeshConfig(data=1, tensor=1))))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v

    got = dict(leaves(mine))
    want = params_from_jax(ref, tc, "cpu")
    from_src = params_from_jax(src, tc, "cpu")
    assert set(got) == set(dict(leaves(want)))
    for (name, w), (_, s) in zip(leaves(want), leaves(from_src)):
        assert torch.equal(got[name], w), name
        assert torch.equal(got[name], s), name


def test_hf_checkpoint_serves_the_references_tokens(checkpoint):
    """The runner on the loaded checkpoint gives the JAX runner's tokens
    on the JAX loader's parameters, with the vocabulary's special ids."""
    d, _ = checkpoint
    tr = TWR.WhisperRunner(tcfg.EngineConfig.for_model(d, dtype="float32"),
                           device="cpu")
    jr = JaxRunner(jcfg.EngineConfig.for_model(d, dtype="float32"))
    assert tr.cfg.eot_id == 50257 and tr.languages == jr.languages
    feats = features(tr)
    for kw in (dict(language="en"), dict(timestamps=True)):
        want_info, got_info = {}, {}
        want = jr.transcribe(feats, info=want_info, **kw)
        got = tr.transcribe(feats, info=got_info, **kw)
        assert_same_run(tr, feats, kw, want, got, want_info, got_info)


def test_hf_loader_names_a_missing_tensor(tmp_path, checkpoint):
    from production_stack_tpu_torch.engine.lora import (
        read_safetensors,
        write_safetensors,
    )

    d, _ = checkpoint
    tensors = read_safetensors(f"{d}/model.safetensors")
    del tensors["model.decoder.layers.1.fc2.bias"]
    write_safetensors(str(tmp_path / "model.safetensors"), tensors)
    cfg = dataclasses.replace(tcfg.ModelConfig.from_pretrained(d),
                              weights_path=str(tmp_path))
    with pytest.raises(KeyError, match="layers.1.fc2.bias"):
        init_or_load(cfg, device="cpu")
    # a tensor of another geometry is refused by name
    tensors = read_safetensors(f"{d}/model.safetensors")
    tensors["model.encoder.conv1.weight"] = np.zeros((64, 80, 3), np.float32)
    write_safetensors(str(tmp_path / "model.safetensors"), tensors)
    with pytest.raises(ValueError, match="conv1.weight has shape"):
        init_or_load(cfg, device="cpu")
