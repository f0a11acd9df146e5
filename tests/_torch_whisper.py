"""Helpers of the port's Whisper tests (``test_torch_whisper``,
``test_torch_whisper_server``, ``test_torch_cuda``): seeded WAV clips,
their features, and the near-tie measure of a greedy decode. They import
neither JAX nor the JAX package, so the card's tests can use them.
"""

import io
import wave

import numpy as np
import torch

from production_stack_tpu_torch.engine import audio as TA
from production_stack_tpu_torch.models import whisper as TW

# two greedy runs may part only where the top-2 logprob gap of the
# suppressed logits is under this: float rounding may pick either token
TIE_GAP = 1e-4


def make_wav(seconds=0.5, rate=8000, freq=440.0, channels=1, width=2,
             kind="tone", seed=0) -> bytes:
    """A PCM WAV: a sine tone, seeded noise or silence."""
    n = int(rate * seconds)
    if kind == "tone":
        x = np.sin(2 * np.pi * freq * np.arange(n) / rate)
    elif kind == "noise":
        x = np.random.default_rng(seed).uniform(-0.5, 0.5, n)
    else:
        x = np.zeros(n)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        if width == 2:
            frames = (x * 20000).astype(np.int16)
        elif width == 4:
            frames = x.astype(np.float32)
        else:
            frames = ((x * 100) + 128).astype(np.uint8)
        if channels > 1:
            frames = np.repeat(frames[:, None], channels, axis=1)
        w.writeframes(frames.tobytes())
    return buf.getvalue()


WAVS = {
    "tone-8k": dict(seconds=0.5, rate=8000),
    "noise-44k-stereo": dict(seconds=0.7, rate=44100, channels=2,
                             kind="noise", seed=3),
    "silence-16k": dict(seconds=0.3, rate=16000, kind="silence"),
}


def features(runner, wav="tone-8k"):
    cfg = runner.cfg
    return TA.wav_to_features(make_wav(**WAVS[wav]), cfg.num_mel_bins,
                              runner.chunk_frames)[0]


def top2_gap(tr, feats, kw, prefix):
    """The top-2 logprob gap of the suppressed logits after ``prefix``
    (the port's model on the CPU, a dense pass): how near a tie the step
    where two runs part was."""
    cfg = tr.cfg
    ck, cv = tr._encode(feats)
    lang = kw.get("language") or tr._language_of(tr._sot_logits(ck, cv))
    ts = kw.get("timestamps", False)
    toks = tr._forced_tokens(lang, kw.get("task", "transcribe"),
                             kw.get("prompt"), timestamps=ts) + prefix
    logits, _ = TW.decode_tokens(cfg, tr.params, torch.tensor([toks]), [0],
                                 TW.init_self_kv(cfg, 1, cfg.max_model_len),
                                 ck, cv, [len(toks)])
    stamps = [t for t in prefix if t > cfg.notimestamps_id]
    run = 0
    for t in prefix:
        run = run + 1 if t > cfg.notimestamps_id else 0
    lp = torch.log_softmax(tr._suppress(
        logits[0, -1], sum(t < cfg.eot_id for t in prefix), ts,
        max(stamps, default=0), run), -1)
    top = lp.topk(2).values
    return float(top[0] - top[1])
