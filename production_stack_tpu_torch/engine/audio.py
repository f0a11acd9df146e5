"""Audio front end of the Whisper serving path: WAV -> log-mel features.

A copy of production_stack_tpu/engine/audio.py, host-side numpy as there:
parse WAV (stdlib ``wave``; no codec library), resample to 16 kHz, and
compute Whisper's log-mel spectrogram (n_fft 400, hop 160, slaney-
normalised mel filterbank, log10 with the max-8 floor and (x+4)/4
scaling). The card sees only the (n_mels, frames) feature tensor.
"""

from __future__ import annotations

import io
import wave

import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
# Whisper pads/trims every input to one 30 s window: 3000 frames, which
# the encoder's stride-2 conv halves to 1500 positions, whatever the
# clip's length.
CHUNK_SECONDS = 30


class AudioError(ValueError):
    """Malformed/unsupported audio payload (maps to HTTP 400)."""


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """PCM WAV bytes → (float32 mono samples in [-1, 1], sample_rate).

    Handles 8/16/32-bit integer and 32-bit float PCM, any channel count
    (averaged to mono). Non-WAV containers (mp3/ogg/flac) are refused
    with a clear message: there is no codec library.
    """
    try:
        with wave.open(io.BytesIO(data)) as w:
            n_channels = w.getnchannels()
            width = w.getsampwidth()
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
    except (wave.Error, EOFError) as e:
        raise AudioError(
            f"could not parse audio as WAV ({e}); supported format: "
            "PCM WAV (8/16/32-bit int or 32-bit float)"
        ) from None
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        # WAVE_FORMAT_IEEE_FLOAT also has sampwidth 4; floats in [-1, 1]
        # reinterpreted as int32 would be denormal-tiny — detect by range
        as_f = np.frombuffer(raw, np.float32)
        if np.all(np.isfinite(as_f)) and (np.abs(as_f) <= 4.0).all():
            x = as_f.astype(np.float32)
        else:
            x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:  # 8-bit WAV is unsigned
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise AudioError(f"unsupported WAV sample width {width * 8} bit")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    if x.size == 0:
        raise AudioError("audio contains no samples")
    return x, rate


def resample(x: np.ndarray, rate: int, target: int = SAMPLE_RATE) -> np.ndarray:
    """Linear-interpolation resample. Adequate for speech features: the
    mel filterbank integrates away interpolation ripple above ~7 kHz."""
    if rate == target:
        return x
    if rate <= 0:
        raise AudioError(f"invalid sample rate {rate}")
    n_out = max(int(round(x.size * target / rate)), 1)
    t_out = np.arange(n_out, dtype=np.float64) * (rate / target)
    return np.interp(t_out, np.arange(x.size, dtype=np.float64), x).astype(
        np.float32
    )


def mel_filterbank(n_mels: int, n_fft: int = N_FFT,
                   rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-style mel filterbank, (n_mels, n_fft//2 + 1): numerically
    the filterbank Whisper ships precomputed (librosa.filters.mel
    defaults: HTK off, slaney area normalisation)."""
    fmax = rate / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        # slaney scale: linear below 1 kHz, log above
        mel = f / (200.0 / 3.0)
        log_region = f >= 1000.0
        logstep = np.log(6.4) / 27.0
        return np.where(
            log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
            mel,
        )

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        logstep = np.log(6.4) / 27.0
        return np.where(
            m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)),
            m * (200.0 / 3.0),
        )

    mel_pts = mel_to_hz(np.linspace(0.0, float(hz_to_mel(fmax)), n_mels + 2))
    fft_freqs = np.linspace(0.0, fmax, n_fft // 2 + 1)
    lower = mel_pts[:-2][:, None]
    center = mel_pts[1:-1][:, None]
    upper = mel_pts[2:][:, None]
    up = (fft_freqs[None, :] - lower) / np.maximum(center - lower, 1e-10)
    down = (upper - fft_freqs[None, :]) / np.maximum(upper - center, 1e-10)
    fb = np.maximum(0.0, np.minimum(up, down))
    # slaney normalisation: constant energy per band
    fb *= (2.0 / (upper - lower))
    return fb.astype(np.float32)


def log_mel_spectrogram(samples: np.ndarray, n_mels: int,
                        chunk_frames: int) -> np.ndarray:
    """float32 mono 16 kHz samples → (n_mels, chunk_frames) features.

    Whisper's recipe exactly: reflect-padded centered STFT (hann 400,
    hop 160), power spectrum with the final frame dropped, mel project,
    log10 clamped at 1e-10, floor at global max − 8, then (x + 4) / 4.
    Input is zero-padded / truncated to the 30 s window FIRST (the
    padding participates in the global max, as upstream)."""
    window_samples = chunk_frames * HOP_LENGTH
    x = samples[:window_samples]
    if x.size < window_samples:
        x = np.concatenate([x, np.zeros(window_samples - x.size, np.float32)])
    pad = N_FFT // 2
    x = np.pad(x, pad, mode="reflect")
    hann = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    n_frames = 1 + (x.size - N_FFT) // HOP_LENGTH
    strided = np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, N_FFT),
        strides=(x.strides[0] * HOP_LENGTH, x.strides[0]),
    )
    spec = np.abs(np.fft.rfft(strided * hann, axis=1)) ** 2  # (T+1, bins)
    spec = spec[:-1].T  # drop the final frame, → (bins, T)
    mel = mel_filterbank(n_mels) @ spec
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def wav_to_features(data: bytes, n_mels: int,
                    chunk_frames: int) -> tuple[np.ndarray, float]:
    """WAV bytes → ((n_mels, chunk_frames) features, clip seconds)."""
    samples, rate = decode_wav(data)
    duration = samples.size / rate
    samples = resample(samples, rate)
    return log_mel_spectrogram(samples, n_mels, chunk_frames), duration
