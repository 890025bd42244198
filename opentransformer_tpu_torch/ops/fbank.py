"""Kaldi-compatible log-mel filterbank on the host, in numpy
(counterpart of the numpy half of ``opentransformer_tpu/ops/fbank.py``).

Snip-edges framing (25 ms window, 10 ms shift), DC-offset removal,
preemphasis 0.97 (the first sample against itself), povey window
((0.5 − 0.5·cos)^0.85), zero-padding to the next power of two, power
spectrum, kaldi mel banks (mel = 1127·ln(1 + f/700), 20 Hz to Nyquist) and
a log floored at ``EPSILON``. ``fbank_numpy`` extracts one utterance on the
host (the dev split's path); the batched device path with the fused
spectrum kernel is ``ops/fbank_kernel.py``, which builds its bases from
``mel_banks`` and ``povey_window`` here.

``logfbank_psf`` is the reference's other extractor (``feature_extractor:
psf``, python_speech_features' ``logfbank``): signal-level preemphasis,
zero-padded ceil framing, a rectangular window, a 512-point power spectrum
and HTK-scale triangles, in float64, returned as float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

EPSILON = 1.1920928955078125e-07  # torch float32 eps, kaldi's log floor


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=8)
def mel_banks(num_bins: int, window_padded: int, sample_freq: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel filterbank f32[num_bins, window_padded//2 + 1];
    the last (Nyquist) column is zero, as in kaldi."""
    num_fft_bins = window_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_freq / window_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_mels = mel_scale(fft_bin_width * np.arange(num_fft_bins))
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (bin_mels[None, :] - left) / (center - left)
    down = (right - bin_mels[None, :]) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return np.concatenate([weights, np.zeros((num_bins, 1), np.float32)], axis=1)


@lru_cache(maxsize=8)
def povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (window_size - 1))
    return (hann ** 0.85).astype(np.float32)


def frame_params(sample_freq: float, frame_length_ms: float, frame_shift_ms: float):
    """(window size, shift, window padded to the next power of two) in samples."""
    window_size = int(sample_freq * frame_length_ms / 1000.0)
    window_shift = int(sample_freq * frame_shift_ms / 1000.0)
    padded = 1 << (window_size - 1).bit_length()
    return window_size, window_shift, padded


def num_frames(n_samples: int, sample_freq: float = 16000.0,
               frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0) -> int:
    ws, shift, _ = frame_params(sample_freq, frame_length_ms, frame_shift_ms)
    if n_samples < ws:
        return 0
    return 1 + (n_samples - ws) // shift


def _process_frames_np(frames: np.ndarray, window: np.ndarray, padded: int,
                       mel: np.ndarray, preemph: float, remove_dc: bool) -> np.ndarray:
    if remove_dc:
        frames = frames - frames.mean(axis=-1, keepdims=True)
    if preemph != 0.0:
        prev = np.concatenate([frames[..., :1], frames[..., :-1]], axis=-1)
        frames = frames - preemph * prev
    frames = frames * window
    spec = np.fft.rfft(frames, n=padded, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    feats = power @ mel.T
    return np.log(np.maximum(feats, EPSILON))


def fbank_numpy(waveform: np.ndarray, sample_freq: float = 16000.0, num_mel_bins: int = 40,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97, remove_dc_offset: bool = True,
                low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Host log-fbank: f32[N] (or [1, N]) waveform → f32[T, num_mel_bins]."""
    wav = np.asarray(waveform, np.float32).reshape(-1)
    ws, shift, padded = frame_params(sample_freq, frame_length_ms, frame_shift_ms)
    t = num_frames(len(wav), sample_freq, frame_length_ms, frame_shift_ms)
    if t == 0:
        return np.zeros((0, num_mel_bins), np.float32)
    idx = np.arange(t)[:, None] * shift + np.arange(ws)[None, :]
    frames = wav[idx]
    mel = mel_banks(num_mel_bins, padded, float(sample_freq), float(low_freq), float(high_freq))
    return _process_frames_np(frames, povey_window(ws), padded, mel, preemphasis,
                              remove_dc_offset)


def normalize_per_utterance(feature: np.ndarray) -> np.ndarray:
    """Whole-tensor mean/std normalization of one utterance's features."""
    std = feature.std()
    return (feature - feature.mean()) / max(std, 1e-10)


def logfbank_psf(waveform: np.ndarray, sample_freq: float = 16000.0, num_mel_bins: int = 26,
                 frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0, nfft: int = 512,
                 preemphasis: float = 0.97, low_freq: float = 0.0,
                 high_freq: float | None = None) -> np.ndarray:
    """python_speech_features-style log filterbank f32[T, num_mel_bins] of
    one waveform."""
    wav = np.asarray(waveform, np.float64).reshape(-1)
    wav = np.append(wav[0], wav[1:] - preemphasis * wav[:-1])
    ws = int(round(frame_length_ms / 1000.0 * sample_freq))
    shift = int(round(frame_shift_ms / 1000.0 * sample_freq))
    n = len(wav)
    t = 1 if n <= ws else 1 + int(np.ceil((n - ws) / shift))
    padded = np.zeros(int((t - 1) * shift + ws))
    padded[:n] = wav
    frames = padded[np.arange(t)[:, None] * shift + np.arange(ws)[None, :]]
    power = (np.abs(np.fft.rfft(frames, nfft)) ** 2) / nfft

    high_freq = high_freq or sample_freq / 2
    mel_lo, mel_hi = (2595.0 * np.log10(1.0 + np.asarray(f) / 700.0) for f in (low_freq, high_freq))
    mel_pts = np.linspace(mel_lo, mel_hi, num_mel_bins + 2)
    hz_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    bins = np.floor((nfft + 1) * hz_pts / sample_freq).astype(int)
    fb = np.zeros((num_mel_bins, nfft // 2 + 1))
    for j in range(num_mel_bins):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    feat = power @ fb.T
    feat = np.where(feat == 0, np.finfo(float).eps, feat)
    return np.log(feat).astype(np.float32)
