"""Plain PyTorch reference of the training front end: kaldi log-mel
filterbank, per-utterance normalisation and SpecAugment.

Kaldi's fbank with snip edges (25 ms window, 10 ms shift at 16 kHz), DC
removal, preemphasis 0.97 (the first sample against itself), the povey
window, a 512-point power spectrum, kaldi's mel triangles (20 Hz to
Nyquist) and a log floored at float32's epsilon; then whole-utterance
mean and variance normalisation over the valid frames; then SpecAugment's
frequency and time masks from uniform draws (width ⌊U·⌊F·rate⌋⌋ at
⌊U·(F − w + 1)⌋, time masks over each utterance's own length), and zeroed
padding frames. Float32 throughout; ``prec`` runs the mel product in
another precision for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import FP32

EPSILON = 1.1920928955078125e-07
SAMPLE_FREQ, WINDOW, SHIFT, N_FFT = 16000, 400, 160, 512


def mel_banks(num_bins: int) -> np.ndarray:
    """Kaldi triangles f32[num_bins, N_FFT // 2 + 1] (the Nyquist column zero)."""
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    lo, hi = mel(20.0), mel(SAMPLE_FREQ / 2)
    delta = (hi - lo) / (num_bins + 1)
    bins = mel(SAMPLE_FREQ / N_FFT * np.arange(N_FFT // 2))
    left = lo + np.arange(num_bins)[:, None] * delta
    up = (bins[None] - left) / delta
    down = (left + 2 * delta - bins[None]) / delta
    w = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return np.concatenate([w, np.zeros((num_bins, 1), np.float32)], axis=1)


def frame_counts(lengths: torch.Tensor) -> torch.Tensor:
    return torch.where(lengths >= WINDOW, 1 + (lengths - WINDOW) // SHIFT, 0)


def fbank(waves: torch.Tensor, num_bins: int, prec=FP32) -> torch.Tensor:
    """f32[B, N] zero-padded waveforms → log-mel f32[B, T, num_bins] over
    every whole frame of the padded length."""
    t = max(1 + (waves.shape[1] - WINDOW) // SHIFT, 1)
    frames = waves.float()[:, : (t - 1) * SHIFT + WINDOW].unfold(1, WINDOW, SHIFT)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], -1)
    n = torch.arange(WINDOW, device=waves.device, dtype=torch.float64)
    window = ((0.5 - 0.5 * torch.cos(2 * math.pi * n / (WINDOW - 1))) ** 0.85).float()
    spec = torch.fft.rfft(frames * window, n=N_FFT)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.from_numpy(mel_banks(num_bins)).to(waves.device)
    return torch.log(torch.clamp_min(prec.mm(power, mel), EPSILON))


def normalise(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].float()
    count = torch.clamp_min(m.sum((1, 2)) * feats.shape[-1], 1.0)
    mean = (feats * m).sum((1, 2)) / count
    var = ((feats - mean[:, None, None]) ** 2 * m).sum((1, 2)) / count
    return (feats - mean[:, None, None]) / torch.sqrt(torch.clamp_min(var, 1e-10))[:, None, None]


def spec_augment(feats, lengths, uniforms, freq_mask_num: int, time_mask_num: int,
                 freq_mask_rate: float, time_mask_rate: float, max_mask_time_len: int = 100):
    """Masks from ``uniforms`` f32[2·(freq_mask_num + time_mask_num), B]."""
    b, t, v = feats.shape
    u = iter(uniforms[:, :, None])
    f_idx = torch.arange(v, device=feats.device)[None]
    t_idx = torch.arange(t, device=feats.device)[None]
    keep_f = torch.ones((b, v), dtype=torch.bool, device=feats.device)
    for _ in range(freq_mask_num):
        w = torch.floor(next(u) * float(int(v * freq_mask_rate)))
        f0 = torch.floor(next(u) * (v - w + 1))
        keep_f &= ~((f_idx >= f0) & (f_idx < f0 + w))
    lens = lengths.float()[:, None]
    span = torch.clamp_max(torch.floor(lens * time_mask_rate), float(max_mask_time_len))
    keep_t = torch.ones((b, t), dtype=torch.bool, device=feats.device)
    for _ in range(time_mask_num):
        w = torch.floor(next(u) * span)
        t0 = torch.floor(next(u) * (lens - w + 1))
        keep_t &= ~((t_idx >= t0) & (t_idx < t0 + w))
    return feats * (keep_t[:, :, None] & keep_f[:, None, :]).float()


def features(waves, lengths, data_cfg: dict, generator, prec=FP32):
    """(feats f32[B, T, M], mask bool[B, T]) as a training user's front end
    makes them; SpecAugment's draws come from ``generator``."""
    feats = fbank(waves, int(data_cfg["num_mel_bins"]), prec)
    n = frame_counts(lengths.long())
    mask = torch.arange(feats.shape[1], device=feats.device)[None] < n[:, None]
    feats = normalise(feats, mask)
    aug = data_cfg["spec_augment_config"]
    if data_cfg.get("spec_augment"):
        k = 2 * (aug["freq_mask_num"] + aug["time_mask_num"])
        uniforms = torch.rand((k, feats.shape[0]), generator=generator, device=feats.device)
        feats = spec_augment(feats, n, uniforms, aug["freq_mask_num"], aug["time_mask_num"],
                             aug["freq_mask_rate"], aug["time_mask_rate"],
                             aug.get("max_mask_time_len", 100))
    return feats * mask[..., None].float(), mask
