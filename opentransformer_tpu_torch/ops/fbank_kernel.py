"""Batched kaldi log-fbank with a fused FFT → power → mel → log kernel
(counterpart of ``opentransformer_tpu/ops/fbank_pallas.py``).

The JAX package writes the real DFT of each windowed 400-sample frame as
two products against cos/sin bases, the form the TPU's matrix unit runs:

    power = (frames · C)² + (frames · S)²      C, S: f32[400, 257]
    feats = log(max(power · melᵀ, EPSILON))

``spec_mel`` computes the same function without writing the [F, 257]
power spectrum to device memory. On a CUDA tensor it launches the
hand-written kernel of ``csrc/fbank_spec_mel.cu`` (which replaces the
Pallas ``_spec_mel_kernel``): a float32 512-point real FFT of each frame,
its power, and each mel bin summed over its own nonzero range of
``mel_t``. The kernel reads the frames, ``mel_t``, a float32 twiddle
table (``twiddles``) and the mel ranges (``mel_ranges``). On a CPU tensor
``spec_mel`` runs ``spec_mel_plain``, the dense products against the JAX
bases in plain PyTorch. There is no other switch and no fallback: a CUDA
tensor the kernel does not take raises. ``spec_mel.launches`` counts
kernel launches.

Framing, DC removal, preemphasis and the povey window stay outside the
kernel in plain torch (``extract_frames``), as they do in the JAX package.
The bases are the JAX package's (float64 trig cast to float32) without the
TPU's lane padding: 400 window rows, 257 frequencies, M mel columns.
``fbank_batch`` has ``fbank_pallas_batch``'s contract.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build
from .fbank import EPSILON, frame_params, mel_banks, num_frames, povey_window

MAX_MEL = 128  # csrc/fbank_spec_mel.cu: mel bins lane + 32 j, j < 4
FFT_SIZE = 512  # csrc/fbank_spec_mel.cu: one 256-point complex FFT a frame
PREEMPHASIS = 0.97


@lru_cache(maxsize=4)
def dft_bases(window: int, n_fft: int):
    """(cos, sin) f32[window, n_fft // 2 + 1] in numpy: the real DFT bases of
    an ``n_fft``-point transform of a ``window``-sample frame."""
    ang = -2.0 * np.pi * np.arange(window)[:, None] * np.arange(n_fft // 2 + 1)[None, :] / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=4)
def bases(num_mel_bins: int, sample_freq: float = 16000.0):
    """(cos f32[ws, n_freq], sin f32[ws, n_freq], mel_t f32[n_freq, M]) in
    numpy: the real DFT bases of a ``padded``-point transform of the
    ``ws``-sample window (25 ms) and the kaldi mel matrix, transposed."""
    ws, _, padded = frame_params(sample_freq, 25.0, 10.0)
    mel_t = np.ascontiguousarray(mel_banks(num_mel_bins, padded, float(sample_freq)).T)
    return (*dft_bases(ws, padded), mel_t)


@lru_cache(maxsize=4)
def twiddles(n_fft: int) -> np.ndarray:
    """f32[n_fft, 2]: (cos, -sin) of 2πj / n_fft, i.e. e^{-2πij/n_fft},
    taken in float64 and cast, as the bases are."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def mel_ranges(mel_t: np.ndarray) -> np.ndarray:
    """i32[M, 3]: for each mel bin m, (lo, hi, start) with [lo, hi) the rows
    of ``mel_t`` where column m is nonzero (a kaldi triangle is one run) and
    ``start`` the sum of the earlier bins' run lengths (where the kernel
    packs the bin's weights). Raises if a column's nonzeros are not one run,
    or if there are more than two weights a frequency in all."""
    out = np.zeros((mel_t.shape[1], 3), np.int32)
    start = 0
    for m in range(mel_t.shape[1]):
        nz = np.flatnonzero(mel_t[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        if hi - lo != nz.size:
            raise ValueError(f"mel bin {m}: its nonzero rows are not one range")
        out[m] = (lo, hi, start)
        start += hi - lo
    if start > 2 * mel_t.shape[0]:
        raise ValueError(f"{start} mel weights: the kernel packs at most two a frequency")
    return out


class SpecMelBases(NamedTuple):
    """What the plain version (cos, sin, mel_t) and the kernel (mel_t,
    twiddles, mel_ranges) read, as tensors on one device."""
    cos: torch.Tensor
    sin: torch.Tensor
    mel_t: torch.Tensor
    twiddles: torch.Tensor
    mel_ranges: torch.Tensor


@lru_cache(maxsize=8)
def device_bases(num_mel_bins: int, sample_freq: float, device: torch.device) -> SpecMelBases:
    """``bases``, the twiddle table and the mel ranges as tensors on
    ``device`` (made once per device)."""
    cos_b, sin_b, mel_t = bases(num_mel_bins, sample_freq)
    _, _, padded = frame_params(sample_freq, 25.0, 10.0)
    host = (cos_b, sin_b, mel_t, twiddles(padded), mel_ranges(mel_t))
    return SpecMelBases(*(torch.from_numpy(x).to(device) for x in host))


def wave_frame_lengths(lengths: torch.Tensor, sample_freq: float = 16000.0) -> torch.Tensor:
    """Valid frame count of each waveform length (snip-edges): i32[B]."""
    ws, shift, _ = frame_params(sample_freq, 25.0, 10.0)
    lengths = lengths.long()
    return torch.where(lengths >= ws, 1 + (lengths - ws) // shift,
                       torch.zeros_like(lengths)).to(torch.int32)


def extract_frames(waveforms: torch.Tensor, sample_freq: float = 16000.0) -> torch.Tensor:
    """f32[B, N] zero-padded waveforms → windowed frames f32[B, T, ws] with
    T = max(num_frames(N), 1): DC removal, preemphasis (the first sample
    against itself) and the povey window, in float32. Frames that cross a
    row's end are computed on its zero padding and masked by the caller."""
    ws, shift, _ = frame_params(sample_freq, 25.0, 10.0)
    b, n = waveforms.shape
    t = max(num_frames(n, sample_freq), 1)
    need = (t - 1) * shift + ws
    wave = waveforms.float()
    if n < need:
        wave = torch.nn.functional.pad(wave, (0, need - n))
    frames = wave[:, :need].unfold(1, ws, shift)  # [B, T, ws] view
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPHASIS * prev
    window = torch.from_numpy(povey_window(ws)).to(frames.device)
    return frames * window


def spec_mel_plain(frames, cos_b, sin_b, mel_t):
    """Plain PyTorch version: float32 products, power, mel, log floor."""
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im
    return torch.log(torch.clamp_min(power @ mel_t, EPSILON))


_LAUNCH = cuda_build.Entry("fbank_spec_mel", "fbank_spec_mel_launch", "ppppiiiiip")


def _spec_mel_cuda(frames, mel_t, twiddle, ranges):
    if frames.dim() != 2 or mel_t.dim() != 2 or twiddle.dim() != 2 or ranges.dim() != 2:
        raise ValueError(f"expected frames [F, W], mel_t [Q, M], twiddles [N, 2], "
                         f"mel_ranges [M, 3]; got {tuple(frames.shape)}, {tuple(mel_t.shape)}, "
                         f"{tuple(twiddle.shape)}, {tuple(ranges.shape)}")
    n_frames, window = frames.shape
    n_freq, n_mel = mel_t.shape
    n_fft = twiddle.shape[0]
    if n_fft != FFT_SIZE or twiddle.shape[1] != 2:
        raise ValueError(f"the fbank kernel takes a {FFT_SIZE}-point transform, got a twiddle "
                         f"table of shape {tuple(twiddle.shape)}")
    if n_freq != n_fft // 2 + 1 or not 0 < window <= n_fft or window % 4:
        raise ValueError(f"frames of {window} samples (a multiple of 4, at most {n_fft}) and "
                         f"{n_fft // 2 + 1} mel_t rows expected, got {window} and {n_freq}")
    if not 1 <= n_mel <= MAX_MEL:
        raise ValueError(f"the fbank kernel takes 1 to {MAX_MEL} mel bins, got {n_mel}")
    if ranges.shape != (n_mel, 3) or ranges.dtype != torch.int32:
        raise ValueError(f"mel_ranges must be int32 [{n_mel}, 3], got {ranges.dtype} "
                         f"{tuple(ranges.shape)}")
    for name, t in (("frames", frames), ("mel_t", mel_t), ("twiddles", twiddle),
                    ("mel_ranges", ranges)):
        if name != "mel_ranges" and t.dtype != torch.float32:
            raise TypeError(f"the fbank kernel takes float32 {name}, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError("frames, mel matrix, twiddles and mel ranges must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"the fbank kernel needs a contiguous {name}")
    if not cuda_build.rows_aligned(frames):
        raise ValueError("the fbank kernel reads frames in 16-byte pieces: their storage "
                         "must start on 16 bytes")
    out = torch.empty((n_frames, n_mel), dtype=torch.float32, device=frames.device)
    if n_frames == 0:
        return out
    _LAUNCH(frames.get_device(), frames.data_ptr(), mel_t.data_ptr(), twiddle.data_ptr(),
            ranges.data_ptr(), n_frames, window, n_fft, n_freq, n_mel, out.data_ptr())
    spec_mel.launches += 1
    return out


def spec_mel(frames, mel_t, twiddle, ranges):
    """log(max(|rfft(frames, n)|² · mel_t, EPSILON)) → f32[F, M], with
    n = ``twiddle.shape[0]`` and ``twiddle``, ``ranges`` as
    ``device_bases`` makes them.

    CPU tensor → the plain version (dense products against the bases of an
    n-point transform); CUDA tensor → the kernel, or an error."""
    if frames.device.type == "cpu":
        cos_b, sin_b = (torch.from_numpy(b) for b in dft_bases(frames.shape[-1], twiddle.shape[0]))
        return spec_mel_plain(frames, cos_b, sin_b, mel_t)
    if frames.device.type != "cuda":
        raise ValueError(f"spec_mel: unsupported device {frames.device}")
    return _spec_mel_cuda(frames, mel_t, twiddle, ranges)


spec_mel.launches = 0


def fbank_batch(waveforms: torch.Tensor, lengths: torch.Tensor, num_mel_bins: int = 40,
                sample_freq: float = 16000.0):
    """Batched log-fbank: (f32[B, N] zero-padded waveforms, i32[B] lengths)
    → (feats f32[B, T, M], frame_lengths i32[B]), T = max(num_frames(N), 1).
    Frames past a row's frame length are garbage and must be masked."""
    frames = extract_frames(waveforms, sample_freq)
    b, t, ws = frames.shape
    tables = device_bases(num_mel_bins, float(sample_freq), frames.device)
    feats = spec_mel(frames.reshape(b * t, ws), tables.mel_t, tables.twiddles, tables.mel_ranges)
    return feats.reshape(b, t, num_mel_bins), wave_frame_lengths(lengths.to(frames.device),
                                                                 sample_freq)
