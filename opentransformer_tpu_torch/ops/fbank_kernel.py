"""Batched kaldi log-fbank with a fused DFT → power → mel → log kernel
(counterpart of ``opentransformer_tpu/ops/fbank_pallas.py``).

The operations of fbank live in the DFT and the mel projection. With the
real DFT written as two products against cos/sin bases,

    power = (frames · C)² + (frames · S)²      C, S: f32[400, 257]
    feats = log(max(power · melᵀ, EPSILON))

``spec_mel`` computes the second line without writing the [F, 257] power
spectrum to device memory: on a CUDA tensor it launches the hand-written
kernel of ``csrc/fbank_spec_mel.cu`` (which replaces the Pallas
``_spec_mel_kernel``), on a CPU tensor it runs ``spec_mel_plain``, the same
function in plain PyTorch. There is no other switch and no fallback: a
CUDA tensor the kernel does not take raises. ``spec_mel.launches`` counts
kernel launches.

Framing, DC removal, preemphasis and the povey window stay outside the
kernel in plain torch (``extract_frames``), as they do in the JAX package.
The bases are the JAX package's (float64 trig cast to float32) without the
TPU's lane padding: 400 window rows, 257 frequencies, M mel columns.
``fbank_batch`` has ``fbank_pallas_batch``'s contract.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import cuda_build
from .fbank import EPSILON, frame_params, mel_banks, num_frames, povey_window

MAX_MEL = 128  # csrc/fbank_spec_mel.cu: mel bins tx + 16 j, j < 8
PREEMPHASIS = 0.97


@lru_cache(maxsize=4)
def bases(num_mel_bins: int, sample_freq: float = 16000.0):
    """(cos f32[ws, n_freq], sin f32[ws, n_freq], mel_t f32[n_freq, M]) in
    numpy: the real DFT bases of a ``padded``-point transform of the
    ``ws``-sample window (25 ms) and the kaldi mel matrix, transposed."""
    ws, _, padded = frame_params(sample_freq, 25.0, 10.0)
    n_freq = padded // 2 + 1
    ang = -2.0 * np.pi * np.arange(ws)[:, None] * np.arange(n_freq)[None, :] / padded
    mel_t = np.ascontiguousarray(mel_banks(num_mel_bins, padded, float(sample_freq)).T)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32), mel_t


@lru_cache(maxsize=8)
def device_bases(num_mel_bins: int, sample_freq: float,
                 device: torch.device) -> tuple[torch.Tensor, ...]:
    """``bases`` as float32 tensors on ``device`` (made once per device)."""
    return tuple(torch.from_numpy(b).to(device) for b in bases(num_mel_bins, sample_freq))


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


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fbank_spec_mel")
    if lib.fbank_spec_mel_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fbank_spec_mel_launch.argtypes = [p, p, p, p, i, i, i, i, p, p]
        lib.fbank_spec_mel_launch.restype = ctypes.c_int
        lib.fbank_spec_mel_error_string.argtypes = [i]
        lib.fbank_spec_mel_error_string.restype = ctypes.c_char_p
    return lib


def _spec_mel_cuda(frames, cos_b, sin_b, mel_t):
    if frames.dim() != 2 or cos_b.dim() != 2 or sin_b.dim() != 2 or mel_t.dim() != 2:
        raise ValueError(f"expected frames [F, W], cos/sin [W, Q], mel_t [Q, M]; got "
                         f"{tuple(frames.shape)}, {tuple(cos_b.shape)}, {tuple(sin_b.shape)}, "
                         f"{tuple(mel_t.shape)}")
    n_frames, window = frames.shape
    n_freq, n_mel = mel_t.shape
    if cos_b.shape != (window, n_freq) or sin_b.shape != (window, n_freq):
        raise ValueError(f"bases {tuple(cos_b.shape)}, {tuple(sin_b.shape)} do not match "
                         f"frames of {window} samples and {n_freq} frequencies")
    if not 1 <= n_mel <= MAX_MEL:
        raise ValueError(f"the fbank kernel takes 1 to {MAX_MEL} mel bins, got {n_mel}")
    for name, t in (("frames", frames), ("cos", cos_b), ("sin", sin_b), ("mel_t", mel_t)):
        if t.dtype != torch.float32:
            raise TypeError(f"the fbank kernel takes float32 {name}, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError("frames, bases and mel matrix must be on the same device")
        if not t.is_contiguous():
            raise ValueError(f"the fbank kernel needs a contiguous {name}")
    out = torch.empty((n_frames, n_mel), dtype=torch.float32, device=frames.device)
    if n_frames == 0:
        return out
    lib = _library()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = lib.fbank_spec_mel_launch(frames.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
                                        mel_t.data_ptr(), n_frames, window, n_freq, n_mel,
                                        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fbank_spec_mel kernel launch failed: "
                           f"{lib.fbank_spec_mel_error_string(err).decode()} ({err})")
    spec_mel.launches += 1
    return out


def spec_mel(frames, cos_b, sin_b, mel_t):
    """log(max((frames·C)² + (frames·S)²) · mel_t, EPSILON)) → f32[F, M].

    CPU tensor → the plain version; CUDA tensor → the kernel, or an error."""
    if frames.device.type == "cpu":
        return spec_mel_plain(frames, cos_b, sin_b, mel_t)
    if frames.device.type != "cuda":
        raise ValueError(f"spec_mel: unsupported device {frames.device}")
    return _spec_mel_cuda(frames, cos_b, sin_b, mel_t)


spec_mel.launches = 0


def fbank_batch(waveforms: torch.Tensor, lengths: torch.Tensor, num_mel_bins: int = 40,
                sample_freq: float = 16000.0):
    """Batched log-fbank: (f32[B, N] zero-padded waveforms, i32[B] lengths)
    → (feats f32[B, T, M], frame_lengths i32[B]), T = max(num_frames(N), 1).
    Frames past a row's frame length are garbage and must be masked."""
    frames = extract_frames(waveforms, sample_freq)
    b, t, ws = frames.shape
    cos_b, sin_b, mel_t = device_bases(num_mel_bins, float(sample_freq), frames.device)
    feats = spec_mel(frames.reshape(b * t, ws), cos_b, sin_b, mel_t)
    return feats.reshape(b, t, num_mel_bins), wave_frame_lengths(lengths.to(frames.device),
                                                                 sample_freq)
