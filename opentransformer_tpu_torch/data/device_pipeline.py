"""The feature stage of training on the device
(counterpart of ``opentransformer_tpu/data/device_pipeline.py``).

With ``data.extract_on_device: true`` the loader ships zero-padded raw
waveforms and the whole feature stage runs on the device the tensors lie
on: kaldi log-fbank through the fused spectrum kernel (``ops/fbank_kernel``,
which launches the CUDA kernel for a CUDA tensor and runs its plain
version for a CPU tensor; nothing here chooses), normalization (global
CMVN, or per-utterance whole-tensor mean/std over the valid frames) and
SpecAugment in training. Padding frames come out as zeros.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.fbank_kernel import fbank_batch
from . import BOS, EOS, PAD
from .augment import spec_augment

AUG_KEYS = ("freq_mask_num", "time_mask_num", "freq_mask_rate", "time_mask_rate",
            "max_mask_time_len")


class DeviceFrontend:
    """(waveforms f32[B, N], lengths i32[B], generator, train) →
    (feats f32[B, T, M], mask bool[B, T]) on the waveforms' device."""

    def __init__(self, data_cfg: Any, device):
        self.device = torch.device(device)
        self.num_mel_bins = int(data_cfg.get("num_mel_bins", 40))
        self.normalization = bool(data_cfg.get("normalization", False))
        self.global_mean = self.global_std = None
        if self.normalization and data_cfg.get("global_cmvn"):
            base = data_cfg["global_cmvn"]
            self.global_mean = torch.from_numpy(np.load(base + ".mean.npy")).float().to(device)
            self.global_std = torch.from_numpy(np.load(base + ".std.npy")).float().to(device)
        self.apply_aug = bool(data_cfg.get("spec_augment", False))
        aug_cfg = dict(data_cfg.get("spec_augment_config", {}) or {})
        self.aug_kwargs = {k: aug_cfg[k] for k in AUG_KEYS if k in aug_cfg}

    def __call__(self, waveforms, lengths, generator=None, train: bool = True):
        feats, frame_lengths = fbank_batch(waveforms.to(self.device), lengths,
                                           num_mel_bins=self.num_mel_bins)
        return self.finish(feats, frame_lengths, generator, train)

    def finish(self, feats, frame_lengths, generator=None, train: bool = True):
        """Everything after the fbank: normalization, SpecAugment (with
        ``train``; draws from ``generator``), zeroed padding frames."""
        t = feats.shape[1]
        mask = torch.arange(t, device=feats.device)[None, :] < frame_lengths[:, None]
        if self.normalization and self.global_mean is not None:
            feats = (feats - self.global_mean) / self.global_std
        elif self.normalization:
            m = mask[..., None].to(feats.dtype)
            count = torch.clamp_min(m.sum(dim=(1, 2)) * feats.shape[-1], 1.0)
            mean = (feats * m).sum(dim=(1, 2)) / count
            var = (torch.square(feats - mean[:, None, None]) * m).sum(dim=(1, 2)) / count
            feats = (feats - mean[:, None, None]) / torch.sqrt(
                torch.clamp_min(var, 1e-10))[:, None, None]
        if self.apply_aug and train:
            if generator is None:
                raise ValueError("SpecAugment in training needs a generator")
            feats = spec_augment(feats, frame_lengths, generator, **self.aug_kwargs)
        return feats * mask[..., None].to(feats.dtype), mask


def make_device_frontend(data_cfg: Any, device) -> DeviceFrontend:
    return DeviceFrontend(data_cfg, device)


def collate_waveforms(samples, sample_multiple: int = 16000):
    """[(utt, wav f32[N], N, targets, U)] → (utt_ids, inputs, targets) with
    waveforms zero-padded to a multiple of ``sample_multiple`` (1 s) and
    targets BOS ⧺ y ⧺ EOS ⧺ PAD… padded to a multiple of 8."""
    utt_ids = [s[0] for s in samples]
    nlens = [s[2] for s in samples]
    ulens = [s[4] for s in samples]
    b = len(samples)
    n_max = -(-max(nlens) // sample_multiple) * sample_multiple
    u_max = -(-(max(ulens) + 2) // 8) * 8
    w = np.zeros((b, n_max), np.float32)
    y = np.full((b, u_max), PAD, np.int32)
    for i, s in enumerate(samples):
        w[i, : nlens[i]] = s[1]
        y[i, 0] = BOS
        y[i, 1 : 1 + ulens[i]] = s[3]
        y[i, 1 + ulens[i]] = EOS
    inputs = {"waveforms": w, "wave_lengths": np.asarray(nlens, np.int32)}
    targets = {"targets": y, "targets_length": np.asarray(ulens, np.int32) + 1}
    return utt_ids, inputs, targets
