"""The device-resident training corpus
(counterpart of ``opentransformer_tpu/data/resident.py``).

A precomputed-feature training split is read once, without augmentation,
into one padded ``[N, T_max, D]`` array with ``[N]`` frame counts
(``build_corpus``: two passes, lengths then rows, so the unpadded features
and the padded corpus are never held together), and ``ResidentCorpus``
uploads it to the card once. The loader then ships ``[B]`` row indices
(``corpus_idx``) and targets, and each batch is gathered on the device:
rows cast to float32, the mask from the frame counts and, in training,
fresh ``additive_noise_std · N(0, 1)`` noise on the valid frames and the
device SpecAugment, both drawn from the trainer's ``torch.Generator``. So
the noise is fresh every epoch, as the host path's is, but not the JAX
PRNG's numbers.

Every batch gathers to the corpus' frame count: T_max covers the largest
bucket boundary (over-long corpora round up to ``pad_multiple``), the
host path's pad shape for that bucket.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

from .augment import spec_augment
from .device_pipeline import AUG_KEYS

logger = logging.getLogger(__name__)

STORAGE_DTYPES = {"float16": torch.float16, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


def build_corpus(dataset, pad_to_frames: int | None = None, pad_multiple: int = 1,
                 storage_dtype: str = "float16"):
    """Every utterance of ``dataset`` (augmentation already off) →
    (corpus [N, T_max, D] in ``storage_dtype`` on the host, int32 [N] frame
    counts). T_max is ``pad_to_frames`` when every utterance fits in it,
    else the longest rounded up to ``pad_multiple``."""
    if storage_dtype not in STORAGE_DTYPES:
        raise ValueError(f"device_resident_dtype {storage_dtype!r} not in "
                         f"{sorted(STORAGE_DTYPES)}")
    n = len(dataset)
    if n == 0:
        raise ValueError("device_resident: empty dataset")
    first = dataset[0][1]
    lens = np.zeros((n,), np.int32)
    for i in range(n):
        lens[i] = (first if i == 0 else dataset[i][1]).shape[0]
    t_max = int(lens.max())
    if pad_to_frames and t_max <= int(pad_to_frames):
        t_max = int(pad_to_frames)
    elif pad_multiple > 1:
        t_max = -(-t_max // pad_multiple) * pad_multiple
    corpus = torch.zeros((n, t_max, first.shape[1]), dtype=STORAGE_DTYPES[storage_dtype])
    for i in range(n):
        f = first if i == 0 else dataset[i][1]
        corpus[i, : f.shape[0]] = torch.from_numpy(f)
    return corpus, lens


class ResidentCorpus:
    """The corpus on ``device`` and the per-batch gather: ``(corpus_idx,
    targets, targets_length, generator, train) → (feats f32[B, T_max, D],
    mask bool[B, T_max], targets, targets_length)``."""

    def __init__(self, data_cfg: Any, corpus: torch.Tensor, lens: np.ndarray, device):
        self.device = torch.device(device)
        self.noise_std = float(data_cfg.get("additive_noise_std", 0.0))
        self.apply_aug = bool(data_cfg.get("spec_augment", False))
        aug_cfg = dict(data_cfg.get("spec_augment_config", {}) or {})
        self.aug_kwargs = {k: aug_cfg[k] for k in AUG_KEYS if k in aug_cfg}
        t0 = time.time()
        self.feats = corpus.to(self.device)
        self.lens = torch.from_numpy(np.asarray(lens, np.int32)).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_seconds = time.time() - t0
        self.nbytes = self.feats.numel() * self.feats.element_size()
        logger.info("device-resident corpus: %d utts [%d, %d, %d] %s = %d bytes uploaded to %s "
                    "in %.3f s", corpus.shape[0], *corpus.shape, corpus.dtype, self.nbytes,
                    self.device, self.upload_seconds)

    def __call__(self, corpus_idx, targets, targets_length, generator=None, train: bool = True):
        idx = torch.as_tensor(np.asarray(corpus_idx), dtype=torch.long).to(self.device)
        x = self.feats.index_select(0, idx).float()
        xl = self.lens.index_select(0, idx)
        mask = torch.arange(x.shape[1], device=self.device)[None, :] < xl[:, None]
        if train and (self.noise_std > 0.0 or self.apply_aug) and generator is None:
            raise ValueError("noise and SpecAugment in training need a generator")
        if train and self.noise_std > 0.0:
            # only the valid frames: the host path pads with zeros after
            # adding its noise
            noise = torch.randn(x.shape, generator=generator, device=self.device)
            x = x + self.noise_std * noise * mask[..., None].to(x.dtype)
        if train and self.apply_aug:
            x = spec_augment(x, xl, generator, **self.aug_kwargs)
        return (x, mask, torch.as_tensor(targets, dtype=torch.long).to(self.device),
                torch.as_tensor(targets_length, dtype=torch.long).to(self.device))
