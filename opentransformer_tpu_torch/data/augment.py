"""SpecAugment (counterpart of ``opentransformer_tpu/data/augment.py``):
``spec_augment_numpy``, the host variant of one utterance that the
host-feature datasets apply (``spec_augment`` there), and the batched
device variant (``spec_augment_jax`` there).

Host: ``freq_mask_num`` frequency masks of width ⌊U(0, ⌊F·freq_mask_rate⌋)⌋
at an integer drawn from [0, F − w], then ``time_mask_num`` time masks of
width ⌊U(0, min(⌊T·time_mask_rate⌋, max_mask_time_len))⌋, from a numpy
generator in the JAX function's call order, so the same seed gives the
same masks.

Device: ``freq_mask_num`` frequency masks of width ⌊U·⌊F·freq_mask_rate⌋⌋ at
⌊U·(F − w + 1)⌋, then ``time_mask_num`` time masks of width
⌊U·min(⌊T_b·time_mask_rate⌋, max_mask_time_len)⌋ at ⌊U·(T_b − w + 1)⌋, where
T_b is each utterance's own frame count, so padding frames are never the
reason a mask lands where it does; masked cells are zeroed, no time warp.

``spec_augment_from_uniforms`` takes the uniform draws as a tensor
[2·(freq_mask_num + time_mask_num), B], in the JAX function's order (for
each frequency mask its width then its start, then the same for each time
mask), so a test can feed it JAX's draws. ``spec_augment`` draws them from
a ``torch.Generator``. The arithmetic is float32 as in JAX, so the same
draws give the same masks.
"""

from __future__ import annotations

import numpy as np
import torch


def spec_augment_numpy(mel: np.ndarray, freq_mask_num: int = 2, time_mask_num: int = 2,
                       freq_mask_rate: float = 0.3, time_mask_rate: float = 0.05,
                       max_mask_time_len: int = 100,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """One [T, F] utterance → a masked copy (masked cells zeroed)."""
    rng = rng or np.random.default_rng()
    out = np.array(mel, copy=True)
    tau, v = out.shape
    freq_para = int(v * freq_mask_rate)
    time_para = min(int(tau * time_mask_rate), max_mask_time_len)
    for _ in range(freq_mask_num):
        f = int(rng.uniform(0.0, freq_para))
        f0 = int(rng.integers(0, v - f + 1))
        out[:, f0 : f0 + f] = 0.0
    for _ in range(time_mask_num):
        t = int(rng.uniform(0.0, time_para))
        t0 = int(rng.integers(0, tau - t + 1))
        out[t0 : t0 + t, :] = 0.0
    return out


def spec_augment_from_uniforms(feats: torch.Tensor, lengths: torch.Tensor,
                               uniforms: torch.Tensor, freq_mask_num: int = 2,
                               time_mask_num: int = 2, freq_mask_rate: float = 0.3,
                               time_mask_rate: float = 0.05,
                               max_mask_time_len: int = 100) -> torch.Tensor:
    """feats f[B, T, F] padded, lengths i32[B] real frame counts, uniforms
    f32[2·(freq_mask_num + time_mask_num), B] in [0, 1) → masked feats."""
    b, t, v = feats.shape
    if uniforms.shape != (2 * (freq_mask_num + time_mask_num), b):
        raise ValueError(f"expected uniforms [{2 * (freq_mask_num + time_mask_num)}, {b}], "
                         f"got {tuple(uniforms.shape)}")
    u = iter(uniforms.float()[:, :, None])  # each [B, 1]
    freq_para = float(int(v * freq_mask_rate))
    fbins = torch.arange(v, device=feats.device)[None, :]
    tbins = torch.arange(t, device=feats.device)[None, :]
    keep_f = torch.ones((b, v), dtype=torch.bool, device=feats.device)
    for _ in range(freq_mask_num):
        f = torch.floor(next(u) * freq_para)
        f0 = torch.floor(next(u) * (v - f + 1))
        keep_f &= ~((fbins >= f0) & (fbins < f0 + f))
    lens = lengths.to(device=feats.device, dtype=torch.float32)[:, None]
    time_para = torch.clamp_max(torch.floor(lens * time_mask_rate), float(max_mask_time_len))
    keep_t = torch.ones((b, t), dtype=torch.bool, device=feats.device)
    for _ in range(time_mask_num):
        tm = torch.floor(next(u) * time_para)
        t0 = torch.floor(next(u) * (lens - tm + 1))
        keep_t &= ~((tbins >= t0) & (tbins < t0 + tm))
    return feats * (keep_t[:, :, None] & keep_f[:, None, :]).to(feats.dtype)


def spec_augment(feats: torch.Tensor, lengths: torch.Tensor, generator: torch.Generator,
                 freq_mask_num: int = 2, time_mask_num: int = 2, **kwargs) -> torch.Tensor:
    """``spec_augment_from_uniforms`` with the draws taken from ``generator``
    (which lives on ``feats``' device)."""
    n = 2 * (freq_mask_num + time_mask_num)
    uniforms = torch.rand((n, feats.shape[0]), generator=generator, device=feats.device)
    return spec_augment_from_uniforms(feats, lengths, uniforms, freq_mask_num, time_mask_num,
                                      **kwargs)
