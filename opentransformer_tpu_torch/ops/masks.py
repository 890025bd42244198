"""Mask utilities (counterpart of ``opentransformer_tpu/ops/masks.py``).

Conventions: ``pad_mask`` is bool[B, T], True on real positions; attention
masks are bool, broadcastable to [B, H, T_q, T_k], True = may attend, and
are applied inside the softmax as an additive ``NEG_INF``.
"""

from __future__ import annotations

import torch

# Large but finite: (-inf) - (-inf) would give NaN in the softmax, and the
# beam search's init scores and finished-beam arithmetic rely on the value.
NEG_INF = -1.0e9


def mask_to_length(mask: torch.Tensor) -> torch.Tensor:
    """bool[B, T] → int[B] number of valid positions."""
    return mask.long().sum(dim=-1)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """bool[1, 1, t, t] lower-triangular causal mask (True = may attend)."""
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()[None, None]


def subsample_mask(pad_mask: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Subsample a time mask through a conv layer: ``mask[:, k//2::stride]``;
    the caller truncates to the conv output length."""
    return pad_mask[:, kernel // 2 :: stride]
