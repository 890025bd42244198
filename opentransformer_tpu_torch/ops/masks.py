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


def attn_mask_from_pad(pad_mask: torch.Tensor) -> torch.Tensor:
    """bool[B, T_k] key padding → bool[B, 1, 1, T_k] attention mask."""
    return pad_mask[:, None, None, :]


def apply_attn_mask(scores: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Scores with ``NEG_INF`` where ``mask`` is False (None: unchanged)."""
    if mask is None:
        return scores
    return scores.masked_fill(~mask, NEG_INF)


def chunk_attn_mask(t: int, chunk_size: int, left_chunks: int = -1,
                    device=None) -> torch.Tensor:
    """Block-chunked attention mask bool[1, 1, t, t] for streaming encoders:
    query q (in chunk q // chunk_size) may attend the keys of its own chunk
    and of up to ``left_chunks`` chunks before it (-1 = all of them)."""
    chunk = torch.arange(t, device=device) // chunk_size
    q_chunk, k_chunk = chunk[:, None], chunk[None, :]
    ok = k_chunk <= q_chunk
    if left_chunks >= 0:
        ok &= k_chunk >= q_chunk - left_chunks
    return ok[None, None]


def subsample_mask(pad_mask: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Subsample a time mask through a conv layer: ``mask[:, k//2::stride]``;
    the caller truncates to the conv output length."""
    return pad_mask[:, kernel // 2 :: stride]
