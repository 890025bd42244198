"""Label-smoothing loss (counterpart of ``label_smoothing_loss`` in
``opentransformer_tpu/ops/loss.py``).

KL(smoothed one-hot ‖ softmax(logits)): the target keeps 1 − ε, every other
class gets ε/(V − 1), positions whose target is PAD are dropped, and the
sum is divided by the number of non-PAD targets. The CTC loss of the hybrid
head is not ported yet (``ctc_weight > 0`` raises in ``SpeechToText``).
"""

from __future__ import annotations

import torch

from ..data import PAD


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.1,
                         pad_id: int = PAD, normalize_length: bool = True) -> torch.Tensor:
    """logits f[B, U, V], targets int[B, U] → scalar float32 loss."""
    vocab = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    fill = smoothing / (vocab - 1)
    true_dist = torch.full_like(logp, fill)
    true_dist.scatter_(-1, targets.long()[..., None], 1.0 - smoothing)
    log_true = torch.where(true_dist > 0, torch.log(torch.clamp_min(true_dist, 1e-20)),
                           torch.zeros_like(true_dist))
    kl = torch.sum(true_dist * (log_true - logp), dim=-1)  # [B, U]
    token_mask = (targets != pad_id).float()
    total = torch.sum(kl * token_mask)
    if normalize_length:
        return total / torch.clamp_min(token_mask.sum(), 1.0)
    return total / logits.shape[0]
