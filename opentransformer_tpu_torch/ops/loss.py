"""Losses (counterpart of ``opentransformer_tpu/ops/loss.py``): label
smoothing and CTC.

Label smoothing: KL(smoothed one-hot ‖ softmax(logits)); the target keeps
1 − ε, every other class gets ε/(V − 1), positions whose target is PAD are
dropped, and the sum is divided by the number of non-PAD targets.

CTC: the JAX package calls ``optax.ctc_loss``; ``ctc_neg_log_likelihood``
is the port's own copy of that recursion, so that it gives optax's numbers
where ``torch.nn.functional.ctc_loss`` does not. optax writes log(0) as
``log_epsilon = -1e5``, so a label sequence that no alignment fits (more
labels than frames) costs a large *finite* value (~1e5 per missing
frame), where ``F.ctc_loss`` gives ``inf``. The JAX package's
``isfinite`` guards therefore never fire, and the port keeps them for the
same (never taken) case.

Where every sequence of a batch has an alignment (at least as many valid
frames as labels plus adjacent repeats), both compute the same sum over
alignments, log(0) terms drop out, and ``ctc_loss`` takes PyTorch's
``F.ctc_loss`` for the batch: one native kernel forward and one backward,
where the recursion's Python loop launches some 45 small kernels a frame
(0.2 s of a 0.24 s anchor update on the card). A batch with an infeasible
sequence takes the recursion, for optax's finite values.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from ..data import PAD
from .collectives import VocabShard, batch_mean, copy_to, gather_cat, global_mean, reduce_from

LOG_EPSILON = -1e5  # optax's numerically stable log(+0)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.1,
                         pad_id: int = PAD, normalize_length: bool = True,
                         vocab_shard: VocabShard | None = None, group=None) -> torch.Tensor:
    """logits f[B, U, V], targets int[B, U] → scalar float32 loss. With
    ``vocab_shard`` the logits are this rank's columns of the vocabulary
    (``sharded_smoothing_kl``); with a data ``group`` the rows are this
    rank's share of the group's batch and the loss is its partial (the
    count summed over the group)."""
    if vocab_shard is not None:
        kl = sharded_smoothing_kl(logits, targets, smoothing, vocab_shard)
    else:
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
    if group is not None:  # this rank's partial of the data group's mean
        return global_mean(total, token_mask.sum() if normalize_length else logits.shape[0],
                           group)
    if normalize_length:
        return total / torch.clamp_min(token_mask.sum(), 1.0)
    return total / logits.shape[0]


def sharded_smoothing_kl(logits: torch.Tensor, targets: torch.Tensor, smoothing: float,
                         shard: VocabShard) -> torch.Tensor:
    """The label-smoothing KL a position [B, U] from this rank's vocabulary
    columns [start, start + V/n) of the logits (tensor parallelism): the
    log-partition is a logsumexp over the group (the row maxima gathered,
    each rank's sum of exponentials summed with g, read back through f), and
    of the smoothed target only Σ_v logp_v and the target's logp are
    needed, each summed over the group with g; Σ t·log t is a constant."""
    x = logits.float()
    with torch.no_grad():  # the shift only steadies exp; any value gives the same lse
        peak = gather_cat(x.amax(-1, keepdim=True), -1, shard.group).amax(-1)
    lse = peak + torch.log(reduce_from(torch.exp(x - peak[..., None]).sum(-1), shard.group))
    # every rank's columns read the whole row's lse: f sums their parts of its gradient
    logp = x - copy_to(lse, shard.group)[..., None]
    local = targets.long() - shard.start
    inside = (local >= 0) & (local < x.shape[-1])
    picked = logp.gather(-1, local.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
    logp_target = reduce_from(torch.where(inside, picked, torch.zeros_like(picked)), shard.group)
    sum_logp = reduce_from(logp.sum(-1), shard.group)
    fill, conf = smoothing / (shard.size - 1), 1.0 - smoothing
    const = sum(w * n * math.log(w) for w, n in ((fill, shard.size - 1), (conf, 1)) if w > 0)
    return const - (fill * sum_logp + (conf - fill) * logp_target)


def _add_to_phi(phi: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
    """``phi[:, 1:] ⊕= added`` in log space (optax's ``update_phi_score``)."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)


def ctc_nll_from_logprobs(logp_emit: torch.Tensor, logp_blank: torch.Tensor,
                          logit_pad: torch.Tensor, labels: torch.Tensor,
                          label_pad: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood f32[B] from the log-probs
    already gathered at the label columns: ``logp_emit`` f[B, T, N] (frame t,
    label n), ``logp_blank`` f[B, T]; ``logit_pad`` [B, T] and ``label_pad``
    [B, N] are 1 (or True) on padding; labels are right-padded.

    optax's recursion over frames, vectorised over batch and labels: the
    states are "after label n, in blank" (phi, N + 1 of them) and "emitting
    label n" (emit, N); a padded frame carries the state unchanged, and the
    last frame ends with an emit→phi epsilon transition."""
    b, t, n = logp_emit.shape
    dev = logp_emit.device
    logp_emit = logp_emit.float()
    logp_blank = logp_blank.float()
    pad = logit_pad.bool()
    label_lens = n - label_pad.float().sum(dim=1).long()
    repeat = torch.zeros((b, n), dtype=torch.float32, device=dev)
    if n > 1:
        repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).float()
    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=torch.float32, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, dtype=torch.float32, device=dev)
    to_phi_eps = LOG_EPSILON * repeat  # emit→phi epsilon, barred before a repeat
    to_phi_blank = LOG_EPSILON * (1.0 - repeat)  # emit→phi by a blank, only before one
    for i in range(t):
        lp_emit, lp_blank, pad_i = logp_emit[:, i], logp_blank[:, i, None], pad[:, i, None]
        prev_phi = _add_to_phi(phi, emit + to_phi_eps)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = _add_to_phi(prev_phi + lp_blank, emit + lp_blank + to_phi_blank)
        emit = torch.where(pad_i, emit, next_emit)
        phi = torch.where(pad_i, phi, next_phi)
    last = _add_to_phi(phi, emit)
    return -last.gather(1, label_lens[:, None])[:, 0]


def gather_label_logprobs(logp: torch.Tensor, labels: torch.Tensor, blank_id: int = 0):
    """(log-probs f[B, T, N] at the label columns, blank log-probs f[B, T])
    of frame log-probs ``logp`` f[B, T, V] and labels int[B, N]."""
    b, t, _ = logp.shape
    cols = labels.long()[:, None, :].expand(b, t, labels.shape[1])
    return torch.gather(logp, 2, cols), logp[:, :, blank_id]


def ctc_neg_log_likelihood(logits: torch.Tensor, logit_pad: torch.Tensor, labels: torch.Tensor,
                           label_pad: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """``optax.ctc_loss``: per-sequence f32[B] of logits f[B, T, V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    emit, blank = gather_label_logprobs(logp, labels, blank_id)
    return ctc_nll_from_logprobs(emit, blank, logit_pad, labels, label_pad)


def all_aligned(logit_lengths: torch.Tensor, labels: torch.Tensor,
                label_pad: torch.Tensor) -> bool:
    """Whether every sequence has an alignment: valid frames ≥ labels +
    adjacent repeats (a repeat needs a blank between). One host sync."""
    valid = ~label_pad.bool()
    repeats = (labels[:, 1:] == labels[:, :-1]) & valid[:, 1:]
    need = valid.sum(dim=1) + repeats.sum(dim=1)
    return bool((logit_lengths >= need).all())


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0, group=None) -> torch.Tensor:
    """Mean over the batch of each sequence's CTC loss divided by its label
    length (torch's 'mean' reduction; over a data ``group``'s batch, this
    rank's partial). logits f[B, T, V], labels int[B, U] PAD-padded,
    lengths int[B]."""
    t, u = logits.shape[1], labels.shape[1]
    dev = logits.device
    logit_pad = torch.arange(t, device=dev)[None, :] >= logit_lengths[:, None]
    label_pad = torch.arange(u, device=dev)[None, :] >= label_lengths[:, None]
    if all_aligned(logit_lengths, labels, label_pad):
        logp = torch.log_softmax(logits.float(), dim=-1)
        per_seq = F.ctc_loss(logp.transpose(0, 1), labels.long(), logit_lengths.long(),
                             label_lengths.long(), blank=blank_id, reduction="none")
    else:
        per_seq = ctc_neg_log_likelihood(logits, logit_pad, labels, label_pad, blank_id)
    # the JAX package's zero_infinity guard; optax's values are always finite
    per_seq = torch.where(torch.isfinite(per_seq), per_seq, torch.zeros_like(per_seq))
    per_seq = per_seq / torch.clamp_min(label_lengths.float(), 1.0)
    return batch_mean(per_seq, group)
