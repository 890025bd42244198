"""RNN-Transducer loss (counterpart of ``opentransformer_tpu/ops/rnnt_loss.py``).

``log_probs`` f32[B, T, U+1, V] are the joint's log-softmaxed outputs over
T encoder frames × (U+1) prediction states (state u = "u labels emitted").
The forward variables over the T × (U+1) lattice are

    α[t, u] = logaddexp(α[t-1, u] + blank[t-1, u],  α[t, u-1] + emit[t, u-1])
    loss    = -(α[T_b-1, U_b] + blank[T_b-1, U_b])

with the JAX package's conventions: ``labels`` may be wider than U (only
``labels[:, :U]`` is read), emission at u ≥ ``label_lengths`` is forbidden,
and the terminal is read exactly at frame ``T_b − 1``; the result is the
per-utterance NLL f32[B] (``1e30`` for a row with no frame, as there).

Both of α's terms lie on the previous anti-diagonal t + u, so the port
walks the lattice diagonal by diagonal: T + U steps, each a few elementwise
ops over [B, U+1], the operands skewed once by a gather so that diagonal d
is a plain slice. The arithmetic is α's own definition (logaddexp of
finite terms), so the gradient autograd takes through it is exact; JAX's
in-frame associative scan has no cheap counterpart in PyTorch, and its
cumulative-sum form (``G + logcumsumexp(a − G)``) loses bits once |G|
reaches hundreds. Cells off the lattice hold large negative values whose
logaddexp weight is 0.
"""

from __future__ import annotations

import torch

from .collectives import batch_mean

NEG_INF = -1.0e30


def _skew(x: torch.Tensor, n_diag: int) -> torch.Tensor:
    """x f[B, T, W] → f[B, n_diag, W] with out[:, d, u] = x[:, d − u, u]
    where 0 ≤ d − u < T, else ``NEG_INF``."""
    b, t, w = x.shape
    d = torch.arange(n_diag, device=x.device)[:, None]
    t_idx = d - torch.arange(w, device=x.device)[None, :]
    valid = (t_idx >= 0) & (t_idx < t)
    idx = t_idx.clamp(0, t - 1)[None].expand(b, n_diag, w)
    return torch.where(valid, torch.gather(x, 1, idx), NEG_INF)


def rnnt_loss_from_blank_emit(lp_blank: torch.Tensor, emit: torch.Tensor,
                              frame_lengths: torch.Tensor,
                              label_lengths: torch.Tensor) -> torch.Tensor:
    """The lattice's forward pass over the two slices it reads:
    ``lp_blank`` f[B, T, U+1] = log P(blank | t, u) and ``emit`` f[B, T, U]
    = log P(label_u | t, u) → per-utterance NLL f32[B]."""
    lp_blank, emit = lp_blank.float(), emit.float()
    b, t_max, u1 = lp_blank.shape
    frame_lengths = frame_lengths.to(lp_blank.device).long()
    label_lengths = label_lengths.to(lp_blank.device).long()
    u_ids = torch.arange(u1 - 1, device=emit.device)
    emit = torch.where(u_ids[None, None, :] < label_lengths[:, None, None], emit, NEG_INF)
    # emission from state U leads off the lattice
    emit = torch.cat([emit, torch.full_like(emit[..., :1], NEG_INF)], dim=-1)
    n_diag = t_max + u1 - 1
    blank_sk = _skew(lp_blank, n_diag)
    emit_sk = _skew(emit, n_diag)
    alpha = torch.full((b, u1), NEG_INF, device=lp_blank.device)
    alpha[:, 0] = 0.0
    alphas = [alpha]
    for d in range(1, n_diag):
        from_emit = alpha + emit_sk[:, d - 1]
        alpha = torch.logaddexp(alpha + blank_sk[:, d - 1],
                                torch.cat([from_emit.new_full((b, 1), NEG_INF),
                                           from_emit[:, :-1]], dim=1))
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)  # [B, n_diag, U+1]
    rows = torch.arange(b, device=lp_blank.device)
    t_last = (frame_lengths - 1).clamp(min=0)
    ll = alphas[rows, t_last + label_lengths, label_lengths] + lp_blank[rows, t_last, label_lengths]
    return torch.where(frame_lengths > 0, -ll, -NEG_INF)


def rnnt_loss(log_probs: torch.Tensor, labels: torch.Tensor, frame_lengths: torch.Tensor,
              label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """``log_probs`` f[B, T, U+1, V], ``labels`` int[B, ≥ U] → NLL f32[B]."""
    u_max = log_probs.shape[2] - 1
    labels = labels[:, :u_max].long()
    emit = torch.gather(log_probs[:, :, :u_max, :], 3,
                        labels[:, None, :, None].expand(-1, log_probs.shape[1], -1, 1))[..., 0]
    return rnnt_loss_from_blank_emit(log_probs[..., blank], emit, frame_lengths, label_lengths)


def rnnt_loss_mean(log_probs, labels, frame_lengths, label_lengths, blank: int = 0,
                   group=None):
    """Batch-mean RNN-T loss (scalar; over a data ``group``'s batch, this
    rank's partial)."""
    return batch_mean(rnnt_loss(log_probs, labels, frame_lengths, label_lengths, blank), group)
