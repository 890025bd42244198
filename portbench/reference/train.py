"""Plain PyTorch reference of a training update of the Speech-Transformer.

Per micro-batch: the front end of ``features.py``, the model of
``speech2text.py`` with residual dropout (rate ``residual_dropout``, a
uniform draw an element, kept where it is at least the rate, the rest
scaled by 1/(1 − rate)), label-smoothed cross entropy normalised by the
target tokens, the loss over ``accum_steps`` back-propagated. Per update:
the global gradient norm, clipping to ``clip_grad``, then Adam with L2
weight decay (``torch.optim.Adam``) at the Noam learning rate
``d^-0.5·min(s^-0.5, s·warmup^-1.5)`` of update s (from 1).

The augmentation and the dropout draw from one ``torch.Generator`` in the
order a training user's loop takes them: each micro-batch's SpecAugment
draws, then one draw a residual branch in the order the blocks run. Given
the generator's state, the draws are the harness's input to both sides.
"""

from __future__ import annotations

import torch

from . import features as fe
from . import speech2text as s2t
from .precision import FP32

PAD = 0


def smoothed_kl(logp: torch.Tensor, targets: torch.Tensor, smoothing: float):
    """(summed KL to the smoothed target, 1 − ε on the label and ε/(V − 1)
    elsewhere, over the non-pad targets; their count)."""
    v = logp.shape[-1]
    fill = smoothing / (v - 1)
    true = torch.full_like(logp, fill).scatter_(-1, targets[..., None], 1.0 - smoothing)
    kl = (true * (torch.log(true) - logp)).sum(-1)
    m = (targets != PAD).float()
    return (kl * m).sum(), m.sum()


def micro_kl(w: dict, cfg: dict, waves, wave_lens, targets, generator, prec=FP32,
             feat_prec=FP32):
    """(summed KL, target count, features) of one micro-batch in training
    mode, its augmentation and dropout drawn from ``generator``."""
    model = cfg["model"]
    feats, mask = fe.features(waves, wave_lens, cfg["data"], generator, feat_prec)
    rate = float(model["encoder"]["residual_dropout"])

    def drop(x):
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
        return x * keep.float() / (1.0 - rate)

    memory, mem_mask = s2t.encode(w, model, feats, mask, prec, drop)
    rate = float(model["decoder"]["residual_dropout"])
    logp = s2t.decode_logp(w, model, targets[:, :-1], memory, mem_mask, prec, drop)
    kl, count = smoothed_kl(logp, targets[:, 1:], float(model["smoothing"]))
    return kl, count, feats


def noam(step: int, sched: dict) -> float:
    d, warmup = float(sched["model_size"]), float(sched["warmup_steps"])
    return float(sched.get("factor", 1.0)) * d ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def train(w0: dict, cfg: dict, updates, generator, prec=FP32, feat_prec=FP32, adam=None,
          first_step: int = 1):
    """Run ``updates`` (each a list of micro-batches (waves, lengths,
    targets)) from the weights ``w0``, drawing from ``generator``; with
    ``adam`` ({name: (step, exp_avg, exp_avg_sq)}) from that optimizer
    state, the first update at step ``first_step`` of the schedule. A
    micro-batch's loss is its summed KL over its targets. Returns the
    losses of every micro-batch, the first update's gradients as Adam takes
    them (clipped, plus the L2 term), the weights after the last update and
    the first micro-batch's features."""
    tr = cfg["train"]
    opt_cfg = tr["optimizer"]
    wd = float(opt_cfg["weight_decay"])
    w = {k: v.detach().float().clone().requires_grad_(True) for k, v in w0.items()}
    opt = torch.optim.Adam(list(w.values()), lr=0.0, betas=tuple(opt_cfg["betas"]),
                           eps=float(opt_cfg["eps"]), weight_decay=wd)
    for k, (step, m, v) in (adam or {}).items():
        opt.state[w[k]] = {"step": torch.tensor(float(step)), "exp_avg": m.float().clone(),
                           "exp_avg_sq": v.float().clone()}
    accum = int(tr["accum_steps"])
    losses, grad1, feats0 = [], None, None
    for step, micro in enumerate(updates, start=first_step):
        for waves, lens, targets in micro:
            kl, count, feats = micro_kl(w, cfg, waves, lens, targets, generator, prec, feat_prec)
            part = kl / count.clamp_min(1.0)
            (part / accum).backward()
            losses.append(float(part.detach()))
            if feats0 is None:
                feats0 = feats.detach()
        with torch.no_grad():
            grads = [p.grad for p in w.values()]
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            scale = torch.clamp_max(float(tr["clip_grad"]) / (norm + 1e-6), 1.0)
            for g in grads:
                g.mul_(scale)
            if grad1 is None:
                grad1 = {k: p.grad + wd * p for k, p in w.items()}
        for group in opt.param_groups:
            group["lr"] = noam(step, tr["scheduler"])
        opt.step()
        opt.zero_grad(set_to_none=True)
    return losses, grad1, {k: v.detach() for k, v in w.items()}, feats0
