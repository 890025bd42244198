"""Optimizers and learning-rate schedules
(counterpart of ``opentransformer_tpu/train/scheduler.py``).

Optimizers {adam, sgd} with torch's semantics, which are the JAX package's:
L2 weight decay is added to the gradient *before* the moments (not AdamW),
and Adam's eps is added after the square root. ``torch.optim.Adam`` with
``weight_decay`` is exactly optax's ``add_decayed_weights`` →
``scale_by_adam``; ``torch.optim.SGD`` with momentum is ``add_decayed_weights``
→ ``trace``. With ``adam_m_dtype`` (``bfloat16``) the first moment is
stored in that dtype, as optax's ``mu_dtype``: ``AdamMoments`` runs the
step in float32 from the stored moment and rounds the new one on the way
back; the second moment stays float32.

The seven schedules {constant, step-linear, epoch-linear, exp, step-exp,
transformer (Noam), linear-warmup-exp-decay} are pure host-side closed forms
``lr(global_step, global_epoch)``; the trainer sets the learning rate from
them before each optimizer update, with ``global_step`` starting at 1.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable

import torch

Schedule = Callable[[int, int], float]  # (global_step, global_epoch) -> lr


def build_optimizer(params: Iterable[torch.nn.Parameter], opt_cfg: Any,
                    opt_type: str = "adam") -> torch.optim.Optimizer:
    """The optimizer over ``params``; its learning rate is set from the
    schedule by the trainer before every update."""
    wd = float(opt_cfg.get("weight_decay", 0.0))
    if opt_type == "adam":
        b1, b2 = (float(b) for b in opt_cfg.get("betas", (0.9, 0.999)))
        eps = float(opt_cfg.get("eps", 1e-8))
        if opt_cfg.get("adam_m_dtype"):
            return AdamMoments(params, betas=(b1, b2), eps=eps, weight_decay=wd,
                               m_dtype=moment_dtype(opt_cfg))
        return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps, weight_decay=wd)
    if opt_type == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=float(opt_cfg.get("momentum", 0.0)),
                               nesterov=bool(opt_cfg.get("nesterov", False)), weight_decay=wd)
    raise KeyError(f"unknown optimizer type: {opt_type!r}")


def moment_dtype(opt_cfg: Any) -> torch.dtype:
    """The first moment's storage dtype (``adam_m_dtype``; float32 if unset)."""
    name = opt_cfg.get("adam_m_dtype") or "float32"
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
    if name not in dtypes:
        raise ValueError(f"adam_m_dtype {name!r} not in {sorted(dtypes)}")
    return dtypes[name]


def adam_update(p, g, mu, nu, count: int, lr: float, b1: float, b2: float, eps: float,
                wd: float):
    """One step of optax's ``add_decayed_weights`` → ``scale_by_adam`` (the
    torch-Adam semantics) on float32 tensors, in place on ``p`` and ``nu``;
    ``mu`` is read in float32 and the new one returned in float32 (its
    caller stores it in its own dtype)."""
    gw = g + wd * p if wd > 0 else g
    mu32 = mu.float() * b1 + gw * (1.0 - b1)
    nu.mul_(b2).add_(gw * gw * (1.0 - b2))
    step = (mu32 / (1.0 - b1 ** count)) / (torch.sqrt(nu / (1.0 - b2 ** count)) + eps)
    p.sub_(lr * step)
    return mu32


class AdamMoments(torch.optim.Optimizer):
    """Adam with the first moment stored in ``m_dtype`` (``adam_m_dtype``):
    the step runs in float32 from the stored moment, as optax's
    ``scale_by_adam(mu_dtype=...)`` does."""

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, m_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=0.0, betas=betas, eps=eps, weight_decay=weight_decay))
        self.m_dtype = m_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.m_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
                mu = adam_update(p, p.grad.float(), st["exp_avg"], st["exp_avg_sq"], st["step"],
                                 group["lr"], b1, b2, group["eps"], group["weight_decay"])
                st["exp_avg"] = mu.to(self.m_dtype)

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        # torch casts floating state to the parameter's dtype: store the first moment back
        for st in self.state.values():
            st["exp_avg"] = st["exp_avg"].to(self.m_dtype)


def _linear(i: float, start: float, end: float, start_lr: float, end_lr: float) -> float:
    if i < start:
        return start_lr
    if i > end:
        return end_lr
    return start_lr + (i - start) * (end_lr - start_lr) / (end - start)


def _power_decay_lr(x0: float, d: float, m: float, k: int) -> float:
    """Closed form of k applications of ``x <- max(x ** d, m)`` from x0:
    pure powers until the clamp is reached; for a decreasing map the floor
    m is absorbing, otherwise a first clamp restarts the powers from m."""
    if k <= 0:
        return x0
    if x0 ** d < m:
        if m ** d <= m:
            return m
        return m ** (d ** (k - 1))
    c = x0 ** (d ** k)
    return c if c >= m else m


def build_scheduler(cfg: Any, sched_type: str = "transformer") -> Schedule:
    if sched_type == "constant":
        lr0 = float(cfg["lr"])
        return lambda step, epoch: lr0

    if sched_type in ("step-linear", "epoch-linear", "exp"):
        key = "final_epoch" if sched_type == "epoch-linear" else "final_step"
        final = float(cfg[key])
        start_lr, final_lr = float(cfg["start_lr"]), float(cfg["final_lr"])
        if sched_type == "step-linear":
            return lambda step, epoch: _linear(step, 0, final, start_lr, final_lr)
        if sched_type == "epoch-linear":
            return lambda step, epoch: _linear(epoch, 0, final, start_lr, final_lr)
        # the reference's quirk: exp() of a linearly interpolated value
        return lambda step, epoch: math.exp(_linear(step, 0, final, start_lr, final_lr))

    if sched_type == "step-exp":
        # lr <- max(lr ** decay_factor, min_lr) once per update, in closed form
        init_lr = float(cfg["init_lr"])
        decay = float(cfg["decay_factor"])
        min_lr = float(cfg.get("min_lr", 1e-6))
        return lambda step, epoch: _power_decay_lr(init_lr, decay, min_lr, max(int(step), 0))

    if sched_type == "transformer":
        # Noam: factor * d^-0.5 * min(step^-0.5, step * warmup^-1.5)
        d = float(cfg["model_size"])
        warmup = float(cfg["warmup_steps"])
        factor = float(cfg.get("factor", 1.0))

        def noam(step, epoch):
            s = max(step, 1)
            return factor * d ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)

        return noam

    if sched_type == "linear-warmup-exp-decay":
        # linear 0 → peak over warmup, hold to decay_start, then the step-exp
        # recurrence from peak
        warmup = float(cfg["warmup_steps"])
        decay_start = float(cfg["decay_start"])
        peak_lr = float(cfg["peak_lr"])
        final_lr = float(cfg["final_lr"])
        decay = float(cfg["decay_factor"])
        if not (decay_start > warmup and decay < 1.0):
            raise ValueError("linear-warmup-exp-decay needs decay_start > warmup_steps and "
                             "decay_factor < 1")

        def sched(step, epoch):
            if step < warmup:
                return _linear(step, 0, warmup, 0.0, peak_lr)
            if step > decay_start:
                return _power_decay_lr(peak_lr, decay, final_lr, int(step - decay_start))
            return peak_lr

        return sched

    raise KeyError(f"unknown scheduler type: {sched_type!r}")


SCHEDULER_TYPES = ("constant", "step-linear", "epoch-linear", "exp", "step-exp", "transformer",
                   "linear-warmup-exp-decay")
