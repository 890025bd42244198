"""The training loop (counterpart of ``opentransformer_tpu/train/trainer.py``,
its single-step and multi-step paths).

Per micro-batch, the batch's kind picks the preprocess, which runs without
gradient: padded waveforms go through the device feature stage
(``data/device_pipeline.py``: fbank kernel, CMVN, SpecAugment), row indices
into the device-resident corpus through its gather (``data/resident.py``:
noise, SpecAugment), host features straight to the device
(``feature_args``), and a text batch (2-d ``inputs``: an LM's src, tgt and
lengths) likewise (``text_args``). Then the model's loss divided by
``accum_steps`` is back-propagated into the parameters' ``.grad`` (the
accumulator); with ``dtype: bfloat16`` the forward runs under
``torch.autocast`` in bfloat16 over the float32 parameters, while the loss
itself is float32 (``ops/loss.py``) and Adam's state stays float32. Every
``accum_steps`` micro-batches, and at the end of an epoch for a short last
window (still divided by ``accum_steps``), one update:

  * the global gradient norm, then clip by ``min(1, clip / (norm + 1e-6))``;
  * Gaussian gradient noise of std ``grad_noise / accum_steps``;
  * a non-finite norm skips the whole update, Adam's count included, and
    adds one to ``nan_skips``;
  * otherwise the optimizer steps at ``lr = schedule(global_step,
    global_epoch)``.

A BatchNorm conformer's running averages (buffers, outside the optimizer
and the clipping) move on every training micro-batch's forward, skipped
updates included, as the JAX trainer threads ``batch_stats`` out of each
gradient step; ``evaluate`` and the probe normalize with them.

``global_step`` starts at 1 and counts updates, skipped ones too. The
loader is reshuffled before each epoch; after it come the checkpoint, the
deterministic dev loss, the best-epoch ``model.best`` and the dev probe
(``dev_probe_fn(model, epoch)``, e.g. the greedy CER of ``cli/run.py``).
Dropout, noise, SpecAugment and gradient noise all draw from one
``torch.Generator`` on the model's device.

``steps_per_exec: N`` is the JAX trainer's multi-step execution, N updates
scanned in one compiled program to spare the TPU's dispatch. The JAX
program runs the single-step arithmetic, with accumulation windows that run
on across a change of batch shape, so the same lr sequence, ``global_step``
and history come from N single updates, which is how the port runs it.

``fused_update`` (Adam only) makes the parameters and their gradients views
into one flat float32 buffer each (``FusedAdam``): the norm, the clip, the
noise (one draw over the flat buffer, as the JAX fused path) and Adam run
as a few whole-buffer ops, with flat moments (the first in ``adam_m_dtype``).
MixSpeech (``mixspeech``) mixes the batch's rows in pairs after the
feature stage, ``λ·x_2i + (1 − λ)·x_2i+1`` with λ ~ Beta(0.5, 0.5) from the
trainer's generator, the union of the two masks, and weights the two rows'
targets' losses by λ and 1 − λ; both forwards draw the same dropout and
BatchNorm moves once, as in the JAX trainer's one-rng pair of applies.
``OT_FAULT_INJECT_STEP=N`` crashes the run once an update reaches step N,
and ``OT_FAULT_INJECT_MARKER=FILE`` disarms it once FILE exists (it is
written before the crash): the supervised restart of ``cli/run.py
--supervise`` is proven with it.

On a mesh (``parallel/mesh.py``; ``mesh=``) the model is sharded over its
``model``, ``expert`` and ``pipe`` axes (``parallel/engine.py``) and each
micro-batch is this rank's rows of the global batch. ``train.pp_schedule``
``sharded`` (the default) keeps one device's numbers: each loss is a
partial of the global batch's, the gradients are summed over ``data``, the
norm, clip, NaN guard and Adam see the one-card gradient. ``1f1b`` runs the
speech2text loss through the pipeline schedule of ``parallel/pipeline.py``
with ``train.pp_micro_batches`` microbatches (the pipe size by default),
whose loss is the mean over (microbatch, data shard) of each one's loss; a
batch that micro × data does not divide is dropped with a warning, as in
JAX. A draw for the whole step (the gradient noise, drawn in the one-card
shapes with each rank adding its slice, and MixSpeech's λ) comes from
``step_generator``, which every rank holds alike; a draw for the rows
(dropout, noise, SpecAugment) from ``generator``. With more than one data
rank they are two streams: the step's from the seed, each data rank's rows
from the seed plus its index + 1 times a constant (the ranks of one data
index share it). A MixSpeech batch whose rank share is odd runs whole on
every data rank, so the pairs are one device's. Checkpoints are the
one-card layout, gathered and written by rank 0; the dev probe decodes a
one-card model built for the call on rank 0. With ``data_shards`` (the
loader of ``--multihost`` reads each data rank's shard of a batch) the
micro-batch is that shard, which ``ParallelModel.assemble`` turns into this
rank's rows of the global batch, or into the global batch for a ragged
batch, a MixSpeech batch of odd shards and the 1F1B schedule.

Under a ``torch.profiler`` session the one-card micro-step records its
spans (``profiling.span``): ``trainer.micro_step`` around
``trainer.features`` (``batch_args``), ``trainer.forward`` and
``trainer.backward``; an update records ``trainer.update`` around
``trainer.wait`` (its one host read) and ``trainer.optimizer`` (the step
and ``zero_grad``).
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any

import torch

from .. import profiling
from ..models.modules import BatchNorm, set_dropout_generator
from ..ops.collectives import all_reduce_
from ..parallel.launch import is_rank0
from .scheduler import adam_update, build_optimizer, build_scheduler, moment_dtype
from .utils import AverageMeter, MeanLoss, Summary

logger = logging.getLogger(__name__)

AUTOCAST_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
FUSED_ADAM_KEYS = {"lr", "betas", "eps", "weight_decay", "adam_m_dtype"}


class FusedAdam:
    """``train.fused_update``: the model's float32 parameters and their
    gradients become views into one flat buffer each (``flat``, ``grad``),
    so that the trainer's norm, clip and noise and this Adam step (the
    JAX fused path's arithmetic: L2 into the gradient, float32 math, the
    first moment stored in ``adam_m_dtype``) are a few whole-buffer ops.
    The gradient buffer is zeroed in place, never freed, so backward
    accumulates into it."""

    def __init__(self, params, opt_cfg: dict):
        params = list(params)
        if any(p.dtype != torch.float32 for p in params):
            raise ValueError("train.fused_update needs float32 parameters")
        self.b1, self.b2 = (float(b) for b in opt_cfg.get("betas", (0.9, 0.999)))
        self.eps = float(opt_cfg.get("eps", 1e-8))
        self.wd = float(opt_cfg.get("weight_decay", 0.0))
        n = sum(p.numel() for p in params)
        dev = params[0].device
        self.flat = torch.empty(n, dtype=torch.float32, device=dev)
        self.grad = torch.zeros(n, dtype=torch.float32, device=dev)
        off = 0
        with torch.no_grad():
            for p in params:
                k = p.numel()
                self.flat[off : off + k].copy_(p.reshape(-1))
                p.data = self.flat[off : off + k].view_as(p)
                p.grad = self.grad[off : off + k].view_as(p)
                off += k
        self.mu = torch.zeros(n, dtype=moment_dtype(opt_cfg), device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = 0
        self.param_groups = [{"lr": 0.0}]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        mu = adam_update(self.flat, self.grad, self.mu, self.nu, self.count,
                         self.param_groups[0]["lr"], self.b1, self.b2, self.eps, self.wd)
        self.mu.copy_(mu)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])


def beta_half(generator: torch.Generator, device) -> torch.Tensor:
    """One draw of Beta(0.5, 0.5), the arcsine law: sin²(πU/2), U ~ U(0, 1)."""
    u = torch.rand((), generator=generator, device=device)
    return torch.sin(u * (math.pi / 2)) ** 2


def _tensor(x, device, dtype=None):
    return torch.as_tensor(x, dtype=dtype).to(device)


def feature_args(batch, device):
    """A host-feature batch → (feats, mask, targets, targets_length) on ``device``."""
    _, inputs, targets = batch
    return (_tensor(inputs["inputs"], device), _tensor(inputs["mask"], device, torch.bool),
            _tensor(targets["targets"], device, torch.long),
            _tensor(targets["targets_length"], device, torch.long))


def slice_rows(batch, rows: list):
    """The rows ``rows`` of a host batch (utt_ids, inputs, targets): every
    array is indexed on its first dimension, nothing is re-padded."""
    utts, inputs, targets = batch

    def pick(d):
        return {k: v[rows] if getattr(v, "ndim", 0) > 0 else v for k, v in d.items()}

    return ([utts[i] for i in rows] if utts is not None else None), pick(inputs), pick(targets)


def text_args(batch, device):
    """A text batch → (src, tgt, tgt_length) on ``device``."""
    _, inputs, targets = batch
    return (_tensor(inputs["inputs"], device, torch.long),
            _tensor(targets["targets"], device, torch.long),
            _tensor(targets["targets_length"], device, torch.long))


class Trainer:
    """Drives epochs over a loader of (utt_ids, inputs, targets) batches
    whose inputs are padded waveforms (through ``frontend``), row indices
    into ``resident``, padded host features or token ids."""

    def __init__(self, train_cfg: Any, model: torch.nn.Module, frontend,
                 generator: torch.Generator, checkpointer=None, log_interval: int = 10,
                 keep_last_n: int = 30, dev_loader=None, is_debug: bool = False,
                 resident=None, dev_probe_fn=None, mixspeech: bool = False, visualizer=None,
                 mesh=None, data_shards: bool = False):
        # the pipeline schedule of a pipe axis: 'sharded' (stage-sharded
        # weights and moments, one device's numbers) or '1f1b'
        self.pp_schedule = str(train_cfg.get("pp_schedule") or "sharded")
        if self.pp_schedule not in ("sharded", "1f1b"):
            raise ValueError(f"pp_schedule {self.pp_schedule!r} not in ['1f1b', 'sharded']")
        self.pp_micro_batches = train_cfg.get("pp_micro_batches")
        self.fused = bool(train_cfg.get("fused_update", False))
        # the JAX trainer's refusals, in its words, before anything is sharded
        if self.pp_schedule == "1f1b":
            if mesh is None:
                raise ValueError("pp_schedule=1f1b needs a mesh with a pipe axis")
            if mixspeech:
                raise ValueError("mixspeech is not supported under pp_schedule=1f1b")
            if int(train_cfg.get("steps_per_exec", 1)) > 1:
                raise ValueError("steps_per_exec > 1 does not support pp_schedule=1f1b")
            if self.fused:
                raise ValueError("train.fused_update does not compose with pp_schedule=1f1b")
            from ..parallel.pipeline import check_1f1b_model

            check_1f1b_model(model, mesh.size("pipe"))
        if self.fused and mesh is not None and any(mesh.size(a) > 1
                                                   for a in ("model", "pipe", "expert")):
            raise ValueError("train.fused_update needs replicated params (data-axis-only "
                             "mesh): the flat moment buffer has no per-leaf shardings")
        dtype = str(train_cfg.get("dtype", "float32"))
        if dtype not in AUTOCAST_DTYPES:
            raise ValueError(f"train.dtype {dtype!r} not in {sorted(AUTOCAST_DTYPES)}")
        self.autocast_dtype = AUTOCAST_DTYPES[dtype]
        self.steps_per_exec = int(train_cfg.get("steps_per_exec", 1))
        if self.steps_per_exec < 1:
            raise ValueError(f"train.steps_per_exec must be >= 1, got {self.steps_per_exec}")
        self.model = model
        self.frontend = frontend
        self.resident = resident
        self.dev_probe_fn = dev_probe_fn
        self.device = next(model.parameters()).device
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"the generator lives on {generator.device}, the model on "
                             f"{self.device}")
        self.generator = generator
        self.step_generator = generator  # the step's draws, alike on every rank
        self.mesh = mesh
        # the loader reads this rank's data shard of each batch (--multihost)
        self.data_shards = bool(data_shards) and mesh is not None and mesh.size("data") > 1
        self.parallel = None
        self.pipeline = None
        if mesh is not None:
            from ..parallel.engine import ParallelModel

            if mesh.size("data") > 1:  # the rows' stream of each data rank its own
                seed = generator.initial_seed()
                self.step_generator = torch.Generator(device=generator.device).manual_seed(seed)
                generator.manual_seed(seed + 1000003 * (mesh.index("data") + 1))
            self.parallel = ParallelModel(model, mesh, self.pp_schedule)
        set_dropout_generator(model, generator)
        self.checkpointer = checkpointer
        self.log_interval = log_interval
        self.keep_last_n = keep_last_n
        self.dev_loader = dev_loader
        self.is_debug = is_debug  # an epoch stops after 30 micro-batches
        self.accum_steps = int(train_cfg.get("accum_steps", 1))
        self.grad_clip = float(train_cfg.get("clip_grad", 0.0))
        self.grad_noise = float(train_cfg.get("grad_noise", 0.0))
        self.epochs = int(train_cfg.get("epochs", 1))
        self.mixspeech = mixspeech
        self.visualizer = visualizer
        opt_cfg = train_cfg.get("optimizer", {}) or {}
        opt_type = train_cfg.get("optimizer_type", "adam")
        if self.fused:
            unknown = set(opt_cfg) - FUSED_ADAM_KEYS
            if opt_type != "adam" or unknown:
                raise ValueError(f"train.fused_update supports adam and the optimizer keys "
                                 f"{sorted(FUSED_ADAM_KEYS)} (got {opt_type!r}, "
                                 f"{sorted(unknown)})")
            self.optimizer = FusedAdam(model.parameters(), opt_cfg)
        else:
            self.optimizer = build_optimizer(model.parameters(), opt_cfg, opt_type)
        self.schedule = build_scheduler(train_cfg.get("scheduler", {}) or {},
                                        train_cfg.get("scheduler_type", "transformer"))
        self.global_step = 1
        self.global_epoch = 0
        self.nan_skips = 0
        self.fault_step = int(os.environ.get("OT_FAULT_INJECT_STEP", 0))
        self.fault_marker = os.environ.get("OT_FAULT_INJECT_MARKER")
        self.mean_loss = MeanLoss()
        # one record per update: epoch, step, lr, micro-batch losses (and the
        # hybrid loss' parts under "aux"), grad norm, whether it was applied,
        # host time at its end
        self.history: list[dict] = []
        self.dev_losses: list[float] = []
        self._window: list[torch.Tensor] = []
        self._window_aux: list[dict] = []
        if self.pp_schedule == "1f1b":
            from ..parallel.pipeline import Speech2Text1F1B

            self.pipeline = Speech2Text1F1B(
                model, mesh, int(self.pp_micro_batches or mesh.size("pipe")), generator,
                self.autocast)

    # ------------------------------------------------------------ one step
    def autocast(self):
        """The forward's precision context: bfloat16 autocast with
        ``dtype: bfloat16``, else a no-op."""
        return torch.autocast(self.device.type, dtype=self.autocast_dtype or torch.bfloat16,
                              enabled=self.autocast_dtype is not None)

    def batch_args(self, batch, train: bool = True):
        """A batch → the model's arguments on its device, by the batch's
        kind (no gradient): (feats, mask, targets, targets_length) from
        waveforms through the device frontend, ``corpus_idx`` through the
        resident gather, or host features as they are; (src, tgt,
        tgt_length) from a text batch. ``train`` draws the augmentation."""
        _, inputs, targets = batch
        with torch.no_grad():
            if "waveforms" in inputs:
                feats, mask = self.frontend(_tensor(inputs["waveforms"], self.device),
                                            _tensor(inputs["wave_lengths"], self.device),
                                            self.generator, train=train)
                return (feats, mask, _tensor(targets["targets"], self.device, torch.long),
                        _tensor(targets["targets_length"], self.device, torch.long))
            if "corpus_idx" in inputs:
                if self.resident is None:
                    raise ValueError("a device-resident batch needs the trainer's resident "
                                     "corpus")
                return self.resident(inputs["corpus_idx"], targets["targets"],
                                     targets["targets_length"], self.generator, train=train)
        if inputs["inputs"].ndim == 2:
            return text_args(batch, self.device)
        return feature_args(batch, self.device)

    def micro_step(self, batch) -> torch.Tensor | None:
        """Forward and backward of one micro-batch; its gradient, scaled by
        1/accum_steps, adds to the parameters' ``.grad``. Returns the
        (unscaled) loss (on a mesh this rank's partial of it), or None for a
        batch the 1F1B schedule drops."""
        if self.parallel is not None:
            return self._parallel_micro_step(batch)
        with profiling.span("trainer.micro_step"):
            with profiling.span("trainer.features"):
                args = self.batch_args(batch)
            with profiling.span("trainer.forward"), self.autocast():
                loss, aux = self.mix_loss(*args) if self.mixspeech else self.model(*args)
            with profiling.span("trainer.backward"):
                (loss / self.accum_steps).backward()
            self._window.append(loss.detach())
            self._window_aux.append({k: v.detach() for k, v in aux.items()})
            return loss.detach()

    def _parallel_micro_step(self, batch):
        local = False
        if self.data_shards:  # this rank's shard: its rows, or the batch gathered whole
            n_local = len(batch[2]["targets"])
            batch, local = self.parallel.assemble(
                batch, whole=self.pipeline is not None or (self.mixspeech and n_local % 2 == 1))
        n_rows = len(batch[2]["targets"])
        if self.pipeline is not None:
            n_micro = self.pipeline.n_micro
            div = n_micro * self.mesh.size("data")
            if n_rows % div:
                logger.warning("1f1b: dropping ragged batch of %d (not divisible by "
                               "micro x dp = %d)", n_rows, div)
                return None
            rows, _ = self.parallel.rows(n_rows, n_micro)
            args = self.batch_args(slice_rows(batch, rows))
            scale = 1.0 / (n_micro * self.mesh.size("data") * self.accum_steps)
            with self.parallel.stage_only():
                loss, moe_aux = self.pipeline.step(*args, scale=scale)
            loss, aux = loss * self.accum_steps, {}
            if moe_aux is not None:
                aux = {"moe_aux": moe_aux * self.accum_steps}
        else:
            if local:
                rows, ragged = list(range(n_rows)), False
            else:
                rows, ragged = self.parallel.rows(n_rows)
                if self.mixspeech and len(rows) % 2 and not ragged:  # a pair would straddle
                    rows, ragged = list(range(n_rows)), True
            args = self.batch_args(slice_rows(batch, rows))
            with self.parallel.loss_context(ragged), self.autocast():
                loss, aux = self.mix_loss(*args) if self.mixspeech else self.model(*args)
            if ragged:  # every data rank ran the whole batch
                share = 1.0 / self.mesh.size("data")
                loss, aux = loss * share, {k: v * share for k, v in aux.items()}
            (loss / self.accum_steps).backward()
        self._window.append(loss.detach())
        self._window_aux.append({k: v.detach() for k, v in aux.items()})
        return loss.detach()

    def mix_lambda(self) -> torch.Tensor:
        return beta_half(self.step_generator, self.device)

    def mix_loss(self, feats, mask, targets, targets_length):
        """MixSpeech: rows 2i and 2i+1 mixed at λ, the loss ``λ·L(mix,
        y_2i) + (1 − λ)·L(mix, y_2i+1)`` (an odd last row is left out). The
        second forward replays the first's generator state and BatchNorm
        statistics, so both see the same dropout and the statistics move
        once."""
        if feats.dim() != 3:
            raise ValueError("MixSpeech mixes speech features [B, T, F]")
        b = feats.shape[0] // 2 * 2
        lam = self.mix_lambda()
        mixed = lam * feats[0:b:2] + (1.0 - lam) * feats[1:b:2]
        mixed_mask = mask[0:b:2] | mask[1:b:2]
        bns = [m for m in self.model.modules() if isinstance(m, BatchNorm)]
        stats = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
        gen_state = self.generator.get_state()
        l1, _ = self.model(mixed, mixed_mask, targets[0:b:2], targets_length[0:b:2])
        self.generator.set_state(gen_state)
        for m, (mean, var) in zip(bns, stats):
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
        l2, _ = self.model(mixed, mixed_mask, targets[1:b:2], targets_length[1:b:2])
        return lam * l1 + (1.0 - lam) * l2, {}

    @profiling.spanned("trainer.update")
    def update(self, epoch: int = 0) -> dict:
        """Clip, noise, NaN guard and one optimizer step on the accumulated
        gradient; clears it and advances ``global_step``."""
        if self.parallel is not None:  # summed over the mesh, only this rank's blocks
            grads = self.parallel.sync_grads(self.optimizer)
        if self.fused:
            grads = [self.optimizer.grad]
        elif self.parallel is None:
            params = list(self.model.parameters())
            for p in params:  # an unused parameter takes part with a zero gradient
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
        if self.parallel is not None and not self.fused:  # the one-card norm
            gnorm = self.parallel.grad_norm()
        else:
            gnorm = torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                            for g in grads]).sum())
        if self.grad_clip > 0:
            scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-6), 1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        if self.grad_noise > 0:
            for g, noise in self.grad_noise_draws(grads):
                g.add_(noise * self.grad_noise / self.accum_steps)
        aux_keys = sorted(self._window_aux[0]) if self._window_aux else []
        aux_vals = [a[k].float() for a in self._window_aux for k in aux_keys]
        # one host sync per update
        values = torch.stack([gnorm, *self._window, *aux_vals])
        if self.parallel is not None:  # the partials summed to the step's
            values = torch.cat([values[:1], self.parallel.report(values[1:].clone())])
        with profiling.span("trainer.wait"):
            values = values.tolist()
        n = len(self._window)
        gnorm_val, losses = values[0], values[1 : 1 + n]
        aux = {k: values[1 + n + i :: len(aux_keys)] for i, k in enumerate(aux_keys)}
        applied = math.isfinite(gnorm_val)
        lr = self.schedule(self.global_step, self.global_epoch)
        with profiling.span("trainer.optimizer"):
            if applied:
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
            else:
                self.nan_skips += 1
            self.optimizer.zero_grad(set_to_none=True)
        self._window, self._window_aux = [], []
        record = {"epoch": epoch, "step": self.global_step, "lr": lr, "losses": losses,
                  "gnorm": gnorm_val, "applied": applied, "time": time.time()}
        if aux:
            record["aux"] = aux
        self.history.append(record)
        self.mean_loss.update(sum(losses) / max(len(losses), 1))
        if self.visualizer is not None:
            self.visualizer.add_scalar("train_loss", sum(losses) / max(len(losses), 1),
                                       self.global_step)
            self.visualizer.add_scalar("lr", lr, self.global_step)
            self.visualizer.add_scalar("grad_norm", gnorm_val, self.global_step)
        self.global_step += 1
        return record

    def grad_noise_draws(self, grads: list):
        """(gradient, its N(0, 1) noise) pairs: one device's draws from
        ``step_generator``, gradient by gradient (on a sharded mesh in the
        one-card shapes of every parameter, each rank keeping its slices)."""
        gen = self.step_generator
        if self.parallel is None or self.fused or not self.parallel.sharded:
            return [(g, torch.randn(g.shape, generator=gen, device=g.device, dtype=g.dtype))
                    for g in grads]
        return self.parallel.noise_draws(gen)

    def maybe_inject_fault(self) -> None:
        """Crash once ``global_step`` reaches ``OT_FAULT_INJECT_STEP``; the
        marker file, written first, disarms it for the restarted run."""
        if not self.fault_step or self.global_step < self.fault_step:
            return
        if self.fault_marker:
            if os.path.exists(self.fault_marker):
                return
            with open(self.fault_marker, "w", encoding="utf-8") as f:
                f.write(str(self.global_step))
        raise RuntimeError(f"fault injection: crashing at global step {self.global_step} "
                           "(OT_FAULT_INJECT_STEP)")

    # ----------------------------------------------------------- the epochs
    def train_one_epoch(self, epoch: int, train_loader) -> None:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        self._window, self._window_aux = [], []
        n_batches = len(train_loader)
        span_t0 = time.time()
        micro = 0
        for step, batch in enumerate(train_loader):
            if self.micro_step(batch) is not None:
                micro += 1
            if micro > 0 and (micro == self.accum_steps or step == n_batches - 1):
                rec = self.update(epoch)
                micro = 0
                if rec["step"] % self.log_interval == 0:
                    parts = "".join(f", {k}:{sum(v) / len(v):.5f}"
                                    for k, v in rec.get("aux", {}).items())
                    logger.info(
                        "-Training-Epoch-%d(%.5f%%), Global Step:%d, lr:%.8f, Loss:%.5f, "
                        "AvgLoss: %.5f, Run Time:%.3f%s, GNorm:%.3f%s", epoch,
                        (step + 1) / max(n_batches, 1) * 100, rec["step"], rec["lr"],
                        sum(rec["losses"]) / len(rec["losses"]), self.mean_loss.mean(),
                        time.time() - span_t0, parts, rec["gnorm"],
                        f", NaNSkips:{self.nan_skips}" if self.nan_skips else "")
                    span_t0 = time.time()
                self.maybe_inject_fault()
            if self.is_debug and step > 30:
                break

    def train(self, train_loader) -> None:
        best = Summary()
        for epoch in range(self.global_epoch, self.epochs):
            train_loader.set_epoch(epoch)  # reshuffle before the epoch
            self.train_one_epoch(epoch, train_loader)
            self.global_epoch = epoch + 1
            if self.checkpointer is not None:
                state, opt_state = self.one_card_state(with_optimizer=True)
                if is_rank0():
                    self.checkpointer.save(epoch, self.model, self.optimizer,
                                           extra={"global_step": self.global_step,
                                                  "nan_skips": self.nan_skips},
                                           keep_last_n=self.keep_last_n, state=state,
                                           optimizer_state=opt_state)
            if self.dev_loader is not None:
                dev_loss = self.evaluate(self.dev_loader)
                self.dev_losses.append(dev_loss)
                logger.info("epoch %d dev loss %.5f", epoch, dev_loss)
                if self.visualizer is not None:
                    self.visualizer.add_scalar("dev_loss", dev_loss, self.global_step)
                if best.update(epoch, dev_loss) and self.checkpointer is not None:
                    state, _ = self.one_card_state()
                    if is_rank0():
                        self.checkpointer.save_params_only("model.best", self.model, state)
                    logger.info("new best epoch %d (dev loss %.5f)", epoch, dev_loss)
            if self.dev_probe_fn is not None:
                # a sharded model is decoded as its one-card state
                state, _ = self.one_card_state()
                if is_rank0():
                    self.model.eval()
                    with self.autocast():
                        self.dev_probe_fn(self.model if state is None else state, epoch)
                self.model.train()
        if self.checkpointer is not None:
            self.checkpointer.wait()  # an asynchronous save still in flight

    def one_card_state(self, with_optimizer: bool = False):
        """(the model's state dict, the optimizer's or None) in the one-card
        layout; on a sharded mesh gathered (every rank takes part), else
        None, None (the live model and optimizer are the one-card ones)."""
        if self.parallel is None or not self.parallel.sharded:
            return None, None
        state = self.parallel.gather_state()
        opt = self.parallel.gather_optimizer_state(self.optimizer) if with_optimizer else None
        return state, opt

    def evaluate(self, dev_loader) -> float:
        """Mean deterministic loss over a loader of host-feature batches,
        in the training forward's precision (on a mesh each rank's rows, the
        batch's loss summed from the partials)."""
        self.model.eval()
        meter = AverageMeter()
        with torch.no_grad(), self.autocast():
            for batch in dev_loader:
                if self.parallel is None:
                    loss, _ = self.model(*self.batch_args(batch, train=False))
                else:
                    rows, ragged = self.parallel.rows(len(batch[2]["targets"]))
                    with self.parallel.loss_context(ragged):
                        loss, _ = self.model(*self.batch_args(slice_rows(batch, rows),
                                                              train=False))
                    if ragged:
                        loss = loss / self.mesh.size("data")
                    loss = all_reduce_(loss.reshape(1).float(), self.mesh.group("data"))
                meter.update(float(loss))
        self.model.train()
        return meter.avg
