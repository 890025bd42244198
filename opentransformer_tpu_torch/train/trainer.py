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
and history come from N single updates, which is how the port runs it. The
JAX trainer's other paths (fused update, pipeline schedules, a mesh,
MixSpeech, asynchronous saves) are not ported and raise.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any

import torch

from ..models.modules import set_dropout_generator
from .scheduler import build_optimizer, build_scheduler
from .utils import AverageMeter, MeanLoss, Summary

logger = logging.getLogger(__name__)

# train-section options of the JAX trainer that are not ported, with the
# value that means "off"
_NOT_PORTED = {"fused_update": False, "pp_schedule": "sharded", "pp_micro_batches": None,
               "async_save": False}
AUTOCAST_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to opentransformer_tpu_torch yet "
        "(see ROADMAP.md, Queue 1: What training and decoding still lack)")


def _tensor(x, device, dtype=None):
    return torch.as_tensor(x, dtype=dtype).to(device)


def feature_args(batch, device):
    """A host-feature batch → (feats, mask, targets, targets_length) on ``device``."""
    _, inputs, targets = batch
    return (_tensor(inputs["inputs"], device), _tensor(inputs["mask"], device, torch.bool),
            _tensor(targets["targets"], device, torch.long),
            _tensor(targets["targets_length"], device, torch.long))


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
                 resident=None, dev_probe_fn=None):
        for key, off in _NOT_PORTED.items():
            if train_cfg.get(key, off) != off:
                raise _not_ported(f"train.{key}={train_cfg[key]!r}")
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
        self.optimizer = build_optimizer(model.parameters(), train_cfg.get("optimizer", {}) or {},
                                         train_cfg.get("optimizer_type", "adam"))
        self.schedule = build_scheduler(train_cfg.get("scheduler", {}) or {},
                                        train_cfg.get("scheduler_type", "transformer"))
        self.global_step = 1
        self.global_epoch = 0
        self.nan_skips = 0
        self.mean_loss = MeanLoss()
        # one record per update: epoch, step, lr, micro-batch losses (and the
        # hybrid loss' parts under "aux"), grad norm, whether it was applied,
        # host time at its end
        self.history: list[dict] = []
        self.dev_losses: list[float] = []
        self._window: list[torch.Tensor] = []
        self._window_aux: list[dict] = []

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

    def micro_step(self, batch) -> torch.Tensor:
        """Forward and backward of one micro-batch; its gradient, scaled by
        1/accum_steps, adds to the parameters' ``.grad``. Returns the
        (unscaled) loss."""
        args = self.batch_args(batch)
        with self.autocast():
            loss, aux = self.model(*args)
        (loss / self.accum_steps).backward()
        self._window.append(loss.detach())
        self._window_aux.append({k: v.detach() for k, v in aux.items()})
        return loss.detach()

    def update(self, epoch: int = 0) -> dict:
        """Clip, noise, NaN guard and one optimizer step on the accumulated
        gradient; clears it and advances ``global_step``."""
        params = list(self.model.parameters())
        for p in params:  # an unused parameter takes part with a zero gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        gnorm = torch.sqrt(torch.stack([torch.sum(torch.square(g.float())) for g in grads]).sum())
        if self.grad_clip > 0:
            scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-6), 1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        if self.grad_noise > 0:
            for g in grads:
                noise = torch.randn(g.shape, generator=self.generator, device=g.device,
                                    dtype=g.dtype)
                g.add_(noise * self.grad_noise / self.accum_steps)
        aux_keys = sorted(self._window_aux[0]) if self._window_aux else []
        aux_vals = [a[k].float() for a in self._window_aux for k in aux_keys]
        # one host sync per update
        values = torch.stack([gnorm, *self._window, *aux_vals]).tolist()
        n = len(self._window)
        gnorm_val, losses = values[0], values[1 : 1 + n]
        aux = {k: values[1 + n + i :: len(aux_keys)] for i, k in enumerate(aux_keys)}
        applied = math.isfinite(gnorm_val)
        lr = self.schedule(self.global_step, self.global_epoch)
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
        self.global_step += 1
        return record

    # ----------------------------------------------------------- the epochs
    def train_one_epoch(self, epoch: int, train_loader) -> None:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        self._window, self._window_aux = [], []
        n_batches = len(train_loader)
        span_t0 = time.time()
        micro = 0
        for step, batch in enumerate(train_loader):
            self.micro_step(batch)
            micro += 1
            if micro == self.accum_steps or step == n_batches - 1:
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
            if self.is_debug and step > 30:
                break

    def train(self, train_loader) -> None:
        best = Summary()
        for epoch in range(self.global_epoch, self.epochs):
            train_loader.set_epoch(epoch)  # reshuffle before the epoch
            self.train_one_epoch(epoch, train_loader)
            self.global_epoch = epoch + 1
            if self.checkpointer is not None:
                self.checkpointer.save(epoch, self.model, self.optimizer,
                                       extra={"global_step": self.global_step,
                                              "nan_skips": self.nan_skips},
                                       keep_last_n=self.keep_last_n)
            if self.dev_loader is not None:
                dev_loss = self.evaluate(self.dev_loader)
                self.dev_losses.append(dev_loss)
                logger.info("epoch %d dev loss %.5f", epoch, dev_loss)
                if best.update(epoch, dev_loss) and self.checkpointer is not None:
                    self.checkpointer.save_params_only("model.best", self.model)
                    logger.info("new best epoch %d (dev loss %.5f)", epoch, dev_loss)
            if self.dev_probe_fn is not None:
                self.model.eval()
                with self.autocast():
                    self.dev_probe_fn(self.model, epoch)
                self.model.train()

    def evaluate(self, dev_loader) -> float:
        """Mean deterministic loss over a loader of host-feature batches,
        in the training forward's precision."""
        self.model.eval()
        meter = AverageMeter()
        with torch.no_grad(), self.autocast():
            for batch in dev_loader:
                loss, _ = self.model(*self.batch_args(batch, train=False))
                meter.update(float(loss))
        self.model.train()
        return meter.avg
