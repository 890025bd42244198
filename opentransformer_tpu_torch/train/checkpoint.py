"""Per-epoch checkpoints (counterpart of ``opentransformer_tpu/train/checkpoint.py``).

``<expdir>/model.epoch.N/`` holds

  * ``params.npz``: the model's parameters in the JAX package's naming
    (``compat.params_to_jax``, ``"//"``-joined keys), float32, which the
    port's eval CLI (``--npz``, with ``--model_cfg <expdir>/config.json``)
    and ``compat.load_npz`` read;
  * ``optimizer.pt``: the optimizer's state dict (``torch.save``);
  * ``extra.json``: the trainer's counters (global step, NaN skips).

A directory is written under a ``.tmp`` name and renamed when complete, so
a crash never leaves a partial ``model.epoch.N``. The run's config sits
beside them as ``config.json`` (``load_config``). ``save_params_only``
writes a directory with ``params.npz`` alone (``model.best``); ``average``
writes the mean of an epoch range's parameters as
``model.average.from{s}to{e}``, summed in float64 and written as float32,
as the JAX package's does. ``restore_latest`` and ``load_optimizer`` /
``load_extra`` give back what resuming (``-ct``, ``-ios``) needs. Orbax is
not available on the card, so these are not orbax directories.

With ``async_save`` a save copies the parameters and the optimizer state
on their device and returns; a writer thread moves them to the host and
writes them while training goes on. One save is in flight at a time, and
``wait()`` (called before every read and by the trainer at the end) joins
it and raises its error, if any.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from .. import compat

PARAMS = "params.npz"
OPTIMIZER = "optimizer.pt"
EXTRA = "extra.json"


def _clone(tree):
    """Tensors of a (nested) state dict copied on their device."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


class Checkpointer:
    def __init__(self, expdir: str, config: Optional[dict] = None, async_save: bool = False):
        self.expdir = os.path.abspath(expdir)
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.expdir, exist_ok=True)
        if config is not None:
            with open(os.path.join(self.expdir, "config.json"), "w", encoding="utf-8") as f:
                json.dump(config, f, ensure_ascii=False, indent=1)

    def wait(self) -> None:
        """Join the save in flight, if any, and raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.expdir, f"model.epoch.{epoch}")

    def list_epochs(self) -> list[int]:
        out = []
        for name in os.listdir(self.expdir):
            m = re.fullmatch(r"model\.epoch\.(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    @staticmethod
    def _write_params(path: str, model: torch.nn.Module, state=None, optimizer_state=None,
                   extra: Optional[dict] = None) -> None:
        """Write the directory under ``path.tmp``, then rename it to ``path``."""
        tmp = path + ".tmp"
        for p in (tmp, path):
            if os.path.exists(p):
                shutil.rmtree(p)
        os.makedirs(tmp)
        compat.save_npz(os.path.join(tmp, PARAMS), compat.params_to_jax(model, state),
                        dtype=np.float32)
        if optimizer_state is not None:
            torch.save(optimizer_state, os.path.join(tmp, OPTIMIZER))
        if extra is not None:
            with open(os.path.join(tmp, EXTRA), "w", encoding="utf-8") as f:
                json.dump(extra, f)
        os.rename(tmp, path)

    def save(self, epoch: int, model: torch.nn.Module, optimizer,
             extra: Optional[dict] = None, keep_last_n: int = 0, state: Optional[dict] = None,
             optimizer_state: Optional[dict] = None) -> str:
        """Write ``model.epoch.N``. ``state`` / ``optimizer_state`` give the
        values in place of the live model's and optimizer's (a sharded
        model's, gathered to the one-card layout)."""
        path = self.epoch_path(epoch)
        extra = dict(extra or {})
        if optimizer_state is None:
            optimizer_state = optimizer.state_dict()
        if not self.async_save:
            self._write_params(path, model, state, optimizer_state, extra)
            if keep_last_n > 0:
                self.prune(keep_last_n)
            return path
        self.wait()
        state = _clone(model.state_dict() if state is None else state)
        opt_state = _clone(optimizer_state)

        def work():
            try:
                self._write_params(path, model, state, opt_state, extra)
                if keep_last_n > 0:
                    self.prune(keep_last_n)
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, name="checkpoint-save", daemon=True)
        self._thread.start()
        return path

    def save_params_only(self, name: str, model: torch.nn.Module,
                         state: Optional[dict] = None) -> str:
        path = os.path.join(self.expdir, name)
        self._write_params(path, model, state)
        return path

    def load_params(self, path: str) -> dict:
        """The JAX-layout parameter tree of a checkpoint directory (for
        ``compat.load_into``)."""
        self.wait()
        return compat.load_npz(os.path.join(path, PARAMS))

    def load_optimizer(self, path: str, device) -> dict:
        """The optimizer state dict saved in a checkpoint directory."""
        self.wait()
        return torch.load(os.path.join(path, OPTIMIZER), map_location=device, weights_only=True)

    def load_extra(self, path: str) -> dict:
        self.wait()
        with open(os.path.join(path, EXTRA), encoding="utf-8") as f:
            return json.load(f)

    def restore_latest(self) -> Optional[tuple[int, str]]:
        """(epoch, directory) of the newest ``model.epoch.N``, or None."""
        self.wait()
        epochs = self.list_epochs()
        return (epochs[-1], self.epoch_path(epochs[-1])) if epochs else None

    def average(self, start_epoch: int, end_epoch: int, out_name: Optional[str] = None) -> str:
        """Average the parameters of the epochs in [start_epoch, end_epoch]
        (those that exist) into ``<expdir>/model.average.from{s}to{e}``;
        returns its path."""
        self.wait()
        epochs = [e for e in self.list_epochs() if start_epoch <= e <= end_epoch]
        if not epochs:
            raise FileNotFoundError(
                f"no checkpoints in [{start_epoch}, {end_epoch}] under {self.expdir}")
        acc: dict = {}
        for e in epochs:
            with np.load(os.path.join(self.epoch_path(e), PARAMS)) as z:
                for key in z.files:
                    x = z[key].astype(np.float64)
                    acc[key] = acc[key] + x if key in acc else x
        out_name = out_name or f"model.average.from{start_epoch}to{end_epoch}"
        path = os.path.join(self.expdir, out_name)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        n = float(len(epochs))
        np.savez(os.path.join(path, PARAMS),
                 **{k: (v / n).astype(np.float32) for k, v in acc.items()})
        return path

    def load_config(self) -> Optional[dict]:
        """The run's ``config.json``, if it was written."""
        p = os.path.join(self.expdir, "config.json")
        if not os.path.exists(p):
            return None
        with open(p, encoding="utf-8") as f:
            return json.load(f)

    def prune(self, keep_last_n: int) -> None:
        for e in self.list_epochs()[:-keep_last_n]:
            shutil.rmtree(self.epoch_path(e), ignore_errors=True)
