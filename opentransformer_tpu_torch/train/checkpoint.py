"""Per-epoch checkpoints (counterpart of ``opentransformer_tpu/train/checkpoint.py``).

``<expdir>/model.epoch.N/`` holds

  * ``params.npz``: the model's parameters in the JAX package's naming
    (``compat.params_to_jax``, ``"//"``-joined keys), float32, which the
    port's eval CLI (``--npz``, with ``--model_cfg <expdir>/config.json``)
    and ``compat.load_npz`` read;
  * ``optimizer.pt``: the torch optimizer's state dict;
  * ``extra.json``: the trainer's counters (global step, NaN skips).

The run's config sits beside them as ``config.json`` (``load_config``).
``save_params_only`` writes a directory with ``params.npz`` alone
(``model.best``); ``average`` writes the mean of an epoch range's
parameters as ``model.average.from{s}to{e}``, summed in float64 and
written as float32, as the JAX package's does. Orbax is not available on
the card, so these are not orbax directories; resuming (``-ct``) is not
ported yet.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from .. import compat

PARAMS = "params.npz"
OPTIMIZER = "optimizer.pt"
EXTRA = "extra.json"


class Checkpointer:
    def __init__(self, expdir: str, config: Optional[dict] = None):
        self.expdir = os.path.abspath(expdir)
        os.makedirs(self.expdir, exist_ok=True)
        if config is not None:
            with open(os.path.join(self.expdir, "config.json"), "w", encoding="utf-8") as f:
                json.dump(config, f, ensure_ascii=False, indent=1)

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.expdir, f"model.epoch.{epoch}")

    def list_epochs(self) -> list[int]:
        out = []
        for name in os.listdir(self.expdir):
            m = re.fullmatch(r"model\.epoch\.(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _write_params(self, path: str, model: torch.nn.Module) -> None:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        compat.save_npz(os.path.join(path, PARAMS), compat.params_to_jax(model),
                        dtype=np.float32)

    def save(self, epoch: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             extra: Optional[dict] = None, keep_last_n: int = 0) -> str:
        path = self.epoch_path(epoch)
        self._write_params(path, model)
        torch.save(optimizer.state_dict(), os.path.join(path, OPTIMIZER))
        with open(os.path.join(path, EXTRA), "w", encoding="utf-8") as f:
            json.dump(dict(extra or {}), f)
        if keep_last_n > 0:
            self.prune(keep_last_n)
        return path

    def save_params_only(self, name: str, model: torch.nn.Module) -> str:
        path = os.path.join(self.expdir, name)
        self._write_params(path, model)
        return path

    def load_params(self, path: str) -> dict:
        """The JAX-layout parameter tree of a checkpoint directory (for
        ``compat.load_into``)."""
        return compat.load_npz(os.path.join(path, PARAMS))

    def average(self, start_epoch: int, end_epoch: int, out_name: Optional[str] = None) -> str:
        """Average the parameters of the epochs in [start_epoch, end_epoch]
        (those that exist) into ``<expdir>/model.average.from{s}to{e}``;
        returns its path."""
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
