"""Training meters (counterpart of ``opentransformer_tpu/train/utils.py``):
the window-100 running mean loss, an average meter, the best-epoch tracker
and the TensorBoard scalar writer of ``--visual``."""

from __future__ import annotations

import collections
import logging

logger = logging.getLogger(__name__)


class MeanLoss:
    """Running mean over the last ``window`` optimizer updates."""

    def __init__(self, window: int = 100):
        self.buf: collections.deque = collections.deque(maxlen=window)

    def update(self, v: float) -> None:
        self.buf.append(float(v))

    def mean(self) -> float:
        return sum(self.buf) / max(len(self.buf), 1)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Summary:
    """Best-epoch tracker (lower is better)."""

    def __init__(self):
        self.best_epoch = -1
        self.best_value = float("inf")

    def update(self, epoch: int, value: float) -> bool:
        if value < self.best_value:
            self.best_value = value
            self.best_epoch = epoch
            return True
        return False


class Visualizer:
    """TensorBoard scalars through ``torch.utils.tensorboard``; where that
    does not import (no ``tensorboard`` package), a warning and no-ops."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            logger.warning("--visual: torch.utils.tensorboard does not import (%s); no "
                           "TensorBoard scalars are written", e)
            self.writer = None
        else:
            self.writer = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
