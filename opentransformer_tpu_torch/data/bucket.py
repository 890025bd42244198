"""Length bucketing (counterpart of ``opentransformer_tpu/data/bucket.py``).

Utterances go into frame-length buckets with explicit boundaries; each
batch holds one bucket and is tagged with its boundary, which the collate
pads the frames to. An utterance longer than the last boundary gets a
pseudo-boundary at the next multiple of ``overlong_pad_multiple`` (or is
dropped with ``rm_the_long_sents``). A bucket's batch size is fixed
(``batch_size``), set per bucket (``bucket_batch_sizes``; an over-long
pseudo-boundary scales the last one down by the frame ratio) or derived from
a frame budget (``max_frames_one_batch``). Each epoch draws from
``np.random.default_rng(seed + epoch)``: one permutation a bucket in
insertion order, then one of the batch order, the JAX sampler's calls in its
order, so both give the same batches.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_BOUNDARIES = (100, 200, 300, 400, 500, 600, 700, 800, 900, 1000, 1200, 1600, 2000)


class BySequenceLengthSampler:
    """Iterates ``(boundary, [dataset indices])`` batches; ``batches`` is
    drawn again by ``set_epoch``."""

    def __init__(self, index_length_pairs: Sequence[tuple[int, int]],
                 bucket_boundaries: Sequence[int] = DEFAULT_BOUNDARIES, batch_size: int = 16,
                 bucket_batch_sizes: Optional[Sequence[int]] = None,
                 max_frames_one_batch: int = 0, rm_the_long_sents: bool = False,
                 drop_last: bool = False, seed: int = 0, overlong_pad_multiple: int = 256):
        self.boundaries = sorted(int(b) for b in bucket_boundaries)
        self.batch_size = int(batch_size)
        self.bucket_batch_sizes = list(bucket_batch_sizes) if bucket_batch_sizes else None
        self.max_frames_one_batch = int(max_frames_one_batch or 0)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.epoch = 0
        self.overlong_pad_multiple = max(int(overlong_pad_multiple or 256), 1)

        self.buckets: dict[int, list[int]] = {b: [] for b in self.boundaries}
        dropped = overlong = 0
        for idx, length in index_length_pairs:
            b = self._bucket_of(length)
            if b is None:
                if rm_the_long_sents:
                    dropped += 1
                    continue
                m = self.overlong_pad_multiple
                b = -(-int(length) // m) * m
                overlong += 1
                self.buckets.setdefault(b, [])
            self.buckets[b].append(idx)
        if dropped:
            logger.info("dropped %d utterances longer than %d frames", dropped,
                        self.boundaries[-1])
        if overlong:
            logger.info("%d utterances longer than %d frames bucketed to %d-frame quanta",
                        overlong, self.boundaries[-1], self.overlong_pad_multiple)
        self._regenerate()

    def _bucket_of(self, length: int) -> Optional[int]:
        for b in self.boundaries:
            if length <= b:
                return b
        return None

    def _batch_size_for(self, boundary: int) -> int:
        if self.max_frames_one_batch > 0:
            return max(self.max_frames_one_batch // boundary, 1)
        if self.bucket_batch_sizes:
            i = next((k for k, b in enumerate(self.boundaries) if b >= boundary),
                     len(self.boundaries) - 1)
            bs = int(self.bucket_batch_sizes[min(i, len(self.bucket_batch_sizes) - 1)])
            if boundary > self.boundaries[-1]:
                # an over-long pseudo-boundary: the last size scaled down by
                # the frame ratio
                bs = max(int(bs * self.boundaries[-1] / boundary), 1)
            return bs
        return self.batch_size

    def _regenerate(self) -> None:
        rng = np.random.default_rng(self.seed + self.epoch)
        batches: list[tuple[int, list[int]]] = []
        for b, idxs in self.buckets.items():
            if not idxs:
                continue
            order = rng.permutation(len(idxs))
            bs = self._batch_size_for(b)
            for s in range(0, len(idxs), bs):
                chunk = [idxs[i] for i in order[s : s + bs]]
                if self.drop_last and len(chunk) < bs:
                    continue
                batches.append((b, chunk))
        order = rng.permutation(len(batches))
        self.batches = [batches[i] for i in order]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self._regenerate()

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)
