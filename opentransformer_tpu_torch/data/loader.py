"""Batches for training and evaluation
(counterpart of ``opentransformer_tpu/data/loader.py``).

``FeatureLoader`` builds the dataset of one split (``dataset_type``
``online``, ``kaldi``, ``espnet`` or ``text``), a sampler whose batch order
``set_epoch`` draws again (the bucketing sampler of ``bucket.py`` when the
config has a ``bucket`` section and the data is speech, else length-sorted
fixed-size batches), and yields collated batches from a background thread:

  * a training split of the online dataset with ``extract_on_device``:
    padded waveforms (``device_pipeline.collate_waveforms``);
  * a training split of the kaldi or espnet dataset with ``device_resident``: the
    ``[B]`` row indices ``corpus_idx`` into the corpus that
    ``build_resident_corpus`` reads for ``data/resident.py`` (another
    dataset streams from the host, with a warning, as in the JAX package);
  * a text split: src = BOS ⧺ tokens and tgt = tokens ⧺ EOS
    (``collate_text``, the LMs' training pairs);
  * otherwise padded host features (``collate_speech``), padded to the
    batch's bucket boundary.

Speech targets are BOS ⧺ y ⧺ EOS ⧺ PAD… with ``targets_length = len(y) +
1``. As in the JAX package, an evaluation split buckets too, so
``drop_last`` drops its short batches. On a spawned mesh (``cli/run.py
-n``) every rank reads the global batch and the trainer keeps its rows
(``parallel/engine.py``), so a rank's rows keep the global batch's padding.
With ``num_shards`` > 1 (``cli/run.py --multihost``: a rank's data index
over the data axis' size) each shard iterates the same sampler sequence and
reads only its rows of each batch, ``idxs[shard_id::num_shards]`` (row 0
when that slice is empty), as the JAX loader slices per host; the trainer
assembles the global batch from the shards. The device-resident corpus is
then off, with the JAX loader's warning.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional

import numpy as np

from . import BOS, EOS, PAD
from .bucket import DEFAULT_BOUNDARIES, BySequenceLengthSampler
from .datasets import AudioDataset, ESPNetDataset, KaldiDataset, TextDataset
from .device_pipeline import collate_waveforms

logger = logging.getLogger(__name__)

DATASETS = {"online": AudioDataset, "kaldi": KaldiDataset, "espnet": ESPNetDataset,
            "text": TextDataset}


def quantize(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def collate_targets(tgts, ulens, target_pad_multiple: int = 8):
    """Target ids → (BOS ⧺ y ⧺ EOS ⧺ PAD…, bool mask, targets_length = len + 1),
    padded to a multiple of ``target_pad_multiple``."""
    b = len(tgts)
    u_max = quantize(max(ulens) + 2, target_pad_multiple)
    y = np.full((b, u_max), PAD, np.int32)
    y_mask = np.zeros((b, u_max), bool)
    for i in range(b):
        y[i, 0] = BOS
        y[i, 1 : 1 + ulens[i]] = tgts[i]
        y[i, 1 + ulens[i]] = EOS
        y_mask[i, : ulens[i] + 2] = True
    return {"targets": y, "targets_length": np.asarray(ulens, np.int32) + 1, "mask": y_mask}


def collate_speech(samples, pad_to_frames: Optional[int] = None, target_pad_multiple: int = 8):
    """[(utt, feat[T, F], T, targets, U)] → (utt_ids, inputs, targets) with
    features zero-padded to ``pad_to_frames`` (longer ones are cut to it)."""
    utt_ids = [s[0] for s in samples]
    t_max = pad_to_frames or max(s[2] for s in samples)
    tlens = [min(s[2], t_max) for s in samples]
    b, f = len(samples), samples[0][1].shape[1]
    x = np.zeros((b, t_max, f), np.float32)
    x_mask = np.zeros((b, t_max), bool)
    for i, s in enumerate(samples):
        x[i, : tlens[i]] = s[1][: tlens[i]]
        x_mask[i, : tlens[i]] = True
    inputs = {"inputs": x, "inputs_length": np.asarray(tlens, np.int32), "mask": x_mask}
    return utt_ids, inputs, collate_targets([s[3] for s in samples], [s[4] for s in samples],
                                            target_pad_multiple)


def collate_text(samples, target_pad_multiple: int = 8):
    """[(utt, src ids, tgt ids)] → (utt_ids, inputs, targets) with src = BOS
    ⧺ tokens and tgt = tokens ⧺ EOS, PAD-filled to a multiple of
    ``target_pad_multiple`` (both dicts share the mask and the lengths,
    which count EOS)."""
    b = len(samples)
    u_max = quantize(max(len(s[1]) for s in samples) + 1, target_pad_multiple)
    src = np.full((b, u_max), PAD, np.int32)
    tgt = np.full((b, u_max), PAD, np.int32)
    mask = np.zeros((b, u_max), bool)
    lens = np.zeros((b,), np.int32)
    for i, (_, s_ids, t_ids) in enumerate(samples):
        n = len(s_ids)
        src[i, 0] = BOS
        src[i, 1 : 1 + n] = s_ids
        tgt[i, :n] = t_ids
        tgt[i, n] = EOS
        mask[i, : n + 1] = True
        lens[i] = n + 1
    return ([s[0] for s in samples], {"inputs": src, "inputs_length": lens, "mask": mask},
            {"targets": tgt, "targets_length": lens, "mask": mask})


class _Prefetcher:
    """Iterates ``gen_fn()`` in a background thread through a bounded
    queue; abandoning the iterator stops the thread at its next put."""

    def __init__(self, gen_fn, max_prefetch: int = 10):
        self.gen_fn = gen_fn
        self.max_prefetch = max_prefetch

    def __iter__(self):
        q: queue.Queue = queue.Queue(self.max_prefetch)
        sentinel = object()
        stop = threading.Event()
        failure: list[Exception] = []

        def put_bounded(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.gen_fn():
                    if not put_bounded(item):
                        return
            except Exception as e:  # handed to the consumer, raised there
                failure.append(e)
            finally:
                put_bounded(sentinel)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if failure:
                raise failure[0]
        finally:
            stop.set()
            th.join(timeout=5.0)


class _SimpleSampler:
    """Length-sorted fixed-size batches, each with its frame count padded to
    a multiple of ``frame_multiple``, in a permutation seeded by
    ``seed + epoch``."""

    def __init__(self, order, lengths, batch_size, seed=0, frame_multiple=32):
        self.order = order
        self.lengths = lengths
        self.batch_size = batch_size
        self.seed = seed
        self.frame_multiple = frame_multiple
        self.epoch = 0
        self._regen()

    def _regen(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for s in range(0, len(self.order), self.batch_size):
            chunk = self.order[s : s + self.batch_size]
            max_len = max(self.lengths[i] for i in chunk)
            batches.append((quantize(max_len, self.frame_multiple), chunk))
        perm = rng.permutation(len(batches))
        self.batches = [batches[i] for i in perm]

    def set_epoch(self, epoch):
        self.epoch = epoch
        self._regen()

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class FeatureLoader:
    """Dataset + sampler + collate for one split of ``params['data']``."""

    def __init__(self, params: Any, name: str = "train", is_eval: bool = False,
                 batch_size: Optional[int] = None, seed: int = 0, num_shards: int = 1,
                 shard_id: int = 0):
        data_cfg = params["data"] if "data" in params else params
        self.data_cfg = data_cfg
        dataset_type = data_cfg.get("dataset_type", "kaldi")
        if dataset_type not in DATASETS:
            raise ValueError(f"unknown dataset_type {dataset_type!r} (known: {sorted(DATASETS)})")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.num_shards, self.shard_id = int(num_shards), int(shard_id)
        want_resident = bool(data_cfg.get("device_resident", False)) and not is_eval
        self.device_resident = (want_resident and dataset_type in ("kaldi", "espnet")
                                and self.num_shards == 1)
        if want_resident and not self.device_resident:
            logger.warning("device_resident requested but unsupported here (dataset_type=%s, "
                           "num_shards=%d) — using the host path", dataset_type,
                           self.num_shards)
        self.target_pad_multiple = int(data_cfg.get("target_pad_multiple", 8))
        self.num_workers = int(data_cfg.get("num_workers", 0))
        self.dataset = DATASETS[dataset_type](data_cfg, data_cfg[name], is_eval=is_eval,
                                              rng=np.random.default_rng(seed))
        self.extract_on_device = getattr(self.dataset, "return_waveform", False)
        self.is_text = dataset_type == "text"
        self.batch_size = int(batch_size or data_cfg.get("batch_size", 16))
        pairs = self.dataset.index_length_pair()
        bucket = data_cfg.get("bucket")
        if bucket and not self.is_text:
            auto = bucket.get("audo_set_batch_size", bucket.get("auto_set_batch_size", False))
            self.sampler = BySequenceLengthSampler(
                pairs, bucket_boundaries=bucket.get("bucket_boundaries", DEFAULT_BOUNDARIES),
                batch_size=self.batch_size,
                bucket_batch_sizes=bucket.get("bucket_batch_size") or None,
                max_frames_one_batch=bucket.get("max_frames_one_batch", 0) if auto else 0,
                rm_the_long_sents=bucket.get("rm_the_long_sents", False),
                drop_last=bucket.get("drop_last", False), seed=seed,
                overlong_pad_multiple=bucket.get("overlong_pad_multiple", 256))
        else:
            order = [i for i, _ in sorted(pairs, key=lambda p: p[1])]
            self.sampler = _SimpleSampler(
                order, dict(pairs), self.batch_size, seed=seed,
                frame_multiple=int(data_cfg.get("frame_pad_multiple", 32)))

    def __len__(self) -> int:
        return len(self.sampler)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def build_resident_corpus(self, storage_dtype: Optional[str] = None):
        """The split's clean features (noise and SpecAugment off: they are
        drawn on the device) as ``resident.build_corpus`` pads them, to the
        largest bucket boundary (→ (corpus, frame counts))."""
        from .resident import build_corpus

        if not self.device_resident:
            raise RuntimeError("the loader is not in device_resident mode")
        storage_dtype = storage_dtype or str(self.data_cfg.get("device_resident_dtype",
                                                               "float16"))
        bucket = self.data_cfg.get("bucket")
        if bucket:
            pad_to = max(bucket.get("bucket_boundaries", DEFAULT_BOUNDARIES))
            pad_multiple = int(bucket.get("overlong_pad_multiple", 256))
        else:
            pad_to, pad_multiple = 0, int(self.data_cfg.get("frame_pad_multiple", 32))
        ds = self.dataset
        saved = ds.apply_spec_augment, ds.additive_noise_std
        ds.apply_spec_augment, ds.additive_noise_std = False, 0.0
        try:
            return build_corpus(ds, pad_to_frames=pad_to, pad_multiple=pad_multiple,
                                storage_dtype=storage_dtype)
        finally:
            ds.apply_spec_augment, ds.additive_noise_std = saved

    def _resident_batch(self, idxs):
        """(utt_ids, {corpus_idx}, targets): the features stay on the card."""
        rows = [self.dataset.target_row(i) for i in idxs]
        tgts = [t for _, t in rows]
        return ([u for u, _ in rows], {"corpus_idx": np.asarray(idxs, np.int32)},
                collate_targets(tgts, [len(t) for t in tgts], self.target_pad_multiple))

    def _shard(self, idxs):
        """This shard's rows of a batch (the JAX loader's rule: the same
        batches and steps on every shard; row 0 when the slice is empty)."""
        if self.num_shards == 1:
            return idxs
        return idxs[self.shard_id :: self.num_shards] or [idxs[0]]

    def _iter_batches(self):
        if self.device_resident:
            for _, idxs in self.sampler:
                yield self._resident_batch(idxs)
            return
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 1 else None
        try:
            for boundary, idxs in self.sampler:
                idxs = self._shard(idxs)
                if pool is not None:
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                else:
                    samples = [self.dataset[i] for i in idxs]
                if self.is_text:
                    yield collate_text(samples, self.target_pad_multiple)
                elif self.extract_on_device:
                    yield collate_waveforms(samples)
                else:
                    yield collate_speech(samples, pad_to_frames=boundary,
                                         target_pad_multiple=self.target_pad_multiple)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    def __iter__(self) -> Iterator:
        return iter(_Prefetcher(self._iter_batches))
