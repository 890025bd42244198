"""The online audio, kaldi feature, ESPnet and text datasets (counterpart
of ``opentransformer_tpu/data/datasets.py``).

``AudioDataset`` reads a ``wav.scp`` and a transcript file. A training
split with ``extract_on_device`` yields raw waveforms for the device
feature stage (``data/device_pipeline.py``); otherwise it yields host
log-fbank (``ops/fbank.py``: the kaldi-compatible ``fbank_numpy``, or
``logfbank_psf`` with ``feature_extractor: psf``) with per-utterance or
global CMVN, then, on a training split, ``gaussian_noise``: one offset a
mel bin, N(0, gaussian_noise²), added to every frame (as the JAX package
draws it), and host SpecAugment. Training waveforms may be speed- and
volume-perturbed first.

``KaldiDataset`` reads precomputed features through a ``feats.scp``, with
speaker CMVN (``utt2spk`` + ``cmvn``) or per-utterance normalization, a
``max_target_length`` filter, train-only ``additive_noise_std`` (fresh
Gaussian noise on every read) and host SpecAugment.

``ESPNetDataset`` reads ESPnet ``data.json`` files (``utts``: each one's
feature ark, frame count and token ids) with train-only SpecAugment.

These yield ``(utt_id, array, length, target ids, target count)`` and draw
every random number from child generators of the numpy generator they are
given, one locked draw a child, in the JAX package's order, so the same
seed gives the same arrays.

``TextDataset`` reads parallel ``utt unit unit ...`` src and tgt files for
LM training and yields ``(utt_id, src ids, tgt ids)``, both reversed with
``reverse``; unknown units map to each vocabulary's UNK.
"""

from __future__ import annotations

import json
import threading
import wave
from typing import Any, Optional

import numpy as np

from ..ops.fbank import fbank_numpy, logfbank_psf, normalize_per_utterance, num_frames
from . import UNK_TOKEN, load_vocab
from .augment import spec_augment_numpy
from .kaldi_io import cmvn_from_stats, load_mat, read_scp

PSF_EXTRACTORS = ("psf", "python_speech_feature")


class _RngSpawner:
    """Thread-safe per-sample generators: one locked draw from the parent
    seeds an independent child (the loader reads samples from a pool)."""

    def __init__(self, rng: Optional[np.random.Generator]):
        self._rng = rng or np.random.default_rng()
        self._lock = threading.Lock()

    def spawn(self) -> np.random.Generator:
        with self._lock:
            seed = int(self._rng.integers(0, 2 ** 63 - 1))
        return np.random.default_rng(seed)


def read_targets(text_files, unit2idx) -> dict[str, list[int]]:
    """``utt unit unit ...`` lines → {utt: ids}, unknown units to UNK."""
    return dict(_read_token_lines(text_files, unit2idx))


def _read_token_lines(paths, unit2idx):
    """(utt, ids) of every non-empty ``utt unit unit ...`` line, in file
    order, unknown units to the vocabulary's UNK."""
    unk = unit2idx.get(UNK_TOKEN, 2)
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split()
                if parts:
                    yield parts[0], [unit2idx.get(c, unk) for c in parts[1:]]


def _read_wav(path: str) -> tuple[int, np.ndarray]:
    """wav → (sample rate, float32 samples in [-1, 1], first channel)."""
    import scipy.io.wavfile as siw

    sr, data = siw.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav[:, 0]
    return int(sr), wav


class AudioDataset:
    """Online dataset over ``wav.scp`` (``dataset_type: online``)."""

    def __init__(self, params: Any, datadict: Any, is_eval: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self._rngs = _RngSpawner(rng)
        self.num_mel_bins = int(params.get("num_mel_bins", 40))
        # 'torchaudio' / 'ta': kaldi-compatible; 'psf': python_speech_features
        self.feature_extractor = params.get("feature_extractor", "torchaudio")
        self.return_waveform = bool(params.get("extract_on_device", False)) and not is_eval
        self.gaussian_noise = float(params.get("gaussian_noise", 0.0)) if not is_eval else 0.0
        # the online dataset ignores spec_augment_config and uses the
        # function's defaults, as the JAX package's does
        self.apply_spec_augment = bool(params.get("spec_augment", False)) and not is_eval
        self.normalization = bool(params.get("normalization", False))
        self.apply_volume_perturb = bool(params.get("volume_perturb", False)) and not is_eval
        self.apply_speed_perturb = bool(params.get("speed_perturb", False)) and not is_eval
        self.global_mean = self.global_std = None
        if self.normalization and params.get("global_cmvn"):
            base = params["global_cmvn"]
            self.global_mean = np.load(base + ".mean.npy")
            self.global_std = np.load(base + ".std.npy")

        self.unit2idx = load_vocab(params["vocab"])
        self.targets_dict = read_targets(datadict["text"], self.unit2idx)
        self.file_list: list[tuple[str, str]] = []
        for feat_file in datadict["feat"]:
            with open(feat_file, "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) == 2 and parts[0] in self.targets_dict:
                        self.file_list.append((parts[0], parts[1]))
        self.durations = datadict.get("wav-to-duration")

    def __len__(self) -> int:
        return len(self.file_list)

    def __getitem__(self, index: int):
        utt_id, path = self.file_list[index]
        sr, wav = _read_wav(path)
        rng = self._rngs.spawn()
        if self.apply_speed_perturb:
            ratio = rng.choice([0.9, 1.0, 1.1])
            if ratio != 1.0:
                from scipy.signal import resample_poly

                # resampling by 1/ratio changes the duration by ratio
                up, down = (10, 9) if ratio == 0.9 else (10, 11)
                wav = resample_poly(wav, up, down).astype(np.float32)
        if self.apply_volume_perturb:
            wav = wav * 10 ** (rng.uniform(-1.6, 1.6) / 20)
        targets = self.targets_dict[utt_id]
        if self.return_waveform:
            return utt_id, wav.astype(np.float32), len(wav), targets, len(targets)
        extract = logfbank_psf if self.feature_extractor in PSF_EXTRACTORS else fbank_numpy
        feature = extract(wav, sample_freq=sr, num_mel_bins=self.num_mel_bins)
        if self.normalization:
            if self.global_mean is not None:
                feature = (feature - self.global_mean) / self.global_std
            else:
                feature = normalize_per_utterance(feature)
        if self.gaussian_noise > 0.0:
            feature = feature + rng.normal(0.0, self.gaussian_noise,
                                           (feature.shape[-1],)).astype(np.float32)
        if self.apply_spec_augment:
            feature = spec_augment_numpy(feature, rng=rng)
        return utt_id, feature.astype(np.float32), feature.shape[0], targets, len(targets)

    def index_length_pair(self) -> list[tuple[int, int]]:
        """(index, frame count) from a wav-to-duration file where given,
        else from the wav headers."""
        dur_map = {}
        if self.durations:
            paths = self.durations if isinstance(self.durations, (list, tuple)) else [
                self.durations]
            for p in paths:
                with open(p, "r", encoding="utf-8") as f:
                    for line in f:
                        utt, dur = line.strip().split()
                        dur_map[utt] = int(float(dur) * 100)  # seconds → 10 ms frames
        pairs = []
        for i, (utt, path) in enumerate(self.file_list):
            if utt in dur_map:
                pairs.append((i, dur_map[utt]))
            else:
                with wave.open(path, "rb") as w:
                    pairs.append((i, num_frames(w.getnframes(), w.getframerate())))
        return pairs


class KaldiDataset:
    """Precomputed features from ``feats.scp`` (``dataset_type: kaldi``)."""

    def __init__(self, params: Any, datadict: Any, is_eval: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self._rngs = _RngSpawner(rng)
        self.apply_spec_augment = bool(params.get("spec_augment", False)) and not is_eval
        self.spec_augment_config = dict(params.get("spec_augment_config", {}) or {})
        self.max_target_length = int(params.get("max_target_length", 0))
        self.normalization = bool(params.get("normalization", False))
        # fresh noise on every read of a training split: the noise is added
        # after any CMVN, so it assumes unnormalized features (the synthetic
        # corpus keeps normalization off and bakes noise into dev and test)
        self.additive_noise_std = (float(params.get("additive_noise_std", 0.0))
                                   if not is_eval else 0.0)
        self.unit2idx = load_vocab(params["vocab"])
        self.targets_dict = read_targets(datadict["text"], self.unit2idx)

        self.utt2spk: dict[str, str] = {}
        self.spk_cmvn: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        if "utt2spk" in datadict and "cmvn" in datadict:
            for p in datadict["utt2spk"]:
                with open(p, "r", encoding="utf-8") as f:
                    for line in f:
                        u, spk = line.strip().split()
                        self.utt2spk[u] = spk
            for p in datadict["cmvn"]:
                for spk, rx in read_scp(p).items():
                    self.spk_cmvn[spk] = cmvn_from_stats(load_mat(rx))

        self.file_list: list[tuple[str, str]] = []
        for feat_file in datadict["feat"]:
            for utt, rx in read_scp(feat_file).items():
                if utt not in self.targets_dict:
                    continue
                if (self.max_target_length
                        and len(self.targets_dict[utt]) > self.max_target_length):
                    continue
                self.file_list.append((utt, rx))
        self.lengths_file = datadict.get("feat-to-len")

    def __len__(self) -> int:
        return len(self.file_list)

    def __getitem__(self, index: int):
        utt_id, rx = self.file_list[index]
        feature = load_mat(rx)
        spk = self.utt2spk.get(utt_id)
        if spk and spk in self.spk_cmvn:
            mean, std = self.spk_cmvn[spk]
            feature = (feature - mean) / std
        elif self.normalization:
            feature = normalize_per_utterance(feature)
        if self.additive_noise_std > 0.0:
            noise_rng = self._rngs.spawn()
            feature = feature + self.additive_noise_std * noise_rng.standard_normal(
                feature.shape).astype(feature.dtype)
        if self.apply_spec_augment:
            feature = spec_augment_numpy(feature, rng=self._rngs.spawn(),
                                         **self.spec_augment_config)
        targets = self.targets_dict[utt_id]
        return utt_id, feature.astype(np.float32), feature.shape[0], targets, len(targets)

    def target_row(self, index: int):
        """(utt_id, target ids) without reading the features (the
        device-resident corpus holds them)."""
        utt_id = self.file_list[index][0]
        return utt_id, self.targets_dict[utt_id]

    def index_length_pair(self) -> list[tuple[int, int]]:
        """(index, frame count) from a ``feat-to-len`` file where given (an
        utterance it lacks is read from its ark), else from the arks."""
        if not self.lengths_file:
            return [(i, load_mat(rx).shape[0]) for i, (_, rx) in enumerate(self.file_list)]
        paths = (self.lengths_file if isinstance(self.lengths_file, (list, tuple))
                 else [self.lengths_file])
        lmap = {}
        for p in paths:
            with open(p, "r", encoding="utf-8") as f:
                for line in f:
                    u, n = line.strip().split()
                    lmap[u] = int(n)
        return [(i, lmap[u] if u in lmap else load_mat(rx).shape[0])
                for i, (u, rx) in enumerate(self.file_list)]


class ESPNetDataset:
    """ESPnet ``data.json`` files (``dataset_type: espnet``; the split's
    ``json`` list, or ``feat``)."""

    additive_noise_std = 0.0  # read by the loader's resident-corpus build

    def __init__(self, params: Any, datadict: Any, is_eval: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self._rngs = _RngSpawner(rng)
        self.apply_spec_augment = bool(params.get("spec_augment", False)) and not is_eval
        self.spec_augment_config = dict(params.get("spec_augment_config", {}) or {})
        self.utts: list[tuple[str, str, list[int], int]] = []
        for path in datadict["json"] if "json" in datadict else datadict["feat"]:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            for utt_id, info in data["utts"].items():
                inp = info["input"][0]
                self.utts.append((utt_id, inp["feat"],
                                  [int(t) for t in info["output"][0]["tokenid"].split()],
                                  int(inp["shape"][0])))

    def __len__(self) -> int:
        return len(self.utts)

    def __getitem__(self, index: int):
        utt_id, rx, targets, _ = self.utts[index]
        feature = load_mat(rx)
        if self.apply_spec_augment:
            feature = spec_augment_numpy(feature, rng=self._rngs.spawn(),
                                         **self.spec_augment_config)
        return utt_id, feature.astype(np.float32), feature.shape[0], targets, len(targets)

    def target_row(self, index: int):
        """(utt_id, target ids) without reading the features."""
        utt_id, _, targets, _ = self.utts[index]
        return utt_id, targets

    def index_length_pair(self) -> list[tuple[int, int]]:
        return [(i, n) for i, (_, _, _, n) in enumerate(self.utts)]


class TextDataset:
    """Parallel src/tgt token files for LM training (``dataset_type: text``)."""

    def __init__(self, params: Any, datadict: Any, is_eval: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.src_unit2idx = load_vocab(params["src_vocab"])
        self.tgt_unit2idx = load_vocab(params["tgt_vocab"])
        self.reverse = bool(params.get("reverse", False))
        self.src_list = list(_read_token_lines(datadict["src"], self.src_unit2idx))
        self.tgt_dict = read_targets(datadict["tgt"], self.tgt_unit2idx)

    def __len__(self) -> int:
        return len(self.src_list)

    def __getitem__(self, index: int):
        utt_id, src = self.src_list[index]
        tgt = self.tgt_dict[utt_id]
        if self.reverse:
            src, tgt = src[::-1], tgt[::-1]
        return utt_id, src, tgt

    def index_length_pair(self) -> list[tuple[int, int]]:
        return [(i, len(s)) for i, (_, s) in enumerate(self.src_list)]

