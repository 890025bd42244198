"""The online audio dataset (counterpart of the ``AudioDataset`` part of
``opentransformer_tpu/data/datasets.py``).

Reads a ``wav.scp`` and a transcript file. A training split with
``extract_on_device`` yields raw waveforms for the device feature stage
(``data/device_pipeline.py``); an evaluation split yields host log-fbank
(``ops/fbank.py:fbank_numpy``) with per-utterance or global CMVN. Both
yield ``(utt_id, array, length, target ids, target count)``. Speed and
volume perturbation of the training waveforms are ported; host-feature
training (host SpecAugment, ``gaussian_noise``) and the python_speech_features
extractor are not, and raise.
"""

from __future__ import annotations

import threading
import wave
from typing import Any, Optional

import numpy as np

from ..ops.fbank import fbank_numpy, normalize_per_utterance, num_frames
from . import UNK_TOKEN, load_vocab


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
    targets: dict[str, list[int]] = {}
    unk = unit2idx.get(UNK_TOKEN, 2)
    for path in text_files:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split()
                if parts:
                    targets[parts[0]] = [unit2idx.get(c, unk) for c in parts[1:]]
    return targets


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
        extractor = params.get("feature_extractor", "torchaudio")
        if extractor not in ("torchaudio", "ta"):
            raise NotImplementedError(
                f"feature_extractor {extractor!r} is not ported to opentransformer_tpu_torch "
                "yet (see ROADMAP.md, Queue 1 item 6); the kaldi-compatible one is")
        self.return_waveform = bool(params.get("extract_on_device", False)) and not is_eval
        if not is_eval and not self.return_waveform:
            raise NotImplementedError(
                "training from host features is not ported to opentransformer_tpu_torch yet "
                "(see ROADMAP.md, Queue 1 item 6); set data.extract_on_device: true")
        if not is_eval and float(params.get("gaussian_noise", 0.0)) > 0.0:
            raise NotImplementedError(
                "data.gaussian_noise acts on host features, which training with "
                "extract_on_device does not make; it is not ported")
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
        feature = fbank_numpy(wav, sample_freq=sr, num_mel_bins=self.num_mel_bins)
        if self.normalization:
            if self.global_mean is not None:
                feature = (feature - self.global_mean) / self.global_std
            else:
                feature = normalize_per_utterance(feature)
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
