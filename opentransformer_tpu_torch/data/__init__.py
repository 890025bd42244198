"""Vocabulary constants and I/O (counterpart of ``opentransformer_tpu/data``).

Special-token ids are part of the on-disk data contract: PAD and the CTC
blank share id 0, BOS and EOS share id 1 (written as ``<S/E>``), UNK is 2.
Vocab files are ``unit idx`` lines.
"""

from __future__ import annotations

PAD = 0
BLK = 0  # CTC blank shares the padding id
BOS = 1
EOS = 1  # start/end share one token, written as '<S/E>'
UNK = 2

PAD_TOKEN = "<PAD>"
BOS_TOKEN = "<S/E>"
EOS_TOKEN = "<S/E>"
UNK_TOKEN = "<UNK>"


def load_vocab(path: str) -> dict[str, int]:
    """Read a ``unit idx`` vocab file into a unit→id dict."""
    vocab: dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 2:
                continue
            unit, idx = parts
            vocab[unit] = int(idx)
    return vocab


def load_idx2unit_map(path: str) -> dict[int, str]:
    """Read a ``unit idx`` vocab file into an id→unit dict."""
    return {idx: unit for unit, idx in load_vocab(path).items()}


def write_vocab(vocab: dict[str, int], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for unit, idx in sorted(vocab.items(), key=lambda kv: kv[1]):
            f.write(f"{unit} {idx}\n")
