"""Synthetic benchmark corpus (counterpart of ``opentransformer_tpu/data/synth.py``).

Every split derives from fixed seeds with numpy alone, so any process
regenerates it bit-exactly: same seeds, same RNG call order as the JAX
package's module (``tests/test_torch_port_model.py`` checks the bytes).

  * each unit u has a random 40-dim acoustic pattern ``p_u``;
  * a token is ``p_u`` tiled for a random 24-40 frame duration;
  * utterances are 8-28 tokens drawn uniformly from the 300 active units,
    terminated by a distinct end-of-utterance cue pattern;
  * Gaussian noise at sigma=0.3 is baked into dev/test, not into train.

The vocab has 4233 entries (3 specials + 4230 units) so the decoder's output
projection matches the AISHELL flagship; only the first 300 units appear.
"""

from __future__ import annotations

import os

import numpy as np

FEAT_DIM = 40
VOCAB_SIZE = 4233
N_ACTIVE_UNITS = 300
MIN_TOKENS, MAX_TOKENS = 8, 28
MIN_DUR, MAX_DUR = 24, 40  # frames per token (10 ms frames)
END_DUR = 24
NOISE_SIGMA = 0.3
PATTERN_SEED = 7
SPLIT_SEEDS = {"train": 100, "dev": 200, "test": 300}
SPLIT_SIZES = {"train": 20000, "dev": 200, "test": 500}
MAX_FRAMES = MAX_TOKENS * MAX_DUR + END_DUR  # 1144


def unit_names() -> list:
    return [f"u{i:04d}" for i in range(VOCAB_SIZE - 3)]


def make_vocab() -> dict:
    vocab = {"<PAD>": 0, "<S/E>": 1, "<UNK>": 2}
    for i, u in enumerate(unit_names()):
        vocab[u] = 3 + i
    return vocab


def make_patterns() -> np.ndarray:
    """[N_ACTIVE_UNITS + 1, FEAT_DIM]; last row is the end-of-utterance cue."""
    rng = np.random.default_rng(PATTERN_SEED)
    return (rng.normal(size=(N_ACTIVE_UNITS + 1, FEAT_DIM)) * 2.0).astype(np.float32)


def gen_utterance(rng: np.random.Generator, patterns: np.ndarray,
                  noise: bool = True):
    """-> (feats [T, FEAT_DIM] f32, token_unit_indices list[int])."""
    n_tok = int(rng.integers(MIN_TOKENS, MAX_TOKENS + 1))
    toks = rng.integers(0, N_ACTIVE_UNITS, n_tok).tolist()
    segs = [np.tile(patterns[t], (int(rng.integers(MIN_DUR, MAX_DUR + 1)), 1))
            for t in toks]
    segs.append(np.tile(patterns[N_ACTIVE_UNITS], (END_DUR, 1)))
    feats = np.concatenate(segs).astype(np.float32)
    if noise:
        feats += (NOISE_SIGMA * rng.normal(size=feats.shape)).astype(np.float32)
    return feats, [int(t) for t in toks]


def gen_split(name: str, n_utts: int | None = None):
    """Yields (utt_id, feats, unit_indices) deterministically for a split;
    train is clean, dev/test carry baked noise."""
    patterns = make_patterns()
    rng = np.random.default_rng(SPLIT_SEEDS[name])
    n = SPLIT_SIZES[name] if n_utts is None else int(n_utts)
    for i in range(n):
        feats, toks = gen_utterance(rng, patterns, noise=(name != "train"))
        yield f"{name}{i:05d}", feats, toks


def write_corpus(root: str, splits=("train", "dev", "test"), n_utts=None) -> None:
    """Materialize vocab + per-split feats.ark/feats.scp/text under root."""
    from . import write_vocab
    from .kaldi_io import write_ark

    os.makedirs(root, exist_ok=True)
    write_vocab(make_vocab(), os.path.join(root, "vocab"))
    units = unit_names()
    for split in splits:
        sdir = os.path.join(root, split)
        os.makedirs(sdir, exist_ok=True)
        feats, lines = {}, []
        for utt, x, toks in gen_split(split, None if n_utts is None else n_utts.get(split)):
            feats[utt] = x
            lines.append(f"{utt} " + " ".join(units[t] for t in toks))
        write_ark(os.path.join(sdir, "feats.ark"), feats,
                  os.path.join(sdir, "feats.scp"))
        with open(os.path.join(sdir, "text"), "w") as f:
            f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Generate the synthetic benchmark corpus")
    p.add_argument("root", help="output directory")
    p.add_argument("--splits", nargs="*", default=["train", "dev", "test"])
    args = p.parse_args(argv)
    write_corpus(args.root, splits=tuple(args.splits))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
