"""Edit distance + WER/CER scoring (counterpart of
``opentransformer_tpu/ops/levenshtein.py``), pure Python two-row DP."""

from __future__ import annotations

from typing import Sequence


def edit_distance(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def edit_distances(ref: Sequence, hyps: Sequence[Sequence]) -> list[int]:
    """distance(ref, h) for every hypothesis of an n-best list."""
    return [edit_distance(ref, h) for h in hyps]


class ErrorRateAccumulator:
    """Corpus-level WER/CER: sum(edit distances) / sum(reference lengths)."""

    def __init__(self):
        self.errors = 0
        self.tokens = 0
        self.utts = 0

    def update(self, ref: Sequence, hyp: Sequence) -> int:
        d = edit_distance(ref, hyp)
        self.errors += d
        self.tokens += len(ref)
        self.utts += 1
        return d

    @property
    def rate(self) -> float:
        return self.errors / max(self.tokens, 1)
