#!/usr/bin/env python
"""Corpus WER/CER of a hypothesis file against a reference file, with the
port's Levenshtein scorer. Both files hold ``utt tok tok ...`` lines; it
prints each utterance with errors, then the corpus rate. A host tool: it
touches no device.

    python tools/torch_computer_wer.py REF_TEXT HYP_TEXT
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opentransformer_tpu_torch.ops.levenshtein import ErrorRateAccumulator  # noqa: E402


def read(path: str) -> dict[str, list[str]]:
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def score(refs: dict, hyps: dict) -> tuple[ErrorRateAccumulator, list[str]]:
    """(the accumulator over every reference utterance, the lines of those
    with errors); a missing hypothesis counts as empty."""
    acc, lines = ErrorRateAccumulator(), []
    for utt, ref in refs.items():
        hyp = hyps.get(utt, [])
        d = acc.update(ref, hyp)
        if d:
            lines.append(f"{utt} errors={d} ref={' '.join(ref)} hyp={' '.join(hyp)}")
    return acc, lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    acc, lines = score(read(argv[0]), read(argv[1]))
    for line in lines:
        print(line)
    print(f"WER {acc.rate * 100:.2f}% ({acc.errors}/{acc.tokens}) over {acc.utts} utts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
