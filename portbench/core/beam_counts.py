"""Counts of the long-form decode cell that ``counts.py`` lacks: the FLOPs of
Whisper's Conv1d front end, and the bytes that kernel 4 (the beam step's
attention over its caches, ``csrc/beam_attention.cu``) has to move.

Kernel 4's bound is its bytes at the memory rate (``counts.PEAK_BYTES``);
its float32 products are counted nowhere else: the decoder step's attention
FLOPs are ``counts.decoder_step``'s.
"""

from __future__ import annotations

from . import counts


def conv1d_frontend(t: int, f: int, d: int) -> tuple[float, int]:
    """(FLOPs, output frames) of Conv1d(f → d, k 3, pad 1) and Conv1d(d → d,
    k 3, stride 2, pad 1) over ``t`` frames."""
    t2 = (t - 1) // 2 + 1
    return 2.0 * 3 * (t * f * d + t2 * d * d), t2


def attention_step_bytes(batch: int, beam: int, t_mem: int, index: int, d: int,
                         dtype: str) -> float:
    """Bytes kernel 4 has to move in one decoder block's beam step at
    position ``index`` for ``batch`` utterances of ``beam`` hypotheses:

    cross entry: each utterance's cross keys and values once, its frame
    mask, the beams' q read and their context written;
    self entry: the least its lineages read, each position of each
    utterance once (beams that share a prefix read its rows once; the
    distinct rows are not observable from outside the port, so a position
    counts one row), the lineage map's entries up to ``index``, the step's
    q, keys and values read, the keys and values written into the caches,
    the context written."""
    e = counts.ESIZE[dtype]
    rows = batch * beam
    cross = batch * t_mem * d * 2 * e + batch * t_mem + rows * d * e * 2
    self_ = (batch * (index + 1) * d * 2 * e + rows * (index + 1) * 8
             + rows * d * e * 3 + rows * d * e * 2 + rows * d * e)
    return float(cross + self_)


def attention_bound_s(batch: int, beam: int, t_mem: int, steps: int, d: int, blocks: int,
                      dtype: str) -> float:
    """Kernel 4's least time (s) over a search of ``steps`` steps through
    ``blocks`` decoder blocks."""
    nbytes = sum(attention_step_bytes(batch, beam, t_mem, s, d, dtype) for s in range(steps))
    return blocks * nbytes / counts.PEAK_BYTES
