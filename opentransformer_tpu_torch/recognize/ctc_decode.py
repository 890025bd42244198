"""CTC decoding (counterpart of ``opentransformer_tpu/recognize/ctc_decode.py``):
the greedy collapse as one vectorised pass on the device, and the prefix
beam search on the host in numpy (the reference semantics; the native C++
decoder of ``native_ctc`` runs the same search with n-gram fusion).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import BLK


def ctc_greedy_decode(log_probs: torch.Tensor, frame_mask: torch.Tensor):
    """Greedy CTC of frame log-probs f[B, T, V]: argmax (smallest id on
    ties), then ``ctc_collapse_ids``."""
    return ctc_collapse_ids(torch.argmax(log_probs, dim=-1), frame_mask)


def ctc_collapse_ids(ids: torch.Tensor, frame_mask: torch.Tensor):
    """Per-frame ids int[B, T] → (tokens int32[B, T] with repeats merged and
    blanks dropped, left-packed with a BLK tail; lengths int32[B]). Frames
    outside ``frame_mask`` count as blanks."""
    b, t = ids.shape
    ids = torch.where(frame_mask, ids.int(), BLK)
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype, device=ids.device),
                      ids[:, :-1]], dim=1)
    keep = (ids != BLK) & (ids != prev)  # a new non-blank symbol
    pos = torch.cumsum(keep.int(), dim=1) - 1  # its slot in the packed row
    lengths = keep.int().sum(dim=1)
    out = torch.full((b, t), BLK, dtype=torch.int32, device=ids.device)
    # dropped frames write BLK to slot t - 1, which is a kept symbol's slot
    # only when no frame was dropped, and then there is no such write
    out.scatter_(1, torch.where(keep, pos, t - 1).long(), torch.where(keep, ids, BLK))
    return out, lengths


def _logsumexp2(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    m = max(a, b)
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def ctc_prefix_beam_search(log_probs: np.ndarray, frame_count: int, beam_width: int = 10,
                           blank: int = BLK, prune_k: int = 32):
    """Prefix beam search of one utterance's frame log-probs f[T, V] (numpy):
    the (blank, non-blank) log-probabilities of each prefix, the top
    ``prune_k`` symbols of each frame. Returns [(prefix tuple, log-prob)]
    best first."""
    lp = np.asarray(log_probs)[:frame_count]
    beams = {(): (0.0, -np.inf)}  # prefix -> (logp ending in blank, in its last symbol)
    for frame in lp:
        top_syms = np.argpartition(-frame, min(prune_k, len(frame) - 1))[:prune_k]
        new_beams: dict = {}

        def add(prefix, pb, pnb):
            opb, opnb = new_beams.get(prefix, (-np.inf, -np.inf))
            new_beams[prefix] = (_logsumexp2(opb, pb), _logsumexp2(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = _logsumexp2(pb, pnb)
            for s in top_syms:
                p = float(frame[s])
                if s == blank:
                    add(prefix, total + p, -np.inf)
                elif prefix and s == prefix[-1]:
                    # a repeat extends the prefix only from a path ending in blank
                    add(prefix, -np.inf, pnb + p)
                    add(prefix + (int(s),), -np.inf, pb + p)
                else:
                    add(prefix + (int(s),), -np.inf, total + p)
        beams = dict(sorted(new_beams.items(),
                            key=lambda kv: -_logsumexp2(*kv[1]))[:beam_width])
    out = [(prefix, _logsumexp2(pb, pnb)) for prefix, (pb, pnb) in beams.items()]
    out.sort(key=lambda kv: -kv[1])
    return out
