"""Long-form decoding (counterpart of ``opentransformer_tpu/recognize/streaming.py``).

Audio far beyond the training lengths is encoded in fixed windows of
``window`` frames with ``context`` frames of acoustic context on either
side; only each window's centre frames are kept, so every kept frame saw
its context. With a relative-position encoder whose chunked attention fits
inside ``context`` this is window-invariant; an absolute-position encoder
restarts its positions every window. The stitched memory goes into the
KV-cached beam search (``make_memory_search``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.masks import mask_to_length
from .base import SpeechToTextRecognizer
from .online import _frontend_geometry


@torch.inference_mode()
def encode_windowed(model, feats: torch.Tensor, feat_lengths, window: int = 1200,
                    context: int = 200):
    """Encode feats f32[B, T, F] (valid lengths ``feat_lengths``) window by
    window, keeping the centres → (memory [B, T', D], bool[B, T']), laid out
    as ``model.encode``'s. Window w starts at input frame w·centre − context
    (window 0 at 0), centre = window − 2·context; its kept outputs are the
    centre frames."""
    b, t, _ = feats.shape
    center = window - 2 * context
    if not center >= context > 0:
        raise ValueError(f"window {window} and context {context}: need window - 2*context "
                         ">= context > 0")
    factor, _ = _frontend_geometry(model.frontend)  # output j starts at input j·factor
    if context % factor or center % factor:
        raise ValueError(f"context {context} and centre {center} must be multiples of the "
                         f"frontend's subsampling {factor}")
    lengths = np.asarray(torch.as_tensor(feat_lengths).cpu(), np.int64)
    pieces, piece_masks = [], []
    for w in range(max(1, -(-t // center))):
        start = 0 if w == 0 else w * center - context
        hi = min(start + window, t)
        chunk = feats[:, start:hi]
        if window > hi - start:
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, window - (hi - start)))
        valid = torch.from_numpy(np.clip(lengths - start, 0, hi - start)).to(feats.device)
        chunk_mask = torch.arange(window, device=feats.device)[None] < valid[:, None]
        mem, mem_mask = model.encode(chunk, chunk_mask)
        lo = 0 if w == 0 else context // factor
        up = min((context * (w > 0) + center) // factor, mem.shape[1])
        pieces.append(mem[:, lo:up])
        piece_masks.append(mem_mask[:, lo:up])
    return torch.cat(pieces, dim=1), torch.cat(piece_masks, dim=1)


class LongFormRecognizer(SpeechToTextRecognizer):
    """Beam-search recognizer whose encoder runs in overlapping windows when
    the input is longer than ``window`` frames (lectures, meetings): the
    memory grows linearly and the KV-cached search is unchanged."""

    def __init__(self, *args, window: int = 1200, context: int = 200, **kwargs):
        super().__init__(*args, **kwargs)
        self.window, self.context = int(window), int(context)

    @torch.inference_mode()
    def recognize_arrays(self, feats, feat_mask):
        if feats.shape[1] <= self.window:
            memory, memory_mask = self.model.encode(feats, feat_mask)
        else:
            memory, memory_mask = encode_windowed(self.model, feats, mask_to_length(feat_mask),
                                                  self.window, self.context)
        return self.search(memory, memory_mask)
