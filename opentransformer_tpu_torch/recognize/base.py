"""Recognizers: model → n-best transcripts
(counterpart of ``opentransformer_tpu/recognize/base.py``, speech2text
without an LM). LM shallow fusion, CTC rescoring and the CTC/transducer
recognizers are later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import EOS, PAD
from .beam import BeamHypotheses, beam_search, greedy_search


class Recognizer:
    def __init__(self, model, idx2unit: Optional[dict] = None):
        self.model = model
        self.idx2unit = idx2unit or {}

    def translate(self, ids) -> str:
        """id sequence → text; stop at EOS, skip PAD."""
        out = []
        for i in np.asarray(ids).tolist():
            if i == EOS:
                break
            if i == PAD:
                continue
            out.append(self.idx2unit.get(int(i), "<UNK>"))
        return " ".join(out)

    def nbest_translate(self, tokens) -> list[list[str]]:
        """[B, K, U] token array (BOS stripped by caller) → texts."""
        return [[self.translate(hyp) for hyp in utt] for utt in np.asarray(tokens)]


def make_memory_search(model, beam_width: int, max_len: int, penalty: float = 0.6,
                       lamda: float = 5.0, eos_id: Optional[int] = None,
                       fused_topk: bool = True):
    """``(memory, memory_mask) -> BeamHypotheses`` over a precomputed encoder
    memory: the KV-cached beam (beam 1: greedy). The fused
    projection→log-softmax→top-k step is used whenever ``beam_width`` fits
    the kernel (≤ 128); ``eos_id`` overrides the end token."""
    eos = EOS if eos_id is None else int(eos_id)
    decode_topk = model.decode_step_topk if (fused_topk and beam_width <= 128) else None

    @torch.inference_mode()
    def search(memory, memory_mask) -> BeamHypotheses:
        if beam_width == 1:
            return greedy_search(model.decode_step, model.init_cache, memory, memory_mask,
                                 max_len, eos_id=eos, decode_topk=decode_topk)
        return beam_search(model.decode_step, model.init_cache, memory, memory_mask,
                           beam_width=beam_width, max_len=max_len, penalty=penalty,
                           lamda=lamda, eos_id=eos, decode_topk=decode_topk)

    return search


class SpeechToTextRecognizer(Recognizer):
    """Encoder + batched beam search with KV cache."""

    def __init__(self, model, beam_width: int = 5, max_len: int = 100, penalty: float = 0.6,
                 lamda: float = 5.0, idx2unit: Optional[dict] = None,
                 eos_id: Optional[int] = None):
        super().__init__(model, idx2unit)
        self.search = make_memory_search(model, int(beam_width), int(max_len),
                                         float(penalty), float(lamda), eos_id=eos_id)

    @torch.inference_mode()
    def recognize_arrays(self, feats, feat_mask) -> BeamHypotheses:
        memory, memory_mask = self.model.encode(feats, feat_mask)
        return self.search(memory, memory_mask)

    def recognize(self, feats, feat_mask):
        """Returns (nbest texts [B][K], scores f32[B, K] numpy)."""
        hyp = self.recognize_arrays(feats, feat_mask)
        tokens = hyp.tokens[:, :, 1:].cpu().numpy()  # strip BOS
        return self.nbest_translate(tokens), hyp.scores.float().cpu().numpy()
