"""Recognizers: model + optional LM → n-best transcripts
(counterpart of ``opentransformer_tpu/recognize/base.py``): the speech2text
recognizer with LM shallow fusion (transformer or LSTM LM) and n-best LM
rescoring. CTC rescoring and the CTC/transducer recognizers are not ported
yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import EOS, PAD
from ..models.lm import RecurrentLanguageModel, TransformerLanguageModel
from ..ops.project_topk import MAX_K, project2_logp_topk
from .beam import BeamHypotheses, beam_search, greedy_search


def make_lm_adapter(lm, max_len: int):
    """(lm_init, lm_step) closures for shallow fusion inside the beam loop:
    ``lm_init(n)`` → the LM state at n rows, ``lm_step(tokens, state,
    index)`` → (log_probs f32[n, V], state)."""
    if lm is None:
        return None, None
    if isinstance(lm, TransformerLanguageModel):
        return (lambda n: lm.init_cache(n, max_len + 1)), lm.decode_step
    if isinstance(lm, RecurrentLanguageModel):
        return lm.init_hidden, lm.decode_step
    raise TypeError(f"unsupported LM type {type(lm)}")


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
                       lamda: float = 5.0, lm=None, lm_weight: float = 0.1,
                       eos_id: Optional[int] = None, fused_topk: bool = True):
    """``(memory, memory_mask) -> BeamHypotheses`` over a precomputed encoder
    memory: the KV-cached beam (beam 1 without an LM: greedy), with LM
    shallow fusion when ``lm`` is given. ``eos_id`` overrides the end token.

    The beam consumes only the per-step top-k of the (LM-fused) next-token
    distribution, so the fused projection→log-softmax→top-k step is used
    whenever ``beam_width`` fits the kernel (≤ 128): without an LM the
    model's ``decode_step_topk``, with one the two-head form over the
    model's and the LM's hidden states, which also needs the two
    vocabularies to be equal. ``fused_topk=False`` forces the materialized
    log-probs and a plain top-k."""
    eos = EOS if eos_id is None else int(eos_id)
    fits_kernel = fused_topk and beam_width <= MAX_K
    has_topk = lm is None and fits_kernel
    has_topk_lm = (lm is not None and fits_kernel
                   and model.decoder.vocab_size == lm.vocab_size)
    # a transformer LM takes the beam's ancestry map: its KV caches stay
    # append-only like the decoder's and the beam loop skips the per-step
    # gather of the LM state. An LSTM's state has no positions to select
    # from and is gathered.
    lm_ancestral = has_topk_lm and isinstance(lm, TransformerLanguageModel)
    lm_init, lm_step = make_lm_adapter(lm, max_len)

    def decode_topk_lm(tokens, cache, lm_state, index, mem_mask, src, k):
        h, cache = model.decode_hidden_step(tokens, cache, index, mem_mask, src)
        if lm_ancestral:
            h_lm, lm_state = lm.decode_hidden(tokens, lm_state, index, src)
        else:
            h_lm, lm_state = lm.decode_hidden(tokens, lm_state, index)
        vals, idx = project2_logp_topk(h, *model.vocab_head(), h_lm, *lm.vocab_head(),
                                       lm_weight, k)
        return vals, idx, cache, lm_state

    @torch.inference_mode()
    def search(memory, memory_mask) -> BeamHypotheses:
        decode_topk = model.decode_step_topk if has_topk else None
        if beam_width == 1 and lm is None:
            return greedy_search(model.decode_step, model.init_cache, memory, memory_mask,
                                 max_len, eos_id=eos, decode_topk=decode_topk)
        return beam_search(model.decode_step, model.init_cache, memory, memory_mask,
                           beam_width=beam_width, max_len=max_len, penalty=penalty,
                           lamda=lamda, eos_id=eos, decode_topk=decode_topk,
                           lm_step=lm_step, lm_init=lm_init, lm_weight=lm_weight,
                           decode_topk_lm=decode_topk_lm if has_topk_lm else None,
                           lm_ancestral=lm_ancestral)

    return search


class SpeechToTextRecognizer(Recognizer):
    """Encoder + batched beam search with KV cache + optional LM fusion."""

    def __init__(self, model, lm=None, beam_width: int = 5, max_len: int = 100,
                 penalty: float = 0.6, lamda: float = 5.0, lm_weight: float = 0.1,
                 idx2unit: Optional[dict] = None, eos_id: Optional[int] = None):
        super().__init__(model, idx2unit)
        self.search = make_memory_search(model, int(beam_width), int(max_len),
                                         float(penalty), float(lamda), lm=lm,
                                         lm_weight=float(lm_weight), eos_id=eos_id)

    @torch.inference_mode()
    def recognize_arrays(self, feats, feat_mask) -> BeamHypotheses:
        memory, memory_mask = self.model.encode(feats, feat_mask)
        return self.search(memory, memory_mask)

    def recognize(self, feats, feat_mask):
        """Returns (nbest texts [B][K], scores f32[B, K] numpy)."""
        hyp = self.recognize_arrays(feats, feat_mask)
        tokens = hyp.tokens[:, :, 1:].cpu().numpy()  # strip BOS
        return self.nbest_translate(tokens), hyp.scores.float().cpu().numpy()


@torch.inference_mode()
def lm_rescore(lm, hyp: BeamHypotheses, weight: float = 0.1) -> BeamHypotheses:
    """N-best rescoring by the LM's mean log-prob per token: the weighted
    mean over the tokens after BOS is added to each score and the n-best
    list is sorted again (stable)."""
    b, k, u = hyp.tokens.shape
    tokens = hyp.tokens.reshape(b * k, u)
    logp = torch.log_softmax(lm.logits(tokens), dim=-1)
    tok_lp = torch.gather(logp[:, :-1], 2, tokens[:, 1:, None])[..., 0]
    valid = torch.arange(u - 1, device=tokens.device)[None, :] < hyp.lengths.reshape(b * k, 1)
    mean_lp = (tok_lp * valid).sum(-1) / valid.sum(-1).clamp(min=1)
    scores, order = torch.sort(hyp.scores + weight * mean_lp.reshape(b, k), dim=1,
                               descending=True, stable=True)
    return BeamHypotheses(
        tokens=torch.gather(hyp.tokens, 1, order[:, :, None].expand_as(hyp.tokens)),
        scores=scores, lengths=torch.gather(hyp.lengths, 1, order))
