"""Recognizers: model + optional LM → n-best transcripts
(counterpart of ``opentransformer_tpu/recognize/base.py``): the speech2text
recognizer with LM shallow fusion (transformer or LSTM LM), joint
CTC/attention rescoring and n-best LM rescoring; the CTC recognizer (greedy
on the device, or the native sparse prefix beam with optional n-gram
fusion); the transducer recognizer (greedy through kernel 1 at k = 1, or
the mAES beam with optional LM fusion); ``build_recognizer`` by model type.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from .. import profiling
from ..data import BLK, EOS, PAD
from ..models.lm import RecurrentLanguageModel, TransformerLanguageModel
from ..ops.loss import ctc_nll_from_logprobs, gather_label_logprobs
from ..ops.masks import mask_to_length
from ..ops.project_topk import MAX_K, project2_logp_topk, topk_smallest_id
from .beam import BeamHypotheses, beam_search, greedy_search
from .ctc_decode import ctc_collapse_ids

logger = logging.getLogger(__name__)


def make_lm_adapter(lm, max_len: int):
    """(lm_init, lm_step) closures for shallow fusion inside the beam loop:
    ``lm_init(n)`` → the LM state at n rows (a transformer LM's caches hold
    ``max_len + 1`` positions), ``lm_step(tokens, state, index)`` →
    (log_probs f32[n, V], state). ``index`` is an int (the lockstep beam)
    or int[n], each row at its own position (the transducer beam's
    per-hypothesis LM state); an LSTM LM ignores it. An MoE transformer LM
    whose capacity can bind warns: its steps (beam fusion) and its
    whole-sequence scores (n-best rescoring) then disagree."""
    if lm is None:
        return None, None
    if isinstance(lm, TransformerLanguageModel):
        drop_free = lm.moe_experts / max(lm.moe_top_k, 1)
        if lm.moe_experts > 0 and lm.moe_capacity_factor < drop_free:
            logger.warning(
                "MoE LM built for recognition with moe_capacity_factor=%.2f < n_experts/top_k "
                "= %.2f: beam-fusion and n-best rescoring scores diverge whenever expert "
                "capacity binds; raise moe_capacity_factor to >= %.2f for the drop-free "
                "regime", lm.moe_capacity_factor, drop_free, drop_free)
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


def _gather_rows(state, rows: torch.Tensor):
    """Reorder the leading axis of every tensor in a nest of lists, tuples
    and dicts (a transformer LM's per-block {"k", "v"}, an LSTM's per-layer
    (c, h))."""
    if isinstance(state, torch.Tensor):
        return state.index_select(0, rows)
    if isinstance(state, dict):
        return {key: _gather_rows(val, rows) for key, val in state.items()}
    return type(state)(_gather_rows(val, rows) for val in state)


def make_memory_search(model, beam_width: int, max_len: int, penalty: float = 0.6,
                       lamda: float = 5.0, lm=None, lm_weight: float = 0.1,
                       eos_id: Optional[int] = None, force_beam: bool = False,
                       fused_topk: bool = True):
    """``(memory, memory_mask) -> BeamHypotheses`` over a precomputed encoder
    memory: the KV-cached beam (beam 1 without an LM and without
    ``force_beam``: greedy), with LM shallow fusion when ``lm`` is given.
    ``eos_id`` overrides the end token; ``force_beam`` keeps beam 1 on the
    beam path, whose scores are length-penalised (CTC rescoring adds them).

    The beam consumes only the per-step top-k of the (LM-fused) next-token
    distribution, so the step is chosen here, once, from four: where
    ``beam_width`` fits the kernels (≤ 128), without an LM the model's
    fused ``decode_step_topk`` (kernel 1), with one the two-head top-k of
    ``logp_model + lm_weight · logp_lm`` from the model's and the LM's
    hidden states (kernel 2; it also needs the two vocabularies equal);
    otherwise the materialized log-probs, with or without the LM's added,
    and a plain top-k. ``fused_topk=False`` forces the materialized ones.
    The search's state is the decoder's caches, paired with the LM's state
    under fusion. A transformer LM on kernel 2 takes the beam's ancestry
    map (its caches stay append-only like the decoder's); every other LM
    state is gathered to the surviving hypotheses after each step."""
    eos = EOS if eos_id is None else int(eos_id)
    fits_kernel = fused_topk and beam_width <= MAX_K
    reorder = None
    if lm is None and fits_kernel:
        step = model.decode_step_topk
    elif lm is None:
        def step(tokens, cache, index, mem_mask, src, k):
            logp, cache = model.decode_step(tokens, cache, index, mem_mask, src)
            return (*topk_smallest_id(logp, k), cache)
    else:
        lm_init, lm_step = make_lm_adapter(lm, max_len)
        fused = fits_kernel and model.decoder.vocab_size == lm.vocab_size
        ancestral = fused and isinstance(lm, TransformerLanguageModel)
        if fused:
            def step(tokens, state, index, mem_mask, src, k):
                h, cache = model.decode_hidden_step(tokens, state[0], index, mem_mask, src)
                h_lm, lm_state = (lm.decode_hidden(tokens, state[1], index, src) if ancestral
                                  else lm.decode_hidden(tokens, state[1], index))
                vals, idx = project2_logp_topk(h, *model.vocab_head(), h_lm, *lm.vocab_head(),
                                               lm_weight, k)
                return vals, idx, (cache, lm_state)
        else:
            def step(tokens, state, index, mem_mask, src, k):
                logp, cache = model.decode_step(tokens, state[0], index, mem_mask, src)
                lm_logp, lm_state = lm_step(tokens, state[1], index)
                return (*topk_smallest_id(logp + lm_weight * lm_logp, k), (cache, lm_state))
        if not ancestral:
            def reorder(state, flat_parent):
                return state[0], _gather_rows(state[1], flat_parent)

    def init_state(memory, k):
        cache = model.init_cache(memory, max_len + 1, k)
        return cache if lm is None else (cache, lm_init(memory.shape[0] * k))

    @torch.inference_mode()
    def search(memory, memory_mask) -> BeamHypotheses:
        if beam_width == 1 and lm is None and not force_beam:
            return greedy_search(step, init_state, memory, memory_mask, max_len, eos_id=eos)
        return beam_search(step, init_state, memory, memory_mask, beam_width=beam_width,
                           max_len=max_len, penalty=penalty, lamda=lamda, eos_id=eos,
                           reorder=reorder)

    return search


# bytes one float32 score tensor of an encoder layer may take: a batch whose
# scores ([B, H, T', T'] at the encoder's T' positions) would be larger is
# encoded in slices of rows (128 Whisper windows of 1,500 positions and 20
# heads would take 23 GB a copy; 1,024 utterances of 374 and 4 heads take 2.3)
ENCODE_SCORE_BYTES = 4 << 30


def encode_slice_rows(model, batch: int, frames: int) -> int:
    """Rows a slice of a [batch, frames] encode: the batch cut into as few
    slices as keep each slice's float32 scores within
    ``ENCODE_SCORE_BYTES``, as even as they come."""
    t = model.frontend.output_length(frames)
    per_row = 4 * model.encoder.n_heads * t * t
    slices = max(1, -(-batch * per_row // ENCODE_SCORE_BYTES))
    return max(1, -(-batch // slices))


class SpeechToTextRecognizer(Recognizer):
    """Encoder + batched beam search with KV cache + optional LM fusion,
    then joint CTC/attention rescoring when ``ctc_weight`` > 0 (the model
    needs a CTC head: trained with ``ctc_weight`` > 0)."""

    def __init__(self, model, lm=None, beam_width: int = 5, max_len: int = 100,
                 penalty: float = 0.6, lamda: float = 5.0, lm_weight: float = 0.1,
                 ctc_weight: float = 0.0, idx2unit: Optional[dict] = None,
                 eos_id: Optional[int] = None):
        super().__init__(model, idx2unit)
        self.ctc_weight = float(ctc_weight)
        if self.ctc_weight > 0.0 and not hasattr(model, "ctc"):
            raise ValueError("CTC rescoring (ctc_weight > 0) needs a model with a CTC head, "
                             "one trained with ctc_weight > 0")
        self.search = make_memory_search(model, int(beam_width), int(max_len),
                                         float(penalty), float(lamda), lm=lm,
                                         lm_weight=float(lm_weight), eos_id=eos_id,
                                         force_beam=self.ctc_weight > 0.0)

    def encode(self, feats, feat_mask):
        """The encoder memory and its mask, ``model.encode`` over slices of
        rows whose float32 attention scores stay within
        ``ENCODE_SCORE_BYTES`` each (``encode_slice_rows``), each in a
        program span ``encoder.slice`` (timed on the device too); one slice
        returns as it came."""
        rows = encode_slice_rows(self.model, feats.shape[0], feats.shape[1])
        parts = []
        for i in range(0, feats.shape[0], rows):
            with profiling.span("encoder.slice", feats.device):
                parts.append(self.model.encode(feats[i:i + rows], feat_mask[i:i + rows]))
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    @torch.inference_mode()
    def recognize_arrays(self, feats, feat_mask) -> BeamHypotheses:
        memory, memory_mask = self.encode(feats, feat_mask)
        hyp = self.search(memory, memory_mask)
        if self.ctc_weight > 0.0:
            hyp = ctc_rescore_scores(self.model.ctc_logits(memory), memory_mask, hyp,
                                     self.ctc_weight)
        return hyp

    def recognize(self, feats, feat_mask):
        """Returns (nbest texts [B][K], scores f32[B, K] numpy)."""
        hyp = self.recognize_arrays(feats, feat_mask)
        tokens = hyp.tokens[:, :, 1:].cpu().numpy()  # strip BOS
        return self.nbest_translate(tokens), hyp.scores.float().cpu().numpy()


class CTCRecognizer(Recognizer):
    """CTC decoding: greedy (``beam_width`` ≤ 1) through the fused top-1 and
    the collapse on the device; otherwise the per-frame top ``prune_k``
    candidates and the blank's log-prob through the fused top-k with lse,
    then the native prefix beam on the host, with optional ARPA n-gram
    fusion at weights ``alpha`` (LM) and ``beta`` (insertion bonus)."""

    def __init__(self, model, idx2unit: Optional[dict] = None, beam_width: int = 1,
                 nbest: int = 1, lm_path: Optional[str] = None, alpha: float = 0.0,
                 beta: float = 0.0, prune_k: int = 32):
        super().__init__(model, idx2unit)
        self.beam_width = int(beam_width)
        self.nbest = int(nbest)
        self.alpha, self.beta = float(alpha), float(beta)
        self.lm = None
        if lm_path:
            from .native_ctc import NgramLM

            units = ([self.idx2unit.get(i, f"<{i}>") for i in range(max(self.idx2unit) + 1)]
                     if self.idx2unit else [])
            self.lm = NgramLM(lm_path, units)
        # clamped to the vocabulary and to the fused kernel's largest k
        self.prune_k = min(int(prune_k), int(model.vocab_size), MAX_K)

    @torch.inference_mode()
    def recognize(self, feats, feat_mask):
        """Returns (n-best texts [B][nbest], scores f32[B, nbest] numpy;
        greedy: one text, score 0)."""
        if self.beam_width <= 1:
            ids, mask = self.model.recognize_argmax(feats, feat_mask)
            tokens, lengths = ctc_collapse_ids(ids, mask)
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            texts = [[self.translate(tokens[i, : lengths[i]])] for i in range(tokens.shape[0])]
            return texts, np.zeros((tokens.shape[0], 1), np.float32)

        from .native_ctc import ctc_beam_decode_sparse

        vals, ids, blank_lp, mask = self.model.recognize_topk(feats, feat_mask, self.prune_k)
        tokens, lens, scores = ctc_beam_decode_sparse(
            vals.cpu().numpy(), ids.cpu().numpy(), blank_lp.cpu().numpy(),
            mask_to_length(mask).int().cpu().numpy(), beam_width=self.beam_width,
            blank=BLK, alpha=self.alpha, beta=self.beta, lm=self.lm, nbest=self.nbest)
        texts = [[self.translate(tokens[i, j, : lens[i, j]]) for j in range(self.nbest)]
                 for i in range(tokens.shape[0])]
        return texts, scores


class TransducerRecognizer(Recognizer):
    """Transducer decoding: the frame-synchronous greedy search
    (``beam_width`` ≤ 1; kernel 1 at k = 1 in every lattice step) or the
    mAES beam of ``beam_width`` with ``expansions`` a frame and an optional
    LM fused at ``lm_weight`` (beam only: greedy warns and ignores the LM)."""

    def __init__(self, model, idx2unit: Optional[dict] = None, max_symbols: int = 200,
                 beam_width: int = 1, nbest: int = 1, expansions: int = 2,
                 max_per_frame: int = 8, lm=None, lm_weight: float = 0.0):
        super().__init__(model, idx2unit)
        self.beam_width = int(beam_width)
        self.nbest = min(int(nbest), max(1, self.beam_width))
        self.max_symbols = int(max_symbols)
        self.max_per_frame = int(max_per_frame)
        self.expansions = int(expansions)
        if lm is not None and lm_weight != 0.0 and self.beam_width <= 1:
            logger.warning("transducer LM fusion applies to beam decoding only; greedy "
                           "(-bw 1 / -md greedy) ignores the LM")
        self.lm_init = self.lm_step = None
        self.lm_weight = 0.0
        if lm is not None and lm_weight != 0.0 and self.beam_width > 1:
            self.lm_init, self.lm_step = make_lm_adapter(lm, self.max_symbols)
            self.lm_weight = float(lm_weight)

    def recognize(self, feats, feat_mask):
        """Returns (n-best texts [B][nbest], scores f32[B, nbest] numpy;
        greedy: one text, score 0)."""
        if self.beam_width <= 1:
            tokens, n = self.model.greedy_decode(feats, feat_mask, self.max_symbols,
                                                 self.max_per_frame)
            tokens, n = tokens.cpu().numpy(), n.cpu().numpy()
            texts = [[self.translate(tokens[i, : n[i]])] for i in range(len(n))]
            return texts, np.zeros((len(n), 1), np.float32)
        tokens, lens, scores = self.model.beam_decode(
            feats, feat_mask, self.beam_width, self.max_symbols, self.expansions,
            self.lm_init, self.lm_step, self.lm_weight)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        texts = [[self.translate(tokens[i, j, : lens[i, j]]) for j in range(self.nbest)]
                 for i in range(tokens.shape[0])]
        return texts, scores[:, : self.nbest].float().cpu().numpy()


def ctc_rescore_scores(logits, memory_mask, hyp: BeamHypotheses, weight: float) -> BeamHypotheses:
    """Joint CTC/attention n-best rescoring: ``(1 − w)·att + w·ctc``, where
    ctc is the hypothesis' CTC log-likelihood (y + EOS, as the hybrid head
    was trained) under the frame logits f[B, T, V] of the CTC head; the
    n-best list is sorted again (stable). The log-probs of the label
    columns are gathered per hypothesis, so the [B·K, T, V] distribution is
    never repeated K times."""
    b, k, u = hyp.tokens.shape
    t = logits.shape[1]
    dev = logits.device
    # labels: BOS stripped, EOS kept; hyp.lengths counts BOS + y = len(y + EOS)
    labels = hyp.tokens[:, :, 1:]
    label_lens = hyp.lengths.reshape(b * k)
    pos = torch.arange(u - 1, device=dev)
    labels = torch.where(pos < hyp.lengths[:, :, None], labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    emit, blank = gather_label_logprobs(logp, labels.reshape(b, k * (u - 1)), BLK)
    emit = emit.reshape(b, t, k, u - 1).permute(0, 2, 1, 3).reshape(b * k, t, u - 1)
    blank = blank.repeat_interleave(k, dim=0)
    frame_pad = (torch.arange(t, device=dev)[None, :]
                 >= mask_to_length(memory_mask).repeat_interleave(k)[:, None])
    label_pad = pos[None, :] >= label_lens[:, None]
    neg_logp = ctc_nll_from_logprobs(emit, blank, frame_pad, labels.reshape(b * k, u - 1),
                                     label_pad)
    # the JAX package's guard; the recursion's values are always finite
    ctc_scores = torch.where(torch.isfinite(neg_logp), -neg_logp,
                             torch.full_like(neg_logp, -1e9)).reshape(b, k)
    scores, order = torch.sort((1.0 - weight) * hyp.scores + weight * ctc_scores, dim=1,
                               descending=True, stable=True)
    return BeamHypotheses(
        tokens=torch.gather(hyp.tokens, 1, order[:, :, None].expand_as(hyp.tokens)),
        scores=scores, lengths=torch.gather(hyp.lengths, 1, order))


@torch.inference_mode()
def ctc_rescore(model, feats, feat_mask, hyp: BeamHypotheses, weight: float = 0.3):
    """CTC rescoring of ``hyp`` on its own (encodes again; the recognizer
    rescores with the memory it searched)."""
    memory, memory_mask = model.encode(feats, feat_mask)
    return ctc_rescore_scores(model.ctc_logits(memory), memory_mask, hyp, weight)


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


def build_recognizer(model_type: str, model, lm=None, args: Any = None, idx2unit=None):
    """The recognizer of a model type, configured from ``args`` (a dict or
    an argparse namespace with the eval CLI's names)."""
    args = args or {}
    get = args.get if hasattr(args, "get") else lambda key, d=None: getattr(args, key, d)
    if model_type == "speech2text":
        return SpeechToTextRecognizer(
            model, lm=lm, beam_width=get("beam_width", 5), max_len=get("max_len", 100),
            penalty=get("penalty", 0.6), lamda=get("lamda", 5.0),
            lm_weight=get("lm_weight", 0.1), ctc_weight=get("ctc_weight", 0.0),
            idx2unit=idx2unit)
    if model_type == "ctc":
        return CTCRecognizer(
            model, idx2unit=idx2unit, beam_width=get("ctc_beam_width", get("beam_width", 1)),
            nbest=get("nbest", 1), lm_path=get("ngram_lm", None), alpha=get("alpha", 0.0),
            beta=get("beta", 0.0), prune_k=get("prune_k", 32) or 32)
    if model_type == "transducer":
        return TransducerRecognizer(
            model, idx2unit=idx2unit, max_symbols=get("max_len", 200),
            beam_width=get("beam_width", 1), nbest=get("nbest", 1),
            max_per_frame=get("max_tokens_per_chunk", 8), lm=lm,
            lm_weight=get("lm_weight", 0.1) if lm is not None else 0.0)
    raise KeyError(f"unknown model type for recognition: {model_type!r}")
