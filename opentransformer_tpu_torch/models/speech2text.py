"""End-to-end models (counterpart of ``opentransformer_tpu/models/speech2text.py``):
the attention-based ``SpeechToText`` and the pure-CTC ``CTCModel``.

``SpeechToText``: frontend (``conv`` or ``concat``) → encoder
(``transformer`` or ``conformer``) → KV-cached decoder for decoding;
``forward`` is the teacher-forced training loss (label smoothing), plus the
hybrid ``(1 − w)·att + w·ctc`` with a CTC head on the encoder memory when
``ctc_weight`` w > 0. ``CTCModel``: frontend → encoder → CTC head, with the
optional causal look-ahead depthwise conv over future frames. With an MoE
encoder both add ``moe_aux_weight`` times its load-balance loss to the
training loss and report that loss as ``moe_aux``.

Targets contract (as the JAX package): targets[B, U+2] = BOS ⧺ y ⧺ EOS ⧺
PAD…, ``targets_length`` counts y + EOS; the CTC head is trained on y + EOS.
"""

from __future__ import annotations

import inspect

import torch
from torch import nn
from torch.nn import functional as F

from ..data import BLK, PAD
from ..ops.loss import ctc_loss, label_smoothing_loss
from ..ops.masks import mask_to_length
from ..ops.project_topk import project_logp_topk
from .decoder import TransformerDecoder
from .encoder import ConformerEncoder, TransformerEncoder
from .frontend import ConcatFrontEnd, ConvFrontEnd, WhisperFrontEnd

FRONTENDS = {"conv": ConvFrontEnd, "concat": ConcatFrontEnd, "whisper": WhisperFrontEnd}
ENCODERS = {"transformer": TransformerEncoder, "conformer": ConformerEncoder}


def _build(cls, cfg: dict, **extra):
    """``cls(**cfg)`` keeping only the keys its constructor takes (a config
    section also carries keys of options that are checked elsewhere)."""
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in dict(cfg).items() if k in params}, **extra)


class CTCAssistor(nn.Module):
    """Frame-level vocabulary projection and CTC loss (blank 0), with the
    optional causal look-ahead depthwise conv that mixes the next
    ``lookahead_steps`` frames into each frame before the projection (flax
    ``Conv`` kernel [K, 1, D] ↔ ``Conv1d`` weight [D, 1, K], no bias).
    ``data_group`` (set by ``parallel/engine.py``) makes the loss this
    rank's partial of that data group's batch mean."""

    data_group = None

    def __init__(self, d_model: int, vocab_size: int, lookahead_steps: int = 0):
        super().__init__()
        self.lookahead_steps = int(lookahead_steps)
        if self.lookahead_steps > 0:
            self.look_ahead_conv = nn.Conv1d(d_model, d_model, self.lookahead_steps + 1,
                                             groups=d_model, bias=False)
        self.output_layer = nn.Linear(d_model, vocab_size)

    def _hidden(self, memory):
        """[B, T, D] → pre-projection [B, T, D]: the look-ahead conv over
        frames t … t + lookahead (right padding only), if any."""
        if self.lookahead_steps == 0:
            return memory
        h = F.pad(memory.transpose(1, 2), (0, self.lookahead_steps))
        return self.look_ahead_conv(h).transpose(1, 2)

    def project(self, memory):
        """Frame logits f32[B, T, V]."""
        return self.output_layer(self._hidden(memory)).float()

    def project_topk(self, memory, k: int, with_label: int | None = None):
        """Top-k of the frame log-probs through the fused projection →
        log-softmax → top-k (``ops/project_topk``; the [B, T, V] distribution
        is never written): (vals f32[B, T, k] desc-sorted, ids i32[B, T, k]).
        With ``with_label`` also that label's exact log-prob f32[B, T], its
        logit minus the row logsumexp (the sparse prefix beam needs the
        blank's even outside the top-k)."""
        h = self._hidden(memory)
        b, t = h.shape[0], h.shape[1]
        h2 = h.reshape(b * t, -1).contiguous()
        w, bias = self.output_layer.weight, self.output_layer.bias
        if with_label is None:
            vals, idx = project_logp_topk(h2, w, bias, k)
            return vals.reshape(b, t, k), idx.reshape(b, t, k)
        vals, idx, lse = project_logp_topk(h2, w, bias, k, with_lse=True)
        logit_l = h2.float() @ w[with_label].to(h2.dtype).float()
        label_lp = logit_l + bias[with_label].float() - lse
        return vals.reshape(b, t, k), idx.reshape(b, t, k), label_lp.reshape(b, t)

    def forward(self, memory, memory_lengths, labels, label_lengths):
        return ctc_loss(self.project(memory), memory_lengths, labels, label_lengths, blank_id=BLK,
                        group=self.data_group)


def encode_with(model, feats, feat_mask, return_aux: bool):
    """frontend → encoder: (memory, memory_mask), and with ``return_aux`` the
    MoE load-balance loss (None without MoE) third."""
    x, mask = model.frontend(feats.to(model.dtype), feat_mask)
    out = model.encoder(x, mask)
    if return_aux:
        return out[0], out[1], (out[2] if len(out) > 2 else None)
    return out[0], out[1]


def add_moe_aux(loss, aux: dict, moe_aux, weight: float):
    """The loss with ``weight``·``moe_aux`` added, ``aux`` with it under
    ``moe_aux`` (both unchanged without MoE)."""
    if moe_aux is None:
        return loss, aux
    return loss + weight * moe_aux, {**aux, "moe_aux": moe_aux}


class SpeechToText(nn.Module):
    data_group = None  # the data group whose batch the loss is a partial of (parallel/engine.py)

    def __init__(self, frontend_cfg: dict, encoder_cfg: dict, decoder_cfg: dict,
                 ctc_weight: float = 0.0, smoothing: float = 0.1, lookahead_steps: int = 0,
                 frontend_type: str = "conv", encoder_type: str = "transformer",
                 moe_aux_weight: float = 0.01):
        super().__init__()
        self.ctc_weight = ctc_weight
        self.moe_aux_weight = moe_aux_weight
        self.smoothing = smoothing
        self.frontend = _build(FRONTENDS[frontend_type], frontend_cfg)
        self.encoder = _build(ENCODERS[encoder_type], encoder_cfg)
        self.decoder = _build(TransformerDecoder, decoder_cfg)
        if ctc_weight > 0.0:
            self.ctc = CTCAssistor(self.encoder.d_model, self.decoder.vocab_size,
                                   lookahead_steps)

    @property
    def dtype(self):
        return self.decoder.embedding.weight.dtype

    def encode(self, feats, feat_mask, return_aux: bool = False):
        """feats [B, T, F], bool[B, T] → (memory [B, T', D], bool[B, T'][,
        the MoE aux])."""
        return encode_with(self, feats, feat_mask, return_aux)

    def forward(self, feats, feat_mask, targets, targets_length):
        """Teacher-forced loss: (scalar float32 loss, aux dict).

        targets int[B, U+2] = BOS ⧺ y ⧺ EOS ⧺ PAD…; the decoder reads
        ``targets[:, :-1]`` under a causal-only self-attention mask (padded
        targets stay attendable keys, as in the reference; their outputs are
        dropped by the loss) and is scored on ``targets[:, 1:]``. With
        ``ctc_weight`` w > 0 the loss is ``(1 − w)·att + w·ctc`` and ``aux``
        holds ``ctc_loss`` and ``att_loss``; an MoE encoder adds
        ``moe_aux_weight``·``moe_aux``."""
        memory, memory_mask, moe_aux = self.encode(feats, feat_mask, return_aux=True)
        target_out = targets[:, 1:]
        logits = self.decoder(targets[:, :-1], memory, memory_mask)
        att_loss = label_smoothing_loss(logits, target_out, self.smoothing, pad_id=PAD,
                                        vocab_shard=self.decoder.vocab_shard,
                                        group=self.data_group)
        if self.ctc_weight <= 0.0:
            return add_moe_aux(att_loss, {}, moe_aux, self.moe_aux_weight)
        closs = self.ctc(memory, mask_to_length(memory_mask), target_out, targets_length)
        loss = (1.0 - self.ctc_weight) * att_loss + self.ctc_weight * closs
        return add_moe_aux(loss, {"ctc_loss": closs, "att_loss": att_loss}, moe_aux,
                           self.moe_aux_weight)

    def decode_full(self, targets_in, memory, memory_pad_mask):
        """Teacher-forced logits f32[B, U, V]."""
        return self.decoder(targets_in, memory, memory_pad_mask)

    def init_cache(self, memory, max_len: int, beam_width: int = 1):
        return self.decoder.init_cache(memory, max_len, beam_width)

    def decode_step(self, token_t, cache, index: int, memory_pad_mask, src=None):
        return self.decoder.decode_step(token_t, cache, index, memory_pad_mask, src)

    def decode_step_topk(self, token_t, cache, index: int, memory_pad_mask, src, k: int):
        return self.decoder.decode_step_topk(token_t, cache, index, memory_pad_mask, src, k)

    def decode_hidden_step(self, token_t, cache, index: int, memory_pad_mask, src=None):
        return self.decoder.decode_hidden_step(token_t, cache, index, memory_pad_mask, src)

    def vocab_head(self):
        return self.decoder.vocab_head()

    def ctc_logits(self, memory):
        """The CTC head's frame logits f32[B, T', V] (joint rescoring)."""
        return self.ctc.project(memory)


class CTCModel(nn.Module):
    """frontend → encoder → CTC head (the JAX package's ``CTCModel``)."""

    def __init__(self, frontend_cfg: dict, encoder_cfg: dict, vocab_size: int,
                 lookahead_steps: int = 0, frontend_type: str = "conv",
                 encoder_type: str = "transformer", moe_aux_weight: float = 0.01):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.moe_aux_weight = moe_aux_weight
        self.frontend = _build(FRONTENDS[frontend_type], frontend_cfg)
        self.encoder = _build(ENCODERS[encoder_type], encoder_cfg)
        self.ctc = CTCAssistor(self.encoder.d_model, self.vocab_size, lookahead_steps)

    @property
    def dtype(self):
        return self.ctc.output_layer.weight.dtype

    def encode(self, feats, feat_mask, return_aux: bool = False):
        """feats [B, T, F], bool[B, T] → (memory [B, T', D], bool[B, T'][,
        the MoE aux])."""
        return encode_with(self, feats, feat_mask, return_aux)

    def forward(self, feats, feat_mask, targets, targets_length):
        """CTC loss on y + EOS (``targets[:, 1:]``): (scalar loss, {}), with
        an MoE encoder's ``moe_aux_weight``·``moe_aux`` added."""
        memory, memory_mask, moe_aux = self.encode(feats, feat_mask, return_aux=True)
        loss = self.ctc(memory, mask_to_length(memory_mask), targets[:, 1:], targets_length)
        return add_moe_aux(loss, {}, moe_aux, self.moe_aux_weight)

    def recognize_logits(self, feats, feat_mask):
        """Frame log-probs for CTC decoding: (f32[B, T', V], bool[B, T'])."""
        memory, memory_mask = self.encode(feats, feat_mask)
        return torch.log_softmax(self.ctc.project(memory), dim=-1), memory_mask

    def recognize_argmax(self, feats, feat_mask):
        """Per-frame argmax ids through the fused top-1 (smallest id on
        ties, as argmax): (ids i32[B, T'], bool[B, T'])."""
        memory, memory_mask = self.encode(feats, feat_mask)
        _, idx = self.ctc.project_topk(memory, 1)
        return idx[:, :, 0], memory_mask

    def recognize_topk(self, feats, feat_mask, k: int):
        """Per-frame top-k candidates and the exact blank log-prob for the
        sparse prefix beam: (vals f32[B, T', k], ids i32[B, T', k],
        blank_lp f32[B, T'], bool[B, T'])."""
        memory, memory_mask = self.encode(feats, feat_mask)
        vals, idx, blank_lp = self.ctc.project_topk(memory, k, with_label=BLK)
        return vals, idx, blank_lp, memory_mask
