"""Attention-based speech recognizer
(counterpart of ``opentransformer_tpu/models/speech2text.py:SpeechToText``).

frontend → encoder → KV-cached decoder for decoding; ``forward`` is the
teacher-forced training loss (label smoothing). The hybrid CTC loss is not
ported yet (``ctc_weight > 0`` raises in ``forward``); the ``CTCAssistor``
output layer is, so a hybrid-trained checkpoint (the anchor) loads whole
for decoding.
"""

from __future__ import annotations

import inspect

from torch import nn

from ..data import PAD
from ..ops.loss import label_smoothing_loss
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .frontend import ConvFrontEnd


def _build(cls, cfg: dict, **extra):
    """``cls(**cfg)`` keeping only the keys its constructor takes (a config
    section also carries keys of options that are checked elsewhere)."""
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in dict(cfg).items() if k in params}, **extra)


class CTCAssistor(nn.Module):
    """Frame-level vocabulary projection of the hybrid CTC head. Only its
    weights are ported so far (CTC decoding is ROADMAP Queue 1 item 7)."""

    def __init__(self, d_model: int, vocab_size: int):
        super().__init__()
        self.output_layer = nn.Linear(d_model, vocab_size)


class SpeechToText(nn.Module):
    def __init__(self, frontend_cfg: dict, encoder_cfg: dict, decoder_cfg: dict,
                 ctc_weight: float = 0.0, smoothing: float = 0.1):
        super().__init__()
        self.ctc_weight = ctc_weight
        self.smoothing = smoothing
        self.frontend = _build(ConvFrontEnd, frontend_cfg)
        self.encoder = _build(TransformerEncoder, encoder_cfg)
        self.decoder = _build(TransformerDecoder, decoder_cfg)
        if ctc_weight > 0.0:
            self.ctc = CTCAssistor(self.decoder.d_model, self.decoder.vocab_size)

    @property
    def dtype(self):
        return self.decoder.embedding.weight.dtype

    def encode(self, feats, feat_mask):
        """feats [B, T, F], bool[B, T] → (memory [B, T', D], bool[B, T'])."""
        x, mask = self.frontend(feats.to(self.dtype), feat_mask)
        return self.encoder(x, mask)

    def forward(self, feats, feat_mask, targets, targets_length):
        """Teacher-forced loss: (scalar float32 loss, aux dict).

        targets int[B, U+2] = BOS ⧺ y ⧺ EOS ⧺ PAD…; the decoder reads
        ``targets[:, :-1]`` under a causal-only self-attention mask (padded
        targets stay attendable keys, as in the reference; their outputs are
        dropped by the loss) and is scored on ``targets[:, 1:]``."""
        if self.ctc_weight > 0.0:
            raise NotImplementedError(
                "the hybrid CTC loss (ctc_weight > 0) is not ported to opentransformer_tpu_torch "
                "yet (see ROADMAP.md, Queue 1 item 5)")
        memory, memory_mask = self.encode(feats, feat_mask)
        logits = self.decoder(targets[:, :-1], memory, memory_mask)
        return label_smoothing_loss(logits, targets[:, 1:], self.smoothing, pad_id=PAD), {}

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
