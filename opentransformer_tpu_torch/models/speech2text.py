"""Attention-based speech recognizer, decode side
(counterpart of ``opentransformer_tpu/models/speech2text.py:SpeechToText``).

frontend → encoder → KV-cached decoder. The training losses (label
smoothing, hybrid CTC) are not ported yet; the ``CTCAssistor`` output layer
is, so a hybrid-trained checkpoint (the anchor) loads whole.
"""

from __future__ import annotations

import inspect

from torch import nn

from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .frontend import ConvFrontEnd


def _build(cls, cfg: dict, **extra):
    """``cls(**cfg)`` keeping only the keys its constructor takes (training
    options such as dropout rates do not apply to the decode side)."""
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
                 ctc_weight: float = 0.0):
        super().__init__()
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

    def decode_full(self, targets_in, memory, memory_pad_mask):
        """Teacher-forced logits f32[B, U, V]."""
        return self.decoder(targets_in, memory, memory_pad_mask)

    def init_cache(self, memory, max_len: int, beam_width: int = 1):
        return self.decoder.init_cache(memory, max_len, beam_width)

    def decode_step(self, token_t, cache, index: int, memory_pad_mask, src=None):
        return self.decoder.decode_step(token_t, cache, index, memory_pad_mask, src)

    def decode_step_topk(self, token_t, cache, index: int, memory_pad_mask, src, k: int):
        return self.decoder.decode_step_topk(token_t, cache, index, memory_pad_mask, src, k)
