"""Transformer encoder (counterpart of ``opentransformer_tpu/models/encoder.py``).

Absolute sinusoidal positions and dense FFNs, post-norm (the shipped
configs) or the reference's pre-norm, whose residual is the *normalized*
tensor. Relative positions, chunked attention, MoE, concat_after and the
scanned layout are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from torch import nn

from .modules import (
    MultiHeadSelfAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    layer_norm,
)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, normalize_before: bool = False,
                 activation: str = "relu"):
        super().__init__()
        self.normalize_before = normalize_before
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.slf_attn = MultiHeadSelfAttention(n_heads, d_model)
        self.ffn = PositionwiseFeedForward(d_model, d_ff, activation)

    def forward(self, x, attn_mask):
        # the residual is the sublayer's input: x (post-norm) or norm(x)
        pre = self.normalize_before
        h = self.norm1(x) if pre else x
        h = h + self.slf_attn(h, attn_mask)
        if not pre:
            h = self.norm1(h)
        h2 = self.norm2(h) if pre else h
        h = h2 + self.ffn(h2)
        if not pre:
            h = self.norm2(h)
        return h


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 256, n_heads: int = 4, d_ff: int = 2048,
                 n_blocks: int = 12, normalize_before: bool = False, activation: str = "relu"):
        super().__init__()
        self.normalize_before = normalize_before
        self.pos_enc = PositionalEncoding(d_model)
        self.layers = []
        for i in range(n_blocks):
            layer = TransformerEncoderLayer(d_model, n_heads, d_ff, normalize_before, activation)
            self.add_module(f"block_{i}", layer)
            self.layers.append(layer)
        self.after_norm = layer_norm(d_model) if normalize_before else None

    def forward(self, x, pad_mask):
        """x: [B, T, D]; pad_mask: bool[B, T] → (y [B, T, D], pad_mask)."""
        attn_mask = pad_mask[:, None, None, :]
        x = self.pos_enc(x)
        for layer in self.layers:
            x = layer(x, attn_mask)
        if self.after_norm is not None:
            x = self.after_norm(x)
        return x, pad_mask
