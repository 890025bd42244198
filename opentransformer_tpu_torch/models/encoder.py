"""Encoders (counterpart of ``opentransformer_tpu/models/encoder.py``):
Transformer and Conformer.

``TransformerEncoder``: post-norm (the shipped configs) or the reference's
pre-norm, whose residual is the *normalized* tensor; absolute sinusoidal
positions, or relative positions (``relative_positional``: rel-pos
attention over −(T−1) … T−1, and no absolute encoding); block-chunked
attention with ``chunk_size`` > 0. In training, dropout acts after the
absolute positions (``pos_dropout``), on the attention output
(``slf_attn_dropout``), inside the FFN (``ffn_dropout``) and on both
sublayers' outputs before the residual add (``residual_dropout``).

``ConformerEncoder``: macaron blocks ½·FFN → attention (rel-pos, or
absolute with ``relative_positional: false``) → conv module → ½·FFN →
LayerNorm, with ``conv_first``, ``conv_causal``, ``ffn_scale`` and the
reference-import mode ``ref_compat`` (the second FFN dropped, its norm
applied bare, no attention output projection). ``res_dropout`` acts on
every residual branch.

MoE blocks, concat_after, the scanned layout and the streamed encode
(``encode_step``) are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.masks import attn_mask_from_pad, chunk_attn_mask
from .modules import (
    ConformerConvModule,
    Dropout,
    MultiHeadSelfAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RelPosSelfAttention,
    layer_norm,
    rel_pos_embedding,
)


def encoder_attn_mask(pad_mask: torch.Tensor, chunk_size: int = 0,
                      left_chunks: int = -1) -> torch.Tensor:
    """Key padding, AND the block-chunked mask when ``chunk_size`` > 0:
    bool[B, 1, 1 or T, T]."""
    attn_mask = attn_mask_from_pad(pad_mask)
    if chunk_size > 0:
        attn_mask = attn_mask & chunk_attn_mask(pad_mask.shape[1], chunk_size, left_chunks,
                                                pad_mask.device)
    return attn_mask


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, normalize_before: bool = False,
                 activation: str = "relu", slf_attn_dropout: float = 0.0,
                 ffn_dropout: float = 0.0, residual_dropout: float = 0.1,
                 relative_positional: bool = False):
        super().__init__()
        self.normalize_before = normalize_before
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        attn = RelPosSelfAttention if relative_positional else MultiHeadSelfAttention
        self.slf_attn = attn(n_heads, d_model, slf_attn_dropout)
        self.relative_positional = relative_positional
        self.ffn = PositionwiseFeedForward(d_model, d_ff, activation, ffn_dropout)
        self.res_dropout = Dropout(residual_dropout)

    def forward(self, x, attn_mask, pos_emb=None):
        # the residual is the sublayer's input: x (post-norm) or norm(x)
        pre = self.normalize_before
        h = self.norm1(x) if pre else x
        attn = (self.slf_attn(h, attn_mask, pos_emb) if self.relative_positional
                else self.slf_attn(h, attn_mask))
        h = h + self.res_dropout(attn)
        if not pre:
            h = self.norm1(h)
        h2 = self.norm2(h) if pre else h
        h = h2 + self.res_dropout(self.ffn(h2))
        if not pre:
            h = self.norm2(h)
        return h


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 256, n_heads: int = 4, d_ff: int = 2048,
                 n_blocks: int = 12, normalize_before: bool = False, activation: str = "relu",
                 pos_dropout: float = 0.0, slf_attn_dropout: float = 0.0,
                 ffn_dropout: float = 0.0, residual_dropout: float = 0.1,
                 relative_positional: bool = False, chunk_size: int = 0,
                 left_chunks: int = -1):
        super().__init__()
        self.d_model = d_model
        self.relative_positional = relative_positional
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.pos_enc = None if relative_positional else PositionalEncoding(d_model, pos_dropout)
        self.layers = []
        for i in range(n_blocks):
            layer = TransformerEncoderLayer(d_model, n_heads, d_ff, normalize_before, activation,
                                            slf_attn_dropout, ffn_dropout, residual_dropout,
                                            relative_positional)
            self.add_module(f"block_{i}", layer)
            self.layers.append(layer)
        self.after_norm = layer_norm(d_model) if normalize_before else None

    def forward(self, x, pad_mask):
        """x: [B, T, D]; pad_mask: bool[B, T] → (y [B, T, D], pad_mask)."""
        attn_mask = encoder_attn_mask(pad_mask, self.chunk_size, self.left_chunks)
        pos_emb = None
        if self.relative_positional:
            pos_emb = rel_pos_embedding(x.shape[1], self.d_model, x.dtype, x.device)
        else:
            x = self.pos_enc(x)
        for layer in self.layers:
            x = layer(x, attn_mask, pos_emb)
        if self.after_norm is not None:
            x = self.after_norm(x)
        return x, pad_mask


class ConformerEncoderBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, cov_kernel_size: int = 15,
                 slf_attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 residual_dropout: float = 0.1, conv_dropout: float = 0.0,
                 macaron_style: bool = True, ffn_scale: float = 0.5, conv_first: bool = False,
                 conv_norm_type: str = "layer", conv_causal: bool = False,
                 relative_positional: bool = True, activation: str = "glu",
                 ref_compat: bool = False):
        super().__init__()
        self.macaron_style = macaron_style
        self.ffn_scale = ffn_scale
        self.conv_first = conv_first
        self.relative_positional = relative_positional
        self.ref_compat = ref_compat
        if macaron_style:
            self.pre_ffn_norm = layer_norm(d_model)
            self.pre_ffn = PositionwiseFeedForward(d_model, d_ff, activation, ffn_dropout)
        self.attn_norm = layer_norm(d_model)
        if relative_positional:
            self.slf_attn = RelPosSelfAttention(n_heads, d_model, slf_attn_dropout,
                                                use_out_proj=not ref_compat)
        else:
            self.slf_attn = MultiHeadSelfAttention(n_heads, d_model, slf_attn_dropout)
        self.conv_norm = layer_norm(d_model)
        self.conv_module = ConformerConvModule(d_model, cov_kernel_size, conv_norm_type,
                                               conv_dropout, conv_causal)
        self.post_ffn_norm = layer_norm(d_model)
        if not ref_compat:
            self.post_ffn = PositionwiseFeedForward(d_model, d_ff, activation, ffn_dropout)
        self.final_norm = layer_norm(d_model)
        self.res_dropout = Dropout(residual_dropout)

    def _attn(self, x, attn_mask, pos_emb):
        h = self.attn_norm(x)
        h = (self.slf_attn(h, attn_mask, pos_emb) if self.relative_positional
             else self.slf_attn(h, attn_mask))
        return x + self.res_dropout(h)

    def _conv(self, x, pad_mask):
        return x + self.res_dropout(self.conv_module(self.conv_norm(x), pad_mask))

    def forward(self, x, pad_mask, attn_mask, pos_emb=None):
        if self.macaron_style:
            x = x + self.ffn_scale * self.res_dropout(self.pre_ffn(self.pre_ffn_norm(x)))
        if self.conv_first:
            x = self._attn(self._conv(x, pad_mask), attn_mask, pos_emb)
        else:
            x = self._conv(self._attn(x, attn_mask, pos_emb), pad_mask)
        h = self.post_ffn_norm(x)
        if self.ref_compat:
            # the reference's trained forward: no second FFN, its norm bare
            x = h
        else:
            x = x + self.ffn_scale * self.res_dropout(self.post_ffn(h))
        return self.final_norm(x)


class ConformerEncoder(nn.Module):
    """The conformer stack; its config key for depth is ``nblocks`` (no
    underscore), as in the JAX package and the reference."""

    def __init__(self, d_model: int = 256, n_heads: int = 4, d_ff: int = 2048,
                 nblocks: int = 12, cov_kernel_size: int = 15, pos_dropout: float = 0.0,
                 slf_attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 residual_dropout: float = 0.1, conv_dropout: float = 0.0,
                 macaron_style: bool = True, ffn_scale: float = 0.5, conv_first: bool = False,
                 conv_norm_type: str = "layer", conv_causal: bool = False,
                 activation: str = "glu", positional_encoding: bool = True,
                 relative_positional: bool = True, chunk_size: int = 0, left_chunks: int = -1,
                 ref_compat: bool = False):
        super().__init__()
        self.d_model = d_model
        self.relative_positional = relative_positional
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.pos_enc = (PositionalEncoding(d_model, pos_dropout)
                        if positional_encoding and not relative_positional else None)
        self.layers = []
        for i in range(nblocks):
            block = ConformerEncoderBlock(
                d_model, n_heads, d_ff, cov_kernel_size, slf_attn_dropout, ffn_dropout,
                residual_dropout, conv_dropout, macaron_style, ffn_scale, conv_first,
                conv_norm_type, conv_causal, relative_positional, activation, ref_compat)
            self.add_module(f"block_{i}", block)
            self.layers.append(block)

    def forward(self, x, pad_mask):
        """x: [B, T, D]; pad_mask: bool[B, T] → (y [B, T, D], pad_mask)."""
        attn_mask = encoder_attn_mask(pad_mask, self.chunk_size, self.left_chunks)
        pos_emb = None
        if self.relative_positional:
            pos_emb = rel_pos_embedding(x.shape[1], self.d_model, x.dtype, x.device)
        elif self.pos_enc is not None:
            x = self.pos_enc(x)
        for block in self.layers:
            x = block(x, pad_mask, attn_mask, pos_emb)
        return x, pad_mask
