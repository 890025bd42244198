"""Transformer decoder with KV-cached decoding
(counterpart of ``opentransformer_tpu/models/decoder.py``).

Teacher-forced ``forward`` for full sequences; ``init_cache`` projects the
cross-attention K/V once per utterance (B rows) and allocates the
self-attention caches at B·K rows, [N, H, U_max, Dh]; ``decode_step`` and
``decode_step_topk`` append one position. The output projection is the
tied embedding with its own separate ``output_bias``. ``decode_step_topk``
hands the last hidden state to the fused projection→log-softmax→top-k
(``ops/project_topk.py``), so the [N, V] log-probs are never written.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.masks import causal_mask
from ..ops.project_topk import project_logp_topk
from .modules import (
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
    PositionwiseFeedForward,
    layer_norm,
    sinusoid_position_encoding,
)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, normalize_before: bool = False,
                 activation: str = "glu"):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.normalize_before = normalize_before
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)
        self.slf_attn = MultiHeadSelfAttention(n_heads, d_model)
        self.src_attn = MultiHeadCrossAttention(n_heads, d_model)
        self.ffn = PositionwiseFeedForward(d_model, d_ff, activation)

    def _sublayer(self, norm, x, fn):
        # the residual is the sublayer's input: x (post-norm) or norm(x)
        h = norm(x) if self.normalize_before else x
        x = h + fn(h)
        return x if self.normalize_before else norm(x)

    def forward(self, x, memory, self_mask, memory_mask):
        x = self._sublayer(self.norm1, x, lambda h: self.slf_attn(h, self_mask))
        x = self._sublayer(self.norm2, x, lambda h: self.src_attn(h, memory, memory_mask))
        return self._sublayer(self.norm3, x, self.ffn)

    def init_layer_cache(self, memory, batch: int, max_len: int, beam_width: int = 1):
        ck, cv = self.src_attn.project_kv(memory)
        shape = (batch * beam_width, self.n_heads, max_len, self.d_model // self.n_heads)
        zeros = dict(dtype=memory.dtype, device=memory.device)
        return ({"k": torch.zeros(shape, **zeros), "v": torch.zeros(shape, **zeros)},
                {"ck": ck, "cv": cv})

    def decode_step(self, x_t, self_cache, cross_cache, index: int, memory_pad_mask, src=None):
        """x_t: [B·K, 1, D]; cross cache per utterance [B, H, T, Dh].
        Writes position ``index`` of the self cache in place."""
        x = self._sublayer(self.norm1, x_t, lambda h: self.slf_attn.decode_step(
            h, self_cache["k"], self_cache["v"], index, src))
        x = self._sublayer(self.norm2, x, lambda h: self.src_attn.attend_beamed(
            h, cross_cache["ck"], cross_cache["cv"], memory_pad_mask))
        return self._sublayer(self.norm3, x, self.ffn)


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 256, n_heads: int = 4, d_ff: int = 2048,
                 memory_dim: int = 256, n_blocks: int = 6, activation: str = "glu",
                 normalize_before: bool = False, share_embedding: bool = True):
        super().__init__()
        if memory_dim != d_model:
            raise ValueError(f"memory_dim {memory_dim} must equal d_model {d_model}")
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.share_embedding = share_embedding
        self.embedding = nn.Embedding(vocab_size, d_model)
        self.layers = []
        for i in range(n_blocks):
            layer = TransformerDecoderLayer(d_model, n_heads, d_ff, normalize_before, activation)
            self.add_module(f"block_{i}", layer)
            self.layers.append(layer)
        self.after_norm = layer_norm(d_model) if normalize_before else None
        if share_embedding:
            # the tied output layer keeps its own bias (reference parity)
            self.output_bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.output_layer = nn.Linear(d_model, vocab_size)

    def _embed(self, tokens, start: int = 0):
        pos = torch.arange(start, start + tokens.shape[1], device=tokens.device)
        x = self.embedding(tokens)
        return x * math.sqrt(self.d_model) + sinusoid_position_encoding(
            pos, self.d_model)[None].to(x.dtype)

    def vocab_head(self):
        """(weight [V, D], bias [V]) of the output projection."""
        if self.share_embedding:
            return self.embedding.weight, self.output_bias
        return self.output_layer.weight, self.output_layer.bias

    def _project(self, h):
        w, b = self.vocab_head()
        return h.float() @ w.to(h.dtype).float().T + b.float()

    def forward(self, targets_in, memory, memory_pad_mask):
        """Teacher-forced logits f32[B, U, V] for BOS-prefixed targets; the
        self-attention mask is causal only (reference parity)."""
        self_mask = causal_mask(targets_in.shape[1], device=targets_in.device)
        mem_mask = memory_pad_mask[:, None, None, :]
        x = self._embed(targets_in)
        for layer in self.layers:
            x = layer(x, memory, self_mask, mem_mask)
        if self.after_norm is not None:
            x = self.after_norm(x)
        return self._project(x)

    def init_cache(self, memory, max_len: int, beam_width: int = 1):
        """{"self": per-layer {"k","v"} at B·beam rows, "cross": per-layer
        {"ck","cv"} at B rows}."""
        pairs = [layer.init_layer_cache(memory, memory.shape[0], max_len, beam_width)
                 for layer in self.layers]
        return {"self": [p[0] for p in pairs], "cross": [p[1] for p in pairs]}

    def _decode_hidden(self, token_t, cache, index: int, memory_pad_mask, src=None):
        """Embed at ``index``, run the block stack against the cache, final
        norm → [N, 1, D]. The position term is added as the JAX reference
        does: embedded at position 0, then shifted by pe(index) − pe(0)."""
        x = self._embed(token_t[:, None])
        pos = torch.tensor([0, index], device=token_t.device)
        pe = sinusoid_position_encoding(pos, self.d_model)
        x = x + (pe[1] - pe[0]).to(x.dtype)
        for layer, sc, cc in zip(self.layers, cache["self"], cache["cross"]):
            x = layer.decode_step(x, sc, cc, index, memory_pad_mask, src)
        if self.after_norm is not None:
            x = self.after_norm(x)
        return x

    def decode_step(self, token_t, cache, index: int, memory_pad_mask, src=None):
        """token_t: int[B·K]; src: optional int[B, K, U_max] ancestry map.
        Returns (log_probs f32[B·K, V], cache)."""
        x = self._decode_hidden(token_t, cache, index, memory_pad_mask, src)
        return torch.log_softmax(self._project(x)[:, 0], dim=-1), cache

    def decode_step_topk(self, token_t, cache, index: int, memory_pad_mask, src, k: int):
        """``topk(decode_step(...)[0], k)`` through the fused kernel.
        Returns (logp f32[B·K, k] desc-sorted, ids i32[B·K, k], cache)."""
        x = self._decode_hidden(token_t, cache, index, memory_pad_mask, src)
        w, b = self.vocab_head()
        vals, idx = project_logp_topk(x[:, 0], w, b, k)
        return vals, idx, cache
