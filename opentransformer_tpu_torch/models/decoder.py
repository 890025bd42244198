"""Transformer decoder with KV-cached decoding
(counterpart of ``opentransformer_tpu/models/decoder.py``).

Teacher-forced ``forward`` for full sequences; ``init_cache`` projects the
cross-attention K/V once per utterance (B rows) and allocates the
self-attention caches at B·K rows, [N, H, U_max, Dh]; ``decode_step`` and
``decode_step_topk`` append one position. The output projection is the
tied embedding with its own separate ``output_bias`` (none with
``output_bias: false``, Whisper's). Positions are the reference's
sinusoid added to the embedding scaled by √d, or with ``pos_style:
"learned"`` a learned table of ``max_positions`` rows (``pos_embedding``)
added to the unscaled embedding (Whisper's). In training, dropout
acts after the embedding (``pos_dropout``), on the attention outputs
(``slf_attn_dropout``, ``src_attn_dropout``), inside the FFN
(``ffn_dropout``) and on every sublayer's output before the residual add
(``residual_dropout``); in eval mode, and so in every decode step, none.
``decode_step_topk`` hands the last hidden state to the fused projection→log-softmax→top-k
(``ops/project_topk.py``), so the [N, V] log-probs are never written.
``concat_after`` replaces each attention sublayer's residual add by
``h + concat_linear{1,2}([h ∥ attn(h)])``, without residual dropout, as in
the reference; ``scan_layers`` changes the checkpoint layout only (see
``encoder.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.collectives import vocab_parallel_logits
from ..ops.masks import causal_mask
from ..ops.project_topk import project_logp_topk
from .encoder import input_residual
from .modules import (
    LN_EPS,
    Dropout,
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
    PositionwiseFeedForward,
    layer_norm,
    sinusoid_position_encoding,
)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, normalize_before: bool = False,
                 activation: str = "glu", slf_attn_dropout: float = 0.0,
                 src_attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 residual_dropout: float = 0.1, concat_after: bool = False,
                 ln_eps: float = LN_EPS, input_residual: bool = False):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.normalize_before = normalize_before
        self.input_residual = input_residual
        self.norm1 = layer_norm(d_model, ln_eps)
        self.norm2 = layer_norm(d_model, ln_eps)
        self.norm3 = layer_norm(d_model, ln_eps)
        self.slf_attn = MultiHeadSelfAttention(n_heads, d_model, slf_attn_dropout)
        self.src_attn = MultiHeadCrossAttention(n_heads, d_model, src_attn_dropout)
        self.ffn = PositionwiseFeedForward(d_model, d_ff, activation, ffn_dropout)
        if concat_after:
            self.concat_linear1 = nn.Linear(2 * d_model, d_model)
            self.concat_linear2 = nn.Linear(2 * d_model, d_model)
        self.concat_after = concat_after
        self.res_dropout = Dropout(residual_dropout)

    def _sublayer(self, norm, x, fn, concat=None):
        # the residual is the sublayer's input: x (post-norm, or pre-norm
        # with input_residual) or norm(x); with ``concat`` (concat_after)
        # the branch is concat([h, fn(h)]) through that linear, with no
        # residual dropout
        h = norm(x) if self.normalize_before else x
        if self.input_residual:
            return x + self.res_dropout(fn(h))
        if concat is not None:
            x = h + concat(torch.cat([h, fn(h)], dim=-1))
        else:
            x = h + self.res_dropout(fn(h))
        return x if self.normalize_before else norm(x)

    def _concat(self, i: int):
        return getattr(self, f"concat_linear{i}") if self.concat_after else None

    def forward(self, x, memory, self_mask, memory_mask):
        x = self._sublayer(self.norm1, x, lambda h: self.slf_attn(h, self_mask), self._concat(1))
        x = self._sublayer(self.norm2, x, lambda h: self.src_attn(h, memory, memory_mask),
                           self._concat(2))
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
            h, self_cache["k"], self_cache["v"], index, src), self._concat(1))
        x = self._sublayer(self.norm2, x, lambda h: self.src_attn.attend_beamed(
            h, cross_cache["ck"], cross_cache["cv"], memory_pad_mask), self._concat(2))
        return self._sublayer(self.norm3, x, self.ffn)


class TransformerDecoder(nn.Module):
    # this rank's columns of a tied vocabulary split over a tensor group
    # (set by parallel/tensor.py), None when the logits are whole
    vocab_shard = None

    def __init__(self, vocab_size: int, d_model: int = 256, n_heads: int = 4, d_ff: int = 2048,
                 memory_dim: int | None = None, n_blocks: int = 6, activation: str = "glu",
                 normalize_before: bool = False, share_embedding: bool = True,
                 pos_dropout: float = 0.0, slf_attn_dropout: float = 0.0,
                 src_attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 residual_dropout: float = 0.1, concat_after: bool = False,
                 scan_layers: bool = False, pos_style: str = "scaled", max_positions: int = 448,
                 output_bias: bool = True, ln_eps: float = LN_EPS,
                 pre_norm_residual: str = "normalized"):
        super().__init__()
        if memory_dim is not None and memory_dim != d_model:
            raise ValueError(f"memory_dim {memory_dim} must equal d_model {d_model}")
        if pos_style not in ("scaled", "learned"):
            raise ValueError(f"unknown decoder pos_style {pos_style!r} (known: scaled, learned)")
        if not output_bias and not share_embedding:
            raise ValueError("output_bias: false belongs to a tied head (share_embedding)")
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.share_embedding = share_embedding
        self.scan_layers = scan_layers  # the checkpoint layout only (compat)
        self.embedding = nn.Embedding(vocab_size, d_model)
        self.pos_embedding = (nn.Embedding(max_positions, d_model) if pos_style == "learned"
                              else None)
        residual = input_residual(pre_norm_residual, normalize_before, concat_after)
        self.layers = []
        for i in range(n_blocks):
            layer = TransformerDecoderLayer(d_model, n_heads, d_ff, normalize_before, activation,
                                            slf_attn_dropout, src_attn_dropout, ffn_dropout,
                                            residual_dropout, concat_after, ln_eps, residual)
            self.add_module(f"block_{i}", layer)
            self.layers.append(layer)
        self.after_norm = layer_norm(d_model, ln_eps) if normalize_before else None
        self.pos_dropout = Dropout(pos_dropout)
        self.output_bias = None
        if not share_embedding:
            self.output_layer = nn.Linear(d_model, vocab_size)
        elif output_bias:
            # the tied output layer keeps its own bias (reference parity)
            bound = 1.0 / math.sqrt(d_model)  # torch's Linear bias init, as in JAX
            self.output_bias = nn.Parameter(torch.empty(vocab_size).uniform_(-bound, bound))

    def _embed(self, tokens, start: int = 0):
        pos = torch.arange(start, start + tokens.shape[1], device=tokens.device)
        x = self.embedding(tokens)
        if self.pos_embedding is not None:
            return self.pos_dropout(x + self.pos_embedding(pos)[None])
        return self.pos_dropout(x * math.sqrt(self.d_model) + sinusoid_position_encoding(
            pos, self.d_model)[None].to(x.dtype))

    def vocab_head(self):
        """(weight [V, D], bias [V] or None) of the output projection."""
        if self.share_embedding:
            return self.embedding.weight, self.output_bias
        return self.output_layer.weight, self.output_layer.bias

    def _project(self, h):
        w, b = self.vocab_head()
        if self.vocab_shard is not None:  # this rank's columns (tensor parallelism)
            return vocab_parallel_logits(h, w, b, self.vocab_shard)
        logits = h.float() @ w.to(h.dtype).float().T
        return logits if b is None else logits + b.float()

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
        norm → [N, 1, D]. The sinusoid is added as the JAX reference does:
        embedded at position 0, then shifted by pe(index) − pe(0); a learned
        table is read at ``index``."""
        if self.pos_embedding is not None:
            x = self._embed(token_t[:, None], index)
        else:
            x = self._embed(token_t[:, None])
            pos = torch.tensor([0, index], device=token_t.device)
            pe = sinusoid_position_encoding(pos, self.d_model)
            x = x + (pe[1] - pe[0]).to(x.dtype)
        for layer, sc, cc in zip(self.layers, cache["self"], cache["cross"]):
            x = layer.decode_step(x, sc, cc, index, memory_pad_mask, src)
        if self.after_norm is not None:
            x = self.after_norm(x)
        return x

    def decode_hidden_step(self, token_t, cache, index: int, memory_pad_mask, src=None):
        """One cached step up to the pre-projection hidden state:
        (h [N, D], cache). The vocabulary head is applied elsewhere, fused
        with an LM's head in ``project2_logp_topk`` for shallow fusion."""
        x = self._decode_hidden(token_t, cache, index, memory_pad_mask, src)
        return x[:, 0], cache

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
