"""Language models for shallow fusion and n-best rescoring, inference side
(counterpart of ``opentransformer_tpu/models/lm.py``).

``TransformerLanguageModel``: embedding·√d + positions → N causal
self-attention blocks (post-norm, no final norm) → tied or untied vocabulary
head, with a KV-cached ``decode_step``. ``RecurrentLanguageModel``:
embedding → LSTM stack → head, stepping on a carried hidden state.

Both expose what the beam search needs: ``logits`` over whole sequences
(rescoring), ``decode_step`` (log-probs of one step, the unfused path),
``decode_hidden`` (the pre-projection hidden state of one step) and
``vocab_head``, which together feed the fused two-head top-k
(``ops/project_topk.py:project2_logp_topk``). Module and parameter names
follow the flax modules so ``compat.params_from_jax`` maps their weights.

The transformer LM's decode step takes a scalar position (the lockstep
beam) or one position a row (the transducer beam's per-hypothesis LM
state). ``forward(src, tgt, tgt_length)`` is the training loss over the
text collate's pairs (src = BOS ⧺ tokens, tgt = tokens ⧺ EOS): label
smoothing with PAD targets dropped, with dropout at the JAX positions in
training (after each residual branch of a transformer block; between
LSTM layers).

``moe_experts`` > 0 makes every transformer block's FFN an
``MoEFeedForward``. Scoring a whole sequence keeps PAD tokens out of its
dispatch and adds ``moe_aux_weight`` times the blocks' summed load-balance
loss to the training loss (reported as ``moe_aux``); the cached decode
step routes each row's one token with capacity 1 and drops the loss. The
two agree only where capacity never binds over the whole sequence
(``moe_capacity_factor`` >= E / k).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..data import PAD
from ..ops.collectives import vocab_parallel_logits
from ..ops.loss import label_smoothing_loss
from ..ops.masks import causal_mask
from .modules import (
    Dense,
    Dropout,
    MoEFeedForward,
    MultiHeadSelfAttention,
    PositionwiseFeedForward,
    layer_norm,
    sinusoid_position_encoding,
)


class _VocabHead(nn.Module):
    """The output projection both LMs share: the embedding matrix with a
    separate ``output_bias`` when tied, an ``output_layer`` otherwise.
    Set by ``parallel/``: ``vocab_shard``, this rank's columns of a tied
    vocabulary split over a tensor group, and ``data_group``, the data group
    whose batch the loss is a partial of."""

    vocab_shard = None
    data_group = None

    def __init__(self, vocab_size: int, width: int, share_embedding: bool,
                 smoothing: float = 0.1):
        super().__init__()
        self.vocab_size = vocab_size
        self.smoothing = smoothing
        self.share_embedding = share_embedding
        self.embedding = nn.Embedding(vocab_size, width)
        if share_embedding:
            self.output_bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.output_layer = nn.Linear(width, vocab_size)

    def vocab_head(self):
        """(weight [V, D], bias [V]) of the output projection."""
        if self.share_embedding:
            return self.embedding.weight, self.output_bias
        return self.output_layer.weight, self.output_layer.bias

    def _project(self, h):
        """Logits in float32 (products accumulate there, as in the reference)."""
        w, b = self.vocab_head()
        if self.vocab_shard is not None:  # this rank's columns (tensor parallelism)
            return vocab_parallel_logits(h, w, b, self.vocab_shard)
        return h.float() @ w.to(h.dtype).float().T + b.float()

    def decode_step(self, token_t, state, index=None):
        """token_t: int[N] → (log_probs f32[N, V], new state)."""
        h, state = self.decode_hidden(token_t, state, index)
        return torch.log_softmax(self._project(h), dim=-1), state

    def forward(self, src, tgt, tgt_length):
        """The training loss: (label-smoothed loss over the non-PAD targets,
        {}). ``tgt_length`` is part of the text batch and not read (the PAD
        targets mark the lengths)."""
        return label_smoothing_loss(self.logits(src), tgt, self.smoothing, pad_id=PAD,
                                    vocab_shard=self.vocab_shard, group=self.data_group), {}


class TransformerLMLayer(nn.Module):
    """Self-attention and feed-forward, each followed by its LayerNorm
    (the JAX model never sets its layers' ``normalize_before``), with
    ``residual_dropout`` on each branch's output in training; ``moe`` (the
    ``MoEFeedForward`` keyword arguments) makes the FFN a mixture of
    experts."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, activation: str = "glu",
                 residual_dropout: float = 0.0, moe: dict | None = None):
        super().__init__()
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.slf_attn = MultiHeadSelfAttention(n_heads, d_model)
        if moe is None:
            self.ffn = PositionwiseFeedForward(d_model, d_ff, activation)
        self.moe = None if moe is None else MoEFeedForward(d_model, d_ff, activation=activation,
                                                           **moe)
        self.res_dropout = Dropout(residual_dropout)

    def _ffn(self, x, pad_mask=None):
        return self.moe(x, pad_mask) if self.moe is not None else (self.ffn(x), None)

    def forward(self, x, attn_mask, pad_mask=None):
        """→ x, or (x, the MoE's aux) in an MoE layer (``pad_mask`` gates its
        dispatch)."""
        x = self.norm1(x + self.res_dropout(self.slf_attn(x, attn_mask)))
        out, aux = self._ffn(x, pad_mask)
        x = self.norm2(x + self.res_dropout(out))
        return x if aux is None else (x, aux)

    def decode_step(self, x_t, cache, index, src=None):
        """x_t: [N, 1, D]; writes position ``index`` (an int, or int[N]) of
        ``cache`` in place. An MoE routes each row's token alone."""
        x = self.norm1(x_t + self.slf_attn.decode_step(x_t, cache["k"], cache["v"], index, src))
        return self.norm2(x + self._ffn(x)[0])


class TransformerLanguageModel(_VocabHead):
    def __init__(self, vocab_size: int, num_blocks: int = 6, d_model: int = 256,
                 n_heads: int = 4, d_ff: int = 1024, share_embedding: bool = True,
                 activation: str = "glu", moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25, moe_router_jitter: float = 0.0,
                 moe_aux_weight: float = 0.01, residual_dropout: float = 0.1,
                 smoothing: float = 0.1):
        super().__init__(vocab_size, d_model, share_embedding, smoothing)
        self.num_blocks = num_blocks
        self.d_model = d_model
        self.n_heads = n_heads
        self.moe_experts, self.moe_top_k = moe_experts, moe_top_k
        self.moe_capacity_factor, self.moe_aux_weight = moe_capacity_factor, moe_aux_weight
        moe = (dict(n_experts=moe_experts, top_k=moe_top_k, capacity_factor=moe_capacity_factor,
                    router_jitter=moe_router_jitter) if moe_experts > 0 else None)
        self.layers = []
        for i in range(num_blocks):
            layer = TransformerLMLayer(d_model, n_heads, d_ff, activation, residual_dropout, moe)
            self.add_module(f"block_{i}", layer)
            self.layers.append(layer)

    def _embed(self, tokens):
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embedding(tokens)
        return x * math.sqrt(self.d_model) + sinusoid_position_encoding(
            pos, self.d_model)[None].to(x.dtype)

    def _forward(self, tokens):
        """tokens int[B, T] → (f32[B, T, V], the MoE aux or None). The mask
        is causal only: padded keys stay attendable (reference parity); PAD
        tokens claim no expert capacity."""
        mask = causal_mask(tokens.shape[1], device=tokens.device)
        pad_mask = tokens != PAD if self.moe_experts > 0 else None
        x = self._embed(tokens)
        aux = None if pad_mask is None else torch.zeros((), device=x.device)
        for layer in self.layers:
            x = layer(x, mask, pad_mask)
            if isinstance(x, tuple):
                x, a = x
                aux = aux + a
        return self._project(x), aux

    def logits(self, tokens):
        """tokens int[B, T] → f32[B, T, V]."""
        return self._forward(tokens)[0]

    def forward(self, src, tgt, tgt_length):
        """The training loss, with an MoE's ``moe_aux_weight``·``moe_aux``
        added: (loss, {} or {"moe_aux"})."""
        logits, aux = self._forward(src)
        loss = label_smoothing_loss(logits, tgt, self.smoothing, pad_id=PAD,
                                    vocab_shard=self.vocab_shard, group=self.data_group)
        if aux is None:
            return loss, {}
        return loss + self.moe_aux_weight * aux, {"moe_aux": aux}

    def init_cache(self, batch: int, max_len: int):
        """Per-block {"k", "v"} of [batch, H, max_len, Dh] zeros."""
        p = self.embedding.weight
        shape = (batch, self.n_heads, max_len, self.d_model // self.n_heads)
        return [{"k": torch.zeros(shape, dtype=p.dtype, device=p.device),
                 "v": torch.zeros(shape, dtype=p.dtype, device=p.device)}
                for _ in range(self.num_blocks)]

    def decode_hidden(self, token_t, cache, index, src=None):
        """Pre-projection hidden of one step: (h [N, D], cache), the caches
        written in place at position ``index``: an int (lockstep beam), or
        int[N], each row at its own position (the transducer beam; a row
        whose position lies past the cache writes nothing, as the JAX
        package's one-hot write).

        ``src``: optional int[B, K, U] beam-ancestry map (B·K = N), the one
        the decoder threads through its own step. With it the KV caches are
        unordered append-only buffers read through the map
        (``ops.beam_attention.beam_self_attention``) and the beam search never
        gathers them: the LM consumes exactly the decoder's token sequence,
        so the decoder's ancestry is the LM's. Without it the caches are in
        hypothesis order and the caller reorders them between steps.

        The position term is added as the JAX reference does: embedded at
        position 0, then shifted by pe(index) − pe(0) (a row's own with
        per-row positions)."""
        x = self._embed(token_t[:, None])
        pe0 = sinusoid_position_encoding(torch.zeros(1, device=token_t.device), self.d_model)
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            pe = sinusoid_position_encoding(index.to(token_t.device), self.d_model)[:, None]
        else:
            pe = sinusoid_position_encoding(torch.tensor([index], device=token_t.device),
                                            self.d_model)
        x = x + (pe - pe0).to(x.dtype)
        for layer, layer_cache in zip(self.layers, cache):
            x = layer.decode_step(x, layer_cache, index, src)
        return x[:, 0], cache


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: input kernels ``ii, if, ig, io`` without
    bias, hidden kernels ``hi, hf, hg, ho`` with bias; the carry is (c, h).
    As there, the four gates' kernels act as one stacked matrix."""

    GATES = "ifgo"

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        for g in self.GATES:
            self.add_module("i" + g, Dense(input_size, hidden_size, bias=False))
            self.add_module("h" + g, Dense(hidden_size, hidden_size))

    def stacked(self):
        """(input kernel [4H, D_in], hidden kernel [4H, H], hidden bias
        [4H]), the gates in ``GATES`` order."""
        return (torch.cat([getattr(self, "i" + g).weight for g in self.GATES]),
                torch.cat([getattr(self, "h" + g).weight for g in self.GATES]),
                torch.cat([getattr(self, "h" + g).bias for g in self.GATES]))

    @staticmethod
    def step(carry, x_proj, w_h, b_h):
        """One step from the input's projection ``x_proj`` [N, 4H]."""
        c, h = carry
        i, f, g, o = (x_proj + F.linear(h, w_h, b_h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def forward(self, carry, x):
        w_i, w_h, b_h = self.stacked()
        return self.step(carry, F.linear(x, w_i), w_h, b_h)


class RNN(nn.Module):
    """flax ``nn.RNN`` over one cell: scans [B, T, D] from a carry, the
    input projections of every step taken in one product first."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.cell = LSTMCell(input_size, hidden_size)

    def forward(self, x, carry):
        w_i, w_h, b_h = self.cell.stacked()
        x_proj = F.linear(x, w_i)
        outs = []
        for t in range(x.shape[1]):
            carry, y = self.cell.step(carry, x_proj[:, t], w_h, b_h)
            outs.append(y)
        return carry, torch.stack(outs, dim=1)


class RecurrentLanguageModel(_VocabHead):
    # a config key the JAX model accepts and never reads
    TRAINING_FIELDS = ("residual_dropout",)

    def __init__(self, vocab_size: int, num_layers: int = 2, hidden_size: int = 1024,
                 share_embedding: bool = True, dropout: float = 0.1, smoothing: float = 0.1):
        super().__init__(vocab_size, hidden_size, share_embedding, smoothing)
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.rnns = []
        for i in range(num_layers):
            rnn = RNN(hidden_size, hidden_size)
            self.add_module(f"lstm_{i}", rnn)
            self.rnns.append(rnn)
        self.drop = Dropout(dropout)

    def init_hidden(self, batch: int):
        """Per-layer (c, h) of [batch, hidden] zeros."""
        p = self.embedding.weight
        return [(torch.zeros((batch, self.hidden_size), dtype=p.dtype, device=p.device),
                 torch.zeros((batch, self.hidden_size), dtype=p.dtype, device=p.device))
                for _ in range(self.num_layers)]

    def _run(self, x, hidden):
        finals = []
        for i, (rnn, carry) in enumerate(zip(self.rnns, hidden)):
            carry, x = rnn(x, carry)
            if i + 1 < self.num_layers:
                x = self.drop(x)
            finals.append(carry)
        return x, finals

    def logits(self, tokens):
        """tokens int[B, T] → f32[B, T, V], from a zero hidden state."""
        h, _ = self._run(self.embedding(tokens), self.init_hidden(tokens.shape[0]))
        return self._project(h)

    def decode_hidden(self, token_t, hidden, index=None):
        """Pre-projection hidden of one step: (h [N, D], new hidden)."""
        x, hidden = self._run(self.embedding(token_t)[:, None], hidden)
        return x[:, 0], hidden
