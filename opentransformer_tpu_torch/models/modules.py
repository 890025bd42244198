"""NN building blocks (counterpart of ``opentransformer_tpu/models/modules.py``).

Module and parameter names follow the JAX package so that
``compat.params_from_jax`` maps its weights mechanically (a flax
``TorchLinear``'s ``dense`` level disappears into ``nn.Linear``).

Numerics kept from the reference:
  * attention scores and softmax are computed in float32 whatever the
    model dtype; the softmax weights are rounded to the model dtype before
    the context product, which accumulates in float32;
  * masks are an additive ``NEG_INF`` inside the softmax;
  * LayerNorm eps is 1e-6 (flax's default; torch's is 1e-5);
  * dropout sits where the JAX package has it and acts only in training
    mode, drawing from the generator the trainer hands out
    (``set_dropout_generator``); the cached decode paths have none.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import NEG_INF

LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class Dense(nn.Linear):
    """A flax ``nn.Dense`` used bare: its parameters sit directly under the
    module's name, so ``compat`` writes no ``dense`` level for it (a plain
    ``nn.Linear`` stands for the JAX package's ``TorchLinear``, which has one)."""


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, zero each element with probability
    ``p`` and scale the rest by 1/(1 − p); identity in eval mode or at
    p = 0. Draws from ``self.generator``, which ``set_dropout_generator``
    sets; training with p > 0 and no generator raises."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training needs a generator (set_dropout_generator)")
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Make every ``Dropout`` of ``model`` draw from ``generator``."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator


def swish(x):
    return x * torch.sigmoid(x)


ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "swish": swish,
    # 'glu' is special-cased in the FFN (it halves the width).
}


def sinusoid_position_encoding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of integer positions → f32[..., dim], interleaved:
    sin on even channels, cos on odd, freq ``exp(-ln(1e4)·i/half)``."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].to(torch.float32) * freq
    return torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1).reshape(
        *positions.shape, dim)


class PositionalEncoding(nn.Module):
    """y = dropout(x·√d + pe) (the reference's additive mode)."""

    def __init__(self, dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dim = dim
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        pos = torch.arange(x.shape[1], device=x.device)
        pe = sinusoid_position_encoding(pos, self.dim)[None].to(x.dtype)
        return self.dropout(x * math.sqrt(self.dim) + pe)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def attention_context(q, k, v, mask):
    """Scaled dot-product attention over [B, H, T, Dh]; ``mask`` is bool,
    broadcastable to [B, H, Tq, Tk], True = may attend."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def ancestral_decode_context(q, cache_k, cache_v, index: int, src):
    """Beam-search attention over an unordered, append-only KV cache.

    q: [B·K, H, 1, Dh]; cache_k/v: [B·K, H, U, Dh] where row j holds what
    slot j wrote at each step; src: int[B, K, U] ancestry map — the row of
    the utterance's K that holds position u of the hypothesis in slot k.
    The JAX reference selects rows with a one-hot einsum; here the rows of
    positions 0..index are gathered by index, which gives the same numbers
    (positions past ``index`` are masked out there and absent here)."""
    b, kk, _ = src.shape
    h, dk = q.shape[1], q.shape[3]
    u = index + 1
    qb = q.reshape(b, kk, h, dk).float()
    ck = cache_k.reshape(b, kk, h, -1, dk)
    cv = cache_v.reshape(b, kk, h, -1, dk)
    bi = torch.arange(b, device=q.device)[:, None, None]
    ui = torch.arange(u, device=q.device)[None, None, :]
    rows = src[:, :, :u]
    keys = ck[bi, rows, :, ui]  # [B, K, u, H, Dh]
    vals = cv[bi, rows, :, ui]
    scores = torch.einsum("bkhd,bkuhd->bkhu", qb, keys.float()) / math.sqrt(dk)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkhu,bkuhd->bkhd", weights.float(), vals.float()).to(q.dtype)
    return ctx.reshape(b * kk, h, 1, dk)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with a fused QKV projection and a cached decode step."""

    def __init__(self, n_heads: int, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.d_model = d_model
        self.qkv_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout_rate)

    def _qkv(self, x):
        q, k, v = self.qkv_proj(x).split(self.d_model, dim=-1)
        return (split_heads(q, self.n_heads), split_heads(k, self.n_heads),
                split_heads(v, self.n_heads))

    def forward(self, x, mask=None):
        q, k, v = self._qkv(x)
        return self.attn_dropout(self.out_proj(merge_heads(attention_context(q, k, v, mask))))

    def decode_step(self, x_t, cache_k, cache_v, index: int, src=None):
        """One step at position ``index`` with a [N, H, U_max, Dh] cache.

        The new key/value is written into the cache in place (the JAX
        reference returns updated copies). With ``src`` (int[B, K, U_max])
        the cache is unordered and rows are selected through the ancestry
        map (``ancestral_decode_context``). Returns out [N, 1, D]."""
        q, k_t, v_t = self._qkv(x_t)
        cache_k[:, :, index] = k_t[:, :, 0].to(cache_k.dtype)
        cache_v[:, :, index] = v_t[:, :, 0].to(cache_v.dtype)
        if src is None:
            ctx = attention_context(q, cache_k[:, :, : index + 1].to(q.dtype),
                                    cache_v[:, :, : index + 1].to(q.dtype), None)
        else:
            ctx = ancestral_decode_context(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                                           index, src)
        return self.out_proj(merge_heads(ctx))


class MultiHeadCrossAttention(nn.Module):
    """Cross-attention with a fused KV projection over the memory;
    ``project_kv`` runs once per utterance before decoding."""

    def __init__(self, n_heads: int, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.d_model = d_model
        self.q_proj = nn.Linear(d_model, d_model)
        self.kv_proj = nn.Linear(d_model, 2 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout_rate)

    def project_kv(self, memory):
        k, v = self.kv_proj(memory).split(self.d_model, dim=-1)
        return split_heads(k, self.n_heads), split_heads(v, self.n_heads)

    def forward(self, x, memory, memory_mask=None):
        k, v = self.project_kv(memory)
        q = split_heads(self.q_proj(x), self.n_heads)
        return self.attn_dropout(
            self.out_proj(merge_heads(attention_context(q, k, v, memory_mask))))

    def attend_beamed(self, x, k, v, key_pad_mask=None):
        """Beam-tiled queries over per-utterance K/V.

        x: [B·K, 1, D]; k/v: [B, H, T, Dh]; key_pad_mask: bool[B, T]. The
        cross K/V is the same for all beams of an utterance, so it is stored
        once per utterance and never reordered."""
        b, bk = k.shape[0], x.shape[0]
        beams = bk // b
        q = split_heads(self.q_proj(x), self.n_heads)  # [B·K, H, 1, Dh]
        dk = q.shape[-1]
        q = q.reshape(b, beams, self.n_heads, dk).float()
        scores = torch.einsum("bkhd,bhtd->bkht", q, k.float()) / math.sqrt(dk)
        if key_pad_mask is not None:
            scores = scores.masked_fill(~key_pad_mask[:, None, None, :], NEG_INF)
        weights = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bkht,bhtd->bkhd", weights.float(), v.float()).to(x.dtype)
        return self.out_proj(ctx.reshape(bk, 1, self.n_heads * dk))


class PositionwiseFeedForward(nn.Module):
    """w1 → activation → dropout → w2; ``glu`` doubles w1's width and gates
    a·σ(b)."""

    def __init__(self, d_model: int, d_ff: int, activation: str = "relu",
                 dropout_rate: float = 0.0):
        super().__init__()
        if activation != "glu" and activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.w1 = nn.Linear(d_model, 2 * d_ff if activation == "glu" else d_ff)
        self.w2 = nn.Linear(d_ff, d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        h = self.w1(x)
        if self.activation == "glu":
            a, g = h.chunk(2, dim=-1)
            h = a * torch.sigmoid(g)
        else:
            h = ACTIVATIONS[self.activation](h)
        return self.w2(self.dropout(h))
