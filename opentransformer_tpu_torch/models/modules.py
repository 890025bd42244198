"""NN building blocks (counterpart of ``opentransformer_tpu/models/modules.py``).

Module and parameter names follow the JAX package so that
``compat.params_from_jax`` maps its weights mechanically (a flax
``TorchLinear``'s ``dense`` level disappears into ``nn.Linear``).

Numerics kept from the reference:
  * attention scores and softmax are computed in float32 whatever the
    model dtype; the softmax weights are rounded to the model dtype before
    the context product, which accumulates in float32;
  * masks are an additive ``NEG_INF`` inside the softmax
    (``ops.masks.apply_attn_mask``);
  * LayerNorm eps is 1e-6 (flax's default; torch's is 1e-5), unless a
    config's ``ln_eps`` says otherwise (Whisper's 1e-5);
  * dropout sits where the JAX package has it and acts only in training
    mode, drawing from the generator the trainer hands out
    (``set_dropout_generator``); the cached decode paths have none.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import encoder_attention
from ..ops.beam_attention import beam_cross_attention, beam_self_attention
from ..ops.collectives import copy_to, count_over, reduce_from, sum_over
from ..ops.masks import apply_attn_mask

LN_EPS = 1e-6


def layer_norm(dim: int, eps: float = LN_EPS) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps)


class Dense(nn.Linear):
    """A flax ``nn.Dense`` used bare: its parameters sit directly under the
    module's name, so ``compat`` writes no ``dense`` level for it (a plain
    ``nn.Linear`` stands for the JAX package's ``TorchLinear``, which has one)."""


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, zero each element with probability
    ``p`` and scale the rest by 1/(1 − p); identity in eval mode or at
    p = 0. Draws from ``self.generator``, which ``set_dropout_generator``
    sets; training with p > 0 and no generator raises.

    ``shard`` (set by ``parallel.tensor.shard_model`` on a split FFN or MoE
    hidden) lists (dim, index, count): x is slice ``index`` of ``count``
    along ``dim`` of the whole activation, so the mask is drawn whole and
    sliced. The shards' masks are then independent, and the ranks of a
    tensor group draw what one device draws."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None
        self.shard: list = []

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training needs a generator (set_dropout_generator)")
        shape = list(x.shape)
        for dim, _, count in self.shard:
            shape[dim] *= count
        keep = torch.rand(shape, generator=self.generator, device=x.device) >= self.p
        for dim, index, _ in self.shard:
            keep = keep.narrow(dim, index * x.shape[dim], x.shape[dim])
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Make every ``Dropout`` of ``model``, and every MoE router's jitter,
    draw from ``generator``."""
    for module in model.modules():
        if isinstance(module, (Dropout, MoEFeedForward)):
            module.generator = generator


def swish(x):
    return x * torch.sigmoid(x)


ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    # the exact (erf) GELU, Whisper's
    "gelu_erf": F.gelu,
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


def whisper_sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper's sinusoid of integer positions → f32[..., dim]: ``[sin |
    cos]`` halves, frequency ``exp(-ln(1e4)·i/(half − 1))``."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) / (half - 1)
                     * torch.arange(half, dtype=torch.float32, device=positions.device))
    angles = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class PositionalEncoding(nn.Module):
    """y = dropout(x·√d + pe) (the reference's additive mode), positions
    ``start`` … ``start`` + T − 1. ``start`` is an int or a 0-d tensor (a
    streamed chunk's offset), or int[B] (multi-stream: each row at its own
    stream position, so the table is [B, T, D]). ``style="whisper"`` adds
    Whisper's table (``whisper_sinusoid``) to x unscaled."""

    STYLES = {"scaled": sinusoid_position_encoding, "whisper": whisper_sinusoid}

    def __init__(self, dim: int, dropout_rate: float = 0.0, style: str = "scaled"):
        super().__init__()
        if style not in self.STYLES:
            raise ValueError(f"unknown pos_style {style!r} (known: {sorted(self.STYLES)})")
        self.dim = dim
        self.table = self.STYLES[style]
        self.scale = math.sqrt(dim) if style == "scaled" else 1.0
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, start=0):
        pos = torch.arange(x.shape[1], device=x.device)
        if isinstance(start, torch.Tensor) and start.dim() == 1:
            pe = self.table(start.to(x.device)[:, None] + pos[None], self.dim)
        else:
            pe = self.table(pos + start, self.dim)[None]
        x = x * self.scale if self.scale != 1.0 else x
        return self.dropout(x + pe.to(x.dtype))


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def attention_context(q, k, v, mask):
    """Scaled dot-product attention over [B, H, T, Dh]; ``mask`` is bool,
    broadcastable to [B, H, Tq, Tk], True = may attend. Kernel 5
    (``ops.encoder_attention``) where it takes the call (bf16 on the card,
    no gradient, a key-only mask, its head widths), else the plain
    composition; the two compute the same function."""
    if encoder_attention.takes(q, k, v, mask):
        return encoder_attention.encoder_self_attention(q, k, v, mask)
    return encoder_attention.attention_plain(q, k, v, mask)


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
        q, k, v = self.qkv_proj(x).chunk(3, dim=-1)
        return (split_heads(q, self.n_heads), split_heads(k, self.n_heads),
                split_heads(v, self.n_heads))

    def forward(self, x, mask=None):
        q, k, v = self._qkv(x)
        return self.attn_dropout(self.out_proj(merge_heads(attention_context(q, k, v, mask))))

    def decode_step(self, x_t, cache_k, cache_v, index, src=None):
        """One step at position ``index`` with a [N, H, U_max, Dh] cache.

        The new key/value is written into the cache in place (the JAX
        reference returns updated copies). With ``src`` (int[B, K, U_max])
        the cache is unordered and rows are selected through the ancestry
        map (``ops.beam_attention.beam_self_attention``, which also writes
        them). ``index`` may be int[N], each row at its own position (no
        ``src`` then): as the JAX package, a one-hot write (a row past the
        cache writes nothing) and a mask of the positions up to the row's.
        Returns out [N, 1, D]."""
        if src is not None:  # q, k_t, v_t [N, H, Dh]: views of the one projection
            n = x_t.shape[0]
            q, k_t, v_t = self.qkv_proj(x_t).view(n, 3, self.n_heads, -1).unbind(1)
            ctx = beam_self_attention(q, k_t, v_t, cache_k, cache_v, index, src)
            return self.out_proj(ctx.reshape(n, 1, -1))
        q, k_t, v_t = self._qkv(x_t)
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            pos = torch.arange(cache_k.shape[2], device=cache_k.device)
            hot = (pos[None] == index[:, None])[:, None, :, None]
            cache_k.copy_(torch.where(hot, k_t.to(cache_k.dtype), cache_k))
            cache_v.copy_(torch.where(hot, v_t.to(cache_v.dtype), cache_v))
            valid = pos[None, None, None, :] <= index[:, None, None, None]
            ctx = attention_context(q, cache_k.to(q.dtype), cache_v.to(q.dtype), valid)
            return self.out_proj(merge_heads(ctx))
        cache_k[:, :, index] = k_t[:, :, 0].to(cache_k.dtype)
        cache_v[:, :, index] = v_t[:, :, 0].to(cache_v.dtype)
        ctx = attention_context(q, cache_k[:, :, : index + 1].to(q.dtype),
                                cache_v[:, :, : index + 1].to(q.dtype), None)
        return self.out_proj(merge_heads(ctx))

    def chunk_step(self, x, cache_k, cache_v, kv_mask=None):
        """Chunk-streaming attention: the C new frames x [B, C, D] attend to
        [cache ∥ new] keys and values, the cache [B, H, L, Dh] holding the
        last L frames' (newest last). ``kv_mask``: bool broadcastable to
        [B, H, C, L + C]. Returns (out [B, C, D], the last L entries of
        [cache ∥ new] as the new cache)."""
        q, k_c, v_c = self._qkv(x)
        k = torch.cat([cache_k.to(k_c.dtype), k_c], dim=2)
        v = torch.cat([cache_v.to(v_c.dtype), v_c], dim=2)
        out = self.out_proj(merge_heads(attention_context(q, k, v, kv_mask)))
        return out, keep_last(k, cache_k.shape[2]), keep_last(v, cache_v.shape[2])


def keep_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` entries of axis 2 (none when n = 0)."""
    return x.narrow(2, x.shape[2] - n, n)


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
        k, v = self.kv_proj(memory).chunk(2, dim=-1)
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
        once per utterance and never reordered; the attention is
        ``ops.beam_attention.beam_cross_attention``, in x's type."""
        q = self.q_proj(x).view(x.shape[0], self.n_heads, -1)  # [B·K, H, Dh]
        ctx = beam_cross_attention(q, k, v, key_pad_mask, x.dtype)
        return self.out_proj(ctx.reshape(x.shape[0], 1, -1))


def rel_pos_embedding(t: int, dim: int, dtype, device=None) -> torch.Tensor:
    """Sinusoid embeddings of the relative positions −(T−1) … T−1: [1, 2T−1, D]."""
    pos = torch.arange(-(t - 1), t, device=device)
    return sinusoid_position_encoding(pos, dim)[None].to(dtype)


def rel_pos_embedding_span(lo: int, hi: int, dim: int, dtype, device=None) -> torch.Tensor:
    """Sinusoid embeddings of the relative positions lo … hi − 1: [1, hi − lo, D]
    (a streamed chunk's −(L+C−1) … C−1)."""
    pos = torch.arange(lo, hi, device=device)
    return sinusoid_position_encoding(pos, dim)[None].to(dtype)


def relative_shift(bd: torch.Tensor) -> torch.Tensor:
    """Skew [B, H, T, 2T−1] → [B, H, T, T] with out[q, k] = bd[q, k − q + T − 1],
    as the JAX package does it: pad one column, flatten, slice (views after
    the pad, no gather)."""
    b, h, t, _ = bd.shape
    x = F.pad(bd, (0, 1)).reshape(b, h, 2 * t * t)
    return x.narrow(2, t - 1, t * (2 * t - 1)).reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPosSelfAttention(nn.Module):
    """Transformer-XL relative-position self-attention: a fused QKV
    projection, a bias-free projection ``pos_proj`` of the sinusoid
    embeddings of positions −(T−1) … T−1, and per-head content and position
    biases ``posu`` / ``posv`` [1, H, 1, Dh]. Scores are
    ``((q + u)·k + relative_shift((q + v)·r)) / √Dh`` in float32.

    ``use_out_proj=False`` returns the head concat unprojected (the
    reference's trained forward, ``ref_compat``); ``share_qvk_proj`` uses one
    D-wide projection for q, k and v; ``skip_term_b`` drops q from the
    position term, which becomes ``v·r`` for every query. (The JAX package
    shifts that term before broadcasting it over the queries, which works
    only at T = 1; here it is broadcast first, which gives the same numbers
    at T = 1 and the term's meaning at any T.)"""

    def __init__(self, n_heads: int, d_model: int, dropout_rate: float = 0.0,
                 share_qvk_proj: bool = False, skip_term_b: bool = False,
                 use_out_proj: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.d_model = d_model
        self.share_qvk_proj = share_qvk_proj
        self.skip_term_b = skip_term_b
        self.qkv_proj = nn.Linear(d_model, d_model if share_qvk_proj else 3 * d_model)
        self.pos_proj = nn.Linear(d_model, d_model, bias=False)
        self.out_proj = nn.Linear(d_model, d_model) if use_out_proj else None
        # flax's xavier_normal over (1, H, 1, Dh): fan_in H, fan_out H·Dh
        d_k = d_model // n_heads
        std = math.sqrt(2.0 / (n_heads * (1 + d_k)))
        self.posu = nn.Parameter(torch.randn(1, n_heads, 1, d_k) * std)
        self.posv = nn.Parameter(torch.randn(1, n_heads, 1, d_k) * std)
        self.attn_dropout = Dropout(dropout_rate)

    def forward(self, x, mask=None, pos_emb=None):
        """x: [B, T, D]; pos_emb: [1, 2T−1, D] (``rel_pos_embedding``; made
        here when None) → [B, T, D]."""
        b, t, _ = x.shape
        if pos_emb is None:
            pos_emb = rel_pos_embedding(t, self.d_model, x.dtype, x.device)
        y = self.qkv_proj(x)
        q, k, v = (y, y, y) if self.share_qvk_proj else y.chunk(3, dim=-1)
        q, k, v = (split_heads(a, self.n_heads) for a in (q, k, v))
        r = split_heads(self.pos_proj(pos_emb), self.n_heads)  # [1, H, 2T−1, Dh]
        posu, posv = self.posu.to(x.dtype), self.posv.to(x.dtype)
        ac = torch.matmul((q + posu).float(), k.float().transpose(-1, -2))
        content = posv if self.skip_term_b else q + posv
        bd = torch.matmul(content.float(), r.float().transpose(-1, -2))
        if self.skip_term_b:
            bd = bd.expand(b, self.n_heads, t, 2 * t - 1)
        scores = (ac + relative_shift(bd)) / math.sqrt(q.shape[-1])
        weights = torch.softmax(apply_attn_mask(scores, mask), dim=-1).to(x.dtype)
        out = merge_heads(torch.matmul(weights.float(), v.float()).to(x.dtype))
        if self.out_proj is not None:
            out = self.out_proj(out)
        return self.attn_dropout(out)

    def chunk_step(self, x, cache_k, cache_v, kv_mask=None):
        """Chunk-streaming rel-pos attention: C queries x [B, C, D] over
        [cache(L) ∥ chunk(C)] keys. The offsets key − query run over
        −(L+C−1) … C−1 (L + 2C − 1 sinusoid rows, the batch path's table
        for these offsets), and the position term is gathered as
        ``bd[q, k] = bd_raw[q, k − q + C − 1]``. With ``skip_term_b`` the
        term is broadcast over the queries before the gather. Returns (out,
        new_k, new_v) as ``MultiHeadSelfAttention.chunk_step``."""
        b, c, _ = x.shape
        left = cache_k.shape[2]
        y = self.qkv_proj(x)
        q, k_c, v_c = (y, y, y) if self.share_qvk_proj else y.chunk(3, dim=-1)
        q, k_c, v_c = (split_heads(a, self.n_heads) for a in (q, k_c, v_c))
        k = torch.cat([cache_k.to(k_c.dtype), k_c], dim=2)
        v = torch.cat([cache_v.to(v_c.dtype), v_c], dim=2)
        pos_emb = rel_pos_embedding_span(-(left + c - 1), c, self.d_model, x.dtype, x.device)
        r = split_heads(self.pos_proj(pos_emb), self.n_heads)  # [1, H, L+2C−1, Dh]
        posu, posv = self.posu.to(x.dtype), self.posv.to(x.dtype)
        ac = torch.matmul((q + posu).float(), k.float().transpose(-1, -2))  # [B, H, C, L+C]
        content = posv if self.skip_term_b else q + posv
        bd_raw = torch.matmul(content.float(), r.float().transpose(-1, -2))
        bd_raw = bd_raw.expand(b, self.n_heads, c, bd_raw.shape[-1])
        idx = (torch.arange(left + c, device=x.device)[None, :]
               - torch.arange(c, device=x.device)[:, None]) + (c - 1)
        bd = torch.gather(bd_raw, 3, idx.expand(b, self.n_heads, c, left + c))
        scores = (ac + bd) / math.sqrt(q.shape[-1])
        weights = torch.softmax(apply_attn_mask(scores, kv_mask), dim=-1).to(x.dtype)
        out = merge_heads(torch.matmul(weights.float(), v.float()).to(x.dtype))
        if self.out_proj is not None:
            out = self.out_proj(out)
        return out, keep_last(k, left), keep_last(v, left)


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


class Routing(NamedTuple):
    """One MoE call's routing, slot s = 0 the first choice. ``experts``,
    ``positions`` int64[k, B, T] (a token's expert and its place in that
    expert's buffer), ``kept`` bool[k, B, T] (False: dropped over capacity,
    or a pad), ``weights`` f32[k, B, T] (the combine weight, 0 where not
    kept), ``probs`` f32[B, T, E], the Switch load-balance ``aux`` (f32
    scalar) and the per-expert capacity ``cap``."""

    experts: torch.Tensor
    positions: torch.Tensor
    kept: torch.Tensor
    weights: torch.Tensor
    probs: torch.Tensor
    aux: torch.Tensor
    cap: int


class MoEFeedForward(nn.Module):
    """Mixture-of-experts FFN with top-k routing (the JAX package's
    ``MoEFeedForward``, Switch / GShard style); returns (y, aux).

    The router (``router``, a Linear to E logits) runs in float32 whatever
    the model's dtype or autocast, and its parameters stay float32 when the
    model is cast. Top-k (k = 1 or 2) of its softmax; each expert takes at
    most ``cap = max(min(ceil(T·cf·k / E), T), 1)`` tokens a row (T the
    padded length), earlier choices first and, within a choice, earlier
    tokens first; a token over capacity is dropped and contributes zero
    (it passes on the residual at the call site). Top-1 weighs an expert's
    output by the raw router probability, top-2 by the probabilities
    renormalised over the two. ``pad_mask`` bool[B, T] (True = valid)
    keeps pads out of dispatch, capacity and the statistics of the aux
    loss ``E·Σ_e f_e·P_e`` (f: share of first choices, P: mean
    probability). In training, ``router_jitter`` j scales the router's
    input by U(1 − j, 1 + j), drawn from ``self.generator``
    (``set_dropout_generator``).

    The experts' parameters are stacked over E: ``w1`` [E, D, F] (F = 2·d_ff
    for ``glu``), ``b1`` [E, F], ``w2`` [E, d_ff, D], ``b2`` [E, D], the flax
    layout. The JAX package dispatches with dense one-hot [B, T, E, C]
    products; here each expert's buffer of C token rows is gathered by
    index and the experts run as one batched product over E, which gives
    the same routing and the same numbers.

    ``shard`` (set by ``parallel.tensor.shard_model``) lists the groups the
    layer is split over, as (axis, offset, group): on ``expert`` this rank
    holds experts [offset, offset + E_local), on ``model`` a slice of each
    expert's hidden columns (index ``offset``). The router and the routing
    stay whole; this rank computes the combine of its part, which is a
    partial of the layer's output, summed over the groups (g). The dispatch
    input and the combine weights' logits pass f, so the partial gradients
    sum; the aux loss reads the logits without it (its gradient is the same
    on every rank). With ``data_group`` (set by ``parallel/engine.py``) the
    aux's expert shares and mean probabilities are that data group's."""

    data_group = None

    def __init__(self, d_model: int, d_ff: int, n_experts: int = 4, top_k: int = 1,
                 capacity_factor: float = 1.25, activation: str = "relu",
                 dropout_rate: float = 0.0, router_jitter: float = 0.0):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError(f"moe_top_k must be 1 or 2, got {top_k}")
        if activation != "glu" and activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.n_experts, self.top_k = int(n_experts), int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.router_jitter = float(router_jitter)
        self.activation = activation
        f_out = 2 * d_ff if activation == "glu" else d_ff
        self.router = nn.Linear(d_model, n_experts)
        self.w1 = nn.Parameter(torch.empty(n_experts, d_model, f_out))
        self.b1 = nn.Parameter(torch.empty(n_experts, f_out))
        self.w2 = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        self.b2 = nn.Parameter(torch.empty(n_experts, d_model))
        for p, fan_in in ((self.w1, d_model), (self.b1, d_model), (self.w2, d_ff),
                          (self.b2, d_ff)):
            nn.init.uniform_(p, -1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in))
        self.dropout = Dropout(dropout_rate)
        self.generator: torch.Generator | None = None
        self.shard: list = []

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.router.float()  # the router stays float32 when the model is cast
        return self

    def capacity(self, t: int) -> int:
        cap = int(math.ceil(t * self.capacity_factor * self.top_k / self.n_experts))
        return max(min(cap, t), 1)

    def route(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None) -> Routing:
        """The routing of x [B, T, D] (the jitter applies in training)."""
        b, t, _ = x.shape
        e = self.n_experts
        cap = self.capacity(t)
        r_in = x
        if self.router_jitter > 0.0 and self.training:
            if self.generator is None:
                raise RuntimeError("router jitter in training needs a generator "
                                   "(set_dropout_generator)")
            j = self.router_jitter
            u = torch.rand(x.shape, generator=self.generator, device=x.device)
            r_in = x * ((1.0 - j) + 2.0 * j * u).to(x.dtype)
        with torch.autocast(x.device.type, enabled=False):
            logits = F.linear(r_in.float(), self.router.weight.float(), self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)
        # the combine weights' probabilities: f over the shard groups
        probs_c = probs
        if self.shard:
            for _, _, group in self.shard:
                logits = copy_to(logits, group)
            probs_c = torch.softmax(logits, dim=-1)
        valid = None if pad_mask is None else pad_mask.to(torch.float32)
        remaining, remaining_c = probs, probs_c
        gate_sum = torch.zeros_like(probs[..., 0])
        experts, onehots, gates = [], [], []
        for _ in range(self.top_k):
            idx = torch.argmax(remaining, dim=-1)  # the first maximum on ties
            oh = F.one_hot(idx, e).to(torch.float32)
            if valid is not None:
                oh = oh * valid[..., None]  # pads dispatch nowhere
            gate = (remaining_c * oh).sum(-1)
            experts.append(idx)
            onehots.append(oh)
            gates.append(gate)
            gate_sum = gate_sum + gate
            remaining = remaining * (1.0 - oh)
            remaining_c = remaining if probs_c is probs else remaining_c * (1.0 - oh)
        counts = torch.zeros((b, 1, e), dtype=torch.long, device=x.device)
        positions, kept, weights = [], [], []
        for oh, gate in zip(onehots, gates):
            # a token's place in its expert's buffer: earlier choices, then
            # earlier tokens first (integer cumsums count exactly)
            ohi = oh.long()
            pos = torch.cumsum(ohi, dim=1) - ohi + counts
            keep = (pos < cap) & (ohi > 0)
            counts = counts + keep.sum(dim=1, keepdim=True)
            positions.append((pos * ohi).sum(-1))
            kept.append(keep.any(-1))
            g = gate / torch.clamp_min(gate_sum, 1e-9) if self.top_k > 1 else gate
            weights.append(g * kept[-1])
        masked = probs if valid is None else probs * valid[..., None]
        if self.data_group is None:
            denom = torch.clamp_min(valid.sum(), 1.0) if valid is not None else float(b * t)
            f_frac = onehots[0].sum(dim=(0, 1)) / denom
        else:  # the data group's shares: the aux is this rank's partial
            group = self.data_group
            denom = torch.clamp_min(count_over(
                valid.sum() if valid is not None else float(b * t), group, x.device), 1.0)
            f_frac = count_over(onehots[0].sum(dim=(0, 1)), group) / denom
        aux = e * torch.sum(f_frac * masked.sum(dim=(0, 1)) / denom)
        return Routing(torch.stack(experts), torch.stack(positions), torch.stack(kept),
                       torch.stack(weights), probs, aux, cap)

    def forward(self, x, pad_mask=None):
        """x [B, T, D] → (y [B, T, D], aux f32 scalar)."""
        b, t, d = x.shape
        r = self.route(x, pad_mask)
        k, cap = self.top_k, r.cap
        e0, e = 0, self.w1.shape[0]  # this rank's experts
        kept = r.kept
        b2 = self.b2
        for axis, offset, group in self.shard:
            x = copy_to(x, group)
            if axis == "expert":
                e0 = offset
                kept = kept & (r.experts >= e0) & (r.experts < e0 + e)
            else:  # the bias joins the partial once, on the first hidden shard
                b2 = copy_to(b2, group) * (1.0 if offset == 0 else 0.0)
        dev = x.device
        rows = torch.arange(b, device=dev)[None, :, None]
        # buffer slot of each (choice, token), expert-major: (e·B + b)·C + c;
        # what is not kept goes to one spare slot past the end
        slot = ((r.experts - e0) * b + rows) * cap + r.positions
        n_slots = e * b * cap
        dest = torch.where(kept, slot, n_slots).reshape(-1)
        token = torch.arange(b * t, device=dev).view(1, b, t).expand(k, b, t).reshape(-1)
        src = torch.full((n_slots + 1,), b * t, dtype=torch.long, device=dev)
        src.scatter_(0, dest, token)
        # empty slots read a zero row
        x_rows = torch.cat([x.reshape(b * t, d), x.new_zeros(1, d)])
        xe = x_rows[src[:n_slots]].view(e, b * cap, d)
        h = torch.bmm(xe, self.w1.to(xe.dtype)) + self.b1.to(xe.dtype)[:, None, :]
        if self.activation == "glu":
            a, g = h.chunk(2, dim=-1)
            h = a * torch.sigmoid(g)
        else:
            h = ACTIVATIONS[self.activation](h)
        h = self.dropout(h)
        ye = torch.bmm(h, self.w2.to(h.dtype)) + b2.to(h.dtype)[:, None, :]
        picked = ye.reshape(n_slots, d)[torch.where(kept, slot, 0).reshape(-1)]
        picked = picked.view(k, b, t, d).float()
        weights = r.weights if kept is r.kept else torch.where(kept, r.weights, 0.0)
        w = weights.to(ye.dtype).float()[..., None]
        y = (picked * w).sum(0)
        for _, _, group in self.shard:
            y = reduce_from(y, group)
        return y.to(ye.dtype), r.aux


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (flax 0.12.3's semantics):
    ``(x − mean) · rsqrt(var + 1e-5) · scale + bias``, computed in float32
    and returned in x's dtype. In training, mean and variance are those of
    the batch over every position of the leading axes (pads included; with
    ``data_group``, set by ``parallel/engine.py``, that group's whole
    batch), in float32
    whatever the autocast, the variance ``E[x²] − E[x]²`` clipped
    at 0 (biased), and the running averages of the JAX ``batch_stats``
    collection (the ``running_mean`` / ``running_var`` buffers) move in
    place as ``ra = 0.99·ra + 0.01·batch``; in eval mode they normalize.
    torch's ``BatchNorm1d`` (momentum 0.1, unbiased running variance) is
    not this."""

    MOMENTUM = 0.99
    data_group = None

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.data_group is None:
                mean = xf.mean(dim=axes)
                var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
            else:  # the data group's global batch statistics
                group = self.data_group
                n = count_over(float(xf.numel() // xf.shape[-1]), group, xf.device)
                mean = sum_over(xf.sum(dim=axes), group) / n
                var = torch.clamp_min(sum_over((xf * xf).sum(dim=axes), group) / n
                                      - mean * mean, 0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class ConformerConvModule(nn.Module):
    """pw1 → GLU → zero the pads → pad → depthwise conv → norm → swish →
    pw2 → dropout → zero the pads. The padding is (k − 1, 0) when
    ``causal``, else ((k − 1)//2, k//2) (XLA's SAME); the depthwise conv is a
    grouped ``Conv1d`` (flax kernel [k, 1, D] ↔ weight [D, 1, k]), which the
    JAX package computes outside any kernel as a shift-multiply.
    ``norm_type`` is ``layer`` or ``batch`` (``BatchNorm``)."""

    def __init__(self, d_model: int, kernel_size: int = 15, norm_type: str = "layer",
                 dropout_rate: float = 0.0, causal: bool = False):
        super().__init__()
        if norm_type not in ("layer", "batch"):
            raise ValueError(f"unknown conv norm_type {norm_type!r}")
        self.kernel_size = kernel_size
        self.causal = causal
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.dw_conv = nn.Conv1d(d_model, d_model, kernel_size, groups=d_model)
        self.norm_type = norm_type
        if norm_type == "batch":
            self.bn = BatchNorm(d_model)
        else:
            self.ln = layer_norm(d_model)
        self.pw2 = nn.Linear(d_model, d_model)
        self.drop = Dropout(dropout_rate)

    def _glu_in(self, x, keep):
        a, g = self.pw1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(g)
        # zero the pads after the GLU, so that they feed zeros (not GLU(bias))
        # to the conv window
        return h if keep is None else h * keep

    def _post_conv(self, h, keep):
        h = self.bn(h) if self.norm_type == "batch" else self.ln(h)
        h = self.drop(self.pw2(swish(h)))
        return h if keep is None else h * keep

    def forward(self, x, pad_mask=None):
        """x: [B, T, D]; pad_mask: bool[B, T] → [B, T, D]."""
        keep = None if pad_mask is None else pad_mask[..., None].to(x.dtype)
        h = self._glu_in(x, keep)
        k = self.kernel_size
        pad = (k - 1, 0) if self.causal else ((k - 1) // 2, k // 2)
        h = self.dw_conv(F.pad(h.transpose(1, 2), pad)).transpose(1, 2)
        return self._post_conv(h, keep)

    def conv_step(self, x, conv_state, pad_mask=None):
        """Causal streaming step: ``conv_state`` f[B, k − 1, D] holds the last
        post-GLU frames before the chunk x [B, C, D]; the depthwise conv runs
        VALID over [state ∥ new] and emits exactly C frames. Returns (y [B, C,
        D], the last k − 1 frames of [state ∥ new] as the new state).
        Chunk by chunk it equals ``forward`` with ``causal``."""
        keep = None if pad_mask is None else pad_mask[..., None].to(x.dtype)
        h = self._glu_in(x, keep)
        full = torch.cat([conv_state.to(h.dtype), h], dim=1)
        y = self.dw_conv(full.transpose(1, 2)).transpose(1, 2)
        n = self.kernel_size - 1
        return self._post_conv(y, keep), full.narrow(1, full.shape[1] - n, n)
