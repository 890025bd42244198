"""Encoders (counterpart of ``opentransformer_tpu/models/encoder.py``):
Transformer and Conformer.

``TransformerEncoder``: post-norm (the shipped configs) or the reference's
pre-norm, whose residual is the *normalized* tensor (``pre_norm_residual:
"input"`` makes it the block's input, the usual pre-LN of Whisper);
absolute sinusoidal positions (``pos_style``: the reference's x·√d + an
interleaved table, or ``"whisper"``'s [sin | cos] table added unscaled), or
relative positions (``relative_positional``: rel-pos attention over
−(T−1) … T−1, and no absolute encoding); block-chunked attention with
``chunk_size`` > 0; LayerNorm ε ``ln_eps``. In training, dropout acts after the
absolute positions (``pos_dropout``), on the attention output
(``slf_attn_dropout``), inside the FFN (``ffn_dropout``) and on both
sublayers' outputs before the residual add (``residual_dropout``).

``ConformerEncoder``: macaron blocks ½·FFN → attention (rel-pos, or
absolute with ``relative_positional: false``) → conv module → ½·FFN →
LayerNorm, with ``conv_first``, ``conv_causal``, ``ffn_scale`` and the
reference-import mode ``ref_compat`` (the second FFN dropped, its norm
applied bare, no attention output projection). ``res_dropout`` acts on
every residual branch.

Both encoders stream a chunked-attention config frame-synchronously
(inference only): ``init_stream_cache`` gives per-block shifting KV caches
of the last ``left_chunks`` chunks (and the conformer's causal-conv state),
and ``encode_step`` advances them by one chunk, equal to the offline
encode under the chunk mask. The caches are plain tensors on the model's
device and dtype, not parameters or buffers.

``concat_after`` (the reference's transformer option) replaces the
attention branch's residual add by ``x + concat_linear([x ∥ attn(x)])``,
with no residual dropout on that branch, as in the reference. A
``scan_layers`` config (the JAX package's stacked-parameter blocks under
``lax.scan``) builds the same per-block modules: torch runs a Python loop
over blocks, so there is no program to shrink, and ``compat`` stacks and
unstacks the ``blocks`` layout of its checkpoints.

Mixture of experts (``moe_experts`` > 0): an ``MoEFeedForward`` named
``moe`` replaces the FFN of a transformer layer, or the second macaron FFN
of a conformer block (the first stays dense), in every block i with
(i + 1) % ``moe_every`` == 0. The pad mask gates its dispatch, and the
encoder returns the blocks' summed load-balance loss as a third output.
A ``scan_layers`` encoder must have MoE in every block. The streamed step
gates the dispatch with the chunk mask and drops the loss; capacity then
binds per chunk, so a streamed MoE encoder equals the offline one only when
``moe_capacity_factor`` >= E / k (``init_stream_cache`` warns otherwise).
"""

from __future__ import annotations

import logging

import torch
from torch import nn

from ..ops.masks import attn_mask_from_pad, chunk_attn_mask
from .modules import (
    LN_EPS,
    ConformerConvModule,
    Dropout,
    MoEFeedForward,
    MultiHeadSelfAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RelPosSelfAttention,
    layer_norm,
    rel_pos_embedding,
)


logger = logging.getLogger(__name__)


def _warn_moe_stream_capacity(n_experts: int, top_k: int, capacity_factor: float) -> None:
    """A streamed MoE block routes a chunk at a time and the offline encode a
    whole sequence: the two agree only while capacity never binds."""
    drop_free = n_experts / max(top_k, 1)
    if capacity_factor < drop_free:
        logger.warning(
            "streaming an MoE encoder with moe_capacity_factor=%.2f < "
            "n_experts/top_k=%.2f: expert capacity can bind, and streamed "
            "outputs then diverge from the batch encode (capacity is "
            "enforced per chunk when streaming). Raise moe_capacity_factor "
            "to >= %.2f for exact parity.", capacity_factor, drop_free, drop_free)


def _moe_blocks(n_blocks: int, moe_experts: int, moe_top_k: int, moe_capacity_factor: float,
                moe_router_jitter: float, moe_every: int, scan_layers: bool = False) -> list:
    """Per block, the ``MoEFeedForward`` keyword arguments (an MoE block) or
    None (a dense one)."""
    if moe_experts <= 0:
        return [None] * n_blocks
    if scan_layers and moe_every != 1:
        raise ValueError("scan_layers requires moe_every: 1 (all blocks structurally identical)")
    moe = dict(n_experts=moe_experts, top_k=moe_top_k, capacity_factor=moe_capacity_factor,
               router_jitter=moe_router_jitter)
    return [moe if (i + 1) % moe_every == 0 else None for i in range(n_blocks)]


def _run_blocks(blocks, x, moe: bool, *args):
    """x through ``blocks``; with MoE, (x, the blocks' summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if moe else None
    for block in blocks:
        x = block(x, *args)
        if isinstance(x, tuple):
            x, a = x
            aux = aux + a
    return x, aux


def stream_kv_mask(batch: int, left: int, chunk: int, cache_len, chunk_mask=None,
                   device=None) -> torch.Tensor:
    """Validity mask bool[B, 1, 1, L + C] of a chunk step over [cache(L) ∥
    chunk(C)] keys: the cache fills from the right, so only its last
    ``cache_len`` slots are valid. ``cache_len`` is an int or int[B] (one
    stream depth a row); ``chunk_mask`` bool[B, C] marks the chunk's valid
    frames (all when None)."""
    cl = torch.as_tensor(cache_len, device=device)
    if cl.dim() == 0:
        cl = cl.expand(batch)
    key_valid = torch.arange(left, device=cl.device)[None] >= (left - cl[:, None])
    if chunk_mask is None:
        chunk_mask = torch.ones((batch, chunk), dtype=torch.bool, device=cl.device)
    return torch.cat([key_valid, chunk_mask.to(cl.device)], dim=1)[:, None, None, :]


def _check_streamable(chunk_size: int, left_chunks: int) -> None:
    if chunk_size <= 0 or left_chunks < 0:
        raise ValueError(
            "streaming encode requires chunk_size > 0 and left_chunks >= 0 "
            f"(got chunk_size={chunk_size}, left_chunks={left_chunks})")


def _like(module: nn.Module):
    """(device, dtype) of a module's parameters: where its caches live."""
    p = next(module.parameters())
    return p.device, p.dtype


PRE_NORM_RESIDUALS = ("normalized", "input")


def input_residual(pre_norm_residual: str, normalize_before: bool, concat_after: bool) -> bool:
    """Whether a pre-norm block adds its sublayers to their inputs (the
    usual pre-LN) rather than to their normalized inputs (the reference's)."""
    if pre_norm_residual not in PRE_NORM_RESIDUALS:
        raise ValueError(f"unknown pre_norm_residual {pre_norm_residual!r} "
                         f"(known: {list(PRE_NORM_RESIDUALS)})")
    if pre_norm_residual == "input" and (not normalize_before or concat_after):
        raise ValueError("pre_norm_residual 'input' needs normalize_before and no concat_after")
    return pre_norm_residual == "input"


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
                 relative_positional: bool = False, concat_after: bool = False,
                 moe: dict | None = None, ln_eps: float = LN_EPS,
                 input_residual: bool = False):
        super().__init__()
        self.normalize_before = normalize_before
        self.input_residual = input_residual
        self.norm1 = layer_norm(d_model, ln_eps)
        self.norm2 = layer_norm(d_model, ln_eps)
        attn = RelPosSelfAttention if relative_positional else MultiHeadSelfAttention
        self.slf_attn = attn(n_heads, d_model, slf_attn_dropout)
        self.relative_positional = relative_positional
        self.concat_linear = nn.Linear(2 * d_model, d_model) if concat_after else None
        if moe is None:
            self.ffn = PositionwiseFeedForward(d_model, d_ff, activation, ffn_dropout)
        self.moe = None if moe is None else MoEFeedForward(
            d_model, d_ff, activation=activation, dropout_rate=ffn_dropout, **moe)
        self.res_dropout = Dropout(residual_dropout)

    def _attn_residual(self, h, attn):
        """h + the attention branch: ``concat_linear([h ∥ attn])`` without
        residual dropout (the reference's concat_after), else dropout(attn)."""
        if self.concat_linear is not None:
            return h + self.concat_linear(torch.cat([h, attn], dim=-1))
        return h + self.res_dropout(attn)

    def forward(self, x, attn_mask, pos_emb=None, pad_mask=None):
        """→ y, or (y, the MoE's aux) in an MoE layer (``pad_mask`` gates its
        dispatch)."""
        # the residual is the sublayer's input: x (post-norm) or norm(x)
        pre = self.normalize_before
        h = self.norm1(x) if pre else x
        attn = (self.slf_attn(h, attn_mask, pos_emb) if self.relative_positional
                else self.slf_attn(h, attn_mask))
        h = self._attn_residual(x if self.input_residual else h, attn)
        if not pre:
            h = self.norm1(h)
        h2 = self.norm2(h) if pre else h
        out, aux = self.moe(h2, pad_mask) if self.moe is not None else (self.ffn(h2), None)
        h = (h if self.input_residual else h2) + self.res_dropout(out)
        if not pre:
            h = self.norm2(h)
        return h if aux is None else (h, aux)

    def encode_step(self, x, cache_k, cache_v, kv_mask, chunk_mask=None):
        """One streamed chunk x [B, C, D] over the block's shifting KV cache
        (inference: no dropout) → (y, new_k, new_v); ``chunk_mask`` gates an
        MoE's dispatch."""
        pre = self.normalize_before
        h = self.norm1(x) if pre else x
        attn, new_k, new_v = self.slf_attn.chunk_step(h, cache_k, cache_v, kv_mask)
        h = self._attn_residual(x if self.input_residual else h, attn)  # no dropout here
        if not pre:
            h = self.norm1(h)
        h2 = self.norm2(h) if pre else h
        h = (h if self.input_residual else h2) + (
            self.moe(h2, chunk_mask)[0] if self.moe is not None else self.ffn(h2))
        if not pre:
            h = self.norm2(h)
        return h, new_k, new_v


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 256, n_heads: int = 4, d_ff: int = 2048,
                 n_blocks: int = 12, normalize_before: bool = False, activation: str = "relu",
                 pos_dropout: float = 0.0, slf_attn_dropout: float = 0.0,
                 ffn_dropout: float = 0.0, residual_dropout: float = 0.1,
                 relative_positional: bool = False, chunk_size: int = 0,
                 left_chunks: int = -1, concat_after: bool = False, scan_layers: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 moe_router_jitter: float = 0.0, moe_every: int = 1, pos_style: str = "scaled",
                 ln_eps: float = LN_EPS, pre_norm_residual: str = "normalized"):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.scan_layers = scan_layers  # the checkpoint layout only (compat)
        residual = input_residual(pre_norm_residual, normalize_before, concat_after)
        self.moe_experts, self.moe_top_k = moe_experts, moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.relative_positional = relative_positional
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.pos_enc = None if relative_positional else PositionalEncoding(
            d_model, pos_dropout, pos_style)
        self.layers = []
        moe = _moe_blocks(n_blocks, moe_experts, moe_top_k, moe_capacity_factor,
                          moe_router_jitter, moe_every, scan_layers)
        for i in range(n_blocks):
            layer = TransformerEncoderLayer(d_model, n_heads, d_ff, normalize_before, activation,
                                            slf_attn_dropout, ffn_dropout, residual_dropout,
                                            relative_positional, concat_after, moe[i], ln_eps,
                                            residual)
            self.add_module(f"block_{i}", layer)
            self.layers.append(layer)
        self.after_norm = layer_norm(d_model, ln_eps) if normalize_before else None

    def forward(self, x, pad_mask):
        """x: [B, T, D]; pad_mask: bool[B, T] → (y [B, T, D], pad_mask), and
        with MoE the blocks' summed load-balance loss (f32) third."""
        attn_mask = encoder_attn_mask(pad_mask, self.chunk_size, self.left_chunks)
        pos_emb = None
        if self.relative_positional:
            pos_emb = rel_pos_embedding(x.shape[1], self.d_model, x.dtype, x.device)
        else:
            x = self.pos_enc(x)
        x, aux = _run_blocks(self.layers, x, self.moe_experts > 0, attn_mask, pos_emb, pad_mask)
        if self.after_norm is not None:
            x = self.after_norm(x)
        return (x, pad_mask) if aux is None else (x, pad_mask, aux)

    # ---- frame-synchronous streaming (chunked-attention configs) ----------

    def init_stream_cache(self, batch: int) -> list[dict]:
        """Per-block zero KV caches [B, H, left_chunks·chunk_size, Dh] for
        ``encode_step``."""
        _check_streamable(self.chunk_size, self.left_chunks)
        if self.moe_experts > 0:
            _warn_moe_stream_capacity(self.moe_experts, self.moe_top_k, self.moe_capacity_factor)
        dev, dtype = _like(self)
        shape = (batch, self.n_heads, self.left_chunks * self.chunk_size,
                 self.d_model // self.n_heads)
        return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)} for _ in self.layers]

    def encode_step(self, x_chunk, cache, start, cache_len, chunk_mask=None):
        """One chunk [B, C, D] of frontend frames → (y [B, C, D], new cache),
        equal to the offline encode under the chunk mask. ``start`` (int or
        int[B]) is the global index of the chunk's first frame, for the
        absolute positions (rel-pos attention ignores it); ``cache_len``
        (int or int[B]) the valid frames in the cache; ``chunk_mask``
        bool[B, C] the chunk's valid frames (a final partial chunk)."""
        b, c, _ = x_chunk.shape
        x = x_chunk if self.relative_positional else self.pos_enc(x_chunk, start=start)
        kv_mask = stream_kv_mask(b, self.left_chunks * self.chunk_size, c, cache_len,
                                 chunk_mask, x.device)
        new_cache = []
        for layer, lc in zip(self.layers, cache):
            x, nk, nv = layer.encode_step(x, lc["k"], lc["v"], kv_mask, chunk_mask)
            new_cache.append({"k": nk, "v": nv})
        if self.after_norm is not None:
            x = self.after_norm(x)
        return x, new_cache


class ConformerEncoderBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, cov_kernel_size: int = 15,
                 slf_attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 residual_dropout: float = 0.1, conv_dropout: float = 0.0,
                 macaron_style: bool = True, ffn_scale: float = 0.5, conv_first: bool = False,
                 conv_norm_type: str = "layer", conv_causal: bool = False,
                 relative_positional: bool = True, activation: str = "glu",
                 ref_compat: bool = False, moe: dict | None = None):
        super().__init__()
        if moe is not None and ref_compat:
            raise ValueError("ref_compat drops the post-FFN; it cannot host the MoE "
                             "(unset one of them)")
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
        if not ref_compat and moe is None:
            self.post_ffn = PositionwiseFeedForward(d_model, d_ff, activation, ffn_dropout)
        self.moe = None if moe is None else MoEFeedForward(
            d_model, d_ff, activation=activation, dropout_rate=ffn_dropout, **moe)
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
        aux = None
        if self.ref_compat:
            # the reference's trained forward: no second FFN, its norm bare
            x = h
        else:
            if self.moe is not None:
                h, aux = self.moe(h, pad_mask)
            else:
                h = self.post_ffn(h)
            x = x + self.ffn_scale * self.res_dropout(h)
        x = self.final_norm(x)
        return x if aux is None else (x, aux)

    def encode_step(self, x, cache: dict, kv_mask, chunk_mask=None):
        """One streamed chunk (inference): attention over the shifting KV
        cache and the causal conv over its carried state → (y, new cache
        {"k", "v", "conv"}); ``chunk_mask`` gates an MoE's dispatch. The
        conv step takes no pad mask, as in the JAX package: a final partial
        chunk's pad frames enter the conv state, which only the flush
        reaches."""
        if self.macaron_style:
            x = x + self.ffn_scale * self.pre_ffn(self.pre_ffn_norm(x))
        new_cache = dict(cache)

        def attn(x):
            out, new_cache["k"], new_cache["v"] = self.slf_attn.chunk_step(
                self.attn_norm(x), cache["k"], cache["v"], kv_mask)
            return x + out

        def conv(x):
            out, new_cache["conv"] = self.conv_module.conv_step(self.conv_norm(x), cache["conv"])
            return x + out

        x = attn(conv(x)) if self.conv_first else conv(attn(x))
        h = self.post_ffn_norm(x)
        if self.ref_compat:
            x = h
        else:
            h = self.moe(h, chunk_mask)[0] if self.moe is not None else self.post_ffn(h)
            x = x + self.ffn_scale * h
        return self.final_norm(x), new_cache


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
                 ref_compat: bool = False, moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25, moe_router_jitter: float = 0.0,
                 moe_every: int = 1):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.moe_experts, self.moe_top_k = moe_experts, moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.cov_kernel_size, self.conv_causal = cov_kernel_size, conv_causal
        self.relative_positional = relative_positional
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.pos_enc = (PositionalEncoding(d_model, pos_dropout)
                        if positional_encoding and not relative_positional else None)
        self.layers = []
        moe = _moe_blocks(nblocks, moe_experts, moe_top_k, moe_capacity_factor,
                          moe_router_jitter, moe_every)
        for i in range(nblocks):
            block = ConformerEncoderBlock(
                d_model, n_heads, d_ff, cov_kernel_size, slf_attn_dropout, ffn_dropout,
                residual_dropout, conv_dropout, macaron_style, ffn_scale, conv_first,
                conv_norm_type, conv_causal, relative_positional, activation, ref_compat, moe[i])
            self.add_module(f"block_{i}", block)
            self.layers.append(block)

    def forward(self, x, pad_mask):
        """x: [B, T, D]; pad_mask: bool[B, T] → (y [B, T, D], pad_mask), and
        with MoE the blocks' summed load-balance loss (f32) third."""
        attn_mask = encoder_attn_mask(pad_mask, self.chunk_size, self.left_chunks)
        pos_emb = None
        if self.relative_positional:
            pos_emb = rel_pos_embedding(x.shape[1], self.d_model, x.dtype, x.device)
        elif self.pos_enc is not None:
            x = self.pos_enc(x)
        x, aux = _run_blocks(self.layers, x, self.moe_experts > 0, pad_mask, attn_mask, pos_emb)
        return (x, pad_mask) if aux is None else (x, pad_mask, aux)

    # ---- frame-synchronous streaming (chunked attention + causal conv) ----

    def init_stream_cache(self, batch: int) -> list[dict]:
        """Per-block zero KV caches and causal-conv state f[B, k − 1, D] for
        ``encode_step``; needs ``conv_causal`` (a SAME conv reaches into
        future chunks)."""
        _check_streamable(self.chunk_size, self.left_chunks)
        if not self.conv_causal:
            raise ValueError(
                "streaming a conformer requires conv_causal: true (the SAME-"
                "padded conv window reaches into future chunks)")
        if self.moe_experts > 0:
            _warn_moe_stream_capacity(self.moe_experts, self.moe_top_k, self.moe_capacity_factor)
        dev, dtype = _like(self)
        kv = (batch, self.n_heads, self.left_chunks * self.chunk_size,
              self.d_model // self.n_heads)
        conv = (batch, self.cov_kernel_size - 1, self.d_model)
        return [{"k": torch.zeros(kv, dtype=dtype, device=dev),
                 "v": torch.zeros(kv, dtype=dtype, device=dev),
                 "conv": torch.zeros(conv, dtype=dtype, device=dev)} for _ in self.layers]

    def encode_step(self, x_chunk, cache, start, cache_len, chunk_mask=None):
        """One chunk; the contract of ``TransformerEncoder.encode_step``
        (rel-pos attention computes its offsets within the chunk step, so
        ``start`` serves the absolute-position variant only)."""
        b, c, _ = x_chunk.shape
        x = x_chunk
        if self.pos_enc is not None:
            x = self.pos_enc(x, start=start)
        kv_mask = stream_kv_mask(b, self.left_chunks * self.chunk_size, c, cache_len,
                                 chunk_mask, x.device)
        new_cache = []
        for block, lc in zip(self.layers, cache):
            x, nc = block.encode_step(x, lc, kv_mask, chunk_mask)
            new_cache.append(nc)
        return x, new_cache
