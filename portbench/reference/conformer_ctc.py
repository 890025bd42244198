"""Plain PyTorch reference of the streaming Conformer CTC model, encoded
offline under the chunk mask that streaming implies.

Conv subsampling ×4; blocks of ½·FFN → relative-position self-attention
(Transformer-XL: per-head biases u and v, the sinusoid table of offsets
−(T−1) … T−1 through a bias-free projection) → convolution module
(pointwise to 2D, GLU, a causal depthwise convolution, LayerNorm, swish,
pointwise) → ½·FFN → LayerNorm (Gulati et al., 2020); attention sees the
keys of its own chunk and of ``left_chunks`` chunks before it (a chunk
streamed with ``left_chunks`` chunks of cache sees the same); then the CTC
head's projection. Float32 with TF32 off unless ``prec`` says otherwise;
the weights are the benchmark's, by the port's parameter names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import FP32
from .speech2text import NEG_INF, conv_frontend, ffn, heads, linear, norm, sinusoid


def chunk_mask(t: int, chunk: int, left: int, device) -> torch.Tensor:
    c = torch.arange(t, device=device) // chunk
    return (c[None] <= c[:, None]) & (c[None] >= c[:, None] - left)


def rel_attention(w: dict, p: str, x, mask, n: int, prec=FP32):
    """((q + u)·k + shift((q + v)·r)) / √Dh, r the projected offsets."""
    b, t, d = x.shape
    q, k, v = (heads(a, n) for a in linear(w, p + ".qkv_proj", x, prec).chunk(3, dim=-1))
    pos = sinusoid(torch.arange(-(t - 1), t, device=x.device), d)[None]
    r = heads(prec.mm(pos, w[p + ".pos_proj.weight"].float()), n)      # [1, H, 2T-1, Dh]
    ac = (q + w[p + ".posu"].float()) @ k.transpose(-1, -2)
    bd = (q + w[p + ".posv"].float()) @ r.transpose(-1, -2)              # [B, H, T, 2T-1]
    offs = torch.arange(t, device=x.device)[None] - torch.arange(t, device=x.device)[:, None]
    bd = bd.gather(-1, (offs + t - 1).expand(b, n, t, t))               # offset k − q
    s = ((ac + bd) / math.sqrt(d // n)).masked_fill(~mask, NEG_INF)
    ctx = torch.softmax(s, dim=-1) @ v
    return linear(w, p + ".out_proj", ctx.transpose(1, 2).reshape(b, t, d), prec)


def conv_module(w: dict, p: str, x, keep, kernel: int, prec=FP32):
    a, g = linear(w, p + ".pw1", x, prec).chunk(2, dim=-1)
    h = (a * torch.sigmoid(g)) * keep
    h = F.pad(h.transpose(1, 2), (kernel - 1, 0))
    h = prec.conv1d(h, w[p + ".dw_conv.weight"].float(), w[p + ".dw_conv.bias"].float(),
                    groups=h.shape[1]).transpose(1, 2)
    h = norm(w, p + ".ln", h)
    return linear(w, p + ".pw2", h * torch.sigmoid(h), prec) * keep


def encode(w: dict, cfg: dict, feats, mask, prec=FP32):
    """Memory f32[B, T', D] and its mask."""
    enc = cfg["encoder"]
    n, scale = enc["n_heads"], float(enc["ffn_scale"])
    x, mask = conv_frontend(w, feats, mask, prec)
    t = x.shape[1]
    att = mask[:, None, None, :] & chunk_mask(t, enc["chunk_size"], enc["left_chunks"],
                                              x.device)[None, None]
    keep = mask[..., None].float()
    for i in range(enc["nblocks"]):
        p = f"encoder.block_{i}"
        x = x + scale * ffn(w, p + ".pre_ffn", norm(w, p + ".pre_ffn_norm", x), prec)
        x = x + rel_attention(w, p + ".slf_attn", norm(w, p + ".attn_norm", x), att, n, prec)
        x = x + conv_module(w, p + ".conv_module", norm(w, p + ".conv_norm", x), keep,
                            enc["cov_kernel_size"], prec)
        x = x + scale * ffn(w, p + ".post_ffn", norm(w, p + ".post_ffn_norm", x), prec)
        x = norm(w, p + ".final_norm", x)
    return x, mask


def ctc_logp(w: dict, cfg: dict, feats, mask, prec=FP32):
    """Per-frame CTC log-probs f32[B, T', V] and the frame mask."""
    memory, mask = encode(w, cfg, feats, mask, prec)
    return torch.log_softmax(linear(w, "ctc.output_layer", memory, prec), dim=-1), mask
