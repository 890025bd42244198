"""Plain PyTorch reference of Whisper's forward pass (Radford et al., "Robust
Speech Recognition via Large-Scale Weak Supervision", arXiv:2212.04356; the
``openai/whisper-large-v3`` configuration): the two-convolution front end,
the pre-LN encoder with its sinusoid table, and the pre-LN decoder with
learned positions and a tied, bias-free head.

The benchmark's copy of the port's ``reference/whisper.py``, with
``prec`` (``reference/precision.py``) on every product of a linear layer or
a convolution, for the control. Written from the published description, in
float32 with TF32 off, with no cache and no kernel. It reads the
benchmark's weights by the port's parameter names (``frontend.conv1.weight``,
``encoder.block_0.slf_attn.qkv_proj.weight``, …) and imports nothing of the
port.

Departures from Whisper, all in what runs around the network:

* a search starts from the port's start token (id 1), not from Whisper's
  4-token task prefix (start of transcript, language, task, no timestamps);
* the search is the port's beam (``beam_search`` below: the k best of the
  k × V extensions by summed log-prob, the n-best divided by the length
  penalty ((5 + len) / 6) ** 0.6), not Whisper's decoding with temperature
  fallback;
* Whisper's key projections have no bias. The port's fused projections
  carry one; this reference ignores it: a key bias adds q·b_k to all of a
  query's scores, which the softmax removes;
* the frame mask is applied to the keys as the port applies it (Whisper
  has none: its windows are always full 30-s windows).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import FP32

NEG_INF = -1.0e9
BOS = 1  # the port's start token


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's encoder table f32[length, channels]: sin of the first half
    of the channels, cos of the second, timescales 1 … 10,000 spaced
    geometrically over half − 1 steps."""
    half = channels // 2
    inv = torch.exp(-math.log(10000.0) / (half - 1)
                    * torch.arange(half, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def f32(w: dict, name: str) -> torch.Tensor:
    return w[name].float()


def linear(x, weight, bias=None, prec=FP32):
    y = prec.mm(x, weight)
    return y if bias is None else y + bias


def norm(w: dict, name: str, x, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], f32(w, name + ".weight"), f32(w, name + ".bias"), eps)


def attention(q, k, v, n_heads: int, mask) -> torch.Tensor:
    """q [N, Tq, D] over k, v [N, Tk, D] in ``n_heads`` heads; ``mask``
    bool broadcastable to [N, H, Tq, Tk], True = may attend."""
    n, tq, d = q.shape
    dh = d // n_heads

    def split(x):
        return x.reshape(x.shape[0], x.shape[1], n_heads, dh).transpose(1, 2)

    s = split(q) @ split(k).transpose(-1, -2) / math.sqrt(dh)
    s = s.masked_fill(~mask, NEG_INF)
    ctx = torch.softmax(s, dim=-1) @ split(v)
    return ctx.transpose(1, 2).reshape(n, tq, d)


def self_attention(w: dict, p: str, x, n_heads: int, mask, prec=FP32) -> torch.Tensor:
    """q, k, v from the fused projection's thirds; the key bias left out."""
    wt, b = f32(w, p + ".qkv_proj.weight"), f32(w, p + ".qkv_proj.bias")
    d = x.shape[-1]
    q = linear(x, wt[:d], b[:d], prec)
    k = linear(x, wt[d:2 * d], None, prec)
    v = linear(x, wt[2 * d:], b[2 * d:], prec)
    ctx = attention(q, k, v, n_heads, mask)
    return linear(ctx, f32(w, p + ".out_proj.weight"), f32(w, p + ".out_proj.bias"), prec)


def cross_attention(w: dict, p: str, x, memory, n_heads: int, mask, prec=FP32) -> torch.Tensor:
    """x [N, U, D] over memory [1 or N, T, D] (one utterance's memory is
    projected once and shared by every row)."""
    wt, b = f32(w, p + ".kv_proj.weight"), f32(w, p + ".kv_proj.bias")
    d = x.shape[-1]
    q = linear(x, f32(w, p + ".q_proj.weight"), f32(w, p + ".q_proj.bias"), prec)
    k = linear(memory, wt[:d], None, prec).expand(x.shape[0], -1, -1)
    v = linear(memory, wt[d:], b[d:], prec).expand(x.shape[0], -1, -1)
    ctx = attention(q, k, v, n_heads, mask)
    return linear(ctx, f32(w, p + ".out_proj.weight"), f32(w, p + ".out_proj.bias"), prec)


def mlp(w: dict, p: str, x, prec=FP32) -> torch.Tensor:
    h = F.gelu(linear(x, f32(w, p + ".w1.weight"), f32(w, p + ".w1.bias"), prec))
    return linear(h, f32(w, p + ".w2.weight"), f32(w, p + ".w2.bias"), prec)


def encode(w: dict, cfg: dict, feats, mask, prec=FP32):
    """log-mel feats [B, T, n_mels] and bool[B, T] → the encoder output
    f32[B, ceil(T/2), D] and its mask: conv1 → GELU → conv2 (stride 2) →
    GELU, + the sinusoid table, the blocks (x + attn(ln(x)), x + mlp(ln(x))),
    the final LayerNorm."""
    enc = cfg["encoder"]
    eps = enc["ln_eps"]
    x = feats.float().transpose(1, 2)
    x = F.gelu(prec.conv1d(x, f32(w, "frontend.conv1.weight"), f32(w, "frontend.conv1.bias"),
                           padding=1))
    x = F.gelu(prec.conv1d(x, f32(w, "frontend.conv2.weight"), f32(w, "frontend.conv2.bias"),
                           stride=2, padding=1))
    x = x.transpose(1, 2)
    mask = mask[:, ::2]
    x = x + sinusoids(x.shape[1], x.shape[2], x.device)
    keys = mask[:, None, None, :]
    for i in range(enc["n_blocks"]):
        p = f"encoder.block_{i}"
        x = x + self_attention(w, p + ".slf_attn", norm(w, p + ".norm1", x, eps),
                               enc["n_heads"], keys, prec)
        x = x + mlp(w, p + ".ffn", norm(w, p + ".norm2", x, eps), prec)
    return norm(w, "encoder.after_norm", x, eps), mask


def decode_logits(w: dict, cfg: dict, tokens, memory, mem_mask, prec=FP32) -> torch.Tensor:
    """Teacher-forced logits f32[N, U, V] of the next token after each of
    ``tokens`` [N, U], over memory [1 or N, T, D] and its mask [1 or N, T]:
    token embedding + learned positions 0 … U − 1, the blocks (causal
    self-attention, cross-attention, MLP; each x + f(ln(x))), the final
    LayerNorm, the tied head."""
    dec = cfg["decoder"]
    eps, heads = dec["ln_eps"], dec["n_heads"]
    u = tokens.shape[1]
    emb = f32(w, "decoder.embedding.weight")
    x = emb[tokens] + f32(w, "decoder.pos_embedding.weight")[:u][None]
    causal = torch.ones(u, u, dtype=torch.bool, device=tokens.device).tril()[None, None]
    mem_keys = mem_mask[:, None, None, :]
    memory = memory.float()
    for i in range(dec["n_blocks"]):
        p = f"decoder.block_{i}"
        x = x + self_attention(w, p + ".slf_attn", norm(w, p + ".norm1", x, eps), heads, causal,
                               prec)
        x = x + cross_attention(w, p + ".src_attn", norm(w, p + ".norm2", x, eps), memory,
                                heads, mem_keys, prec)
        x = x + mlp(w, p + ".ffn", norm(w, p + ".norm3", x, eps), prec)
    return prec.mm(norm(w, "decoder.after_norm", x, eps), emb)


def decode_logp(w: dict, cfg: dict, tokens, memory, mem_mask, prec=FP32) -> torch.Tensor:
    return torch.log_softmax(decode_logits(w, cfg, tokens, memory, mem_mask, prec), dim=-1)


def penalty(length: int, p: float, lamda: float = 5.0) -> float:
    """The port's length penalty ((lamda + len) / (lamda + 1)) ** p."""
    return ((lamda + length) / (lamda + 1.0)) ** p


@torch.no_grad()
def beam_search(w: dict, cfg: dict, memory, mem_mask, k: int, steps: int, prec=FP32,
                own_best: bool = False):
    """The port's beam of ``k`` over one utterance's memory [1, T, D] for
    ``steps`` steps with no end of sentence: each step keeps the ``k`` best
    of the k × V extensions by summed log-prob (the first step extends the
    start token alone), running the decoder over each whole hypothesis.
    ``own_best`` extends each hypothesis by its own best token after the
    first step instead (k greedy searches). Returns the tokens long[k,
    steps + 1] (the start token first) and the summed log-probs f32[k],
    best first."""
    dev = memory.device
    vocab = cfg["decoder"]["vocab_size"]
    tokens = torch.full((k, 1), BOS, dtype=torch.long, device=dev)
    scores = torch.full((k,), float("-inf"), device=dev)
    scores[0] = 0.0
    for step in range(steps):
        logp = decode_logp(w, cfg, tokens, memory, mem_mask, prec)[:, -1]
        if own_best and step > 0:
            best, tok = logp.max(-1)
            scores, parent = scores + best, torch.arange(k, device=dev)
        else:
            scores, flat = (scores[:, None] + logp).reshape(-1).topk(k)
            parent, tok = flat // vocab, flat % vocab
        tokens = torch.cat([tokens[parent], tok[:, None]], dim=1)
    order = scores.argsort(descending=True)
    return tokens[order], scores[order]
