"""Plain PyTorch reference of the Speech-Transformer: conv subsampling,
post-norm transformer encoder with GLU feed-forwards and absolute
positions, and the decoder run teacher-forced.

It follows the published description (Dong et al., 2018; the reference
OpenTransformer's ``transformer_baseline``) in float32 with TF32 off, reads
the benchmark's weights by the port's parameter names and imports nothing
of the port. No cache and no kernel: a decode is checked by running the
decoder over each served hypothesis at once, and by a beam search that runs
the decoder over each whole hypothesis at every step. ``prec`` (see
``reference/precision.py``) makes every product of a linear layer or a
convolution run in a lower precision, for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import FP32

NEG_INF = -1.0e9
LN_EPS = 1e-6
BOS = 1  # the start token (<S/E>, which also ends a sentence)


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """sin on even channels, cos on odd, frequency exp(-ln(1e4)·i/(dim/2))."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, device=positions.device,
                                                      dtype=torch.float32) / half)
    ang = positions[..., None].float() * freq
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(*positions.shape, dim)


def linear(w: dict, name: str, x: torch.Tensor, prec=FP32) -> torch.Tensor:
    y = prec.mm(x, w[name + ".weight"].float())
    b = w.get(name + ".bias")
    return y if b is None else y + b.float()


def norm(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"].float(),
                        w[name + ".bias"].float(), LN_EPS)


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def attend(q, k, v, mask) -> torch.Tensor:
    """[B, H, Tq, Dh] queries over keys and values; ``mask`` True = may
    attend; the heads merged again."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask, NEG_INF)
    ctx = torch.softmax(s, dim=-1) @ v
    b, h, t, dh = ctx.shape
    return ctx.transpose(1, 2).reshape(b, t, h * dh)


def ffn(w: dict, name: str, x: torch.Tensor, prec=FP32) -> torch.Tensor:
    a, g = linear(w, name + ".w1", x, prec).chunk(2, dim=-1)
    return linear(w, name + ".w2", a * torch.sigmoid(g), prec)


def conv_frontend(w: dict, feats: torch.Tensor, mask: torch.Tensor, prec=FP32):
    """feats [B, T, F], mask bool[B, T] → ([B, T', D], bool[B, T'])."""
    h = feats.float()[:, None]
    for name in ("frontend.conv1.conv", "frontend.conv2.conv"):
        h = torch.relu(prec.conv2d(h, w[name + ".weight"].float(), w[name + ".bias"].float(),
                                   stride=2, padding=(0, 1)))
        mask = mask[:, 1::2][:, : h.shape[2]]
    b, c, t, f = h.shape
    return linear(w, "frontend.output_layer", h.permute(0, 2, 1, 3).reshape(b, t, c * f),
                  prec), mask


def keep(x):
    return x


def encode(w: dict, cfg: dict, feats, mask, prec=FP32, drop=keep):
    """The encoder memory [B, T', D] float32 and its mask; ``drop`` is the
    residual dropout of training (identity in inference)."""
    enc = cfg["encoder"]
    d, n = enc["d_model"], enc["n_heads"]
    x, mask = conv_frontend(w, feats, mask, prec)
    x = x * math.sqrt(d) + sinusoid(torch.arange(x.shape[1], device=x.device), d)
    key_mask = mask[:, None, None, :]
    for i in range(enc["n_blocks"]):
        p = f"encoder.block_{i}"
        q, k, v = linear(w, p + ".slf_attn.qkv_proj", x, prec).chunk(3, dim=-1)
        a = linear(w, p + ".slf_attn.out_proj",
                   attend(heads(q, n), heads(k, n), heads(v, n), key_mask), prec)
        x = norm(w, p + ".norm1", x + drop(a))
        x = norm(w, p + ".norm2", x + drop(ffn(w, p + ".ffn", x, prec)))
    return x, mask


def decode_logp(w: dict, cfg: dict, tokens, memory, mem_mask, prec=FP32,
                drop=keep) -> torch.Tensor:
    """Teacher-forced log-probs f32[N, U, V] of the next token at each of
    the ``tokens`` [N, U] (a causal mask only), over memory [N, T, D]."""
    dec = cfg["decoder"]
    d, n = dec["d_model"], dec["n_heads"]
    u = tokens.shape[1]
    emb = w["decoder.embedding.weight"].float()
    x = emb[tokens] * math.sqrt(d) + sinusoid(torch.arange(u, device=tokens.device), d)
    causal = torch.ones(u, u, dtype=torch.bool, device=tokens.device).tril()[None, None]
    mem_keys = mem_mask[:, None, None, :]
    for i in range(dec["n_blocks"]):
        p = f"decoder.block_{i}"
        q, k, v = linear(w, p + ".slf_attn.qkv_proj", x, prec).chunk(3, dim=-1)
        a = linear(w, p + ".slf_attn.out_proj",
                   attend(heads(q, n), heads(k, n), heads(v, n), causal), prec)
        x = norm(w, p + ".norm1", x + drop(a))
        q = heads(linear(w, p + ".src_attn.q_proj", x, prec), n)
        k, v = linear(w, p + ".src_attn.kv_proj", memory, prec).chunk(2, dim=-1)
        a = linear(w, p + ".src_attn.out_proj", attend(q, heads(k, n), heads(v, n), mem_keys),
                   prec)
        x = norm(w, p + ".norm2", x + drop(a))
        x = norm(w, p + ".norm3", x + drop(ffn(w, p + ".ffn", x, prec)))
    logits = prec.mm(x, emb) + w["decoder.output_bias"].float()
    return torch.log_softmax(logits, dim=-1)


@torch.no_grad()
def beam_search(w: dict, cfg: dict, memory, mem_mask, k: int, steps: int, prec=FP32,
                own_best: bool = False):
    """A beam of ``k`` over one utterance's memory [1, T, D] for ``steps``
    steps with no end of sentence: each step keeps the ``k`` best of the
    k × V extensions by summed log-prob (the first step extends the start
    token alone). ``own_best`` extends each hypothesis by its own best token
    after the first step instead (a fault: k greedy searches). Returns the
    tokens long[k, steps + 1] (the start token first) and the summed
    log-probs f32[k], best first."""
    dev = memory.device
    vocab = cfg["decoder"]["vocab_size"]
    tokens = torch.full((k, 1), BOS, dtype=torch.long, device=dev)
    scores = torch.full((k,), float("-inf"), device=dev)
    scores[0] = 0.0
    mem, mask = memory.expand(k, -1, -1), mem_mask.expand(k, -1)
    for step in range(steps):
        logp = decode_logp(w, cfg, tokens, mem, mask, prec)[:, -1]
        if own_best and step > 0:
            best, tok = logp.max(-1)
            scores, parent = scores + best, torch.arange(k, device=dev)
        else:
            scores, flat = (scores[:, None] + logp).reshape(-1).topk(k)
            parent, tok = flat // vocab, flat % vocab
        tokens = torch.cat([tokens[parent], tok[:, None]], dim=1)
    order = scores.argsort(descending=True)
    return tokens[order], scores[order]
