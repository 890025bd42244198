"""Self-attention at inference over whole sequences: kernel 5.

``models.modules.attention_context`` hands a call here when the kernel
takes it (``takes``): a bf16 q on a CUDA device, no gradient to be taken
through q, k or v, a mask that is None or masks keys only, and a head
width the kernel is built for. That covers the encoders' inference encode
(Whisper's, the transformer encoders' in the eval CLI and the server's
offline batches), a streamed chunk step over its key-only mask and the
cached step without a beam; training, causal and chunk masks, float32
models and the relative-position attention keep the plain composition.

``encoder_self_attention`` computes it. On a CUDA tensor it launches the
hand-written kernel of ``csrc/encoder_attention.cu``, which reads q, k and v
where they lie (the head splits of one fused projection) and keeps the
scores on the chip; on a CPU tensor it runs ``attention_plain``, the same
function in plain PyTorch (``attention_context``'s composition, unchanged).
There is no other switch and no fallback: a CUDA tensor the kernel does
not take raises.

Arithmetic (every path): the scores q·k summed in float32 over √Dh,
``NEG_INF`` where the mask is False, the softmax in float32, its weights
rounded to bf16, the context summed in float32 and stored in bf16. The
kernel takes the softmax online over tiles of keys and rounds the
unnormalised weights, dividing the context by the float32 sum at the end;
``launches`` counts its launches.
"""

from __future__ import annotations

import math

import torch

from . import cuda_build
from .masks import apply_attn_mask

# the head widths the kernel is built for (compile-time instances)
HEAD_DIMS = (32, 64, 128)


def attention_plain(q, k, v, mask):
    """Scaled dot-product attention over [B, H, T, Dh] in plain PyTorch:
    ``mask`` bool, broadcastable to [B, H, T_q, T_k], True = may attend."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    weights = torch.softmax(apply_attn_mask(scores, mask), dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _key_only(mask, batch: int, t_k: int) -> bool:
    """A bool mask broadcastable from [B or 1, 1, 1, T_k]: keys only."""
    if mask.dtype != torch.bool or not 1 <= mask.dim() <= 4:
        return False
    shape = (1,) * (4 - mask.dim()) + tuple(mask.shape)
    return shape[0] in (1, batch) and shape[1] == shape[2] == 1 and shape[3] == t_k


def takes(q, k, v, mask) -> bool:
    """The routing rule of ``attention_context``: whether the kernel takes
    the call. q a bf16 [B, H, T_q, Dh] on a CUDA device with k and v in its
    type; no gradient to be taken (grad mode off, or none of q, k, v
    requires one); ``mask`` None or key-only; Dh in ``HEAD_DIMS``."""
    if not (_on_card(q) and q.dtype is torch.bfloat16 and q.dim() == 4
            and q.shape[-1] in HEAD_DIMS and k.dtype is q.dtype and v.dtype is q.dtype):
        return False
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return False
    return mask is None or _key_only(mask, q.shape[0], k.shape[-2])


_LAUNCH = cuda_build.Entry("encoder_attention", "encoder_attention_launch",
                          "plllplllplllpllp" + "i" * 5)


def _error(q, k, v, mask, why: str) -> ValueError:
    return ValueError(
        f"encoder attention: {why}; the kernel takes bf16 q, k, v [B, H, T, Dh] with Dh in "
        f"{HEAD_DIMS}, unit stride along Dh and rows on 16 bytes, on one device, and a "
        f"key-only bool mask; got q {q.dtype} {tuple(q.shape)} strides {q.stride()}, k "
        f"{k.dtype} {tuple(k.shape)} strides {k.stride()}, v {v.dtype} {tuple(v.shape)} strides "
        f"{v.stride()} on {q.device}, mask "
        f"{None if mask is None else (mask.dtype, tuple(mask.shape))}")


def _cuda(q, k, v, mask):
    if q.dtype is not torch.bfloat16 or k.dtype is not q.dtype or v.dtype is not q.dtype:
        raise TypeError(f"encoder attention: the kernel takes bf16 q, k and v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise _error(q, k, v, mask, "q, k and v must be [B, H, T, Dh], k and v alike")
    b, h, t_q, dh = q.shape
    t_k = k.shape[2]
    if (k.shape[0] != b or k.shape[1] != h or k.shape[3] != dh or dh not in HEAD_DIMS
            or t_q == 0 or t_k == 0):
        raise _error(q, k, v, mask, "the shapes do not fit")
    index = q.get_device()
    if k.get_device() != index or v.get_device() != index:
        raise _error(q, k, v, mask, "q, k and v on different devices")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise _error(q, k, v, mask, "Dh must be innermost")
    if not cuda_build.rows_aligned(q, k, v):
        raise _error(q, k, v, mask, "rows must start on 16 bytes")
    mask_ptr, mask_b, mask_t = None, 0, 0
    if mask is not None:
        if not _key_only(mask, b, t_k) or mask.get_device() != index:
            raise _error(q, k, v, mask, "the mask must be a bool [B or 1, 1, 1, T_k] on q's device")
        m = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))[:, 0, 0, :]
        mask_ptr, mask_t = m.data_ptr(), m.stride(1)
        mask_b = m.stride(0) if m.shape[0] > 1 else 0
    out = torch.empty((b, t_q, h, dh), dtype=q.dtype, device=q.device)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    _LAUNCH(index, q.data_ptr(), qs[0], qs[1], qs[2], k.data_ptr(), ks[0], ks[1], ks[2],
            v.data_ptr(), vs[0], vs[1], vs[2], mask_ptr, mask_b, mask_t, out.data_ptr(),
            b, h, t_q, t_k, dh)
    encoder_self_attention.launches += 1
    # [B, H, T_q, Dh] as a view of [B, T_q, H, Dh]: merge_heads reshapes it without a copy
    return out.transpose(1, 2)


def encoder_self_attention(q, k, v, mask=None):
    """The context [B, H, T_q, Dh] of q [B, H, T_q, Dh] over k and v [B, H,
    T_k, Dh] (any strides with Dh innermost) under a key-only bool ``mask``
    (None, or broadcastable from [B or 1, 1, 1, T_k]; True = may attend).

    CPU tensor → ``attention_plain``; CUDA tensor → the kernel, or an error.
    On the card the result is a view of [B, T_q, H, Dh] storage."""
    if _on_card(q):
        return _cuda(q, k, v, mask)
    if q.device.type != "cpu":
        raise ValueError(f"encoder_self_attention: unsupported device {q.device}")
    return attention_plain(q, k, v, mask)


encoder_self_attention.launches = 0
