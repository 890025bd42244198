"""Attention of the beam step over its caches.

A decoder's cached beam step attends twice in every block: the K beams of
an utterance over that utterance's cross keys and values (stored once per
utterance, [B, H, T, Dh]), and each beam over its own lineage in the
append-only self-attention caches ([B·K, H, U_max, Dh], row ``src[b, k, p]``
of the utterance holding position p of the hypothesis in slot k).

``beam_cross_attention`` and ``beam_self_attention`` compute these. On a
CUDA tensor they launch the hand-written kernels of
``csrc/beam_attention.cu``, which read each cache row in place, once a
step, in the caches' own type; on a CPU tensor they run
``cross_attention_plain`` and ``self_attention_plain``, the same functions
in plain PyTorch (the decoder's code before the kernel, unchanged). There
is no other switch and no fallback: a CUDA tensor the kernel does not take
raises.

Which kernel a cross call takes is decided by what the call shows: bf16 q
and caches with a bf16 output and Dh in ``ONE_PASS_DH`` take the one-pass
entry (an online softmax over tiles of frames on the tensor cores, no score
stored anywhere, at every T); every other cross call (float32 above all,
whose products on the tensor cores would be TF32) and every self call take
the two-pass kernel, which keeps the scores on chip up to
``SCORES_ON_CHIP_BYTES`` and in a scratch buffer beyond.

Arithmetic: scores q·k summed in float32 (the products of bf16 values are
exact in float32) and scaled by 1/√Dh in float32, ``NEG_INF`` where the key
padding mask is False (``masked_fill``), the softmax's max and sum in
float32, the context summed in float32 and stored in the output type. The
two-pass kernel and the plain versions round the normalised weights to the
output type; the one-pass entry rounds the unnormalised weights exp(s − m)
to bf16 for its P·V product and divides the float32 context by the float32
sum: one bf16 rounding of the weights either way, at another point, and no
lower precision than the configuration's. The output type is the model's:
the cross entry takes it from the caller (the decoder's hidden state), the
self entry from q. Each entry's ``launches`` counts kernel launches;
``beam_cross_attention.one_pass_launches`` counts those of the one-pass
entry.
"""

from __future__ import annotations

import math

import torch

from . import cuda_build
from .masks import apply_attn_mask

# beams one block serves (kMaxBeams in csrc/beam_attention.cu): a wider beam
# is split into chunks of at most this many, each reading the caches again
MAX_BEAMS = 8
# a block keeps its scores in shared memory up to this many bytes, and in a
# scratch buffer in device memory beyond (the two-pass kernel)
SCORES_ON_CHIP_BYTES = 32 * 1024
# the head widths the one-pass cross entry is built for, and the beams one
# of its blocks serves (kOnlineMaxBeams: the rows of an m16n8k16 tile)
ONE_PASS_DH = (32, 64, 96, 128)
ONE_PASS_MAX_BEAMS = 16

_CROSS = cuda_build.Entry("beam_attention", "beam_attention_cross_launch",
                          "pllpplllpll" + "i" * 9 + "pp")
_CROSS_ONE_PASS = cuda_build.Entry("beam_attention", "beam_attention_cross_online_launch",
                                   "pllpplllpll" + "i" * 7 + "p")
_SELF = cuda_build.Entry("beam_attention", "beam_attention_self_launch",
                         "pllppllppp" + "i" * 10 + "pp")


def cross_attention_plain(q, k, v, key_pad_mask, out_dtype):
    """Plain PyTorch version of ``beam_cross_attention``."""
    b = k.shape[0]
    bk, h, dk = q.shape
    qb = q.reshape(b, bk // b, h, dk).float()
    scores = torch.einsum("bkhd,bhtd->bkht", qb, k.float()) / math.sqrt(dk)
    if key_pad_mask is not None:
        scores = apply_attn_mask(scores, key_pad_mask[:, None, None, :])
    weights = torch.softmax(scores, dim=-1).to(out_dtype)
    ctx = torch.einsum("bkht,bhtd->bkhd", weights.float(), v.float()).to(out_dtype)
    return ctx.reshape(bk, h, dk)


def self_attention_plain(q, k_t, v_t, cache_k, cache_v, index: int, src):
    """Plain PyTorch version of ``beam_self_attention``: the step's key and
    value written at ``index`` of every row, then the rows of positions
    0..index gathered through ``src`` (the JAX reference selects them with a
    one-hot einsum, which gives the same numbers: positions past ``index``
    are masked out there and absent here)."""
    cache_k[:, :, index] = k_t.to(cache_k.dtype)
    cache_v[:, :, index] = v_t.to(cache_v.dtype)
    b, kk, _ = src.shape
    h, dk = q.shape[1], q.shape[2]
    u = index + 1
    qb = q.reshape(b, kk, h, dk).float()
    ck = cache_k.to(q.dtype).reshape(b, kk, h, -1, dk)
    cv = cache_v.to(q.dtype).reshape(b, kk, h, -1, dk)
    bi = torch.arange(b, device=q.device)[:, None, None]
    ui = torch.arange(u, device=q.device)[None, None, :]
    rows = src[:, :, :u]
    keys = ck[bi, rows, :, ui]  # [B, K, u, H, Dh]
    vals = cv[bi, rows, :, ui]
    scores = torch.einsum("bkhd,bkuhd->bkhu", qb, keys.float()) / math.sqrt(dk)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkhu,bkuhd->bkhd", weights.float(), vals.float()).to(q.dtype)
    return ctx.reshape(b * kk, h, dk)


def beam_plan(beams: int, most: int = MAX_BEAMS) -> tuple[int, int]:
    """(chunks, beams a chunk): the fewest chunks of at most ``most`` beams
    (the two-pass kernel's ``MAX_BEAMS`` or the one-pass entry's
    ``ONE_PASS_MAX_BEAMS``), as even as they come; every chunk's blocks read
    the caches."""
    chunks = -(-beams // most)
    return chunks, -(-beams // chunks)


def _layout_error(**tensors) -> ValueError:
    return ValueError("beam attention: the kernel takes rows of Dh with unit stride starting "
                      "on 16 bytes, in one type on one device; got " + ", ".join(
                          f"{name} {t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}"
                          for name, t in tensors.items()))


def _scratch(blocks: int, kc: int, n_pos: int, device):
    """Device memory for the scores of blocks whose scores do not fit on
    chip, or None (the kernel keeps them in shared memory). A block's scores
    are [n_pos][P], P its beams rounded up to a power of two."""
    slots = 1 << (kc - 1).bit_length()
    if slots * n_pos * 4 <= SCORES_ON_CHIP_BYTES:
        return None
    return torch.empty((blocks * slots * n_pos,), dtype=torch.float32, device=device)


class _Plan:
    """What an entry checked once about the tensors that stay the same over
    a search, and the launch arguments they give. The decoder builds its
    caches once a search and hands the same tensor objects over at every
    step, so a plan is kept on the cross keys (``k``) or the self keys'
    cache (``cache_k``), lives as long as they do, and serves every call
    with a q of the same shape and type and the same companions (``same``,
    compared by identity) while that tensor's storage stays where it was;
    any other call checks afresh.
    What changes from call to call (q, the step's keys and values, ``src``,
    ``index``) is checked at every call."""

    __slots__ = ("same", "ptr", "q_shape", "dtype", "vec", "index", "device", "args", "blocks",
                 "kc", "positions", "one_pass")


def _cross_plan(q, k, v, key_pad_mask, out_dtype) -> _Plan:
    code = cuda_build.DTYPE_CODE.get(q.dtype)
    if code is None or out_dtype not in cuda_build.DTYPE_CODE:
        raise TypeError(f"beam attention: the kernel takes and writes float32 or bfloat16, "
                        f"got {q.dtype} and {out_dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"beam attention: q must be [B·K, H, Dh], k and v [B, H, T, Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bk, h, dh = q.shape
    b, _, t, _ = k.shape
    if k.shape[1] != h or k.shape[3] != dh or b == 0 or t == 0 or bk % b:
        raise ValueError(f"beam attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"beam attention: q, k and v must share a type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    vec = 8 if code else 4
    if (k.device != q.device or v.device != q.device or v.stride() != k.stride()
            or not cuda_build.rows_aligned(k, v)):
        raise _layout_error(q=q, k=k, v=v)
    mask_ptr, mask_b, mask_t = None, 0, 0
    if key_pad_mask is not None:
        if (key_pad_mask.dtype != torch.bool or key_pad_mask.shape != (b, t)
                or key_pad_mask.device != q.device):
            raise ValueError(f"beam attention: key_pad_mask must be bool [{b}, {t}] on "
                             f"{q.device}, got {key_pad_mask.dtype} {tuple(key_pad_mask.shape)}")
        mask_ptr, (mask_b, mask_t) = key_pad_mask.data_ptr(), key_pad_mask.stride()
    beams = bk // b
    ks = k.stride()
    plan = _Plan()
    plan.same, plan.ptr = (v, key_pad_mask, out_dtype), k.data_ptr()
    plan.q_shape, plan.dtype, plan.vec = q.shape, q.dtype, vec
    plan.device = q.device
    plan.index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    plan.one_pass = q.dtype == out_dtype == torch.bfloat16 and dh in ONE_PASS_DH
    caches = (plan.ptr, v.data_ptr(), ks[0], ks[1], ks[2], mask_ptr, mask_b, mask_t, b, beams, h,
              t, dh)
    if plan.one_pass:
        chunks, kc = beam_plan(beams, ONE_PASS_MAX_BEAMS)
        plan.args = (*caches, kc, chunks)
    else:
        chunks, kc = beam_plan(beams)
        plan.args = (*caches, code, cuda_build.DTYPE_CODE[out_dtype], kc, chunks)
    plan.blocks, plan.kc, plan.positions = b * h * chunks, kc, t
    return plan


def _cross_cuda(q, k, v, key_pad_mask, out_dtype):
    plan = getattr(k, "_beam_attention_plan", None)
    if (plan is None or plan.q_shape != q.shape or plan.dtype is not q.dtype
            or plan.same[0] is not v or plan.same[1] is not key_pad_mask
            or plan.same[2] is not out_dtype or plan.ptr != k.data_ptr()):
        plan = _cross_plan(q, k, v, key_pad_mask, out_dtype)
        k._beam_attention_plan = plan
    # q is new at every call: its rows on 16 bytes, on the caches' device
    qs, q_ptr = q.stride(), q.data_ptr()
    if qs[2] != 1 or q_ptr % 16 or (qs[0] | qs[1]) % plan.vec or q.get_device() != plan.index:
        raise _layout_error(q=q, k=k, v=v)
    out = torch.empty(plan.q_shape, dtype=out_dtype, device=plan.device)
    if plan.one_pass:
        _CROSS_ONE_PASS(plan.index, q_ptr, qs[0], qs[1], *plan.args, out.data_ptr())
        beam_cross_attention.one_pass_launches += 1
    else:
        scratch = _scratch(plan.blocks, plan.kc, plan.positions, plan.device)
        _CROSS(plan.index, q_ptr, qs[0], qs[1], *plan.args,
               None if scratch is None else scratch.data_ptr(), out.data_ptr())
    beam_cross_attention.launches += 1
    return out


def _self_plan(q, cache_k, cache_v, beams: int) -> _Plan:
    code = cuda_build.DTYPE_CODE.get(q.dtype)
    if code is None:
        raise TypeError(f"beam attention: the kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or cache_k.dim() != 4:
        raise ValueError(f"beam attention: q must be [B·K, H, Dh], the caches [B·K, H, U_max, "
                         f"Dh]; got {tuple(q.shape)}, {tuple(cache_k.shape)}")
    bk, h, dh = q.shape
    if (cache_k.shape[:2] != (bk, h) or cache_k.shape[3] != dh or cache_v.shape != cache_k.shape
            or beams <= 0 or bk % beams):
        raise ValueError(f"beam attention: caches {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)} or {beams} beams do not fit q {tuple(q.shape)}")
    if cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise TypeError(f"beam attention: q and the caches must share a type, got {q.dtype}, "
                        f"{cache_k.dtype}, {cache_v.dtype}")
    vec = 8 if code else 4
    if (cache_k.device != q.device or cache_v.device != q.device or not cache_k.is_contiguous()
            or not cache_v.is_contiguous() or not cuda_build.rows_aligned(cache_k, cache_v)):
        raise _layout_error(q=q, cache_k=cache_k, cache_v=cache_v)
    chunks, kc = beam_plan(beams)
    plan = _Plan()
    plan.same, plan.ptr = (cache_v, beams), cache_k.data_ptr()
    plan.q_shape, plan.dtype, plan.vec = q.shape, q.dtype, vec
    plan.device = q.device
    plan.index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    plan.args = (plan.ptr, cache_v.data_ptr(), bk // beams, beams, h, dh, code, kc, chunks)
    plan.blocks, plan.kc, plan.positions = bk // beams * h * chunks, kc, cache_k.shape[2]
    return plan


def _self_cuda(q, k_t, v_t, cache_k, cache_v, index: int, src):
    if src.dim() != 3:
        raise ValueError(f"beam attention: src must be [B, K, > {index}], got "
                         f"{tuple(src.shape)}")
    b, beams, src_len = src.shape
    plan = getattr(cache_k, "_beam_attention_plan", None)
    if (plan is None or plan.q_shape != q.shape or plan.dtype is not q.dtype
            or plan.same[0] is not cache_v or plan.same[1] != beams
            or plan.ptr != cache_k.data_ptr()):
        plan = _self_plan(q, cache_k, cache_v, beams)
        cache_k._beam_attention_plan = plan
    # what is new at every call: the step's q, keys and values (one type and
    # shape, rows on 16 bytes, the keys' and values' strides shared), index
    # and the lineage map
    qs, ts = q.stride(), k_t.stride()
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k_t.data_ptr(), v_t.data_ptr()
    if k_t.shape != plan.q_shape or v_t.shape != plan.q_shape:
        raise ValueError(f"beam attention: q, k_t and v_t must be [B·K, H, Dh], got "
                         f"{tuple(q.shape)}, {tuple(k_t.shape)}, {tuple(v_t.shape)}")
    if k_t.dtype is not plan.dtype or v_t.dtype is not plan.dtype:
        raise TypeError(f"beam attention: q, k_t and v_t must share a type, got {q.dtype}, "
                        f"{k_t.dtype}, {v_t.dtype}")
    if (qs[2] != 1 or ts[2] != 1 or v_t.stride() != ts or (q_ptr | k_ptr | v_ptr) % 16
            or (qs[0] | qs[1] | ts[0] | ts[1]) % plan.vec or q.get_device() != plan.index
            or k_t.get_device() != plan.index or v_t.get_device() != plan.index):
        raise _layout_error(q=q, k_t=k_t, v_t=v_t, cache_k=cache_k, cache_v=cache_v)
    if not 0 <= index < min(plan.positions, src_len):
        raise ValueError(f"beam attention: index {index} outside the caches' {plan.positions} "
                         f"positions or src's {src_len}")
    if (src.dtype is not torch.int64 or not src.is_contiguous() or b != plan.args[2]
            or src.get_device() != plan.index):
        raise ValueError(f"beam attention: src must be a contiguous int64 [B, K, > {index}] "
                         f"with B·K = {q.shape[0]} on {q.device}, got {src.dtype} "
                         f"{tuple(src.shape)}")
    out = torch.empty(plan.q_shape, dtype=plan.dtype, device=plan.device)
    scratch = _scratch(plan.blocks, plan.kc, index + 1, plan.device)
    cache_ptrs, shape = plan.args[:2], plan.args[2:]
    _SELF(plan.index, q_ptr, qs[0], qs[1], k_ptr, v_ptr, ts[0], ts[1], *cache_ptrs,
          src.data_ptr(), src_len, index, plan.positions, *shape,
          None if scratch is None else scratch.data_ptr(), out.data_ptr())
    beam_self_attention.launches += 1
    return out


def beam_cross_attention(q, k, v, key_pad_mask=None, out_dtype=None):
    """The context [B·K, H, Dh] of the K beams of each utterance over its
    cross keys and values.

    q: [B·K, H, Dh] (the beams of utterance b in rows b·K … b·K + K − 1);
    k, v: [B, H, T, Dh] in q's type, any strides with Dh innermost;
    key_pad_mask: bool [B, T], True on frames that may be attended;
    out_dtype: the type the weights are rounded to and the context is
    stored in (q's when None).

    CPU tensor → the plain version; CUDA tensor → the kernel, or an error."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, key_pad_mask, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"beam_cross_attention: unsupported device {q.device}")
    return _cross_cuda(q, k, v, key_pad_mask, out_dtype)


beam_cross_attention.launches = 0
beam_cross_attention.one_pass_launches = 0


def beam_self_attention(q, k_t, v_t, cache_k, cache_v, index: int, src):
    """The context [B·K, H, Dh] of each beam over its own lineage, after
    writing the step's key and value at position ``index`` of every row of
    the caches (in place).

    q, k_t, v_t: [B·K, H, Dh]; cache_k, cache_v: [B·K, H, U_max, Dh],
    append-only, row j holding what slot j wrote at each step; src: int64
    [B, K, ≥ index + 1], the row of the utterance that holds position p of
    the hypothesis in slot k, the identity at ``index`` (each slot reads its
    own new key there, as the beam search sets it).

    CPU tensor → the plain version; CUDA tensor → the kernel, or an error."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k_t, v_t, cache_k, cache_v, index, src)
    if q.device.type != "cuda":
        raise ValueError(f"beam_self_attention: unsupported device {q.device}")
    return _self_cuda(q, k_t, v_t, cache_k, cache_v, index, src)


beam_self_attention.launches = 0
