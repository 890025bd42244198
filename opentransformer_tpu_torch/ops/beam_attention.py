"""Attention of the beam step over its caches.

A decoder's cached beam step attends twice in every block: the K beams of
an utterance over that utterance's cross keys and values (stored once per
utterance, [B, H, T, Dh]), and each beam over its own lineage in the
append-only self-attention caches ([B·K, H, U_max, Dh], row ``src[b, k, p]``
of the utterance holding position p of the hypothesis in slot k).

``beam_cross_attention`` and ``beam_self_attention`` compute these. On a
CUDA tensor they launch the hand-written kernel of
``csrc/beam_attention.cu``, which reads each cache row in place, once a
step, in the caches' own type; on a CPU tensor they run
``cross_attention_plain`` and ``self_attention_plain``, the same functions
in plain PyTorch (the decoder's code before the kernel, unchanged). There
is no other switch and no fallback: a CUDA tensor the kernel does not take
raises.

Arithmetic (every path): scores q·k in float32 over √Dh, ``NEG_INF`` where
the key padding mask is False (``masked_fill``), the softmax in float32,
its weights rounded to the output type, the context summed in float32 and
stored in the output type. The output type is the model's: the cross
entry takes it from the caller (the decoder's hidden state), the self entry
from q. Each entry's ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .masks import apply_attn_mask

# beams one block serves (kMaxBeams in csrc/beam_attention.cu): a wider beam
# is split into chunks of at most this many, each reading the caches again
MAX_BEAMS = 8
# a block keeps its scores in shared memory up to this many bytes, and in a
# scratch buffer in device memory beyond
SCORES_ON_CHIP_BYTES = 32 * 1024

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def beam_plan(beams: int) -> tuple[int, int]:
    """(chunks, beams a chunk): the fewest chunks of at most ``MAX_BEAMS``
    beams, as even as they come; every chunk's blocks read the caches."""
    chunks = -(-beams // MAX_BEAMS)
    return chunks, -(-beams // chunks)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("beam_attention")
    if lib.beam_attention_cross_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.beam_attention_cross_launch.argtypes = [
            p, ll, ll, p, p, ll, ll, ll, p, ll, ll, i, i, i, i, i, i, i, i, i, p, p, p]
        lib.beam_attention_cross_launch.restype = i
        lib.beam_attention_self_launch.argtypes = [
            p, ll, ll, p, p, ll, ll, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p]
        lib.beam_attention_self_launch.restype = i
        lib.beam_attention_error_string.argtypes = [i]
        lib.beam_attention_error_string.restype = ctypes.c_char_p
    return lib


def _stream_getter(c_module=torch._C):
    """``device index -> the raw handle of its current stream``: the binding
    that ``torch.cuda.current_stream`` calls, without building a
    ``torch.cuda.Stream`` (~6 µs of host a call less), looked up once; a
    torch without that private binding (a CPU-only build has none) takes
    the public route."""
    raw = getattr(c_module, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw
    return lambda index: torch.cuda.current_stream(index).cuda_stream


_current_stream = _stream_getter()


def _launch(fn, index: int, args) -> int:
    """``fn(*args, stream)`` on CUDA device ``index`` and its current
    stream, entering the device only when it is not the current one (on
    every decode path it is: entering and leaving costs ~12 µs of host)."""
    if index == torch.cuda.current_device():
        return fn(*args, _current_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _current_stream(index))


def _aligned(vec: int, *tensors) -> bool:
    """Every tensor's rows start on 16 bytes: its address a multiple of 16
    and every stride but the innermost (which is 1) a multiple of the
    ``vec`` elements of a 16-byte load (a power of two, so OR-ing keeps the
    low bits a multiple shares)."""
    addr = strides = 0
    for t in tensors:
        st = t.stride()
        if st[-1] != 1:
            return False
        addr |= t.data_ptr()
        for x in st[:-1]:
            strides |= x
    return addr % 16 == 0 and strides % vec == 0


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


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"beam attention kernel ({entry}) launch failed: "
                           f"{_library().beam_attention_error_string(err).decode()} ({err})")


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

    __slots__ = ("same", "ptr", "q_shape", "dtype", "vec", "index", "device", "fn", "args",
                 "blocks", "kc", "positions")


def _cross_plan(q, k, v, key_pad_mask, out_dtype) -> _Plan:
    code = _DTYPE_CODE.get(q.dtype)
    if code is None or out_dtype not in _DTYPE_CODE:
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
    if k.device != q.device or v.device != q.device or v.stride() != k.stride() or not _aligned(
            vec, k, v):
        raise _layout_error(q=q, k=k, v=v)
    mask_ptr, mask_b, mask_t = None, 0, 0
    if key_pad_mask is not None:
        if (key_pad_mask.dtype != torch.bool or key_pad_mask.shape != (b, t)
                or key_pad_mask.device != q.device):
            raise ValueError(f"beam attention: key_pad_mask must be bool [{b}, {t}] on "
                             f"{q.device}, got {key_pad_mask.dtype} {tuple(key_pad_mask.shape)}")
        mask_ptr, (mask_b, mask_t) = key_pad_mask.data_ptr(), key_pad_mask.stride()
    beams = bk // b
    chunks, kc = beam_plan(beams)
    ks = k.stride()
    plan = _Plan()
    plan.same, plan.ptr = (v, key_pad_mask, out_dtype), k.data_ptr()
    plan.q_shape, plan.dtype, plan.vec = q.shape, q.dtype, vec
    plan.device = q.device
    plan.index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    plan.fn = _library().beam_attention_cross_launch
    plan.args = (plan.ptr, v.data_ptr(), ks[0], ks[1], ks[2], mask_ptr, mask_b, mask_t, b,
                 beams, h, t, dh, code, _DTYPE_CODE[out_dtype], kc, chunks)
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
    scratch = _scratch(plan.blocks, plan.kc, plan.positions, plan.device)
    err = _launch(plan.fn, plan.index, (q_ptr, qs[0], qs[1], *plan.args,
                                        None if scratch is None else scratch.data_ptr(),
                                        out.data_ptr()))
    _raise_on(err, "cross")
    beam_cross_attention.launches += 1
    return out


def _self_plan(q, cache_k, cache_v, beams: int) -> _Plan:
    code = _DTYPE_CODE.get(q.dtype)
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
            or not cache_v.is_contiguous() or not _aligned(vec, cache_k, cache_v)):
        raise _layout_error(q=q, cache_k=cache_k, cache_v=cache_v)
    chunks, kc = beam_plan(beams)
    plan = _Plan()
    plan.same, plan.ptr = (cache_v, beams), cache_k.data_ptr()
    plan.q_shape, plan.dtype, plan.vec = q.shape, q.dtype, vec
    plan.device = q.device
    plan.index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    plan.fn = _library().beam_attention_self_launch
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
    err = _launch(plan.fn, plan.index, (
        q_ptr, qs[0], qs[1], k_ptr, v_ptr, ts[0], ts[1], *cache_ptrs, src.data_ptr(), src_len,
        index, plan.positions, *shape, None if scratch is None else scratch.data_ptr(),
        out.data_ptr()))
    _raise_on(err, "self")
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
