"""Fused vocab projection → log-softmax → top-k
(counterpart of ``opentransformer_tpu/ops/project_topk.py:project_logp_topk``).

Every beam or greedy decode step ends with ``log_softmax(h @ Wᵀ + b)``
followed by a top-k. ``project_logp_topk`` computes that without writing
the [N, V] logits to device memory: on a CUDA tensor it launches the
hand-written kernel of ``csrc/project_topk.cu`` (which replaces the Pallas
``_topk_kernel``), on a CPU tensor it runs ``project_logp_topk_plain``, the
same function in plain PyTorch. There is no other switch and no fallback:
a CUDA tensor the kernel does not take raises.

Semantics (both paths): values are float32 log-probs sorted descending,
ids int32, ties resolve to the smallest vocab id (the ``lax.top_k`` rule),
``with_lse`` adds the row logsumexp. ``weight`` is cast to ``h``'s dtype
(float32 or bfloat16) and the products accumulate in float32, as the JAX
reference does with ``preferred_element_type``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_K = 128
# tile geometry of csrc/project_topk.cu (kRows, kCols); the split plan below
# must agree with it
_ROWS, _COLS = 32, 128
# aim for about two waves of blocks over the H100's 132 SMs
_TARGET_BLOCKS = 264


def topk_smallest_id(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the smallest index.

    ``torch.topk`` does not promise an order among equal values; a stable
    descending sort keeps equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def project_logp_topk_plain(h, weight, bias, k: int, with_lse: bool = False):
    """Plain PyTorch version: materialized logits → log_softmax → top-k."""
    logits = h.float() @ weight.to(h.dtype).float().T + bias.float()
    vals, idx = topk_smallest_id(torch.log_softmax(logits, dim=-1), k)
    idx = idx.to(torch.int32)
    if with_lse:
        return vals, idx, torch.logsumexp(logits, dim=-1)
    return vals, idx


def split_plan(n: int, v: int) -> tuple[int, int]:
    """(splits, tiles_per_split): how many blocks share one row tile's
    vocabulary. Enough splits that a small N still fills the card, each
    split a whole number of 128-column tiles, none empty."""
    n_tiles = -(-v // _COLS)
    row_blocks = -(-n // _ROWS)
    want = max(1, min(n_tiles, -(-_TARGET_BLOCKS // row_blocks)))
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split), per_split


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("project_topk")
    if lib.project_topk_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.project_topk_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p]
        lib.project_topk_launch.restype = ctypes.c_int
        lib.project_topk_error_string.argtypes = [i]
        lib.project_topk_error_string.restype = ctypes.c_char_p
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _project_logp_topk_cuda(h, weight, bias, k: int):
    if h.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"expected h [N, D], weight [V, D], bias [V]; got "
                         f"{tuple(h.shape)}, {tuple(weight.shape)}, {tuple(bias.shape)}")
    n, d = h.shape
    v = weight.shape[0]
    if weight.shape[1] != d or bias.shape[0] != v:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"project_logp_topk kernel takes float32 or bfloat16 h, got {h.dtype}")
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"k={k} must be in [1, min({MAX_K}, V={v})]")
    if weight.device != h.device or bias.device != h.device:
        raise ValueError("h, weight and bias must be on the same device")
    w = weight.to(h.dtype)
    b = bias.to(torch.float32)
    for name, t in (("h", h), ("weight", w), ("bias", b)):
        if not t.is_contiguous():
            raise ValueError(f"project_logp_topk kernel needs a contiguous {name}")
    dev = h.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((n, k), dtype=torch.int32, device=dev)
    lse = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return vals, ids, lse
    splits, per_split = split_plan(n, v)
    part = torch.empty((splits * n * (2 + k),), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits * n * k,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.project_topk_launch(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), _DTYPE_CODE[h.dtype],
            n, d, v, k, splits, per_split, part.data_ptr(), part_i.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"project_topk kernel launch failed: "
                           f"{lib.project_topk_error_string(err).decode()} ({err})")
    project_logp_topk.launches += 1
    return vals, ids, lse


def project_logp_topk(h, weight, bias, k: int, with_lse: bool = False):
    """(vals f32[N, k], ids i32[N, k]) of ``log_softmax(h @ weightᵀ + bias)``,
    plus the row logsumexp f32[N] with ``with_lse``.

    CPU tensor → the plain version; CUDA tensor → the kernel, or an error.
    ``project_logp_topk.launches`` counts kernel launches."""
    if h.device.type == "cpu":
        return project_logp_topk_plain(h, weight, bias, k, with_lse)
    if h.device.type != "cuda":
        raise ValueError(f"project_logp_topk: unsupported device {h.device}")
    vals, ids, lse = _project_logp_topk_cuda(h, weight, bias, k)
    if with_lse:
        return vals, ids, lse
    return vals, ids


project_logp_topk.launches = 0
