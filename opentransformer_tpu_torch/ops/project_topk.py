"""Fused vocab projection → log-softmax → top-k
(counterpart of ``opentransformer_tpu/ops/project_topk.py``).

Every beam or greedy decode step ends with ``log_softmax(h @ Wᵀ + b)``
followed by a top-k. ``project_logp_topk`` computes that without writing
the [N, V] logits to device memory: on a CUDA tensor it launches the
hand-written kernel of ``csrc/project_topk.cu`` (which replaces the Pallas
``_topk_kernel``), on a CPU tensor it runs ``project_logp_topk_plain``, the
same function in plain PyTorch. There is no other switch and no fallback:
a CUDA tensor the kernel does not take raises.

``project2_logp_topk`` is the two-head form that LM shallow fusion consumes:
the top-k of ``log_softmax(h1 @ W1ᵀ + b1) + lam · log_softmax(h2 @ W2ᵀ + b2)``
from the recognizer's and the LM's hidden states, through
``csrc/project2_topk.cu`` (which replaces the Pallas ``_topk2_kernel``) on a
CUDA tensor and ``project2_logp_topk_plain`` on a CPU tensor, under the same
rule.

Semantics (all paths): values are float32 log-probs sorted descending,
ids int32, ties resolve to the smallest vocab id (the ``lax.top_k`` rule),
``with_lse`` adds the row logsumexp; a bias of None is a head without one
(the kernels read zeros). A weight is cast to its ``h``'s dtype
(float32 or bfloat16) and the products accumulate in float32, as the JAX
reference does with ``preferred_element_type``.
"""

from __future__ import annotations

import torch

from . import cuda_build

MAX_K = 128
# tile geometry of csrc/topk_common.cuh (kRows, kCols); the split plan below
# must agree with it
_ROWS, _COLS = 64, 128
# at most one wave of blocks: two blocks on each of the H100's 132 SMs
_TARGET_BLOCKS = 264


def topk_smallest_id(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the smallest index.

    ``torch.topk`` does not promise an order among equal values; a stable
    descending sort keeps equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _logits_plain(h, weight, bias):
    logits = h.float() @ weight.to(h.dtype).float().T
    return logits if bias is None else logits + bias.float()


def project_logp_topk_plain(h, weight, bias, k: int, with_lse: bool = False):
    """Plain PyTorch version: materialized logits → log_softmax → top-k."""
    logits = _logits_plain(h, weight, bias)
    vals, idx = topk_smallest_id(torch.log_softmax(logits, dim=-1), k)
    idx = idx.to(torch.int32)
    if with_lse:
        return vals, idx, torch.logsumexp(logits, dim=-1)
    return vals, idx


def split_plan(n: int, v: int) -> tuple[int, int]:
    """(splits, tiles_per_split): how many blocks share one 64-row tile's
    vocabulary. As many splits as keep the grid within one wave of
    ``_TARGET_BLOCKS``, so that a small N still fills the card and a large
    one leaves no short second wave; each split a whole number of
    128-column tiles, none empty."""
    n_tiles = -(-v // _COLS)
    row_blocks = -(-n // _ROWS)
    want = max(1, min(n_tiles, _TARGET_BLOCKS // row_blocks))
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split), per_split


_LAUNCH = cuda_build.Entry("project_topk", "project_topk_launch", "pppiiiiiiippppp")
_LAUNCH2 = cuda_build.Entry("project2_topk", "project2_topk_launch", "ppppppfiiiiiiiipppp")


_ZERO_BIAS: dict = {}


def _zero_bias(v: int, device) -> torch.Tensor:
    """float32 zeros [V] on ``device``, made once: the bias the kernels read
    for a head without one."""
    key = (v, str(device))
    if key not in _ZERO_BIAS:
        _ZERO_BIAS[key] = torch.zeros(v, dtype=torch.float32, device=device)
    return _ZERO_BIAS[key]


def _kernel_head(h, weight, bias):
    """Check one head's (h [N, D], weight [V, D], bias [V] or None) for the
    kernels and return (h, weight in h's dtype, bias in float32); raises on
    what the kernels do not take."""
    if bias is None and weight.dim() == 2:
        bias = _zero_bias(weight.shape[0], weight.device)
    if h.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"expected h [N, D], weight [V, D], bias [V]; got "
                         f"{tuple(h.shape)}, {tuple(weight.shape)}, {tuple(bias.shape)}")
    if weight.shape[1] != h.shape[1] or bias.shape[0] != weight.shape[0]:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if h.dtype not in cuda_build.DTYPE_CODE:
        raise TypeError(f"the top-k kernels take float32 or bfloat16 h, got {h.dtype}")
    if weight.device != h.device or bias.device != h.device:
        raise ValueError("h, weight and bias must be on the same device")
    w = weight.to(h.dtype)
    b = bias.to(torch.float32)
    for name, t in (("h", h), ("weight", w), ("bias", b)):
        if not t.is_contiguous():
            raise ValueError(f"the top-k kernels need a contiguous {name}")
    return h, w, b


def _check_k(k: int, v: int) -> None:
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"k={k} must be in [1, min({MAX_K}, V={v})]")


def _project_logp_topk_cuda(h, weight, bias, k: int):
    h, w, b = _kernel_head(h, weight, bias)
    n, d = h.shape
    v = w.shape[0]
    _check_k(k, v)
    dev = h.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((n, k), dtype=torch.int32, device=dev)
    lse = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return vals, ids, lse
    splits, per_split = split_plan(n, v)
    part = torch.empty((splits * n * (2 + k),), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits * n * k,), dtype=torch.int32, device=dev)
    _LAUNCH(h.get_device(), h.data_ptr(), w.data_ptr(), b.data_ptr(),
            cuda_build.DTYPE_CODE[h.dtype], n, d, v, k, splits, per_split, part.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(), lse.data_ptr())
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


def project2_logp_topk_plain(h1, w1, b1, h2, w2, b2, lam: float, k: int):
    """Plain PyTorch version of the two-head form: both log-softmaxes
    materialized, ``lp1 + lam · lp2``, then top-k."""
    lp1 = torch.log_softmax(_logits_plain(h1, w1, b1), dim=-1)
    lp2 = torch.log_softmax(_logits_plain(h2, w2, b2), dim=-1)
    vals, idx = topk_smallest_id(lp1 + lam * lp2, k)
    return vals, idx.to(torch.int32)


def _project2_logp_topk_cuda(h1, w1, b1, h2, w2, b2, lam: float, k: int):
    h1, w1, b1 = _kernel_head(h1, w1, b1)
    h2, w2, b2 = _kernel_head(h2, w2, b2)
    n, d1 = h1.shape
    d2 = h2.shape[1]
    v = w1.shape[0]
    if h2.shape[0] != n:
        raise ValueError(f"the heads disagree on rows: {n} and {h2.shape[0]}")
    if w2.shape[0] != v:
        raise ValueError(f"the heads disagree on the vocabulary: {v} and {w2.shape[0]}")
    if h2.dtype != h1.dtype or h2.device != h1.device:
        raise TypeError(f"the heads must share dtype and device: {h1.dtype} on {h1.device}, "
                        f"{h2.dtype} on {h2.device}")
    _check_k(k, v)
    dev = h1.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return vals, ids
    splits, per_split = split_plan(n, v)
    part = torch.empty((splits * n * (4 + k),), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits * n * k,), dtype=torch.int32, device=dev)
    _LAUNCH2(h1.get_device(), h1.data_ptr(), w1.data_ptr(), b1.data_ptr(), h2.data_ptr(),
             w2.data_ptr(), b2.data_ptr(), float(lam), cuda_build.DTYPE_CODE[h1.dtype], n, d1,
             d2, v, k, splits, per_split, part.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
             ids.data_ptr())
    project2_logp_topk.launches += 1
    return vals, ids


def project2_logp_topk(h1, w1, b1, h2, w2, b2, lam: float, k: int):
    """(vals f32[N, k], ids i32[N, k]) of
    ``log_softmax(h1 @ w1ᵀ + b1) + lam · log_softmax(h2 @ w2ᵀ + b2)``;
    the heads share N and V, their widths D1 and D2 may differ.

    CPU tensors → the plain version; CUDA tensors → the kernel, or an error.
    ``project2_logp_topk.launches`` counts kernel launches."""
    if h1.device.type == "cpu":
        return project2_logp_topk_plain(h1, w1, b1, h2, w2, b2, lam, k)
    if h1.device.type != "cuda":
        raise ValueError(f"project2_logp_topk: unsupported device {h1.device}")
    return _project2_logp_topk_cuda(h1, w1, b1, h2, w2, b2, lam, k)


project2_logp_topk.launches = 0
