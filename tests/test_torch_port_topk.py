"""Port of the fused projection→log-softmax→top-k against the JAX package.

The same numpy inputs go through the JAX reference (``project_logp_topk_xla``
and the Pallas kernel in interpret mode) and through the port's plain
PyTorch version, which is what the port's wrapper runs for CPU tensors.
Tolerances: ids identical (ties included), values and logsumexp within
1e-5 in float32 (the JAX kernel tests' own bound); bf16 inputs within 1e-2,
as ``tests/test_project_topk.py`` allows for them.

The CUDA kernel itself runs only on the card: ``test_torch_port_gpu.py``
holds it against the plain version there. What the CPU can check is its
float32 arithmetic: the kernel multiplies float32 inputs as 3xTF32 on the
tensor cores, and ``matmul_tf32`` below models that (TF32 rounding is
float32 with its mantissa rounded to 10 bits, to nearest, ties away from
zero, as ``cvt.rna.tf32.f32``). Held to JAX's float32 result at the
flagship and anchor widths: values within 1e-4 (the card's tolerance
between the kernel and the plain version), ids equal wherever the top
values stand more than 1e-4 apart; one TF32 pass does not stay within
1e-4, which is why the kernel splits each operand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.ops.project_topk import (
    project_logp_topk_pallas,
    project_logp_topk_xla,
)
from opentransformer_tpu_torch.ops import project_topk as port


def _rand(n, d, v, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    return h, w, b


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: 10 mantissa bits, to nearest, ties away
    from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b.T`` as the kernels take it on the tensor cores for float32
    inputs: with ``passes=3`` (3xTF32) each operand splits into
    hi = tf32(x) and lo = tf32(x - hi), and lo·hi + hi·lo + hi·hi sum in
    float32 (each TF32 product is exact in float32); ``passes=1`` is plain
    TF32, hi·hi alone."""
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return a_hi @ b_hi.T
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def untied(vals: np.ndarray, k: int, gap: float) -> np.ndarray:
    """bool[N, k] from the top-(k+1) values: slots whose value stands more
    than ``gap`` apart from both neighbours."""
    d = vals[:, :-1] - vals[:, 1:]
    sep = np.ones((vals.shape[0], k), bool)
    sep[:, 1:] &= d[:, : k - 1] > gap
    sep &= d[:, :k] > gap
    return sep


def _port(h, w, b, k, with_lse=False, dtype=torch.float32):
    out = port.project_logp_topk(torch.from_numpy(h).to(dtype), torch.from_numpy(w),
                                 torch.from_numpy(b), k, with_lse=with_lse)
    return [t.float().numpy() if t.is_floating_point() else t.numpy() for t in out]


@pytest.mark.parametrize(
    "n,d,v,k,block_v",
    [
        (3, 24, 50, 5, 128),     # tiny, single vocab tile, ragged everything
        (17, 64, 700, 5, 256),   # multiple vocab tiles, ragged tail tile
        (16, 32, 260, 1, 128),   # k=1 (greedy path), ragged tail
        (9, 40, 131, 8, 128),    # k>5, vocab just past one tile
        (12, 48, 300, 32, 128),  # k=32 (the CTC sparse beam's width)
        (1, 16, 64, 5, 128),     # n=1
    ],
)
def test_plain_matches_jax(n, d, v, k, block_v):
    h, w, b = _rand(n, d, v, seed=n + v)
    vals, idx, lse = _port(h, w, b, k, with_lse=True)
    ref_vals, ref_idx, ref_lse = project_logp_topk_xla(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k, with_lse=True)
    pal_vals, pal_idx, pal_lse = project_logp_topk_pallas(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k, block_rows=8, block_v=block_v,
        interpret=True, with_lse=True)
    assert vals.dtype == np.float32 and idx.dtype == np.int32 and vals.shape == (n, k)
    for rv, ri, rl in ((ref_vals, ref_idx, ref_lse), (pal_vals, pal_idx, pal_lse)):
        np.testing.assert_array_equal(idx, np.asarray(ri))
        np.testing.assert_allclose(vals, np.asarray(rv), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse, np.asarray(rl), rtol=1e-5, atol=1e-5)


def test_ties_go_to_smallest_id():
    # identical rows and a weight matrix that repeats 7 rows 40 times: every
    # logit value appears 40x, across vocab-tile boundaries
    n, d, k = 4, 16, 6
    h = np.tile(np.linspace(-1.0, 1.0, d, dtype=np.float32)[None], (n, 1))
    w = np.tile(np.random.default_rng(3).normal(size=(7, d)).astype(np.float32), (40, 1))
    b = np.zeros((w.shape[0],), np.float32)
    vals, idx = _port(h, w, b, k)
    ref_vals, ref_idx = project_logp_topk_xla(jnp.asarray(h), jnp.asarray(w),
                                              jnp.asarray(b), k)
    pal_vals, pal_idx = project_logp_topk_pallas(jnp.asarray(h), jnp.asarray(w),
                                                 jnp.asarray(b), k, block_rows=8,
                                                 block_v=128, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_array_equal(idx, np.asarray(pal_idx))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=1e-5, atol=1e-5)


def test_bf16_hidden_states():
    h, w, b = _rand(12, 48, 300, seed=7)
    vals, idx = _port(h, w, b, 5, dtype=torch.bfloat16)
    ref_vals, ref_idx = project_logp_topk_xla(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w),
                                              jnp.asarray(b), 5)
    assert vals.dtype == np.float32
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=1e-2, atol=1e-2)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    h, w, b = (torch.from_numpy(a) for a in _rand(5, 16, 70, seed=2))
    before = port.project_logp_topk.launches
    vals, idx = port.project_logp_topk(h, w, b, 3)
    ref_vals, ref_idx = port.project_logp_topk_plain(h, w, b, 3)
    assert port.project_logp_topk.launches == before  # no kernel launch on the CPU
    assert torch.equal(idx, ref_idx) and torch.equal(vals, ref_vals)


@pytest.mark.parametrize("n,v,splits,per_split", [
    (2560, 4233, 6, 6),    # flagship beam step: 40 row tiles x 6 splits = 240 blocks
    (2561, 4233, 6, 6),    # one row past the tile edge: 41 x 6 = 246
    (500, 4233, 17, 2),    # anchor beam step: 8 x 17 = 136
    (65, 4233, 34, 1),     # two row tiles: every vocab tile its own split
    (7, 4233, 34, 1),      # ragged small N
    (3, 50, 1, 1),         # vocab within one tile
])
def test_split_plan(n, v, splits, per_split):
    assert port.split_plan(n, v) == (splits, per_split)
    # every split non-empty and together covering every tile
    n_tiles = -(-v // 128)
    assert (splits - 1) * per_split < n_tiles <= splits * per_split
    # one wave: at most two 64-row blocks on each of the 132 SMs
    assert -(-n // 64) * splits <= 264


@pytest.mark.parametrize("n,d", [(64, 256), (64, 128)], ids=["flagship", "anchor"])
def test_3xtf32_matches_jax(n, d):
    """The kernel's float32 route, modelled on the CPU, against JAX's
    float32 top-k at the flagship (D=256) and anchor (D=128) widths, V=4233,
    N cut to 64 rows, k=5."""
    v, k = 4233, 5
    h, w, b = _rand(n, d, v, seed=d)
    logits = matmul_tf32(torch.from_numpy(h), torch.from_numpy(w)) + torch.from_numpy(b)
    vals, idx = port.topk_smallest_id(torch.log_softmax(logits, -1), k)
    lse = torch.logsumexp(logits, -1)
    ref_vals, ref_idx, ref_lse = project_logp_topk_xla(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k, with_lse=True)
    wide, _ = project_logp_topk_xla(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k + 1)
    sep = untied(np.asarray(wide), k, 1e-4)
    assert sep.sum() > 0.9 * sep.size
    np.testing.assert_array_equal(idx.numpy()[sep], np.asarray(ref_idx)[sep])
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,d", [(64, 256), (64, 128)], ids=["flagship", "anchor"])
def test_one_tf32_pass_is_not_enough(n, d):
    """Plain TF32 moves the same log-probs by more than 1e-4."""
    v, k = 4233, 5
    h, w, b = _rand(n, d, v, seed=d)
    logits = matmul_tf32(torch.from_numpy(h), torch.from_numpy(w), passes=1) + torch.from_numpy(b)
    vals, _ = port.topk_smallest_id(torch.log_softmax(logits, -1), k)
    ref_vals, _ = project_logp_topk_xla(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k)
    assert np.abs(vals.numpy() - np.asarray(ref_vals)).max() > 1e-4


@pytest.mark.parametrize("name", ["project_topk", "project2_topk"])
def test_kernels_multiply_on_tensor_cores(name):
    """Both top-k kernels take their products on the tensor cores: bf16
    through mma.sync with float32 accumulation, float32 as 3xTF32 (TF32
    rounding to nearest, the split into hi and lo); no FMA tile product and
    no library product is left on their path."""
    import os

    from opentransformer_tpu_torch.ops import cuda_build

    text = ""
    for fname in (name + ".cu", "topk_common.cuh"):
        with open(os.path.join(cuda_build.CSRC_DIR, fname)) as f:
            text += f.read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert "cvt.rna.tf32.f32" in text and "split_tf32" in text
    assert "fmaf(" not in text
    for library in ("cublas", "cutlass", "cute::", "torch/"):
        assert library not in text.lower()
