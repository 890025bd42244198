"""Port of the fused projection→log-softmax→top-k against the JAX package.

The same numpy inputs go through the JAX reference (``project_logp_topk_xla``
and the Pallas kernel in interpret mode) and through the port's plain
PyTorch version, which is what the port's wrapper runs for CPU tensors.
Tolerances: ids identical (ties included), values and logsumexp within
1e-5 in float32 (the JAX kernel tests' own bound); bf16 inputs within 1e-2,
as ``tests/test_project_topk.py`` allows for them.

The CUDA kernel itself runs only on the card: ``test_torch_port_gpu.py``
holds it against the plain version there.
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
    (2560, 4233, 4, 9),    # flagship beam step: 80 row tiles x 4 splits
    (500, 4233, 17, 2),    # anchor beam step
    (7, 4233, 34, 1),      # ragged small N: every vocab tile its own split
    (3, 50, 1, 1),         # vocab within one tile
])
def test_split_plan(n, v, splits, per_split):
    assert port.split_plan(n, v) == (splits, per_split)
    # every split non-empty and together covering every tile
    n_tiles = -(-v // 128)
    assert (splits - 1) * per_split < n_tiles <= splits * per_split
