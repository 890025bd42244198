"""Port of the two-head fused top-k (LM shallow fusion) against the JAX package.

The same numpy inputs go through the JAX reference
(``project2_logp_topk_xla`` and the Pallas kernel in interpret mode) and
through the port's plain PyTorch version, which is what the port's wrapper
runs for CPU tensors. Tolerances: ids identical (ties included), values
within 1e-5 in float32 (the JAX kernel tests' own bound); bf16 hidden
states against the float32 JAX result within 1e-2, as
``tests/test_project_topk.py`` allows for them.

The CUDA kernel itself runs only on the card: ``test_torch_port_gpu.py``
holds it against the plain version there. Its float32 arithmetic (3xTF32
on the tensor cores, modelled by ``test_torch_port_topk.matmul_tf32``) is
held here to JAX's float32 result at the flagship, anchor and LSTM-LM
widths: values within 1e-4, ids equal wherever the top values stand more
than 1e-4 apart; one TF32 pass does not stay within 1e-4.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.ops.project_topk import (
    project2_logp_topk_pallas,
    project2_logp_topk_xla,
)
from opentransformer_tpu_torch.ops import cuda_build
from opentransformer_tpu_torch.ops import project_topk as port
from test_torch_port_topk import matmul_tf32, untied


def _rand2(n, d1, d2, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d1)).astype(np.float32),
            (rng.normal(size=(v, d1)) * 0.3).astype(np.float32),
            (rng.normal(size=(v,)) * 0.1).astype(np.float32),
            rng.normal(size=(n, d2)).astype(np.float32),
            (rng.normal(size=(v, d2)) * 0.3).astype(np.float32),
            (rng.normal(size=(v,)) * 0.1).astype(np.float32))


def _port(args, lam, k, dtype=torch.float32):
    h1, w1, b1, h2, w2, b2 = (torch.from_numpy(a) for a in args)
    vals, idx = port.project2_logp_topk(h1.to(dtype), w1, b1, h2.to(dtype), w2, b2, lam, k)
    return vals.numpy(), idx.numpy()


def _jax_both(args, lam, k, dtype=jnp.float32):
    h1, w1, b1, h2, w2, b2 = (jnp.asarray(a) for a in args)
    args = (h1.astype(dtype), w1, b1, h2.astype(dtype), w2, b2)
    return (project2_logp_topk_xla(*args, lam, k),
            project2_logp_topk_pallas(*args, lam, k, block_rows=8, block_v=128,
                                      interpret=True))


@pytest.mark.parametrize("lam", [0.5, 0.0, -0.3])
@pytest.mark.parametrize(
    "n,d1,d2,v,k",
    [
        (3, 24, 16, 50, 5),    # tiny, ragged everything, D1 != D2
        (17, 64, 32, 700, 5),  # multiple vocab tiles
        (9, 40, 40, 131, 8),   # k > 5, vocab just past one tile
    ],
)
def test_plain_matches_jax(n, d1, d2, v, k, lam):
    args = _rand2(n, d1, d2, v, seed=n + v)
    vals, idx = _port(args, lam, k)
    assert vals.dtype == np.float32 and idx.dtype == np.int32 and vals.shape == (n, k)
    assert (np.diff(vals, axis=1) <= 0).all()
    for ref_vals, ref_idx in _jax_both(args, lam, k):
        np.testing.assert_array_equal(idx, np.asarray(ref_idx))
        np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lam", [0.5, 0.0, -0.3])
def test_ties_go_to_smallest_id(lam):
    # identical rows and weight matrices that repeat 7 rows 40 times: every
    # combined value appears 40x, across vocab-tile boundaries
    n, d1, d2, k = 4, 16, 24, 6
    rng = np.random.default_rng(3)
    h1 = np.tile(np.linspace(-1.0, 1.0, d1, dtype=np.float32)[None], (n, 1))
    h2 = np.tile(np.linspace(1.0, -0.5, d2, dtype=np.float32)[None], (n, 1))
    w1 = np.tile(rng.normal(size=(7, d1)).astype(np.float32), (40, 1))
    w2 = np.tile(rng.normal(size=(7, d2)).astype(np.float32), (40, 1))
    b = np.zeros((280,), np.float32)
    args = (h1, w1, b, h2, w2, b)
    vals, idx = _port(args, lam, k)
    # the best column's first six copies, in id order
    assert (np.diff(idx, axis=1) == 7).all() and (idx[:, 0] < 7).all()
    for ref_vals, ref_idx in _jax_both(args, lam, k):
        np.testing.assert_array_equal(idx, np.asarray(ref_idx))
        np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=1e-5, atol=1e-5)


def _emulated(args, lam, k, passes):
    h1, w1, b1, h2, w2, b2 = (torch.from_numpy(a) for a in args)
    lp1 = torch.log_softmax(matmul_tf32(h1, w1, passes) + b1, -1)
    lp2 = torch.log_softmax(matmul_tf32(h2, w2, passes) + b2, -1)
    vals, idx = port.topk_smallest_id(lp1 + lam * lp2, k)
    return vals.numpy(), idx.numpy()


WIDTHS = pytest.mark.parametrize("n,d1,d2", [(64, 256, 256), (64, 128, 256), (64, 256, 1024)],
                                 ids=["flagship", "anchor", "lstm_lm"])


@WIDTHS
def test_3xtf32_matches_jax(n, d1, d2):
    """The kernel's float32 route, modelled on the CPU, against JAX's
    float32 two-head top-k at V=4233, k=5, lm weight 0.1, N cut to 64."""
    v, k, lam = 4233, 5, 0.1
    args = _rand2(n, d1, d2, v, seed=d1 + d2)
    vals, idx = _emulated(args, lam, k, passes=3)
    jargs = [jnp.asarray(a) for a in args]
    ref_vals, ref_idx = project2_logp_topk_xla(*jargs, lam, k)
    wide, _ = project2_logp_topk_xla(*jargs, lam, k + 1)
    sep = untied(np.asarray(wide), k, 1e-4)
    assert sep.sum() > 0.9 * sep.size
    np.testing.assert_array_equal(idx[sep], np.asarray(ref_idx)[sep])
    np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=0, atol=1e-4)


@WIDTHS
def test_one_tf32_pass_is_not_enough(n, d1, d2):
    v, k, lam = 4233, 5, 0.1
    args = _rand2(n, d1, d2, v, seed=d1 + d2)
    vals, _ = _emulated(args, lam, k, passes=1)
    ref_vals, _ = project2_logp_topk_xla(*[jnp.asarray(a) for a in args], lam, k)
    assert np.abs(vals - np.asarray(ref_vals)).max() > 1e-4


def test_bf16_hidden_states():
    args = _rand2(12, 48, 32, 300, seed=7)
    vals, idx = _port(args, 0.5, 5, dtype=torch.bfloat16)
    (ref_vals, ref_idx), _ = _jax_both(args, 0.5, 5, dtype=jnp.bfloat16)
    assert vals.dtype == np.float32
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=1e-2, atol=1e-2)
    f32_vals, _ = _port(args, 0.5, 5)
    np.testing.assert_allclose(vals, f32_vals, rtol=1e-2, atol=1e-2)


def test_values_are_combined_log_probs():
    args = _rand2(5, 32, 24, 120, seed=5)
    h1, w1, b1, h2, w2, b2 = (torch.from_numpy(a) for a in args)
    combined = torch.log_softmax(h1 @ w1.T + b1, -1) + 0.25 * torch.log_softmax(h2 @ w2.T + b2, -1)
    vals, idx = port.project2_logp_topk(h1, w1, b1, h2, w2, b2, 0.25, 4)
    torch.testing.assert_close(vals, combined.gather(1, idx.long()), rtol=1e-6, atol=1e-6)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    args = [torch.from_numpy(a) for a in _rand2(5, 16, 8, 70, seed=2)]
    before = port.project2_logp_topk.launches
    vals, idx = port.project2_logp_topk(*args, 0.1, 3)
    ref_vals, ref_idx = port.project2_logp_topk_plain(*args, 0.1, 3)
    assert port.project2_logp_topk.launches == before  # no kernel launch on the CPU
    assert torch.equal(idx, ref_idx) and torch.equal(vals, ref_vals)


@pytest.mark.parametrize("name", ["project_topk", "project2_topk"])
def test_build_key_covers_source_and_headers(tmp_path, monkeypatch, name):
    """Both kernels include ``topk_common.cuh``: an edit to it, as to the
    source itself, must give another library name, or a stale build loads."""
    for fname in os.listdir(cuda_build.CSRC_DIR):
        shutil.copy(os.path.join(cuda_build.CSRC_DIR, fname), tmp_path / fname)
    assert os.path.basename(cuda_build.library_path(name)).startswith(name + "-")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    first = cuda_build.library_path(name)
    with open(tmp_path / "topk_common.cuh", "a") as f:
        f.write("// edited\n")
    second = cuda_build.library_path(name)
    with open(tmp_path / (name + ".cu"), "a") as f:
        f.write("// edited\n")
    assert len({first, second, cuda_build.library_path(name)}) == 3
