"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so they also run on a machine that has only the
port's dependencies; there ``tests/conftest.py`` (which imports JAX) is
skipped:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py

Tolerance: ids identical and values/logsumexp within 1e-4 absolute. Both
paths see the same bf16-rounded inputs and accumulate in float32; only
the summation order differs.
"""

import numpy as np
import pytest
import torch

from opentransformer_tpu_torch.ops import project_topk as port


def _rand(n, d, v, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    return h, w, b


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,v,k,dtype", [
    (2560, 256, 4233, 5, torch.bfloat16),
    (2560, 256, 4233, 5, torch.float32),
    (500, 128, 4233, 5, torch.float32),
    (7, 64, 700, 32, torch.float32),
    (33, 40, 131, 128, torch.float32),
])
def test_kernel_matches_plain_on_card(cuda, n, d, v, k, dtype):
    h, w, b = (torch.from_numpy(a).to(cuda) for a in _rand(n, d, v, seed=n))
    h, w = h.to(dtype), w.to(dtype)
    vals, idx, lse = port.project_logp_topk(h, w, b, k, with_lse=True)
    ref_vals, ref_idx, ref_lse = port.project_logp_topk_plain(h, w, b, k, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(idx, ref_idx)
    torch.testing.assert_close(vals, ref_vals, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    h, w, b = (torch.from_numpy(a).to(cuda) for a in _rand(4, 16, 64))
    with pytest.raises(TypeError):
        port.project_logp_topk(h.half(), w, b, 3)
    with pytest.raises(ValueError):
        port.project_logp_topk(h.t(), w[:, :4], b, 3)
    with pytest.raises(ValueError):
        port.project_logp_topk(h, w, b, 129)


@pytest.mark.gpu
def test_decode_runs_through_kernel(cuda):
    """A small random model on the card: the beam search's fused step
    launches the kernel once per step and gives the unfused decode's ids."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    cfg = {"type": "speech2text",
           "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
           "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2,
                       "activation": "glu"},
           "decoder": {"vocab_size": 300, "d_model": 32, "n_heads": 4, "d_ff": 48,
                       "memory_dim": 32, "n_blocks": 2, "activation": "glu",
                       "share_embedding": False}}
    torch.manual_seed(0)
    model = build_model(cfg, device=cuda)
    feats = torch.randn(3, 80, 20, device=cuda)
    mask = torch.ones(3, 80, dtype=torch.bool, device=cuda)
    with torch.inference_mode():
        memory, memory_mask = model.encode(feats, mask)
    port.project_logp_topk.launches = 0
    fused = make_memory_search(model, 4, 10, eos_id=-1)(memory, memory_mask)
    assert port.project_logp_topk.launches == 10
    plain = make_memory_search(model, 4, 10, eos_id=-1, fused_topk=False)(memory, memory_mask)
    assert torch.equal(fused.tokens, plain.tokens)
    torch.testing.assert_close(fused.scores, plain.scores, rtol=0, atol=1e-4)
