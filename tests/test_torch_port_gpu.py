"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so they also run on a machine that has only the
port's dependencies; there ``tests/conftest.py`` (which imports JAX) is
skipped:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py

Tolerance: values/logsumexp within 1e-4 absolute, every returned id
carrying its returned value in the full log-softmax, and ids identical
wherever the plain top values stand more than 1e-5 of the logits' scale
apart. Both paths see the same (possibly bf16-rounded) inputs and
accumulate in float32; the kernels take float32 products as 3xTF32 (a few
1e-6 on logits of scale ~20), and the summation order differs (and, for
the two-head kernel, where the two normalisers are subtracted), so two
values closer than that may trade places.
"""

import os

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


def untied_slots(wide: torch.Tensor, k: int, tie: float) -> torch.Tensor:
    """bool[N, k] from the plain top-(k+1) values (top-k when k = V): the
    slots whose value stands more than ``tie`` apart from both neighbours."""
    gap = wide[:, :-1] - wide[:, 1:]
    sep = torch.ones((wide.shape[0], k), dtype=torch.bool, device=wide.device)
    sep[:, 1:] &= gap[:, : k - 1] > tie
    if wide.shape[1] > k:
        sep &= gap[:, :k] > tie
    return sep


def assert_ids_match(idx, ref_idx, wide, k, scale, vals, logp):
    """Ids equal on the untied slots; every id carries its value."""
    sep = untied_slots(wide, k, 1e-5 * max(scale, 1.0))
    assert torch.equal(idx[sep], ref_idx[sep])
    torch.testing.assert_close(logp.gather(1, idx.long()), vals, rtol=0, atol=1e-4)


SMALL_CFG = {
    "type": "speech2text",
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu"},
    "decoder": {"vocab_size": 300, "d_model": 32, "n_heads": 4, "d_ff": 48, "memory_dim": 32,
                "n_blocks": 2, "activation": "glu", "share_embedding": False}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,v,k,dtype", [
    (2560, 256, 4233, 5, torch.bfloat16),
    (2560, 256, 4233, 5, torch.float32),
    # the conformer's beam step: D = 384
    (2560, 384, 4233, 5, torch.bfloat16),
    (2560, 384, 4233, 5, torch.float32),
    (500, 128, 4233, 5, torch.float32),
    # the streamed CTC tick: 32 slots x a 16-frame chunk, D = 384, top-1
    (512, 384, 4233, 1, torch.bfloat16),
    (512, 384, 4233, 1, torch.float32),
    # the transducer's greedy lattice step: one online stream, the eval CLI's
    # batches of 8, 16 rows, D = 256
    (1, 256, 4233, 1, torch.bfloat16),
    (1, 256, 4233, 1, torch.float32),
    (8, 256, 4233, 1, torch.bfloat16),
    (8, 256, 4233, 1, torch.float32),
    (16, 256, 4233, 1, torch.bfloat16),
    (16, 256, 4233, 1, torch.float32),
    (7, 64, 700, 32, torch.float32),
    (33, 40, 131, 128, torch.float32),
    # tile edges: 64-row blocks, 128-byte depth slices, 128-column tiles,
    # and rows that do not start on 16 bytes (no cp.async)
    (65, 256, 4233, 5, torch.bfloat16),
    (2561, 256, 4233, 5, torch.float32),
    (500, 40, 4233, 5, torch.bfloat16),
    (130, 56, 4233, 5, torch.float32),
    (65, 256, 131, 5, torch.bfloat16),
    (70, 50, 300, 8, torch.bfloat16),
])
def test_kernel_matches_plain_on_card(cuda, n, d, v, k, dtype):
    h, w, b = (torch.from_numpy(a).to(cuda) for a in _rand(n, d, v, seed=n))
    h, w = h.to(dtype), w.to(dtype)
    vals, idx, lse = port.project_logp_topk(h, w, b, k, with_lse=True)
    ref_vals, ref_idx, ref_lse = port.project_logp_topk_plain(h, w, b, k, with_lse=True)
    wide, _ = port.project_logp_topk_plain(h, w, b, min(k + 1, v))
    logits = h.float() @ w.float().T + b
    torch.cuda.synchronize()
    assert_ids_match(idx, ref_idx, wide, k, logits.abs().max().item(), vals,
                     torch.log_softmax(logits, -1))
    torch.testing.assert_close(vals, ref_vals, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bias", ["none", "zero"])
def test_kernel_at_whisper_widths_without_a_bias(cuda, bias):
    """Whisper large-v3's beam step: 128 windows x beam 5, D 1,280, its tied
    head of 51,866 rows with no bias (None, read as zeros) or a zero one;
    weights of the model's scale, logits of about unit spread."""
    n, d, v, k = 640, 1280, 51866, 5
    gen = torch.Generator(device=cuda).manual_seed(21)
    h = torch.randn(n, d, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn(v, d, generator=gen, device=cuda) / d ** 0.5).to(torch.bfloat16)
    b = None if bias == "none" else torch.zeros(v, device=cuda)
    vals, idx, lse = port.project_logp_topk(h, w, b, k, with_lse=True)
    ref_vals, ref_idx, ref_lse = port.project_logp_topk_plain(h, w, b, k, with_lse=True)
    wide, _ = port.project_logp_topk_plain(h, w, b, k + 1)
    logits = h.float() @ w.float().T
    torch.cuda.synchronize()
    assert_ids_match(idx, ref_idx, wide, k, logits.abs().max().item(), vals,
                     torch.log_softmax(logits, -1))
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


def _rand2(n, d1, d2, v, seed=0):
    return _rand(n, d1, v, seed) + _rand(n, d2, v, seed + 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d1,d2,v,k,lam,dtype", [
    (2560, 256, 256, 4233, 5, 0.1, torch.bfloat16),
    (2560, 256, 256, 4233, 5, 0.1, torch.float32),
    (2560, 256, 1024, 4233, 5, 0.1, torch.bfloat16),
    (500, 128, 256, 4233, 5, 0.0, torch.float32),
    (7, 64, 24, 700, 32, -0.3, torch.float32),
    (33, 40, 56, 131, 128, 0.5, torch.float32),
    # tile edges, as for the one-head kernel, and the LSTM LM's D2=1024
    (65, 256, 256, 4233, 5, 0.1, torch.bfloat16),
    (2561, 256, 256, 4233, 5, -0.3, torch.float32),
    (500, 40, 56, 4233, 5, 0.1, torch.bfloat16),
    (130, 256, 1024, 4233, 5, 0.1, torch.float32),
    (65, 256, 1024, 131, 5, 0.0, torch.bfloat16),
    (70, 50, 24, 300, 8, 0.1, torch.bfloat16),
])
def test_two_head_kernel_matches_plain_on_card(cuda, n, d1, d2, v, k, lam, dtype):
    args = [torch.from_numpy(a).to(cuda) for a in _rand2(n, d1, d2, v, seed=n)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(dtype)
    vals, idx = port.project2_logp_topk(*args, lam, k)
    ref_vals, ref_idx = port.project2_logp_topk_plain(*args, lam, k)
    wide, _ = port.project2_logp_topk_plain(*args, lam, min(k + 1, v))
    h1, w1, b1, h2, w2, b2 = args
    l1 = h1.float() @ w1.float().T + b1
    l2 = h2.float() @ w2.float().T + b2
    torch.cuda.synchronize()
    scale = max(l1.abs().max().item(), abs(lam) * l2.abs().max().item())
    assert_ids_match(idx, ref_idx, wide, k, scale, vals,
                     torch.log_softmax(l1, -1) + lam * torch.log_softmax(l2, -1))
    torch.testing.assert_close(vals, ref_vals, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_two_head_kernel_rejects_what_it_does_not_take(cuda):
    h1, w1, b1, h2, w2, b2 = (torch.from_numpy(a).to(cuda) for a in _rand2(4, 16, 8, 64))
    with pytest.raises(TypeError):
        port.project2_logp_topk(h1.half(), w1, b1, h2.half(), w2, b2, 0.1, 3)
    with pytest.raises(TypeError):  # the heads' dtypes differ
        port.project2_logp_topk(h1, w1, b1, h2.bfloat16(), w2, b2, 0.1, 3)
    with pytest.raises(ValueError):  # not contiguous
        port.project2_logp_topk(h1.t(), w1[:, :4], b1, h2, w2, b2, 0.1, 3)
    with pytest.raises(ValueError):  # vocabularies differ
        port.project2_logp_topk(h1, w1, b1, h2, w2[:60], b2[:60], 0.1, 3)
    with pytest.raises(ValueError):
        port.project2_logp_topk(h1, w1, b1, h2, w2, b2, 0.1, 129)


@pytest.mark.gpu
@pytest.mark.parametrize("lm_cfg", [
    {"type": "transformer_lm", "vocab_size": 300, "d_model": 32, "n_heads": 4, "d_ff": 48,
     "num_blocks": 2},
    {"type": "rnn_lm", "vocab_size": 300, "num_layers": 2, "hidden_size": 48},
], ids=["transformer_lm", "rnn_lm"])
def test_lm_fusion_decode_runs_through_two_head_kernel(cuda, lm_cfg):
    """A small random model and LM on the card: the fused shallow-fusion
    step launches the two-head kernel once per step, the one-head kernel
    never, and gives the unfused decode's ids."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    torch.manual_seed(0)
    model = build_model(SMALL_CFG, device=cuda)
    lm = build_model(lm_cfg, device=cuda)
    feats = torch.randn(3, 80, 20, device=cuda)
    mask = torch.ones(3, 80, dtype=torch.bool, device=cuda)
    with torch.inference_mode():
        memory, memory_mask = model.encode(feats, mask)
    port.project_logp_topk.launches = port.project2_logp_topk.launches = 0
    fused = make_memory_search(model, 4, 10, lm=lm, lm_weight=0.3, eos_id=-1)(
        memory, memory_mask)
    assert port.project2_logp_topk.launches == 10
    assert port.project_logp_topk.launches == 0
    plain = make_memory_search(model, 4, 10, lm=lm, lm_weight=0.3, eos_id=-1,
                               fused_topk=False)(memory, memory_mask)
    assert torch.equal(fused.tokens, plain.tokens)
    torch.testing.assert_close(fused.scores, plain.scores, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_decode_runs_through_kernel(cuda):
    """A small random model on the card: the beam search's fused step
    launches the kernel once per step and gives the unfused decode's ids."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    torch.manual_seed(0)
    model = build_model(SMALL_CFG, device=cuda)
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


CONFORMER_CFG = {
    "type": "speech2text", "encoder_type": "conformer",
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "nblocks": 2, "cov_kernel_size": 5,
                "chunk_size": 4, "left_chunks": 1, "conv_causal": True,
                "conv_norm_type": "batch"},
    "decoder": {"vocab_size": 300, "d_model": 32, "n_heads": 4, "d_ff": 48, "memory_dim": 32,
                "n_blocks": 2, "activation": "glu", "share_embedding": False}}


@pytest.mark.gpu
def test_conformer_encodes_as_the_cpu_and_decodes_through_kernel(cuda):
    """A small chunked, causal, batch-norm conformer on the card and the same
    weights on the CPU: the memories agree within 1e-4, and the card's beam
    search launches the kernel once per step and gives the unfused ids."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    torch.manual_seed(0)
    model = build_model(CONFORMER_CFG, device=cuda)
    cpu = build_model(CONFORMER_CFG, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    feats = torch.randn(3, 90, 20)
    mask = torch.arange(90)[None] < torch.tensor([90, 70, 41])[:, None]
    with torch.inference_mode():
        memory, memory_mask = model.encode(feats.to(cuda), mask.to(cuda))
        ref, ref_mask = cpu.encode(feats, mask)
    assert torch.equal(memory_mask.cpu(), ref_mask)
    torch.testing.assert_close(memory.cpu(), ref, rtol=0, atol=1e-4)
    port.project_logp_topk.launches = 0
    fused = make_memory_search(model, 4, 10, eos_id=-1)(memory, memory_mask)
    assert port.project_logp_topk.launches == 10
    plain = make_memory_search(model, 4, 10, eos_id=-1, fused_topk=False)(memory, memory_mask)
    assert torch.equal(fused.tokens, plain.tokens)


def _waves(b, n, seed=0, silent_row=None):
    """f32[B, N] of noise plus a tone; row 1 ragged (3/4 of N), zeros after."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    w = (0.05 * rng.normal(size=(b, n)) + 0.3 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    lens = np.full(b, n, np.int32)
    if b > 1:
        lens[1] = 3 * n // 4
        w[1, lens[1]:] = 0.0
    if silent_row is not None:
        w[silent_row] = 0.0
    return torch.from_numpy(w), torch.from_numpy(lens)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,bins,silent", [
    (4, 16000, 40, None), (2, 65536, 40, None), (4, 48000, 80, None), (8, 160000, 40, None),
    (3, 32000, 40, 2)])
def test_fbank_kernel_matches_plain_on_card(cuda, b, n, bins, silent):
    """The fused FFT → power → mel → log kernel against its plain version and
    a float64 spectrum on the same windowed frames: on valid frames within
    1e-3 of the float64 log-mel and 2e-3 of the plain version (a float32 FFT
    and the float32 400-term DFT sums each land up to ~1e-3 from the exact
    result in mel bins that hold only a tone's side lobes; chip_smoke.py,
    FBANK_ATOL), the silent row exactly log(EPSILON)."""
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.utils import disable_tf32

    disable_tf32()
    w, lens = _waves(b, n, seed=n, silent_row=silent)
    frames = fk.extract_frames(w.to(cuda))
    t = frames.shape[1]
    flat_frames = frames.reshape(b * t, -1)
    tab = fk.device_bases(bins, 16000.0, cuda)
    before = fk.spec_mel.launches
    got = fk.spec_mel(flat_frames, tab.mel_t, tab.twiddles, tab.mel_ranges)
    assert fk.spec_mel.launches == before + 1
    ref = fk.spec_mel_plain(flat_frames, tab.cos, tab.sin, tab.mel_t)
    f64 = flat_frames.double()
    cos_b, sin_b, mel_t = tab.cos.double(), tab.sin.double(), tab.mel_t.double()
    exact = torch.log(torch.clamp_min(((f64 @ cos_b).square() + (f64 @ sin_b).square()) @ mel_t,
                                      fk.EPSILON)).float()
    torch.cuda.synchronize()
    valid = (torch.arange(t)[None] < fk.wave_frame_lengths(lens)[:, None]).reshape(-1).to(cuda)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[valid], exact[valid], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[valid], ref[valid], rtol=0, atol=2e-3)
    if silent is not None:
        log_eps = torch.log(torch.tensor(fk.EPSILON))
        assert torch.equal(got.reshape(b, t, bins)[silent].cpu(),
                           torch.full((t, bins), float(log_eps)))


@pytest.mark.gpu
def test_fbank_kernel_rejects_what_it_does_not_take(cuda):
    from opentransformer_tpu_torch.ops import fbank_kernel as fk

    tab = fk.device_bases(40, 16000.0, cuda)
    tables = (tab.mel_t, tab.twiddles, tab.mel_ranges)
    frames = torch.randn(10, 400, device=cuda)
    with pytest.raises(TypeError):
        fk.spec_mel(frames.double(), *tables)
    with pytest.raises(ValueError):  # not contiguous
        fk.spec_mel(torch.randn(400, 10, device=cuda).t(), *tables)
    with pytest.raises(ValueError):  # a window that is not whole 16-byte pieces
        fk.spec_mel(frames[:, :298].contiguous(), *tables)
    with pytest.raises(ValueError):  # a transform size other than 512
        fk.spec_mel(frames[:, :200].contiguous(), tab.mel_t[:129], tab.twiddles[::2].contiguous(),
                    tab.mel_ranges)
    with pytest.raises(ValueError):  # more mel bins than the kernel holds
        fk.spec_mel(frames, torch.zeros(257, 129, device=cuda), tab.twiddles,
                    torch.zeros(129, 3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):  # frames that do not start on 16 bytes
        fk.spec_mel(torch.randn(10 * 400 + 1, device=cuda)[1:].view(10, 400), *tables)


@pytest.mark.gpu
def test_training_micro_batch_runs_through_fbank_kernel(cuda):
    """One training micro-batch of waveforms on the card launches the fbank
    kernel once and gives a finite loss and gradient."""
    from opentransformer_tpu_torch.data.device_pipeline import (
        collate_waveforms,
        make_device_frontend,
    )
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.train.trainer import Trainer

    torch.manual_seed(0)
    model = build_model(SMALL_CFG, device=cuda)
    trainer = Trainer({"accum_steps": 1, "scheduler_type": "constant", "scheduler": {"lr": 1e-3}},
                      model, make_device_frontend({"num_mel_bins": 20, "normalization": True,
                                                   "spec_augment": True}, cuda),
                      torch.Generator(device=cuda).manual_seed(0))
    w, lens = _waves(3, 16000)
    batch = collate_waveforms([(f"u{i}", w[i, : lens[i]].numpy(), int(lens[i]), [3, 4, 5], 3)
                               for i in range(3)])
    model.train()
    before = fk.spec_mel.launches
    loss = trainer.micro_step(batch)
    rec = trainer.update()
    assert fk.spec_mel.launches == before + 1
    assert torch.isfinite(loss) and rec["applied"] and np.isfinite(rec["gnorm"])


CTC_CFG = {
    "type": "ctc", "vocab_size": 300, "lookahead_steps": 2,
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu"}}


@pytest.mark.gpu
def test_ctc_model_runs_through_kernel(cuda):
    """A small random CTC model (look-ahead conv) on the card and the same
    weights on the CPU: greedy ids and the prefix beam's candidates come
    from one kernel launch each and agree with the CPU's plain version
    (ids on untied slots, values and the blank's log-prob within 1e-4)."""
    from opentransformer_tpu_torch.models.registry import build_model

    torch.manual_seed(0)
    model = build_model(CTC_CFG, device=cuda)
    cpu = build_model(CTC_CFG, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    feats = torch.randn(3, 120, 20)
    mask = torch.arange(120)[None] < torch.tensor([120, 90, 61])[:, None]
    with torch.inference_mode():
        port.project_logp_topk.launches = 0
        ids, _ = model.recognize_argmax(feats.to(cuda), mask.to(cuda))
        vals, top, blank, _ = model.recognize_topk(feats.to(cuda), mask.to(cuda), 32)
        assert port.project_logp_topk.launches == 2
        lp, _ = cpu.recognize_logits(feats, mask)
        ref_vals, ref_top, ref_blank, _ = cpu.recognize_topk(feats, mask, 32)
    b, t, v = lp.shape
    flat_lp = lp.reshape(b * t, v)
    wide = torch.sort(flat_lp, dim=-1, descending=True, stable=True)[0][:, :33]
    scale = float(flat_lp.abs().max())
    assert_ids_match(top.reshape(b * t, 32).cpu(), ref_top.reshape(b * t, 32), wide, 32, scale,
                     vals.reshape(b * t, 32).cpu(), flat_lp)
    assert_ids_match(ids.reshape(b * t, 1).cpu(), ref_top.reshape(b * t, 32)[:, :1],
                     wide[:, :2], 1, scale, vals.reshape(b * t, 32)[:, :1].cpu(), flat_lp)
    torch.testing.assert_close(blank.cpu(), ref_blank, rtol=0, atol=1e-4)
    torch.testing.assert_close(vals.cpu(), ref_vals, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_ctc_loss_and_rescoring_on_card_match_cpu(cuda):
    """The CTC loss and gradient on the card equal the CPU's to 1e-5
    relative, for a batch where every row aligns (``F.ctc_loss`` on each
    device) and for one with an infeasible row (optax's recursion, whose
    loss is finite, ~1e5); and so does the joint rescoring (the recursion),
    whose list holds an infeasible hypothesis."""
    from opentransformer_tpu_torch.ops.loss import all_aligned, ctc_loss
    from opentransformer_tpu_torch.recognize.base import ctc_rescore_scores
    from opentransformer_tpu_torch.recognize.beam import BeamHypotheses

    rng = np.random.default_rng(3)
    logits = torch.from_numpy((2 * rng.normal(size=(4, 30, 50))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, 50, size=(4, 8)))
    args = (torch.tensor([30, 24, 17, 5]), labels, torch.tensor([8, 5, 3, 2]))
    # the last row's 7 labels cannot fit its 5 frames
    infeasible = (args[0], labels, torch.tensor([8, 5, 3, 7]))
    for case, aligned in ((args, True), (infeasible, False)):
        label_pad = torch.arange(labels.shape[1])[None] >= case[2][:, None]
        assert all_aligned(case[0], labels, label_pad) is aligned
        grads = []
        for dev in ("cpu", cuda):
            x = logits.to(dev, copy=True).requires_grad_()
            loss = ctc_loss(x, *(a.to(dev) for a in case))
            loss.backward()
            grads.append((loss.item(), x.grad.cpu()))
        assert np.isfinite(grads[0][0]) and (grads[0][0] > 1e3) is not aligned
        assert abs(grads[1][0] - grads[0][0]) <= 1e-5 * abs(grads[0][0])
        torch.testing.assert_close(grads[1][1], grads[0][1], rtol=0,
                                   atol=1e-5 * float(grads[0][1].abs().max()))
    tokens = torch.ones(4, 3, 10, dtype=torch.long)
    tokens[:, :, 1:7] = torch.from_numpy(rng.integers(2, 50, size=(4, 3, 6)))
    hyp = BeamHypotheses(tokens, torch.tensor([[-1.0, -2.0, -3.0]] * 4),
                         torch.tensor([[7, 5, 3]] * 4))
    mask = torch.arange(30)[None] < args[0][:, None]
    out = [ctc_rescore_scores(logits.to(dev), mask.to(dev),
                              BeamHypotheses(*(h.to(dev) for h in hyp)), 0.3)
           for dev in ("cpu", cuda)]
    assert torch.equal(out[1].tokens.cpu(), out[0].tokens)
    torch.testing.assert_close(out[1].scores.cpu(), out[0].scores, rtol=1e-5, atol=0)


STREAM_CTC_CFG = {
    "type": "ctc", "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4,
                                "out_channel": 8},
    "encoder_type": "conformer",
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "nblocks": 2, "cov_kernel_size": 5,
                "conv_causal": True, "chunk_size": 4, "left_chunks": 2},
    "vocab_size": 50}


@pytest.mark.gpu
def test_multistream_ctc_runs_through_kernel(cuda):
    """A small streaming conformer CTC model on the card and the same
    weights on the CPU: three ragged streams through ``MultiStreamCTC``
    (two slots, so one is reused) give the CPU's transcripts, with one
    kernel-1 launch a tick."""
    import threading

    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamCTC

    torch.manual_seed(0)
    model = build_model(STREAM_CTC_CFG, device=cuda)
    cpu = build_model(STREAM_CTC_CFG, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(4)
    utts = [rng.normal(size=(t, 20)).astype(np.float32) for t in (90, 57, 130)]
    got = {}
    for name, m in (("cpu", cpu), ("cuda", model)):
        ms = MultiStreamCTC(m, n_streams=2)
        port.project_logp_topk.launches = 0
        out = [None] * len(utts)

        def run(i, ms=ms, out=out):
            out[i] = ms.run_stream(utts[i], lambda _t: None)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(utts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        got[name] = (out, port.project_logp_topk.launches, ms.ticks)
    assert got["cuda"][0] == got["cpu"][0]
    assert got["cpu"][1] == 0 and got["cuda"][1] == got["cuda"][2] > 0


TRANSDUCER_CFG = {
    "type": "transducer",
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu",
                "chunk_size": 4, "left_chunks": 2},
    "vocab_size": 50, "predictor": {"num_layers": 1, "d_model": 32}, "d_joint": 32}


@pytest.mark.gpu
def test_transducer_greedy_runs_through_kernel(cuda):
    """A small transducer on the card and the same weights on the CPU: the
    offline greedy of three ragged utterances (N = 3) and one stream through
    ``StreamingTransducerRecognizer`` (N = 1) give the CPU's ids, with one
    kernel-1 launch a lattice-loop iteration."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.online import StreamingTransducerRecognizer

    torch.manual_seed(0)
    model = build_model(TRANSDUCER_CFG, device=cuda)
    with torch.no_grad():  # blank the argmax at some lattice steps, not all
        model.joint.output_layer.bias[0] += 0.5
    cpu = build_model(TRANSDUCER_CFG, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(5)
    lens = (90, 57, 130)
    x = np.zeros((3, 130, 20), np.float32)
    for i, t in enumerate(lens):
        x[i, :t] = rng.normal(size=(t, 20))
    mask = np.arange(130)[None] < np.array(lens)[:, None]
    got = {}
    for name, m in (("cpu", cpu), ("cuda", model)):
        dev = next(m.parameters()).device
        port.project_logp_topk.launches, it0 = 0, m.greedy_iterations
        tokens, n = m.greedy_decode(torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev))
        rec = StreamingTransducerRecognizer(m)
        rc = rec.session.raw_chunk
        for s in range(130 // rc):
            rec.feed(x[:1, s * rc:(s + 1) * rc])
        rec.finish(x[:1, (130 // rc) * rc:])
        got[name] = (tokens.cpu().tolist(), n.cpu().tolist(), rec.tokens,
                     port.project_logp_topk.launches, m.greedy_iterations - it0)
    assert got["cuda"][:3] == got["cpu"][:3]
    assert sum(got["cpu"][1]) > 0
    assert got["cpu"][3] == 0 and got["cuda"][3] == got["cuda"][4] > 0


@pytest.mark.gpu
def test_resident_gather_on_card_matches_cpu(cuda):
    """The device-resident corpus gathered on the card: without noise the
    CPU's rows exactly; with noise 0.3 the pads stay 0 and the valid
    frames move."""
    from opentransformer_tpu_torch.data.resident import ResidentCorpus

    rng = np.random.default_rng(4)
    lens = rng.integers(20, 64, size=16).astype(np.int32)
    corpus = torch.zeros(16, 64, 40, dtype=torch.float16)
    for i, n in enumerate(lens):
        corpus[i, :n] = torch.from_numpy(rng.normal(size=(n, 40)).astype(np.float16))
    cfg = {"additive_noise_std": 0.3}
    idx = np.array([3, 0, 15, 7], np.int32)
    y, yl = np.ones((4, 8), np.int32), np.full(4, 3, np.int32)
    got = ResidentCorpus(cfg, corpus, lens, cuda)
    want = ResidentCorpus(cfg, corpus, lens, "cpu")(idx, y, yl, train=False)
    clean = got(idx, y, yl, train=False)
    for a, b in zip(clean, want):
        assert torch.equal(a.cpu(), b)
    noisy, mask, _, _ = got(idx, y, yl, torch.Generator(device=cuda).manual_seed(0), train=True)
    resid = noisy - clean[0]
    assert torch.count_nonzero(resid[~mask]) == 0 and torch.count_nonzero(resid[mask]) > 0
    assert got.nbytes == 16 * 64 * 40 * 2


@pytest.mark.gpu
def test_rnnt_loss_and_gradient_on_card_match_cpu(cuda):
    """The RNN-T loss and its gradient w.r.t. the log-probs on the card
    against the CPU's, at 1e-5 (relative for the loss, absolute for the
    gradient), on a ragged lattice with a U = 0 row and a one-frame row."""
    from opentransformer_tpu_torch.ops.rnnt_loss import rnnt_loss

    rng = np.random.default_rng(5)
    b, t, u, v = 4, 48, 12, 40
    logits = torch.from_numpy((rng.normal(size=(b, t, u + 1, v)) * 3).astype(np.float32))
    lp = torch.log_softmax(logits, dim=-1)
    labels = torch.from_numpy(rng.integers(1, v, size=(b, u)))
    t_lens, u_lens = torch.tensor([48, 30, 1, 17]), torch.tensor([12, 0, 5, 9])
    out = {}
    for dev in ("cpu", cuda):
        x = lp.clone().to(dev).requires_grad_()
        loss = rnnt_loss(x, labels.to(dev), t_lens.to(dev), u_lens.to(dev))
        loss.sum().backward()
        out[str(dev)] = (loss.detach().cpu(), x.grad.cpu())
    (loss_c, grad_c), (loss_g, grad_g) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-5, atol=0)
    torch.testing.assert_close(grad_g, grad_c, rtol=0, atol=1e-5)
    assert torch.isfinite(grad_g).all()


@pytest.mark.gpu
def test_batch_norm_statistics_update_on_card_matches_cpu(cuda):
    """One training forward moves the running averages on the card as on
    the CPU (1e-6 absolute): a BatchNorm conv module in float32, and the
    BatchNorm alone on the same bfloat16 input under bf16 autocast (its
    statistics in float32)."""
    from opentransformer_tpu_torch.models.modules import BatchNorm, ConformerConvModule
    from opentransformer_tpu_torch.utils import disable_tf32

    disable_tf32()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(4, 37, 64)).astype(np.float32))
    pad = torch.from_numpy(np.arange(37)[None] < np.array([37, 30, 9, 1])[:, None])
    torch.manual_seed(0)
    cpu = ConformerConvModule(64, 15, "batch").train()
    card = ConformerConvModule(64, 15, "batch").to(cuda).train()
    card.load_state_dict(cpu.state_dict())
    bn_cpu, bn_card = BatchNorm(64).train(), BatchNorm(64).to(cuda).train()
    xb = (x * 2 + 0.5).to(torch.bfloat16)
    for (m_cpu, m_card), args, autocast in (((cpu, card), (x, pad), False),
                                            ((bn_cpu, bn_card), (xb,), True)):
        got = []
        for m, dev in ((m_cpu, "cpu"), (m_card, cuda)):
            with torch.no_grad(), torch.autocast(torch.device(dev).type, dtype=torch.bfloat16,
                                                 enabled=autocast):
                m(*(a.to(dev) for a in args))
            bn = m.bn if isinstance(m, ConformerConvModule) else m
            got.append((bn.running_mean.cpu(), bn.running_var.cpu()))
        assert got[1][0].dtype == torch.float32
        for a, b in zip(got[0], got[1]):
            assert not torch.equal(a, torch.zeros_like(a))
            torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("m_dtype", [None, "bfloat16"])
def test_fused_mixspeech_update_on_card_matches_cpu(cuda, m_dtype):
    """Two MixSpeech micro-batches of waveforms (fbank kernel on the card,
    its plain version on the CPU) at a fixed λ with the fused update: the
    kernel launches once a micro-batch, and the card's parameters stay
    within 1e-4 of the CPU's (the features differ by the kernel's
    tolerance)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.data.device_pipeline import (
        collate_waveforms,
        make_device_frontend,
    )
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.train.trainer import FusedAdam, Trainer

    # eps 1 keeps Adam's step near-linear in the gradient, so the features'
    # kernel-level differences stay small in the parameters; no dropout
    # (the two devices' generators draw different streams)
    opt = {"betas": [0.9, 0.98], "eps": 1.0, **({"adam_m_dtype": m_dtype} if m_dtype else {})}
    cfg = {"accum_steps": 1, "fused_update": True, "clip_grad": 5.0, "optimizer": opt,
           "scheduler_type": "constant", "scheduler": {"lr": 1e-2}}
    model_cfg = dict(SMALL_CFG, encoder=dict(SMALL_CFG["encoder"], residual_dropout=0.0),
                     decoder=dict(SMALL_CFG["decoder"], residual_dropout=0.0))
    torch.manual_seed(0)
    tree = compat.params_to_jax(build_model(model_cfg, device="cpu"))
    w, lens = _waves(4, 16000)
    batch = collate_waveforms([(f"u{i}", w[i, : lens[i]].numpy(), int(lens[i]), [3, 4, 5], 3)
                               for i in range(4)])
    params = {}
    for dev in ("cpu", cuda):
        model = compat.load_into(build_model(model_cfg, device=dev), tree).train()
        trainer = Trainer(cfg, model, make_device_frontend({"num_mel_bins": 20,
                                                            "normalization": True}, dev),
                          torch.Generator(device=dev).manual_seed(0), mixspeech=True)
        trainer.mix_lambda = lambda: torch.tensor(0.3)
        before = fk.spec_mel.launches
        for _ in range(2):
            trainer.micro_step(batch)
            assert trainer.update()["applied"]
        assert isinstance(trainer.optimizer, FusedAdam) and trainer.optimizer.count == 2
        assert fk.spec_mel.launches == before + (2 if dev == cuda else 0)
        params[str(dev)] = trainer.optimizer.flat.cpu()
    torch.testing.assert_close(params["cuda"], params["cpu"], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_reference_round_trip_decodes_through_kernel_on_card(cuda, tmp_path):
    """A small model exported to a reference .pt and imported on the card
    is bitwise the same, and its cached top-k decode launches kernel 1."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    torch.manual_seed(0)
    cfg = dict(SMALL_CFG, encoder=dict(SMALL_CFG["encoder"], concat_after=True),
               decoder=dict(SMALL_CFG["decoder"], concat_after=True))
    model = build_model(cfg, device=cuda)
    path = str(tmp_path / "m.pt")
    torch.save(compat.export_reference_checkpoint(model, {"model": cfg}), path)
    state, _ = compat.load_reference_any(path)
    back = build_model(cfg, device=cuda)
    back.load_state_dict(state, strict=True)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 back.state_dict().values()))
    x = torch.randn(2, 80, 20, device=cuda)
    m = torch.ones(2, 80, dtype=torch.bool, device=cuda)
    before = port.project_logp_topk.launches
    with torch.inference_mode():
        mem, mm = back.encode(x, m)
        hyp = make_memory_search(back, 3, 6, eos_id=-1)(mem, mm)
    assert port.project_logp_topk.launches - before == 6 and torch.isfinite(hyp.scores).all()


@pytest.mark.gpu
def test_moe_forward_and_backward_on_card_match_cpu(cuda):
    """One MoE FFN (4 experts, top-2, capacity 1.25, ragged pads) forward
    and backward on the card against the CPU from the same weights: the
    routing (every choice's expert and kept state) equal, the output, the
    aux and every gradient within 1e-5 relative to their scale; and under
    bf16 autocast the router still computes in float32 (its probabilities
    equal the float32 ones)."""
    from opentransformer_tpu_torch.models.modules import MoEFeedForward
    from opentransformer_tpu_torch.utils import disable_tf32

    disable_tf32()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(4, 53, 64)).astype(np.float32))
    pad = torch.from_numpy(np.arange(53)[None] < np.array([53, 40, 17, 1])[:, None])
    torch.manual_seed(0)
    cpu = MoEFeedForward(64, 96, n_experts=4, top_k=2, capacity_factor=1.25, activation="glu")
    card = MoEFeedForward(64, 96, n_experts=4, top_k=2, capacity_factor=1.25,
                          activation="glu").to(cuda)
    card.load_state_dict(cpu.state_dict())
    out = {}
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        xi = x.clone().to(dev).requires_grad_()
        y, aux = m(xi, pad.to(dev))
        (y.square().sum() + 0.01 * aux).backward()
        r = m.route(xi.detach(), pad.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (r.experts, r.kept, y, aux, xi.grad,
                                                    *(p.grad for p in m.parameters()))]
    c, g = out["cpu"], out[str(cuda)]
    assert torch.equal(g[0], c[0]) and torch.equal(g[1], c[1]) and not c[1].all()
    for a, b in zip(c[2:], g[2:]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5 * max(a.abs().max().item(), 1e-6))
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        r16 = card.route(x.to(cuda), pad.to(cuda))
    with torch.no_grad():
        r32 = card.route(x.to(cuda), pad.to(cuda))
    assert r16.probs.dtype == torch.float32 and torch.equal(r16.probs, r32.probs)


PARALLEL_CFG = {
    "type": "speech2text",
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu",
                "residual_dropout": 0.0, "scan_layers": True},
    "decoder": {"vocab_size": 300, "d_model": 32, "n_heads": 4, "d_ff": 48, "memory_dim": 32,
                "n_blocks": 1, "residual_dropout": 0.0}}


def parallel_batch():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(4, 40, 20)).astype(np.float32)
    mask = np.arange(40)[None] < np.array([40, 33, 29, 36])[:, None]
    tgt = rng.integers(3, 300, size=(4, 8)).astype(np.int64)
    tgt[:, 0], tgt[:, 7] = 1, 1
    return None, {"inputs": feats, "mask": mask}, {"targets": tgt,
                                                   "targets_length": np.full(4, 7)}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["data", "tensor", "pipe sharded", "pipe 1f1b", "expert"])
def test_parallel_mode_at_world_one_over_nccl_matches_the_plain_step(cuda, mode):
    """Each parallel mode on a world of one rank over NCCL (the mesh's
    collectives over one rank): one micro-batch's loss and one-card
    gradients equal the plain trainer's on the card (1F1B: its loss rule,
    two row blocks with the loss over 2), within 1e-5 relative."""
    import torch.distributed as dist

    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.parallel import launch
    from opentransformer_tpu_torch.parallel.mesh import make_mesh
    from opentransformer_tpu_torch.train.trainer import Trainer

    cfg = PARALLEL_CFG
    if mode == "expert":
        cfg = dict(cfg, encoder=dict(cfg["encoder"], moe_experts=4, moe_top_k=2))
    tcfg = {"optimizer_type": "adam", "optimizer": {}, "scheduler_type": "constant",
            "scheduler": {"lr": 1e-3}}

    def model():
        torch.manual_seed(3)
        return build_model(cfg, device="cuda").train()

    plain = Trainer(dict(tcfg), model(), None, torch.Generator(device="cuda"))
    args = plain.batch_args(parallel_batch())
    blocks = 2 if mode == "pipe 1f1b" else 1
    want = 0.0
    for m in range(blocks):
        loss, _ = plain.model(*(a[2 * m : 2 * m + 4 // blocks] for a in args))
        (loss / blocks).backward()
        want += loss.item() / blocks
    ref = {n: p.grad for n, p in plain.model.named_parameters()}
    launch.init_single("nccl")
    try:
        pipe = (dict(pp_schedule="1f1b", pp_micro_batches=2) if mode == "pipe 1f1b"
                else dict(pp_schedule="sharded"))
        trainer = Trainer(dict(tcfg, **pipe), model(), None, torch.Generator(device="cuda"),
                          mesh=make_mesh(1, 1, 1, 1))
        assert dist.get_backend() == "nccl" and trainer.mesh.world == 1
        got = float(trainer.micro_step(parallel_batch()))
        trainer.parallel.sync_grads(trainer.optimizer)
        grads = trainer.parallel.gather_grads()
    finally:
        launch.shutdown()
    assert abs(got - want) <= 1e-5 * abs(want)
    for name, g in ref.items():
        torch.testing.assert_close(grads[name], g, rtol=1e-5, atol=1e-5 * float(g.abs().max()),
                                   msg=name)


@pytest.mark.gpu
def test_program_spans_time_the_device_inside_a_window(cuda):
    """A beam search and multi-stream ticks run from threads, inside
    ``profiling.Window`` on the card: ``w.spans`` holds the program's spans,
    ``beam.decode`` and ``multistream.advance`` with device milliseconds
    from their CUDA events, the ticks' spans from the threads that ticked;
    the same calls outside a window record nothing."""
    import threading

    from opentransformer_tpu_torch import profiling
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import make_memory_search
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamCTC

    torch.manual_seed(0)
    model = build_model(SMALL_CFG, device=cuda).eval()
    streamer = build_model(STREAM_CTC_CFG, device=cuda)
    x = torch.randn(4, 64, 20, device=cuda)
    search = make_memory_search(model, 3, 8, eos_id=-1)
    rng = np.random.default_rng(5)
    utts = [rng.normal(size=(t, 20)).astype(np.float32) for t in (90, 57, 130)]

    def work():
        with torch.inference_mode():
            memory, mask = model.encode(x, torch.ones(4, 64, dtype=torch.bool, device=cuda))
            hyp = search(memory, mask)
        ms = MultiStreamCTC(streamer, n_streams=2)
        threads = [threading.Thread(target=ms.run_stream, args=(u, lambda _t: None))
                   for u in utts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        return hyp, ms.ticks

    profiling.reset()
    off, _ = work()
    assert profiling.spans() == []
    with profiling.Window(cuda) as w:
        on, ticks = work()
    assert torch.equal(on.tokens, off.tokens) and torch.equal(on.scores, off.scores)
    names = {}
    for s in w.spans:
        names.setdefault(s.name, []).append(s)
    assert len(names["beam.decode"]) == 8 and len(names["multistream.tick"]) == ticks > 0
    for name in ("beam.decode", "multistream.advance"):
        assert all(s.device_ms is not None and s.device_ms > 0 for s in names[name])
    assert all(s.device_ms is None for s in names["beam.select"] + names["multistream.pack"])
    assert len(names["beam.wait"]) == 8 and len(names["beam.search"]) == 1
    profiling.reset()


def _beam_case(b, k, h, dh, n_pos, dtype, seed, entry):
    """Inputs of one beam attention entry on the card, in the layouts the
    decoder hands over (``chip_smoke.beam_attention_case``, which phase 1c
    holds to the same limit)."""
    import chip_smoke

    return chip_smoke.beam_attention_case(entry, b, k, h, dh, n_pos, dtype, seed, cuda_device())


def cuda_device():
    return torch.device("cuda")


def assert_beam_context_close(got, ref, weighted_abs):
    """The kernel's context against the plain version's, each rounded once
    to the output type from float32 sums taken in another order
    (``chip_smoke.beam_context_gap`` states the room and why). bf16: within
    one bf16 rounding step at the element's magnitude plus 2⁻⁷·Σw·|v|, and
    at least 99% of the elements equal; float32: within 1e-5 of the (beam,
    head) row's largest magnitude."""
    import chip_smoke

    worst, equal = chip_smoke.beam_context_gap(got, ref, weighted_abs)
    assert worst <= 1.0, f"{worst} of the room"
    if ref.dtype == torch.bfloat16:
        assert equal >= 0.99, equal


@pytest.mark.gpu
@pytest.mark.parametrize("entry,b,k,h,dh,n_pos,dtype", [
    # the offline decode cell: B = 1,024, beam 5, d256 over 4 heads; the
    # shortest and longest buckets' frames, the first and the 54th step
    ("cross", 1024, 5, 4, 64, 62, torch.bfloat16),
    ("cross", 1024, 5, 4, 64, 374, torch.bfloat16),
    ("self", 1024, 5, 4, 64, 1, torch.bfloat16),
    ("self", 1024, 5, 4, 64, 54, torch.bfloat16),
    # float32 models (the eval CLI's default --dtype), d128 and d384 over 4 heads
    ("cross", 1024, 5, 4, 32, 374, torch.float32),
    ("cross", 1024, 5, 4, 96, 374, torch.float32),
    ("self", 1024, 5, 4, 32, 54, torch.float32),
    ("self", 1024, 5, 4, 96, 54, torch.float32),
    # greedy (K = 1), a beam split into chunks, scores past the on-chip budget
    # (the two-pass kernel's; bf16 cross calls take the one-pass entry)
    ("cross", 64, 1, 4, 64, 200, torch.bfloat16),
    ("cross", 64, 12, 4, 64, 120, torch.bfloat16),
    ("self", 64, 12, 4, 64, 30, torch.bfloat16),
    ("cross", 32, 5, 4, 64, 3000, torch.bfloat16),
    ("self", 16, 5, 8, 96, 1800, torch.bfloat16),
    # Whisper large-v3's long-form step: 128 windows, beam 5, 20 heads of 64,
    # 1,500-frame cross caches, and the self caches at the 129th step
    ("cross", 128, 5, 20, 64, 1500, torch.bfloat16),
    ("self", 128, 5, 20, 64, 129, torch.bfloat16),
])
def test_beam_attention_kernel_matches_plain_on_card(cuda, entry, b, k, h, dh, n_pos, dtype):
    """Each entry against its plain version: the two-pass kernel (float32
    cross calls, every self call) within ``assert_beam_context_close``; the
    one-pass entry (bf16 cross calls) rounds its weights at another point,
    so it is held to the float64 attention instead, within twice the plain
    version's own distance (``chip_smoke.beam_cross_errors``)."""
    import chip_smoke
    from opentransformer_tpu_torch.ops import beam_attention as ba

    args = _beam_case(b, k, h, dh, n_pos, dtype, seed=b + k + dh + n_pos, entry=entry)
    if entry == "cross":
        q, key, value, mask = args
        before = ba.beam_cross_attention.launches, ba.beam_cross_attention.one_pass_launches
        got = ba.beam_cross_attention(*args, dtype)
        one_pass = dtype == torch.bfloat16
        assert (ba.beam_cross_attention.launches,
                ba.beam_cross_attention.one_pass_launches) == (before[0] + 1,
                                                               before[1] + one_pass)
        torch.cuda.synchronize()
        assert got.shape == (b * k, h, dh)
        if one_pass:
            err, plain_err = chip_smoke.beam_cross_errors(got, *args)
            assert err <= 2.0 * plain_err, (err, plain_err)
            return
        ref = ba.cross_attention_plain(*args, dtype)
        weighted_abs = ba.cross_attention_plain(q, key, value.abs(), mask, dtype)
    else:
        q, k_t, v_t, cache_k, cache_v, index, src = args
        ref_k, ref_v = cache_k.clone(), cache_v.clone()
        ref = ba.self_attention_plain(q, k_t, v_t, ref_k, ref_v, index, src)
        weighted_abs = ba.self_attention_plain(q, k_t, v_t.abs(), cache_k.clone(), cache_v.abs(),
                                               index, src)
        before = ba.beam_self_attention.launches
        got = ba.beam_self_attention(*args)
        assert ba.beam_self_attention.launches == before + 1
        assert torch.equal(cache_k, ref_k) and torch.equal(cache_v, ref_v)
    torch.cuda.synchronize()
    assert got.shape == (b * k, h, dh)
    assert_beam_context_close(got, ref, weighted_abs)


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,h,dh,t,empty", [
    # frame counts at and around the 16-frame tiles and the four warps' 64
    *[(64, 5, 4, 64, t, False) for t in (1, 15, 16, 17, 63, 64, 65)],
    # the decode cell's longest bucket and Whisper's 1,500-frame caches
    (1024, 5, 4, 64, 374, False),
    (16, 5, 20, 64, 1499, False),
    (128, 5, 20, 64, 1500, False),
    # an utterance all padding (uniform weights over its frames)
    (64, 5, 4, 64, 65, True),
    (64, 8, 4, 64, 374, True),
    # greedy, a full block of 8 and of 16 beams, a beam split into chunks
    (64, 1, 4, 64, 374, False),
    (64, 8, 4, 64, 120, False),
    (16, 16, 4, 64, 300, False),
    (32, 20, 4, 64, 120, False),
    # the other head widths
    (64, 5, 4, 32, 300, False),
    (16, 5, 8, 96, 200, True),
    (16, 5, 8, 128, 500, False),
    (16, 20, 8, 128, 77, False),
])
def test_beam_attention_one_pass_cross_on_card(cuda, b, k, h, dh, t, empty):
    """The one-pass cross entry on the strided [B, T, H, Dh] → [B, H, T, Dh]
    views ``split_heads`` makes, with ragged key padding (and, where
    ``empty``, an utterance all padding): its largest |Δ| from the float64
    attention within twice the plain version's own, and two launches bit
    for bit the same."""
    import chip_smoke
    from opentransformer_tpu_torch.ops import beam_attention as ba

    q, key, value, mask = chip_smoke.beam_attention_case("cross", b, k, h, dh, t, torch.bfloat16,
                                                         b + k + dh + t, cuda_device(),
                                                         empty_row=empty)
    before = ba.beam_cross_attention.one_pass_launches
    got = ba.beam_cross_attention(q, key, value, mask)
    again = ba.beam_cross_attention(q, key, value, mask)
    torch.cuda.synchronize()
    assert ba.beam_cross_attention.one_pass_launches == before + 2
    assert got.shape == (b * k, h, dh) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    err, plain_err = chip_smoke.beam_cross_errors(got, q, key, value, mask)
    assert err <= 2.0 * plain_err, (err, plain_err)


@pytest.mark.gpu
def test_beam_attention_rejects_what_it_does_not_take(cuda):
    from opentransformer_tpu_torch.ops import beam_attention as ba

    q, key, value, mask = _beam_case(4, 5, 4, 64, 20, torch.bfloat16, 0, "cross")
    with pytest.raises(TypeError):
        ba.beam_cross_attention(q.half(), key.half(), value.half(), mask)
    with pytest.raises(TypeError):  # k in another type than q
        ba.beam_cross_attention(q, key.float(), value.float(), mask)
    with pytest.raises(ValueError):  # Dh not innermost
        ba.beam_cross_attention(q, key.transpose(2, 3), value.transpose(2, 3), mask)
    with pytest.raises(ValueError):
        ba.beam_cross_attention(q, key, value, mask.int())
    q, k_t, v_t, cache_k, cache_v, index, src = _beam_case(4, 5, 4, 64, 6, torch.bfloat16, 0,
                                                           "self")
    with pytest.raises(ValueError):
        ba.beam_self_attention(q, k_t, v_t, cache_k, cache_v, index, src.int())
    with pytest.raises(ValueError):
        ba.beam_self_attention(q, k_t, v_t, cache_k, cache_v, cache_k.shape[2], src)
    with pytest.raises(TypeError):
        ba.beam_self_attention(q, k_t, v_t, cache_k.float(), cache_v.float(), index, src)
    with pytest.raises(RuntimeError):  # Dh past the 32 lanes a row may take
        big = torch.zeros(20, 1, 512, dtype=torch.bfloat16, device=cuda)
        ba.beam_cross_attention(big, torch.zeros(4, 1, 8, 512, dtype=torch.bfloat16,
                                                 device=cuda),
                                torch.zeros(4, 1, 8, 512, dtype=torch.bfloat16, device=cuda))


@pytest.mark.gpu
def test_six_block_beam_step_launches_the_attention_kernel_twelve_times(cuda):
    """One beam step of a 6-block decoder: each block's self and cross
    attention through the kernel, 12 launches, and the same top-k as the
    plain versions run on the card."""
    from opentransformer_tpu_torch.models import modules
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import beam_attention as ba

    torch.manual_seed(0)
    cfg = dict(SMALL_CFG, decoder=dict(SMALL_CFG["decoder"], n_blocks=6))
    model = build_model(cfg, device=cuda, dtype=torch.bfloat16).eval()
    b, k, steps = 3, 5, 4
    x = torch.randn(b, 80, 20, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(b, 80, dtype=torch.bool, device=cuda)
    src = torch.arange(k, device=cuda)[None, :, None].repeat(b, 1, steps + 1)
    tokens = torch.randint(0, 300, (b * k,), device=cuda)
    with torch.inference_mode():
        memory, memory_mask = model.encode(x, mask)
        tops = []
        for plain in (False, True):
            if plain:
                cross, self_ = modules.beam_cross_attention, modules.beam_self_attention
                modules.beam_cross_attention = ba.cross_attention_plain
                modules.beam_self_attention = ba.self_attention_plain
            try:
                cache = model.init_cache(memory, steps + 1, k)
                before = ba.beam_cross_attention.launches + ba.beam_self_attention.launches
                vals, ids, _ = model.decode_step_topk(tokens, cache, 0, memory_mask, src, k)
                launched = (ba.beam_cross_attention.launches + ba.beam_self_attention.launches
                            - before)
                tops.append((vals, ids))
            finally:
                if plain:
                    modules.beam_cross_attention, modules.beam_self_attention = cross, self_
            assert launched == (0 if plain else 12)
    torch.testing.assert_close(tops[0][0], tops[1][0], rtol=0, atol=0.05)


@pytest.mark.gpu
def test_anchor_beam_decode_through_the_kernel_gives_the_plain_n_best(cuda, monkeypatch):
    """The committed anchor (float32, d128 over 4 heads) decodes the first
    100 synthetic test utterances at beam 5 on the card through the beam
    attention kernel, then through the plain versions on the card: the
    same n-best ids."""
    import json
    import os

    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.cli.eval import collate
    from opentransformer_tpu_torch.data import synth
    from opentransformer_tpu_torch.models import modules
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import beam_attention as ba
    from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer

    anchor = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "egs",
                          "synth_bench", "trained", "anchor_synth_f16")
    with open(anchor + ".manifest.json", encoding="utf-8") as f:
        cfg = json.load(f)["model_cfg"]
    model = compat.load_into(build_model(cfg, device=cuda), compat.load_npz(anchor + ".npz"))
    x, mask, _ = collate([u[1] for u in list(synth.gen_split("test", 100))])
    x, mask = torch.from_numpy(x).to(cuda), torch.from_numpy(mask).to(cuda)
    rec = SpeechToTextRecognizer(model, beam_width=5, max_len=32, penalty=0.6)
    before = ba.beam_self_attention.launches
    fast = rec.recognize_arrays(x, mask)
    assert ba.beam_self_attention.launches > before
    monkeypatch.setattr(modules, "beam_cross_attention", ba.cross_attention_plain)
    monkeypatch.setattr(modules, "beam_self_attention", ba.self_attention_plain)
    plain = rec.recognize_arrays(x, mask)
    assert torch.equal(fast.tokens, plain.tokens)
    torch.testing.assert_close(fast.scores, plain.scores, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_beam_attention_takes_the_raw_stream_binding(cuda):
    """A CUDA build of torch has the private binding that ``cuda_build``
    looks up once at import for the kernels' wrappers, and it gives the
    current stream's handle."""
    from opentransformer_tpu_torch.ops import cuda_build

    assert hasattr(torch._C, "_cuda_getCurrentRawStream")
    assert cuda_build.current_stream is torch._C._cuda_getCurrentRawStream
    index = torch.cuda.current_device()
    assert cuda_build.current_stream(index) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert cuda_build.current_stream(index) == side.cuda_stream


# ---- kernel 5: self-attention at inference (ops/encoder_attention.py)

@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t_q,t_k,dh,mask,empty", [
    # the long-form cell's slice: 22 Whisper windows, 20 heads of 64, all keys valid
    (22, 20, 1500, 1500, 64, "full", False),
    # the decode cell's longest bucket: 1,024 utterances, 4 heads of 64, key padding
    (1024, 4, 374, 374, 64, "ragged", False),
    # the other head widths, T_q != T_k (the cached step without a beam:
    # T_q = 1), a row with no valid key, a mask with holes
    (64, 4, 300, 300, 32, "ragged", False),
    (16, 8, 500, 500, 128, "ragged", False),
    (8, 4, 77, 250, 64, "ragged", False),
    (6, 4, 1, 129, 64, None, False),
    (6, 4, 200, 200, 64, "ragged", True),
    (6, 4, 200, 200, 128, "holes", False),
    (6, 4, 3, 7, 32, "ragged", False),  # fewer keys than a tile's rows
])
def test_encoder_attention_kernel_within_twice_the_composition(cuda, b, h, t_q, t_k, dh, mask,
                                                               empty):
    """Kernel 5 against the float64 attention of the same bf16 inputs (the
    head splits of a fused QKV projection's output, ``chip_smoke``'s case):
    its largest |Δ| is at most twice the plain composition's own. Both round
    the weights and the context to bf16, at other points (the kernel rounds
    the unnormalised weights and divides by the float32 sum at the end), so
    neither is the other's reference; the exact value is."""
    import chip_smoke
    from opentransformer_tpu_torch.ops import encoder_attention as ea

    q, k, v, m = chip_smoke.encoder_attention_case(b, h, t_q, t_k, dh, seed=b + h + t_q + dh,
                                                   mask=mask, empty_row=empty)
    before = ea.encoder_self_attention.launches
    got = ea.encoder_self_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert ea.encoder_self_attention.launches == before + 1
    assert got.shape == (b, h, t_q, dh) and got.dtype == torch.bfloat16
    err, plain_err = chip_smoke.encoder_attention_errors(got, q, k, v, m)
    assert err <= 2.0 * plain_err, (err, plain_err)


@pytest.mark.gpu
def test_encoder_attention_short_rows_back_to_back(cuda):
    """Rows of 1 to 130 valid keys at the decode cell's shape, launched
    back to back: every block exits with tiles it loaded ahead and never
    used, and each launch gives the first one's context bit for bit."""
    import chip_smoke
    from opentransformer_tpu_torch.ops import encoder_attention as ea

    q, k, v, m = chip_smoke.encoder_attention_case(1024, 4, 374, 374, 64, seed=7, mask="short")
    first = ea.encoder_self_attention(q, k, v, m)
    assert chip_smoke.encoder_attention_repeats_differing(q, k, v, m, first) == 0
    err, plain_err = chip_smoke.encoder_attention_errors(first, q, k, v, m)
    assert err <= 2.0 * plain_err, (err, plain_err)


@pytest.mark.gpu
def test_encoder_attention_rejects_what_it_does_not_take(cuda):
    import chip_smoke
    from opentransformer_tpu_torch.ops import encoder_attention as ea
    from opentransformer_tpu_torch.ops.masks import causal_mask

    q, k, v, m = chip_smoke.encoder_attention_case(2, 4, 64, 64, 64, seed=0)
    with pytest.raises(TypeError):
        ea.encoder_self_attention(q.half(), k.half(), v.half(), m)
    with pytest.raises(ValueError):  # Dh not innermost
        ea.encoder_self_attention(q, k.transpose(2, 3), v.transpose(2, 3), m)
    with pytest.raises(ValueError):  # a causal mask
        ea.encoder_self_attention(q, k, v, causal_mask(64, cuda))
    with pytest.raises(ValueError):  # the mask on another device
        ea.encoder_self_attention(q, k, v, m.cpu())
    q96, k96, v96, _ = chip_smoke.encoder_attention_case(2, 4, 16, 16, 96, seed=0)
    with pytest.raises(ValueError):
        ea.encoder_self_attention(q96, k96, v96)


def _seeded_on_card(model, seed):
    """Normal weights drawn on the card: LayerNorm gains 1, other vectors
    0.02, matrices and embeddings 1/sqrt(fan-in)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = torch.randn(p.shape, generator=g, device="cuda")
            if p.dim() > 1:
                x /= float(np.prod(p.shape[1:])) ** 0.5
            elif "norm" in name and name.endswith("weight"):
                x = torch.ones_like(x)
            else:
                x *= 0.02
            p.copy_(x)
    return model


@pytest.mark.gpu
def test_whisper_width_encode_and_long_form_search_through_kernel_five(cuda, monkeypatch):
    """Whisper large-v3 at its widths in bf16: one slice's encode launches
    kernel 5 once per encoder block (32) and lies as close to the float32
    encode of the same weights as the plain composition's bf16 encode does
    (within twice its distance: both round at other points over 32 blocks);
    ``recognize_arrays`` on two 30-s windows at beam 5 gives the plain
    path's 1-best and its n-best: a hypothesis in both scores the same
    within 1e-3 relative (the two encodes round to bf16 at other points;
    gaps of up to 8.6e-4 were seen), and one in only one of them lost at
    the cut, to a hypothesis within twice that (seeded weights leave the
    fifth hypothesis of each window tied that close with the next)."""
    from opentransformer_tpu_torch.config import CONF_DIR, load_config
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import encoder_attention as ea
    from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer

    cfg = load_config(os.path.join(CONF_DIR, "whisper_large_v3.json"))["model"]
    model = _seeded_on_card(build_model(cfg, device=cuda, dtype=torch.bfloat16).eval(), 22)
    g = torch.Generator(device="cuda").manual_seed(5)
    feats = torch.randn(2, 3000, cfg["frontend"]["input_size"], generator=g,
                        device=cuda).to(torch.bfloat16)
    mask = torch.ones(2, 3000, dtype=torch.bool, device=cuda)
    rec = SpeechToTextRecognizer(model, beam_width=5, max_len=8, penalty=0.6,
                                 eos_id=cfg["decoder"]["vocab_size"])
    with torch.inference_mode():
        before = ea.encoder_self_attention.launches
        memory, _ = rec.encode(feats[:1], mask[:1])
        assert ea.encoder_self_attention.launches - before == cfg["encoder"]["n_blocks"] == 32
        fast = rec.recognize_arrays(feats, mask)
        with monkeypatch.context() as plain_path:
            plain_path.setattr(ea, "takes", lambda *args: False)
            plain_memory, _ = rec.encode(feats[:1], mask[:1])
            plain = rec.recognize_arrays(feats, mask)
        assert ea.encoder_self_attention.launches - before == 2 * 32  # none on the plain path
        exact, _ = model.float().encode(feats[:1].float(), mask[:1])  # the composition

    def gap(x):
        return float((x.float() - exact).norm() / exact.norm())

    assert gap(memory) <= 2.0 * gap(plain_memory), (gap(memory), gap(plain_memory))
    assert torch.equal(fast.tokens[:, 0], plain.tokens[:, 0]), (fast.tokens, plain.tokens)
    tol = 1e-3
    for w in range(fast.tokens.shape[0]):
        nbest = [{tuple(t.tolist()): float(s) for t, s in zip(hyp.tokens[w], hyp.scores[w])}
                 for hyp in (fast, plain)]
        for one, other in (nbest, nbest[::-1]):
            cut = min(other.values())
            for tokens, score in one.items():
                if tokens in other:
                    assert abs(score - other[tokens]) <= tol * abs(other[tokens]), (w, nbest)
                else:
                    assert abs(score - cut) <= 2 * tol * abs(cut), (w, nbest)
