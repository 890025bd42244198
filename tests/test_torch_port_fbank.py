"""The port's fbank, device frontend and SpecAugment against the JAX package,
on the CPU (the kernel's plain version; the CUDA kernel itself is held
against it on the card by ``tests/test_torch_port_gpu.py`` and
``chip_smoke.py``).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: the numpy fbank copy is the JAX package's code, so its output
is identical; the batched log-mel is float32 on both sides (dense DFT
products here, FFT or dense products under XLA) and agrees within 1e-3 on
valid frames, the bound the JAX package's own device-frontend test uses;
SpecAugment fed JAX's uniforms gives identical masks.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opentransformer_tpu.data.augment import spec_augment_jax
from opentransformer_tpu.data.device_pipeline import make_device_frontend as jax_frontend
from opentransformer_tpu.ops import fbank as jax_fbank
from opentransformer_tpu.ops.fbank_pallas import _bases as jax_bases
from opentransformer_tpu.ops.fbank_pallas import fbank_pallas_batch
from opentransformer_tpu_torch.data.augment import spec_augment, spec_augment_from_uniforms
from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
from opentransformer_tpu_torch.ops import fbank, fbank_kernel

ATOL = 1e-3
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "opentransformer_tpu_torch", "csrc", "fbank_spec_mel.cu")


def wave_batch(lengths, n=None, seed=0, silent_row=None):
    """f32[B, N] of noise plus a tone per row, zero past each length."""
    rng = np.random.default_rng(seed)
    n = n or max(lengths)
    w = np.zeros((len(lengths), n), np.float32)
    t = np.arange(n) / 16000.0
    for i, m in enumerate(lengths):
        tone = 0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t[:m])
        w[i, :m] = (0.05 * rng.normal(size=m) + tone).astype(np.float32)
    if silent_row is not None:
        w[silent_row] = 0.0
    return w, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("n,bins", [(16000, 40), (11200, 80), (399, 40), (400, 23), (48123, 40)])
def test_numpy_fbank_copy_is_exact(n, bins):
    wav = wave_batch([n], seed=n)[0][0]
    np.testing.assert_array_equal(fbank.fbank_numpy(wav, num_mel_bins=bins),
                                  jax_fbank.fbank_numpy(wav, num_mel_bins=bins))
    np.testing.assert_array_equal(fbank.mel_banks(bins, 512, 16000.0),
                                  jax_fbank.mel_banks(bins, 512, 16000.0))
    np.testing.assert_array_equal(fbank.povey_window(400), jax_fbank.povey_window(400))
    assert fbank.num_frames(n) == jax_fbank.num_frames(n)
    feats = fbank.fbank_numpy(wav, num_mel_bins=bins)
    if feats.size:
        np.testing.assert_array_equal(fbank.normalize_per_utterance(feats),
                                      jax_fbank.normalize_per_utterance(feats))


@pytest.mark.parametrize("bins", [40, 80])
def test_bases_are_the_jax_kernels_without_lane_padding(bins):
    cos_b, sin_b, mel_t = fbank_kernel.bases(bins)
    jcos, jsin, jmel = jax_bases(400, 512, bins, 16000.0)
    assert cos_b.shape == (400, 257) and mel_t.shape == (257, bins)
    np.testing.assert_array_equal(cos_b, jcos[:400, :257])
    np.testing.assert_array_equal(sin_b, jsin[:400, :257])
    np.testing.assert_array_equal(mel_t, jmel[:257, :bins])
    assert not jcos[400:].any() and not jcos[:, 257:].any() and not jmel[257:].any()


@pytest.mark.parametrize("lengths,n,bins,silent", [
    ([8000, 4800], 8000, 40, None),
    ([16000, 11200, 9001], 16000, 80, None),
    ([6000, 6000], 6000, 40, 1),
    ([300, 700], 1000, 40, None),
], ids=["ragged-40", "ragged-80", "silent-row", "shorter-than-a-window"])
def test_fbank_batch_matches_jax_pallas_and_jnp(lengths, n, bins, silent):
    w, lens = wave_batch(lengths, n, seed=len(lengths), silent_row=silent)
    launches = fbank_kernel.spec_mel.launches
    feats, flens = fbank_kernel.fbank_batch(torch.from_numpy(w), torch.from_numpy(lens), bins)
    assert fbank_kernel.spec_mel.launches == launches  # CPU tensors: the plain version
    feats, flens = feats.numpy(), flens.numpy()
    with pltpu.force_tpu_interpret_mode():
        pf, pl = fbank_pallas_batch(jnp.asarray(w), jnp.asarray(lens), num_mel_bins=bins)
    jf, jl = jax_fbank.fbank_jax(jnp.asarray(w), jnp.asarray(lens), num_mel_bins=bins)
    pf, jf = np.asarray(pf), np.asarray(jf)
    assert feats.shape == pf.shape == jf.shape
    np.testing.assert_array_equal(flens, np.asarray(pl))
    np.testing.assert_array_equal(flens, np.asarray(jl))
    for i, t in enumerate(flens):
        np.testing.assert_allclose(feats[i, :t], pf[i, :t], rtol=0, atol=ATOL)
        np.testing.assert_allclose(feats[i, :t], jf[i, :t], rtol=0, atol=ATOL)
        host = fbank.fbank_numpy(w[i, : lens[i]], num_mel_bins=bins)
        np.testing.assert_allclose(feats[i, :t], host, rtol=0, atol=ATOL)
    if silent is not None:
        assert np.all(feats[silent] == np.float32(np.log(fbank.EPSILON)))


def test_spec_mel_dispatch_and_checks():
    cos_b, sin_b, mel_t = (torch.from_numpy(b) for b in fbank_kernel.bases(40))
    frames = torch.randn(5, 400, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(fbank_kernel.spec_mel(frames, cos_b, sin_b, mel_t),
                               fbank_kernel.spec_mel_plain(frames, cos_b, sin_b, mel_t),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        fbank_kernel.spec_mel(frames.to("meta"), cos_b, sin_b, mel_t)


def test_kernel_source_does_its_own_float32_products():
    """The CUDA kernel computes DFT → power → mel → log itself with FMA: no
    tensor-core instruction, TF32 conversion, library product or FFT."""
    with open(CSRC) as f:
        code = re.sub(r"//[^\n]*", "", f.read())  # the comments may name what it avoids
    for banned in ("mma", "wgmma", "wmma", "tf32", "cublas", "cufft", "cutlass", "#include <cu"):
        assert banned not in code.lower().replace("cuda_runtime", ""), banned
    assert code.count("fmaf(") >= 5 and "logf(fmaxf(" in code


def _frontend_pair(cfg, w, lens, train=False, key=0):
    jf, jm = jax_frontend(cfg)(jnp.asarray(w), jnp.asarray(lens), jax.random.PRNGKey(key),
                               train=train)
    tf, tm = make_device_frontend(cfg, "cpu")(torch.from_numpy(w), torch.from_numpy(lens),
                                              torch.Generator().manual_seed(key), train=train)
    return np.asarray(jf), np.asarray(jm), tf.numpy(), tm.numpy()


@pytest.mark.parametrize("bins", [40, 80])
def test_device_frontend_matches_jax(bins, tmp_path):
    w, lens = wave_batch([16000, 11200, 5000], 16000, seed=bins)
    cfg = {"num_mel_bins": bins, "normalization": True, "spec_augment": True}
    jf, jm, tf, tm = _frontend_pair(cfg, w, lens, train=False)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)
    for i, t in enumerate(tm.sum(1)):
        assert not tf[i, t:].any()  # padding frames are zero
    # global CMVN
    mean = np.linspace(-1.0, 1.0, bins).astype(np.float32)
    std = np.linspace(0.5, 2.0, bins).astype(np.float32)
    np.save(tmp_path / "cmvn.mean.npy", mean)
    np.save(tmp_path / "cmvn.std.npy", std)
    cfg["global_cmvn"] = str(tmp_path / "cmvn")
    jf, jm, tf, tm = _frontend_pair(cfg, w, lens, train=False)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)


def _jax_uniforms(key, b, n):
    """The draws ``spec_augment_jax`` makes from ``key``, as [n, B]."""
    keys = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.uniform(k, (b, 1)))[:, 0] for k in keys])


@pytest.mark.parametrize("f_num,t_num,f_rate,t_rate,max_t", [
    (2, 2, 0.3, 0.05, 100), (2, 5, 0.3, 0.05, 100), (1, 3, 0.5, 0.2, 7), (0, 2, 0.3, 0.4, 100)])
def test_spec_augment_with_jax_draws_gives_jax_masks(f_num, t_num, f_rate, t_rate, max_t):
    b, t, v = 4, 300, 40
    lens = np.array([300, 211, 97, 30], np.int32)
    key = jax.random.PRNGKey(f_num * 10 + t_num)
    kw = dict(freq_mask_num=f_num, time_mask_num=t_num, freq_mask_rate=f_rate,
              time_mask_rate=t_rate, max_mask_time_len=max_t)
    ones = np.ones((b, t, v), np.float32)
    jmask = np.asarray(spec_augment_jax(jnp.asarray(ones), jnp.asarray(lens), key, **kw))
    u = torch.from_numpy(_jax_uniforms(key, b, 2 * (f_num + t_num)))
    tmask = spec_augment_from_uniforms(torch.from_numpy(ones), torch.from_numpy(lens), u, **kw)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    assert (jmask == 0).any() or f_rate * v < 1


def test_spec_augment_draws_from_its_generator():
    feats = torch.ones(3, 200, 40)
    lens = torch.tensor([200, 150, 80])
    a = spec_augment(feats, lens, torch.Generator().manual_seed(1), 2, 5)
    b = spec_augment(feats, lens, torch.Generator().manual_seed(1), 2, 5)
    c = spec_augment(feats, lens, torch.Generator().manual_seed(2), 2, 5)
    assert torch.equal(a, b) and not torch.equal(a, c) and (a == 0).any()
    with pytest.raises(ValueError):
        spec_augment_from_uniforms(feats, lens, torch.zeros(3, 3))


def test_train_frontend_masks_only_valid_frames():
    w, lens = wave_batch([16000, 8000], 16000, seed=3)
    cfg = {"num_mel_bins": 40, "normalization": True, "spec_augment": True,
           "spec_augment_config": {"freq_mask_num": 2, "time_mask_num": 5}}
    frontend = make_device_frontend(cfg, "cpu")
    ev, mask = frontend(torch.from_numpy(w), torch.from_numpy(lens), None, train=False)
    tr, mask2 = frontend(torch.from_numpy(w), torch.from_numpy(lens),
                         torch.Generator().manual_seed(0), train=True)
    assert torch.equal(mask, mask2)
    changed = (ev != tr).any(-1)
    assert changed.any() and not (changed & ~mask).any()
    assert torch.equal(tr[tr != ev], torch.zeros_like(tr[tr != ev]))
    with pytest.raises(ValueError, match="generator"):
        frontend(torch.from_numpy(w), torch.from_numpy(lens), None, train=True)
