"""The port's fbank, device frontend and SpecAugment against the JAX package,
on the CPU (the kernel's plain version; the CUDA kernel itself is held
against it on the card by ``tests/test_torch_port_gpu.py`` and
``chip_smoke.py``), and a float32 numpy model of the CUDA kernel's FFT
(``kernel_model``) against float64, the plain version and the JAX Pallas
kernel in interpret mode, at the tolerances the card is held to.

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
    tables = fbank_kernel.device_bases(40, 16000.0, torch.device("cpu"))
    frames = torch.randn(5, 400, generator=torch.Generator().manual_seed(0))
    launches = fbank_kernel.spec_mel.launches
    torch.testing.assert_close(fbank_kernel.spec_mel(frames, tables.mel_t, tables.twiddles,
                                                     tables.mel_ranges),
                               fbank_kernel.spec_mel_plain(frames, cos_b, sin_b, mel_t),
                               rtol=0, atol=0)
    assert fbank_kernel.spec_mel.launches == launches
    for got, want in zip(tables[:3], (cos_b, sin_b, mel_t)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unsupported device"):
        fbank_kernel.spec_mel(frames.to("meta"), tables.mel_t, tables.twiddles, tables.mel_ranges)


def test_kernel_source_does_its_own_float32_products():
    """The CUDA kernel computes FFT → power → mel → log itself in float32:
    no tensor-core instruction, TF32 conversion, library call or CUDA
    library header, no cos/sin bases (the dense 400 × 257 DFT products);
    it reads a twiddle table, exchanges Z[256 - k] by shuffles and takes
    the floored log."""
    with open(CSRC) as f:
        code = re.sub(r"//[^\n]*", "", f.read())  # the comments may name what it avoids
    for banned in ("mma", "wgmma", "wmma", "tf32", "cublas", "cufft", "cutlass", "#include <cu"):
        assert banned not in code.lower().replace("cuda_runtime", ""), banned
    for banned in ("cos_b", "sin_b", "window * n_freq"):
        assert banned not in code, banned
    assert re.search(r"const float2\* __restrict__ tw\b", code)  # the twiddle argument
    assert "dft8(" in code and "__shfl_sync(" in code and "logf(fmaxf(" in code
    assert code.count("fmaf(") >= 3


# ---- the kernel's arithmetic on the CPU: a float32 numpy model ----------
# Each step below is one of csrc/fbank_spec_mel.cu in the same order: the
# 512 real samples as 256 complex z[n] = x[2n] + i x[2n+1], pass A radix-4
# over i (n = a + 64 i) times W256^(a k1), pass B radix-8 over c (a = b + 8 c)
# times W64^(b u), pass C radix-8 over b → Z[k1 + 4 u + 32 v], the real-FFT
# post-step, |X|², and each mel bin summed over its range in ascending q.
# numpy rounds every product and sum to float32 where the card contracts
# some of them into FMAs, so the model is the kernel's algorithm, not its
# bits.

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dft4(r, i):
    a0 = r[0] + r[2], i[0] + i[2]
    a2 = r[0] - r[2], i[0] - i[2]
    a1 = r[1] + r[3], i[1] + i[3]
    a3 = i[1] - i[3], r[3] - r[1]  # (v1 - v3)·(-i)
    return ([a0[0] + a1[0], a2[0] + a3[0], a0[0] - a1[0], a2[0] - a3[0]],
            [a0[1] + a1[1], a2[1] + a3[1], a0[1] - a1[1], a2[1] - a3[1]])


def _dft8(r, i, c):
    ar = [r[j] + r[j + 4] for j in range(4)] + [r[j] - r[j + 4] for j in range(4)]
    ai = [i[j] + i[j + 4] for j in range(4)] + [i[j] - i[j + 4] for j in range(4)]
    ar[5], ai[5] = c * (ar[5] + ai[5]), c * (ai[5] - ar[5])    # · W8
    ar[6], ai[6] = ai[6], -ar[6]                               # · W8²
    ar[7], ai[7] = c * (ai[7] - ar[7]), -c * (ar[7] + ai[7])   # · W8³
    pairs = [(0, 2, 1), (1, 3, 1), (0, 2, -1), (1, 3, -1), (4, 6, 1), (5, 7, 1), (4, 6, -1),
             (5, 7, -1)]
    br = [ar[p] + s * ar[q] for p, q, s in pairs]
    bi = [ai[p] + s * ai[q] for p, q, s in pairs]
    br[3], bi[3] = bi[3], -br[3]
    br[7], bi[7] = bi[7], -br[7]
    order = [(0, 1, 1, 0), (0, 1, -1, 4), (2, 3, 1, 2), (2, 3, -1, 6), (4, 5, 1, 1),
             (4, 5, -1, 5), (6, 7, 1, 3), (6, 7, -1, 7)]
    outr, outi = [None] * 8, [None] * 8
    for p, q, s, k in order:
        outr[k], outi[k] = br[p] + s * br[q], bi[p] + s * bi[q]
    return outr, outi


def kernel_model(frames, mel_t, tw, ranges):
    """The kernel's log-mel of float32 frames [F, W ≤ 512], and its power."""
    f32 = np.float32
    frames = np.asarray(frames, f32)
    x = np.zeros((frames.shape[0], 512), f32)
    x[:, : frames.shape[1]] = frames
    zr, zi = x[:, 0::2], x[:, 1::2]
    twr, twi = tw[:, 0], tw[:, 1]
    c8 = twr[64]
    y = {}  # pass A: (a, k1) → (re, im)
    for a in range(64):
        r, i = _dft4([zr[:, a + 64 * j] for j in range(4)], [zi[:, a + 64 * j] for j in range(4)])
        for k1 in range(4):
            y[a, k1] = _cmul(r[k1], i[k1], twr[2 * a * k1], twi[2 * a * k1]) if k1 else (r[0], i[0])
    w = {}  # pass B: (k1, b, u) → (re, im)
    for k1 in range(4):
        for b in range(8):
            r, i = _dft8([y[b + 8 * c, k1][0] for c in range(8)],
                         [y[b + 8 * c, k1][1] for c in range(8)], c8)
            for u in range(8):
                w[k1, b, u] = _cmul(r[u], i[u], twr[8 * b * u], twi[8 * b * u]) if u else (r[0], i[0])
    zr_, zi_ = np.zeros((x.shape[0], 256), f32), np.zeros((x.shape[0], 256), f32)
    for k1 in range(4):  # pass C
        for u in range(8):
            r, i = _dft8([w[k1, b, u][0] for b in range(8)], [w[k1, b, u][1] for b in range(8)], c8)
            for v in range(8):
                zr_[:, k1 + 4 * u + 32 * v], zi_[:, k1 + 4 * u + 32 * v] = r[v], i[v]
    k = np.arange(256)
    pr, pi = zr_[:, (256 - k) % 256], zi_[:, (256 - k) % 256]
    half = f32(0.5)
    er, ei = (zr_ + pr) * half, (zi_ - pi) * half
    dr, di = (zr_ - pr) * half, (zi_ + pi) * half
    wdr, wdi = _cmul(twr[k], twi[k], dr, di)
    xr, xi = er + wdi, ei - wdr
    power = np.zeros((x.shape[0], 257), f32)
    power[:, :256] = xr * xr + xi * xi
    power[:, 256] = np.square(zr_[:, 0] - zi_[:, 0])
    mel = np.zeros((x.shape[0], mel_t.shape[1]), f32)
    for m, (lo, hi, _) in enumerate(ranges):
        for q in range(lo, hi):
            mel[:, m] = mel[:, m] + power[:, q] * mel_t[q, m]
    return np.log(np.maximum(mel, f32(fbank.EPSILON))), power


def test_twiddle_table_is_float64_trig_cast():
    tw = fbank_kernel.twiddles(512)
    ang = 2.0 * np.pi * np.arange(512, dtype=np.float64) / 512
    assert tw.dtype == np.float32 and tw.shape == (512, 2)
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))


@pytest.mark.parametrize("bins", [23, 40, 80])
def test_mel_ranges_reproduce_the_nonzeros(bins):
    mel_t = fbank_kernel.bases(bins)[2]
    ranges = fbank_kernel.mel_ranges(mel_t)
    rebuilt = np.zeros_like(mel_t)
    packed = []
    for m, (lo, hi, start) in enumerate(ranges):
        assert start == len(packed)
        rebuilt[lo:hi, m] = mel_t[lo:hi, m]
        packed.extend(mel_t[lo:hi, m])
        assert (mel_t[lo:hi, m] != 0).all()
    np.testing.assert_array_equal(rebuilt, mel_t)  # every nonzero inside a range
    assert len(packed) <= 2 * mel_t.shape[0] and (mel_t != 0).sum() == len(packed)
    with pytest.raises(ValueError, match="one range"):
        m = bins // 2  # a triangle of at least three frequencies, broken in the middle
        broken = mel_t.copy()
        broken[ranges[m][0] + 1, m] = 0.0
        fbank_kernel.mel_ranges(broken)


def test_kernel_model_is_an_exact_fft_on_random_frames():
    """The model's power spectrum against numpy's float64 rfft."""
    frames = np.random.default_rng(0).normal(size=(9, 400)).astype(np.float32)
    mel_t = fbank_kernel.bases(40)[2]
    _, power = kernel_model(frames, mel_t, fbank_kernel.twiddles(512),
                            fbank_kernel.mel_ranges(mel_t))
    ref = np.abs(np.fft.rfft(frames.astype(np.float64), n=512)) ** 2
    np.testing.assert_allclose(power, ref, rtol=0, atol=1e-6 * ref.max())


@pytest.mark.parametrize("case", [0, 2], ids=["B=2 N=16000 M=40", "B=2 N=48000 M=80 side lobes"])
def test_kernel_model_matches_float64_plain_and_jax(case):
    """chip_smoke.py phase 6's waves at B = 2 through the model of the
    kernel: within 1e-3 of the float64 log-mel and 2e-3 of the plain version
    and of the JAX package's Pallas kernel (interpret mode) on valid frames,
    the tolerances phase 6 holds the card to."""
    import chip_smoke

    _, _, n, bins, silent = chip_smoke.FBANK_CASES[case]
    w, lens = chip_smoke.fbank_waves(2, n, seed=60 + case, silent=silent, device="cpu")
    frames = fbank_kernel.extract_frames(w)
    b, t, ws = frames.shape
    flat = frames.reshape(b * t, ws)
    cos_b, sin_b, mel_t = fbank_kernel.bases(bins)
    got, _ = kernel_model(flat.numpy(), mel_t, fbank_kernel.twiddles(512),
                          fbank_kernel.mel_ranges(mel_t))
    f64 = flat.double().numpy()
    exact = np.log(np.maximum((np.square(f64 @ cos_b.astype(np.float64))
                               + np.square(f64 @ sin_b.astype(np.float64))) @ mel_t, fbank.EPSILON))
    plain = fbank_kernel.spec_mel_plain(flat, *(torch.from_numpy(x) for x in (cos_b, sin_b, mel_t)))
    with pltpu.force_tpu_interpret_mode():
        pf, pl = fbank_pallas_batch(jnp.asarray(w.numpy()), jnp.asarray(lens.numpy()),
                                    num_mel_bins=bins)
    valid = (np.arange(t)[None] < np.asarray(pl)[:, None]).reshape(-1)
    assert valid.sum() == fbank_kernel.wave_frame_lengths(lens).sum()
    got, exact = got[valid], exact[valid]
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, plain.numpy()[valid], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got, np.asarray(pf).reshape(b * t, bins)[valid], rtol=0, atol=2e-3)


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
