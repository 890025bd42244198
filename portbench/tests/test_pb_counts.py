"""The counted work equals hand values at small shapes."""

from __future__ import annotations

from portbench.core import counts


def test_conv_frontend():
    # T = 11, F = 8: conv1 → 5 x 4 x mid, conv2 → 2 x 2 x out, projection
    flops, t = counts.conv_frontend(11, 8, mid=2, out=3, d=5)
    macs = 5 * 4 * 2 * 9 + 2 * 2 * 3 * 9 * 2 + 2 * (3 * 2) * 5
    assert (flops, t) == (2.0 * macs, 2)


def test_encoder_block():
    t, d, dff = 3, 4, 8
    qkvo = 4 * t * d * d
    att = 2 * t * t * d
    ffn = t * d * 2 * dff + t * dff * d
    assert counts.transformer_encoder(t, d, dff, 2) == 2 * 2.0 * (qkvo + att + ffn)


def test_decoder_step_and_forced():
    rows, pos, tm, d, dff, v = 2, 3, 5, 4, 8, 7
    per = (4 * rows * d * d + 2 * rows * (pos + 1) * d
           + 2 * rows * d * d + 2 * rows * tm * d + 3 * rows * d * dff)
    assert counts.decoder_step(rows, pos, tm, d, dff, 1, v) == 2.0 * (per + rows * d * v)
    assert counts.cross_kv(tm, d, 1) == 2.0 * 2 * tm * d * d
    u = 3
    per = (4 * u * d * d + 2 * u * u * d + 2 * u * d * d + 2 * tm * d * d
           + 2 * u * tm * d + 3 * u * d * dff)
    assert counts.decoder_forced(u, tm, d, dff, 1, v) == 2.0 * (per + u * d * v)


def test_kernel_bounds():
    ops = 2.0 * 2560 * 256 * 4233
    assert counts.topk_bound(2560, 256, 4233, 5, "bfloat16") == ops / 989e12
    nbytes = 10 * 4 * 4 + 4233 * 4 * 4 + 4233 * 4 + 10 * 5 * 8
    assert counts.topk_bound(10, 4, 4233, 5, "float32") == max(
        2.0 * 10 * 4 * 4233 / 495e12, nbytes / 3.35e12)
    assert counts.fbank_bound(100, 400, 40) == 4 * (100 * 400 + 257 * 40 + 100 * 40) / 3.35e12
