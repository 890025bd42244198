"""The port's conformer family against the JAX package, on the CPU.

Masks, ``relative_shift``, rel-pos attention, the conv module (layer norm,
and batch norm with running averages), conformer blocks and encoders, the
concat frontend and the rel-pos / chunked transformer encoder are held
module by module; a small conformer ``speech2text`` (teacher-forced logits,
KV-cached decode steps over a random ancestry map, beam-3 n-best) and a
conformer ``ctc`` model (greedy ids) as whole models; one training update
of a tiny layer-norm conformer against the JAX Trainer; and the committed
full-width configs against the fixture that ``tools/torch_port_conformer_parity.py``
wrote from the JAX package (its first 2 utterances, without JAX).

Inputs come from numpy seeds; the JAX weights are carried over by
``compat``. Tolerance for float32 module outputs and encoder memories: 1e-5
absolute (XLA and PyTorch sum in other orders); for whole-model logits,
log-probs and beam scores (magnitudes up to ~40): 1e-5 of the tensor's
largest magnitude; the training update 1e-5 on every parameter, as
``tests/test_torch_port_train.py``; the full-width fixture at
``chip_smoke``'s limits.
"""

import copy
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from opentransformer_tpu.data.device_pipeline import make_device_frontend as jax_frontend
from opentransformer_tpu.models import encoder as jax_encoder
from opentransformer_tpu.models import frontend as jax_frontend_mod
from opentransformer_tpu.models import modules as jax_modules
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.ops import masks as jax_masks
from opentransformer_tpu.recognize.base import make_memory_search as jax_memory_search
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer
from opentransformer_tpu.train.trainer import TrainState, wave_speech_batch
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.config import CONF_DIR, load_config
from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
from opentransformer_tpu_torch.models import encoder, frontend, modules
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops import masks
from opentransformer_tpu_torch.recognize.base import make_memory_search
from opentransformer_tpu_torch.data.loader import FeatureLoader
from opentransformer_tpu_torch.train.trainer import Trainer, feature_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from test_torch_port_train import (  # noqa: E402
    DATA_CFG,
    TRAIN_CFG,
    flat,
    utterances,
    wave_batch,
    write_corpus,
)

ATOL = 1e-5
D, H, VOCAB = 32, 4, 50
CONFORMER = {"d_model": D, "n_heads": H, "d_ff": 48, "nblocks": 2, "cov_kernel_size": 5,
             "residual_dropout": 0.0}


def model_cfg(encoder_cfg=None, frontend_type="conv", mtype="speech2text", tied=True,
              ctc_weight=0.3):
    front = ({"input_size": 20, "output_size": D, "mid_channel": 4, "out_channel": 8}
             if frontend_type == "conv" else
             {"input_size": 20, "output_size": D, "left_frames": 2, "right_frames": 1,
              "frame_rate": 40})
    enc = dict(CONFORMER, **(encoder_cfg or {}))
    if mtype == "ctc":
        return {"type": "ctc", "frontend_type": frontend_type, "frontend": front,
                "encoder_type": "conformer", "encoder": enc, "vocab_size": VOCAB}
    return {"type": "speech2text", "frontend_type": frontend_type, "frontend": front,
            "encoder_type": "conformer", "encoder": enc,
            "decoder": {"vocab_size": VOCAB, "d_model": D, "n_heads": H, "d_ff": 48,
                        "memory_dim": D, "n_blocks": 2, "residual_dropout": 0.0,
                        "activation": "glu", "share_embedding": tied},
            "ctc_weight": ctc_weight}


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def pad_mask(lengths, t):
    return np.arange(t)[None] < np.asarray(lengths)[:, None]


def init(module, *args, seed=0, **kw):
    return np_tree(module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, args), **kw))


def port(module, variables):
    return compat.load_into(module, variables).eval()


def shapes(tree) -> dict:
    return {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, atol=ATOL, scaled=False):
    """|got − want| ≤ atol, or with ``scaled`` ≤ atol · max(1, max |want|)."""
    want = np.asarray(want)
    if scaled:
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol)


# ------------------------------------------------------------------- masks
@pytest.mark.parametrize("t,chunk,left", [(10, 4, -1), (10, 4, 0), (10, 4, 2), (7, 3, -1),
                                          (16, 16, 0), (1, 4, 2)])
def test_chunk_attn_mask_matches_jax(t, chunk, left):
    got = masks.chunk_attn_mask(t, chunk, left)
    assert got.shape == (1, 1, t, t) and got.dtype == torch.bool
    want = jax_masks.chunk_attn_mask(t, chunk, left)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attn_mask_from_pad_and_apply_attn_mask_match_jax():
    pad = pad_mask([5, 3], 5)
    got = masks.attn_mask_from_pad(torch.from_numpy(pad))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_masks.attn_mask_from_pad(pad)))
    scores = np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32)
    close(masks.apply_attn_mask(torch.from_numpy(scores), got),
          jax_masks.apply_attn_mask(jnp.asarray(scores), jnp.asarray(pad[:, None, None, :])), 0)
    assert masks.apply_attn_mask(torch.from_numpy(scores), None) is not None


# ---------------------------------------------------------- rel-pos pieces
@pytest.mark.parametrize("t", [1, 2, 5, 16])
def test_relative_shift_equals_a_gather_and_jax(t):
    bd = np.random.default_rng(t).normal(size=(2, 3, t, 2 * t - 1)).astype(np.float32)
    got = modules.relative_shift(torch.from_numpy(bd)).numpy()
    q, k = np.arange(t)[:, None], np.arange(t)[None, :]
    np.testing.assert_array_equal(got, bd[:, :, q, k - q + t - 1])
    np.testing.assert_array_equal(got, np.asarray(jax_modules.relative_shift(jnp.asarray(bd))))


def test_sinusoid_of_negative_positions_matches_jax():
    pos = np.arange(-11, 12)
    got = modules.sinusoid_position_encoding(torch.from_numpy(pos), 64)
    close(got, jax_modules.sinusoid_position_encoding(jnp.asarray(pos), 64), 1e-6)
    close(modules.rel_pos_embedding(12, 64, torch.float32), got[None], 0)


ATTN_X = np.random.default_rng(3).normal(size=(3, 9, D)).astype(np.float32)
ATTN_MASK = pad_mask([9, 6, 2], 9)[:, None, None, :]


@pytest.mark.parametrize("use_out_proj,share_qvk_proj,chunked", [
    (True, False, False), (False, False, False), (True, True, False), (True, False, True)],
    ids=["out_proj", "no_out_proj", "shared_qvk", "chunk_mask"])
def test_rel_pos_attention_matches_jax(use_out_proj, share_qvk_proj, chunked):
    kw = dict(use_out_proj=use_out_proj, share_qvk_proj=share_qvk_proj)
    jm = jax_modules.RelPosSelfAttention(H, D, **kw)
    variables = init(jm, ATTN_X)
    tm = port(modules.RelPosSelfAttention(H, D, **kw), variables)
    mask = ATTN_MASK & (np.asarray(jax_masks.chunk_attn_mask(9, 4, 1)) if chunked else True)
    want, _ = jm.apply(variables, jnp.asarray(ATTN_X), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ATTN_X), torch.from_numpy(mask))
    close(got, want)


def test_rel_pos_attention_skip_term_b():
    """JAX shifts the query-free position term before broadcasting it, which
    runs only at T = 1: there the two agree; at T > 1 the port is held to
    the term's definition, scores[q, k] = (q+u)·k_k + v·r[k − q + T − 1]."""
    jm = jax_modules.RelPosSelfAttention(H, D, skip_term_b=True)
    x1 = ATTN_X[:, :1]
    variables = init(jm, x1)
    tm = port(modules.RelPosSelfAttention(H, D, skip_term_b=True), variables)
    want, _ = jm.apply(variables, jnp.asarray(x1))
    with torch.no_grad():
        close(tm(torch.from_numpy(x1)), want)
        x = torch.from_numpy(ATTN_X)
        t, dk = x.shape[1], D // H
        q, k, v = (modules.split_heads(a, H) for a in tm.qkv_proj(x).split(D, dim=-1))
        r = modules.split_heads(tm.pos_proj(modules.rel_pos_embedding(t, D, x.dtype)), H)[0]
        pos_term = torch.einsum("hd,hsd->hs", tm.posv[0, :, 0], r)  # [H, 2T-1]
        rel = torch.arange(t)[None, :] - torch.arange(t)[:, None] + t - 1
        scores = (q + tm.posu) @ k.transpose(-1, -2) + pos_term[:, rel]
        scores = masks.apply_attn_mask(scores / dk ** 0.5, torch.from_numpy(ATTN_MASK))
        ref = tm.out_proj(modules.merge_heads(torch.softmax(scores, -1) @ v))
        close(tm(x, torch.from_numpy(ATTN_MASK)), ref)


# ---------------------------------------------------------- conv module
def batch_stats_like(variables, seed=4):
    """Non-trivial BatchNorm scale, bias and running averages."""
    rng = np.random.default_rng(seed)
    out = copy.deepcopy(variables)

    def fill(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                fill(val)
            elif key in ("mean", "bias"):
                tree[key] = rng.normal(scale=0.3, size=val.shape).astype(np.float32)
            elif key in ("var", "scale"):
                tree[key] = rng.uniform(0.5, 2.0, size=val.shape).astype(np.float32)

    fill(out["batch_stats"])
    for path in [p for p, _ in jax.tree_util.tree_flatten_with_path(out["batch_stats"])[0]]:
        node = out["params"]
        for key in path[:-2]:
            node = node[key.key]
        fill(node["bn"])
    return out


@pytest.mark.parametrize("norm_type,causal", [("layer", False), ("layer", True),
                                              ("batch", False), ("batch", True)])
def test_conv_module_matches_jax(norm_type, causal):
    """Rows padded at 11, 7 and 1 frames: the pads are zeroed after the GLU
    and at the output, and the window never sees GLU(bias) from them."""
    x = np.random.default_rng(5).normal(size=(3, 11, D)).astype(np.float32)
    pad = pad_mask([11, 7, 1], 11)
    jm = jax_modules.ConformerConvModule(D, kernel_size=5, norm_type=norm_type, causal=causal)
    variables = init(jm, x, pad)
    if norm_type == "batch":
        variables = batch_stats_like(variables)
    tm = port(modules.ConformerConvModule(D, 5, norm_type, causal=causal), variables)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(pad), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(pad))
    close(got, want)
    assert (got.numpy()[~pad] == 0).all()


def test_batch_norm_training_raises():
    """Training a batch-norm conv module used to raise: it now gives the JAX
    module's output with ``train=True`` (batch statistics over every
    position, pads included) within 1e-5 of the output's scale (dividing by
    the batch's own deviation amplifies the two convs' rounding), and moves
    the running averages to flax's mutable ``batch_stats`` within 1e-6."""
    x = np.random.default_rng(7).normal(size=(3, 11, D)).astype(np.float32)
    pad = pad_mask([11, 7, 1], 11)
    jm = jax_modules.ConformerConvModule(D, kernel_size=5, norm_type="batch")
    variables = batch_stats_like(init(jm, x, pad))
    tm = port(modules.ConformerConvModule(D, 5, "batch"), variables).train()
    want, new = jm.apply(variables, jnp.asarray(x), jnp.asarray(pad), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(pad))
    close(got, want, scaled=True)
    stats = compat.params_to_jax(tm)["batch_stats"]["bn"]
    for key in ("mean", "var"):
        assert not np.allclose(stats[key], variables["batch_stats"]["bn"][key], atol=1e-3)
        np.testing.assert_allclose(stats[key], np.asarray(new["batch_stats"]["bn"][key]),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------- blocks and encoders
BLOCK_VARIANTS = {
    "macaron": {},
    "conv_first": {"conv_first": True},
    "ref_compat": {"ref_compat": True},
    "abs_pe": {"relative_positional": False},
    "no_macaron": {"macaron_style": False, "ffn_scale": 1.0},
    "batch_norm_causal": {"conv_norm_type": "batch", "conv_causal": True},
}


@pytest.mark.parametrize("variant", list(BLOCK_VARIANTS))
def test_conformer_block_matches_jax(variant):
    kw = dict(BLOCK_VARIANTS[variant], residual_dropout=0.0)
    x = np.random.default_rng(6).normal(size=(3, 10, D)).astype(np.float32)
    pad = pad_mask([10, 8, 3], 10)
    attn = pad[:, None, None, :]
    pos = np.asarray(jax_modules.sinusoid_position_encoding(jnp.arange(-9, 10), D))[None]
    jm = jax_encoder.ConformerEncoderBlock(D, H, 48, cov_kernel_size=5, **kw)
    variables = init(jm, x, pad, attn, pos)
    if "batch_stats" in variables:
        variables = batch_stats_like(variables)
    if variant == "ref_compat":
        assert "post_ffn" not in variables["params"]
        assert "out_proj" not in variables["params"]["slf_attn"]
    tm = port(encoder.ConformerEncoderBlock(D, H, 48, cov_kernel_size=5, **kw), variables)
    want, _ = jm.apply(variables, *map(jnp.asarray, (x, pad, attn, pos)))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, pad, attn, pos)))
    close(got, want)


ENCODER_VARIANTS = {
    "full": {},
    "chunk4_left1_causal": {"chunk_size": 4, "left_chunks": 1, "conv_causal": True},
    "chunk3_unlimited": {"chunk_size": 3, "left_chunks": -1},
    "abs_pe": {"relative_positional": False},
    "no_pe": {"relative_positional": False, "positional_encoding": False},
}


@pytest.mark.parametrize("variant", list(ENCODER_VARIANTS))
def test_conformer_encoder_matches_jax(variant):
    kw = dict(CONFORMER, **ENCODER_VARIANTS[variant])
    x = np.random.default_rng(7).normal(size=(3, 13, D)).astype(np.float32)
    pad = pad_mask([13, 9, 4], 13)
    jm = jax_encoder.ConformerEncoder(**kw)
    variables = init(jm, x, pad)
    tm = port(encoder.ConformerEncoder(**kw), variables)
    want, want_mask = jm.apply(variables, jnp.asarray(x), jnp.asarray(pad))
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    close(got, want)


@pytest.mark.parametrize("variant", [{"normalize_before": False}, {"normalize_before": True},
                                     {"chunk_size": 4, "left_chunks": 0}],
                         ids=["post_norm", "pre_norm", "chunk4_left0"])
def test_transformer_encoder_with_relative_positions_matches_jax(variant):
    kw = dict(d_model=D, n_heads=H, d_ff=48, n_blocks=2, residual_dropout=0.0,
              activation="glu", relative_positional=True, **variant)
    x = np.random.default_rng(8).normal(size=(3, 12, D)).astype(np.float32)
    pad = pad_mask([12, 7, 5], 12)
    jm = jax_encoder.TransformerEncoder(**kw)
    variables = init(jm, x, pad)
    assert "pos_enc" not in variables["params"]
    tm = port(encoder.TransformerEncoder(**kw), variables)
    want, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(pad))
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(pad))
    close(got, want)


@pytest.mark.parametrize("kw", [{}, {"left_frames": 2, "right_frames": 1, "frame_rate": 20},
                                {"with_linear": False}, {"frame_rate": 5, "left_frames": 0}],
                         ids=["default", "left2_right1_stride2", "no_linear", "stride1"])
def test_concat_frontend_matches_jax(kw):
    x = np.random.default_rng(9).normal(size=(3, 23, 20)).astype(np.float32)
    pad = pad_mask([23, 17, 9], 23)
    jm = jax_frontend_mod.ConcatFrontEnd(20, D, **kw)
    variables = init(jm, x, pad)
    tm = port(frontend.ConcatFrontEnd(20, D, **kw), variables)
    want, want_mask = jm.apply(variables, jnp.asarray(x), jnp.asarray(pad))
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got.shape == want.shape
    close(got, want)


# ------------------------------------------------------------ whole models
class Pair:
    """One small conformer model in both packages, with the same seeded
    weights (``chip_smoke.seeded_params``, numpy; BatchNorm statistics from
    ``batch_stats_like``) and inputs."""

    def __init__(self, cfg, seed=0, frames=(64, 50, 37)):
        rng = np.random.default_rng(seed)
        t = frames[0]
        self.feats = rng.normal(size=(len(frames), t, 20)).astype(np.float32)
        self.mask = pad_mask(frames, t)
        self.targets = rng.integers(3, VOCAB, size=(len(frames), 8)).astype(np.int32)
        self.targets[:, 0] = 1
        self.jm = jax_build_model(cfg)
        self.tm = build_model(cfg, device="cpu")
        self.params = chip_smoke.seeded_params(self.tm, seed)
        if "batch_stats" in self.params:
            self.params = batch_stats_like(self.params)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, self.params)
        compat.load_into(self.tm, self.params)

    def encode(self):
        mem_j, mask_j = self.jm.apply(self.jparams, jnp.asarray(self.feats),
                                      jnp.asarray(self.mask), method="encode")
        with torch.no_grad():
            mem_t, mask_t = self.tm.encode(torch.from_numpy(self.feats),
                                           torch.from_numpy(self.mask))
        return mem_j, mask_j, mem_t, mask_t


@pytest.fixture(scope="module")
def pair():
    return Pair(model_cfg({"chunk_size": 4, "left_chunks": 2}))


def test_conformer_speech2text_encode_and_teacher_forced_logits_match_jax(pair):
    mem_j, mask_j, mem_t, mask_t = pair.encode()
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    close(mem_t, mem_j)
    tin = pair.targets[:, :-1]
    logits_j = pair.jm.apply(pair.jparams, jnp.asarray(tin), mem_j, mask_j, method="decode_full")
    with torch.no_grad():
        logits_t = pair.tm.decode_full(torch.from_numpy(tin).long(), mem_t, mask_t)
        close(pair.tm.ctc_logits(mem_t),
              pair.jm.apply(pair.jparams, mem_j, method="ctc_logits"), scaled=True)
    close(logits_t, logits_j, scaled=True)


@pytest.mark.parametrize("fused", [False, True], ids=["decode_step", "decode_step_topk"])
def test_conformer_cached_decode_steps_with_ancestry_match_jax(pair, fused):
    mem_j, mask_j, mem_t, mask_t = pair.encode()
    b, k, u_max = 3, 3, 6
    rng = np.random.default_rng(5)
    cache_j = pair.jm.apply(pair.jparams, mem_j, u_max, k, method="init_cache")
    with torch.no_grad():
        cache_t = pair.tm.init_cache(mem_t, u_max, k)
    for step in range(4):
        tok = rng.integers(3, VOCAB, size=(b * k,)).astype(np.int32)
        src = rng.integers(0, k, size=(b, k, u_max)).astype(np.int32)
        args_j = (jnp.asarray(tok), cache_j, jnp.asarray(step, jnp.int32), mask_j, jnp.asarray(src))
        with torch.no_grad():
            args_t = (torch.from_numpy(tok).long(), cache_t, step, mask_t,
                      torch.from_numpy(src).long())
            if fused:
                vals_j, idx_j, cache_j = pair.jm.apply(pair.jparams, *args_j, 5,
                                                       method="decode_step_topk")
                vals_t, idx_t, cache_t = pair.tm.decode_step_topk(*args_t, 5)
                np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
                close(vals_t, vals_j, scaled=True)
            else:
                logp_j, cache_j = pair.jm.apply(pair.jparams, *args_j, method="decode_step")
                logp_t, cache_t = pair.tm.decode_step(*args_t)
                close(logp_t, logp_j, scaled=True)


@pytest.fixture(scope="module")
def bn_pair():
    """Batch-norm conv modules with non-trivial running averages, and an
    untied output layer: a random tied embedding mostly copies its input
    token, so every beam would repeat BOS."""
    return Pair(model_cfg({"conv_norm_type": "batch"}, tied=False), seed=2)


@pytest.mark.parametrize("norm", ["layer_norm", "batch_norm"])
def test_conformer_beam3_nbest_matches_jax(norm, bn_pair):
    p = bn_pair if norm == "batch_norm" else Pair(model_cfg(tied=False, ctc_weight=0.0), seed=4)
    mem_j, mask_j, mem_t, mask_t = p.encode()
    hyp_j = jax_memory_search(p.jm, 3, 10)(p.jparams, mem_j, mask_j)
    hyp_t = make_memory_search(p.tm, 3, 10)(mem_t, mask_t)
    np.testing.assert_array_equal(hyp_t.tokens.numpy(), np.asarray(hyp_j.tokens))
    np.testing.assert_array_equal(hyp_t.lengths.numpy(), np.asarray(hyp_j.lengths))
    close(hyp_t.scores, hyp_j.scores, scaled=True)
    assert len({tuple(r) for r in hyp_t.tokens[:, 0].tolist()}) > 1  # not one repeated answer


@pytest.mark.parametrize("frontend_type", ["conv", "concat"])
def test_conformer_ctc_model_greedy_ids_match_jax(frontend_type):
    p = Pair(model_cfg({"relative_positional": True}, frontend_type, mtype="ctc"), seed=2)
    args = (p.feats, p.mask)
    ids_j, mask_j = p.jm.apply(p.jparams, *map(jnp.asarray, args), method="recognize_argmax")
    logp_j, _ = p.jm.apply(p.jparams, *map(jnp.asarray, args), method="recognize_logits")
    with torch.no_grad():
        ids_t, mask_t = p.tm.recognize_argmax(*map(torch.from_numpy, args))
        logp_t, _ = p.tm.recognize_logits(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    close(logp_t, logp_j, scaled=True)


def test_params_round_trip_with_batch_stats_and_strict_loading(bn_pair):
    cfg = model_cfg({"conv_norm_type": "batch"}, tied=False)
    model = build_model(cfg, device="cpu")
    tree = compat.params_to_jax(model)
    bn = tree["batch_stats"]["encoder"]["block_1"]["conv_module"]["bn"]
    assert sorted(bn) == ["mean", "var"] and bn["var"].shape == (D,)
    assert tree["params"]["encoder"]["block_0"]["slf_attn"]["posu"].shape == (1, H, 1, D // H)
    conv = tree["params"]["encoder"]["block_0"]["conv_module"]
    assert conv["dw_conv"]["kernel"].shape == (5, 1, D)
    back = compat.params_from_jax(tree)
    state = model.state_dict()
    assert sorted(back) == sorted(state)
    for name, val in state.items():
        assert torch.equal(back[name], val), name
    # the JAX package's own tree has the same leaves, and loads only whole
    jax_tree = bn_pair.params
    assert sorted(flat(jax_tree)) == sorted(flat(tree))
    compat.load_into(build_model(cfg, device="cpu"), jax_tree)
    with pytest.raises(RuntimeError, match="running_mean"):
        compat.load_into(build_model(cfg, device="cpu"), {"params": jax_tree["params"]})
    ctc = compat.load_ctc_from_speech2text(
        build_model(model_cfg({"conv_norm_type": "batch"}, mtype="ctc"), device="cpu"), jax_tree)
    assert torch.equal(ctc.encoder.block_1.conv_module.bn.running_var,
                       torch.from_numpy(jax_tree["batch_stats"]["encoder"]["block_1"]
                                        ["conv_module"]["bn"]["var"]))


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["conformer_baseline", "conformer_streaming"])
def test_committed_conformer_json_is_the_yaml_with_extract_on_device(name):
    ours = load_config(os.path.join(CONF_DIR, f"{name}.json"))
    with open(os.path.join(REPO, "egs", "aishell", "conf", f"{name}.yaml")) as f:
        ref = yaml.safe_load(f)
    assert ours["data"].pop("extract_on_device") is True
    assert ours == ref


@pytest.mark.parametrize("mtype", ["speech2text", "ctc"])
@pytest.mark.parametrize("name", ["conformer_baseline", "conformer_streaming"])
def test_registry_builds_the_committed_conformers_as_jax_lays_them_out(name, mtype):
    cfg = chip_smoke.conformer_model_cfg(name)
    if mtype == "ctc":
        cfg = chip_smoke.ctc_model_cfg(cfg)
    model = build_model(cfg, device="cpu")
    enc = model.encoder
    assert isinstance(enc, encoder.ConformerEncoder) and len(enc.layers) == 12
    assert enc.chunk_size == (16 if name == "conformer_streaming" else 0)
    assert enc.block_0.conv_module.causal == (name == "conformer_streaming")
    assert shapes(compat.params_to_jax(model)) == jax_full_width_shapes(mtype)


@functools.lru_cache(maxsize=None)
def jax_full_width_shapes(mtype: str) -> dict:
    """The JAX package's parameter shapes of the committed conformer (the
    streaming config has the same ones)."""
    cfg = chip_smoke.conformer_model_cfg("conformer_baseline")
    jm = jax_build_model(chip_smoke.ctc_model_cfg(cfg) if mtype == "ctc" else cfg)
    args = (jnp.zeros((1, 64, 80)), jnp.ones((1, 64), bool), jnp.ones((1, 4), jnp.int32),
            jnp.ones((1,), jnp.int32))
    return shapes(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args)))


@pytest.fixture(scope="module")
def fixture():
    return chip_smoke.load_conformer_fixture()


@pytest.mark.parametrize("name", ["conformer_baseline", "conformer_streaming"])
def test_full_width_port_holds_to_the_jax_fixture(fixture, name):
    """The first 2 utterances of the committed JAX fixture, through the
    port's CPU path at full width (no JAX): chip_smoke's phase 9a limits."""
    feats, mask, targets = chip_smoke.fixture_inputs(fixture)
    model = chip_smoke.seeded_conformer(name, fixture, device="cpu")
    c = fixture["inputs"]
    out = chip_smoke.conformer_outputs(model, feats[:2], mask[:2], targets[:2], c["steps"],
                                       c["beam"], c["probe_seed"])
    got = chip_smoke.conformer_parity(out, fixture["results"][name], rows=2)
    assert chip_smoke.conformer_parity_ok(got) and got["ids_differ"] == 0, got


# ------------------------------------------------------------- training
def test_one_training_update_of_a_layer_norm_conformer_matches_jax_trainer():
    """As ``test_torch_port_train``'s update test, with a tiny conformer:
    two micro-batches of waveforms, clip at 5, Adam with weight decay at
    the Noam rate of step 1."""
    cfg = model_cfg({"chunk_size": 4, "left_chunks": 1, "conv_causal": True, "nblocks": 1},
                    ctc_weight=0.0)
    cfg["decoder"]["n_blocks"] = 1
    batches = [wave_batch(utterances(3, seed=s), prefix=f"b{s}-") for s in (10, 11)]
    jfront = jax_frontend(DATA_CFG)

    def preprocess(waveforms, wave_lengths, targets, targets_length, *, rng, train):
        feats, mask = jfront(waveforms, wave_lengths, rng, train=train)
        return feats, mask, targets, targets_length

    jm = jax_build_model(cfg)
    jt = JaxTrainer(TRAIN_CFG, jm, batch_fn=wave_speech_batch, preprocess_fn=preprocess)
    init_args = preprocess(*wave_speech_batch(batches[0]), rng=None, train=False)
    params0 = np_tree(jax.jit(jm.init)(jax.random.PRNGKey(3), *init_args))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params0),
                       opt_state=jt.tx.init(jax.tree_util.tree_map(jnp.asarray, params0["params"])),
                       nan_skips=jnp.zeros((), jnp.int32))
    opt0 = np_tree(state.opt_state)
    grad_fn, update_fn = jt._build_grad_fn(), jt._build_update_fn()
    variables, gacc, losses_j = state.params, jt._zeros_like_grads(state.params), []
    for i, batch in enumerate(batches):
        variables, gacc, loss, _ = grad_fn(variables, gacc, wave_speech_batch(batch),
                                           jax.random.PRNGKey(i), None)
        losses_j.append(float(loss))
    lr = jt.schedule(1, 0)
    new_vars, _, skips, _ = update_fn(variables, opt0, gacc, state.nan_skips, lr,
                                      jax.random.PRNGKey(9))
    assert int(skips) == 0

    model = compat.load_into(build_model(cfg, device="cpu"), params0)
    trainer = Trainer(TRAIN_CFG, model, make_device_frontend(DATA_CFG, "cpu"),
                      torch.Generator().manual_seed(0))
    model.train()
    for batch in batches:
        trainer.micro_step(batch)
    rec = trainer.update()
    assert rec["applied"] and rec["lr"] == lr
    np.testing.assert_allclose(rec["losses"], losses_j, rtol=1e-5)
    want = flat(np_tree(new_vars["params"]))
    got = flat(compat.params_to_jax(model)["params"])
    moved = max(float(np.abs(want[k] - flat(params0["params"])[k]).max()) for k in want)
    assert moved > 10 * 1e-5
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("norm_type", ["layer", "batch"])
def test_cli_trains_a_layer_norm_conformer_and_refuses_batch_norm(tmp_path, norm_type):
    cfg = write_corpus(str(tmp_path / "corpus"), n_train=4, n_dev=2)
    cfg["model"] = model_cfg({"conv_norm_type": norm_type}, ctc_weight=0.0)
    cfg["train"]["epochs"] = 1
    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    argv = ["-c", conf, "--expdir", str(tmp_path / "exp"), "--device", "cpu"]
    trainer = run_cli.run(argv)
    assert trainer.nan_skips == 0 and len(trainer.history) == 1
    assert all(np.isfinite(r["losses"]).all() for r in trainer.history)
    assert isinstance(trainer.model.encoder, encoder.ConformerEncoder)
    if norm_type == "batch":
        # the batch norm conformer used to be refused: now its running
        # averages move off (0, 1), the checkpoint carries them under
        # batch_stats, and it reloads into the same beam decode
        ck = str(tmp_path / "exp" / "model.epoch.0" / "params.npz")
        tree = compat.load_npz(ck)
        assert sorted(tree) == ["batch_stats", "params"]
        for block in trainer.model.encoder.layers:
            bn = block.conv_module.bn
            assert not torch.allclose(bn.running_mean, torch.zeros_like(bn.running_mean))
            assert not torch.allclose(bn.running_var, torch.ones_like(bn.running_var))
        fresh = compat.load_into(build_model(cfg["model"], device="cpu"), tree)
        feats, mask, _, _ = feature_args(next(iter(FeatureLoader(cfg, "dev", is_eval=True))),
                                         "cpu")
        ids = []
        for m in (trainer.model.eval(), fresh):
            with torch.no_grad():
                memory, memory_mask = m.encode(feats, mask)
            ids.append(make_memory_search(m, 3, 6)(memory, memory_mask).tokens)
        assert torch.equal(ids[0], ids[1])
