"""The port's language models against the JAX package, on the CPU.

Each test randomly initialises the JAX LM at a small size, carries the
weights over with ``compat.params_from_jax`` and feeds both packages the
same numpy token arrays. Tolerance for float32 outputs: 1e-4 absolute
(summation order differs between XLA's and PyTorch's CPU kernels).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.models.registry import build_model

ATOL = 1e-4
VOCAB = 50

LM_CFGS = {
    "transformer_lm": {"type": "transformer_lm", "vocab_size": VOCAB, "d_model": 32,
                       "n_heads": 4, "d_ff": 48, "num_blocks": 2, "residual_dropout": 0.0},
    "transformer_lm_untied": {"type": "transformer_lm", "vocab_size": VOCAB, "d_model": 32,
                              "n_heads": 4, "d_ff": 48, "num_blocks": 2,
                              "share_embedding": False, "activation": "relu"},
    "rnn_lm": {"type": "rnn_lm", "vocab_size": VOCAB, "num_layers": 2, "hidden_size": 24,
               "dropout": 0.1},
    "rnn_lm_untied": {"type": "rnn_lm", "vocab_size": VOCAB, "num_layers": 1,
                      "hidden_size": 24, "share_embedding": False},
}


def make_lm_pair(cfg, seed=0):
    """(jax model, jax params, port model) with the same random weights."""
    jm = jax_build_model(cfg)
    ones = jnp.ones((2, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), ones, ones, jnp.asarray([8, 8], jnp.int32))
    tm = compat.load_into(build_model(cfg, device="cpu"),
                          jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module", params=sorted(LM_CFGS))
def lm_pair(request):
    return (request.param, *make_lm_pair(LM_CFGS[request.param]))


def test_logits(lm_pair):
    _, jm, params, tm = lm_pair
    tokens = np.random.default_rng(1).integers(0, VOCAB, size=(3, 9)).astype(np.int32)
    ref = jm.apply(params, jnp.asarray(tokens), method="logits")
    with torch.no_grad():
        out = tm.logits(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 9, VOCAB)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def _init_states(name, jm, tm, n, u_max):
    if name.startswith("transformer"):
        return jm.init_cache(n, u_max), tm.init_cache(n, u_max)
    return jm.init_hidden(n), tm.init_hidden(n)


def test_decode_steps(lm_pair):
    """A run of cached steps: log-probs match step by step, and equal the
    full-sequence logits' log-softmax (cache and position handling)."""
    name, jm, params, tm = lm_pair
    n, steps = 4, 5
    tokens = np.random.default_rng(2).integers(0, VOCAB, size=(n, steps)).astype(np.int32)
    state_j, state_t = _init_states(name, jm, tm, n, steps)
    with torch.no_grad():
        full = torch.log_softmax(tm.logits(torch.from_numpy(tokens).long()), dim=-1)
    for step in range(steps):
        logp_j, state_j = jm.apply(params, jnp.asarray(tokens[:, step]), state_j,
                                   jnp.asarray(step, jnp.int32), method="decode_step")
        with torch.no_grad():
            logp_t, state_t = tm.decode_step(torch.from_numpy(tokens[:, step]).long(),
                                             state_t, step)
        np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), rtol=0, atol=ATOL)
        torch.testing.assert_close(logp_t, full[:, step], rtol=0, atol=ATOL)


def test_decode_hidden_and_vocab_head(lm_pair):
    name, jm, params, tm = lm_pair
    n = 3
    tok = np.random.default_rng(3).integers(0, VOCAB, size=(n,)).astype(np.int32)
    state_j, state_t = _init_states(name, jm, tm, n, 4)
    h_j, _ = jm.apply(params, jnp.asarray(tok), state_j, jnp.asarray(0, jnp.int32),
                      method="decode_hidden")
    w_j, b_j = jm.apply(params, method="vocab_head")
    with torch.no_grad():
        h_t, _ = tm.decode_hidden(torch.from_numpy(tok).long(), state_t, 0)
        w_t, b_t = tm.vocab_head()
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(w_t.detach().numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(b_t.detach().numpy(), np.asarray(b_j))


def test_transformer_lm_ancestral_decode_hidden():
    """Cached steps at B·K rows with a random (non-identity) ancestry map:
    the hidden states match the JAX reference."""
    jm, params, tm = make_lm_pair(LM_CFGS["transformer_lm"], seed=4)
    b, k, u_max, steps = 2, 3, 6, 4
    rng = np.random.default_rng(5)
    cache_j, cache_t = jm.init_cache(b * k, u_max), tm.init_cache(b * k, u_max)
    for step in range(steps):
        tok = rng.integers(3, VOCAB, size=(b * k,)).astype(np.int32)
        src = rng.integers(0, k, size=(b, k, u_max)).astype(np.int32)
        h_j, cache_j = jm.apply(params, jnp.asarray(tok), cache_j,
                                jnp.asarray(step, jnp.int32), jnp.asarray(src),
                                method="decode_hidden")
        with torch.no_grad():
            h_t, cache_t = tm.decode_hidden(torch.from_numpy(tok).long(), cache_t, step,
                                            torch.from_numpy(src).long())
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=ATOL)


def test_params_round_trip_through_jax_layout(lm_pair):
    """``params_to_jax`` gives the flax tree's own paths and shapes, and
    ``params_from_jax`` brings every tensor back bit for bit."""
    _, _, params, tm = lm_pair
    ref = dict(compat._flatten(jax.tree_util.tree_map(np.asarray, params)))
    tree = compat.params_to_jax(tm)
    ours = dict(compat._flatten(tree))
    assert sorted(ours) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(ours[path], leaf, err_msg="/".join(path))
    back = compat.params_from_jax(tree)
    state = tm.state_dict()
    assert sorted(back) == sorted(state)
    for key, val in state.items():
        assert torch.equal(back[key], val), key


def test_lstm_cell_keeps_the_flax_names():
    _, params, _ = make_lm_pair(LM_CFGS["rnn_lm"])
    cell = params["params"]["lstm_0"]["cell"]
    assert sorted(cell) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert sorted(cell["ii"]) == ["kernel"] and sorted(cell["hi"]) == ["bias", "kernel"]


def test_load_is_strict():
    _, params, tm = make_lm_pair(LM_CFGS["rnn_lm"])
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]
    del tree["lstm_1"]["cell"]["hf"]["bias"]
    with pytest.raises(RuntimeError, match="lstm_1.cell.hf.bias"):
        compat.load_into(tm, tree)


def test_npz_round_trip(tmp_path):
    """``save_npz`` writes what ``load_npz`` reads: float16 on disk."""
    _, params, tm = make_lm_pair(LM_CFGS["transformer_lm"])
    tree = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path / "lm.npz")
    compat.save_npz(path, tree)
    with np.load(path) as z:
        assert "params//block_0//slf_attn//qkv_proj//dense//kernel" in z.files
        assert all(z[key].dtype == np.float16 for key in z.files)
    back = dict(compat._flatten(compat.load_npz(path)))
    ref = dict(compat._flatten(tree))
    assert sorted(back) == sorted(ref)
    for key, leaf in ref.items():
        np.testing.assert_array_equal(back[key], leaf.astype(np.float16).astype(np.float32))
    compat.load_into(tm, compat.load_npz(path))


def test_registry_warns_on_dropped_keys(caplog):
    cfg = dict(LM_CFGS["transformer_lm"], n_blocks=4)
    with caplog.at_level(logging.WARNING):
        lm = build_model(cfg, device="cpu")
    assert lm.num_blocks == 2  # n_blocks is not the LM's field
    assert "n_blocks" in caplog.text and "IGNORED" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        build_model(LM_CFGS["rnn_lm"], device="cpu")  # training-only keys pass silently
    assert "IGNORED" not in caplog.text


def test_moe_lm_raises():
    """The MoE LM used to raise; the name is kept for the count. It now
    builds and scores as JAX's: logits over PAD-holding sequences, and the
    training loss with ``moe_aux``, within 1e-4."""
    cfg = dict(LM_CFGS["transformer_lm"], moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
    jm, params, tm = make_lm_pair(cfg)
    rng = np.random.default_rng(5)
    src = rng.integers(3, VOCAB, size=(3, 9)).astype(np.int32)
    src[2, 6:] = 0
    tgt = rng.integers(3, VOCAB, size=(3, 9)).astype(np.int32)
    lens = np.array([9, 9, 6], np.int32)
    ref = jax.jit(lambda p, t: jm.apply(p, t, method="logits"))(params, jnp.asarray(src))
    loss_j, aux_j = jax.jit(jm.apply)(params, *map(jnp.asarray, (src, tgt, lens)))
    with torch.no_grad():
        out = tm.logits(torch.from_numpy(src).long())
        loss, aux = tm(*(torch.from_numpy(a).long() for a in (src, tgt, lens)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(aux["moe_aux"].item(), float(aux_j["moe_aux"]), rtol=0, atol=ATOL)
