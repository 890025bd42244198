"""Reference-checkpoint interchange and the scan layout of the port's
``compat`` against the JAX package, on the CPU.

The reference tree is not mounted, so a reference ``.pt`` is made the way
the JAX package makes one: ``opentransformer_tpu.compat.export_reference_checkpoint``
of a seeded JAX tree, through ``torch.save`` and ``torch.load``. Gates: the
port's import equals ``params_from_jax`` of the JAX package's conversion of
the same file, bitwise; the port's export equals the JAX package's, key by
key, bitwise; the imported model's forward equals the JAX model's within
1e-5 relative to the output's scale (float32 on both sides, summation orders
differ), and so does the KV-cached decoder step with ``concat_after``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu import compat as jax_compat
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.models.registry import build_model

REL = 1e-5
V = 40
B, T = 2, 48


def s2t_cfg(encoder_type="transformer", normalize_before=False, concat_after=False,
            front_ln=False, tied=True, ctc_weight=0.0, lookahead=0, relpos=True,
            scan_layers=False):
    frontend = {"input_size": 16, "output_size": 32, "mid_channel": 4, "out_channel": 8,
                "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2], "dropout": 0.0,
                "front_end_layer_norm": front_ln}
    if encoder_type == "conformer":
        encoder = {"d_model": 32, "n_heads": 4, "d_ff": 48, "nblocks": 2, "cov_kernel_size": 5,
                   "residual_dropout": 0.0, "relative_positional": relpos,
                   "conv_norm_type": "batch", "ref_compat": True}
    else:
        encoder = {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu",
                   "residual_dropout": 0.0, "normalize_before": normalize_before,
                   "concat_after": concat_after, "scan_layers": scan_layers}
    return {"type": "speech2text", "frontend_type": "conv", "frontend": frontend,
            "encoder_type": encoder_type, "encoder": encoder,
            "decoder": {"vocab_size": V, "d_model": 32, "n_heads": 4, "d_ff": 48,
                        "memory_dim": 32, "n_blocks": 2, "residual_dropout": 0.0,
                        "activation": "glu", "normalize_before": normalize_before,
                        "concat_after": concat_after, "share_embedding": tied,
                        "scan_layers": scan_layers},
            "ctc_weight": ctc_weight, "lookahead_steps": lookahead}


CASES = {
    "post_norm_tied_ctc": s2t_cfg(ctc_weight=0.3),
    "pre_norm_untied": s2t_cfg(normalize_before=True, tied=False),
    "concat_after_front_ln_lookahead": s2t_cfg(concat_after=True, front_ln=True,
                                               ctc_weight=0.3, lookahead=2),
    "pre_norm_concat_after": s2t_cfg(normalize_before=True, concat_after=True),
    "conformer_relpos": s2t_cfg("conformer", relpos=True),
    "conformer_abspos": s2t_cfg("conformer", relpos=False),
    "scan_layers": s2t_cfg(scan_layers=True),
    "transformer_lm": {"type": "transformer_lm", "vocab_size": V, "d_model": 32, "n_heads": 4,
                       "d_ff": 48, "num_blocks": 2, "residual_dropout": 0.0},
    "transformer_lm_untied": {"type": "transformer_lm", "vocab_size": V, "d_model": 32,
                              "n_heads": 4, "d_ff": 48, "num_blocks": 2,
                              "share_embedding": False},
    "rnn_lm": {"type": "rnn_lm", "vocab_size": V, "num_layers": 2, "hidden_size": 24,
               "dropout": 0.0},
    "rnn_lm_untied": {"type": "rnn_lm", "vocab_size": V, "num_layers": 1, "hidden_size": 24,
                      "share_embedding": False},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(seed=3):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 16)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([T, 37])[:, None]
    targets = rng.integers(3, V, size=(B, 7)).astype(np.int32)
    targets[:, 0] = 1
    return feats, mask, targets, np.array([6, 4], np.int32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def randomize(tree, seed):
    """Every leaf redrawn from a seeded normal (so that biases, norms and
    BatchNorm statistics are not their initial constants); variances kept
    positive."""
    rng = np.random.default_rng(seed)

    def fill(node, path=()):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, size=np.shape(v)).astype(np.float32)
            else:
                out[k] = (0.3 * rng.normal(size=np.shape(v))).astype(np.float32)
        return out

    return fill(tree)


class Case:
    """A seeded JAX model, its reference ``.pt`` (the JAX package's export
    through torch.save / torch.load), and the port's import of it."""

    def __init__(self, name, tmpdir):
        self.name, self.cfg = name, CASES[name]
        self.is_lm = self.cfg["type"].endswith("_lm")
        self.jm = jax_build_model(self.cfg)
        # the JAX tree's layout from the port's model (cheaper than flax's
        # eager init), held to the shapes of JAX's own init
        tree = compat.params_to_jax(build_model(self.cfg, device="cpu"))
        if self.is_lm:
            ones = jnp.ones((2, 8), jnp.int32)
            shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0), ones, ones,
                                    jnp.asarray([8, 8]))
        else:
            shapes = jax.eval_shape(self.jm.init, jax.random.PRNGKey(0),
                                    *map(jnp.asarray, inputs()))
        want = {k: tuple(v.shape) for k, v in compat._flatten(shapes)}
        assert {k: np.shape(v) for k, v in compat._flatten(tree)} == want
        self.variables = randomize(tree, seed=len(name))
        full_cfg = {"model": self.cfg, "data": {"num_mel_bins": 16}, "train": {}}
        path = os.path.join(tmpdir, f"{name}.pt")
        torch.save(jax_compat.export_reference_checkpoint(self.variables, full_cfg), path)
        self.path = path
        self.chkpt = torch.load(path, map_location="cpu", weights_only=True)
        self.state, self.embedded = compat.load_reference_any(path)
        self.tm = build_model(self.cfg, device="cpu")
        self.tm.load_state_dict(self.state, strict=True)

    def jax_import(self):
        return compat.params_from_jax(np_tree(jax_compat.load_reference_any(self.path)[0]))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmpdir = str(tmp_path_factory.mktemp("ref"))
    return {name: Case(name, tmpdir) for name in CASES}


def assert_close_rel(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: max |diff| {err:.3e} > {REL} x {scale:.3e}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_equals_params_from_jax_of_jax_conversion(cases, name):
    case = cases[name]
    want = case.jax_import()
    assert sorted(case.state) == sorted(want)
    for key, val in want.items():
        assert case.state[key].dtype == torch.float32
        assert torch.equal(case.state[key], val), key


@pytest.mark.parametrize("name", sorted(CASES))
def test_export_equals_jax_export_bitwise(cases, name):
    case = cases[name]
    got = compat.export_reference_checkpoint(case.tm, {"model": case.cfg})
    want = jax_compat.export_reference_checkpoint(case.variables, {"model": case.cfg})
    assert sorted(got) == sorted(want)
    for part in want:
        if part == "params":
            assert got[part] == want[part]
            continue
        assert sorted(got[part]) == sorted(want[part]), part
        for key, val in want[part].items():
            assert got[part][key].dtype == val.dtype, f"{part}.{key}"
            assert torch.equal(got[part][key], val), f"{part}.{key}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_through_pt_is_bitwise(cases, name, tmp_path):
    case = cases[name]
    path = str(tmp_path / "again.pt")
    torch.save(compat.export_reference_checkpoint(case.state, {"model": case.cfg}), path)
    back, cfg = compat.load_reference_any(path)
    assert cfg == {"model": case.cfg} or case.cfg.get("encoder_type") == "conformer"
    assert sorted(back) == sorted(case.state)
    assert all(torch.equal(back[k], v) for k, v in case.state.items())


def s2t_outputs_jax(case):
    f, m, y, yl = map(jnp.asarray, inputs(9))
    v = case.variables
    loss, _ = case.jm.apply(v, f, m, y, yl)

    def encode_and_logits(model, f, m, y_in):
        mem, mmask = model.encode(f, m)
        return mem, model.decode_full(y_in, mem, mmask)

    mem, logits = case.jm.apply(v, f, m, y[:, :-1], method=encode_and_logits)
    return float(loss), np.asarray(mem), np.asarray(logits)


def s2t_outputs_port(case):
    f, m, y, yl = inputs(9)
    tm = case.tm.eval()
    with torch.no_grad():
        args = (torch.from_numpy(f), torch.from_numpy(m))
        loss, _ = tm(*args, torch.from_numpy(y).long(), torch.from_numpy(yl).long())
        mem, mmask = tm.encode(*args)
        logits = tm.decode_full(torch.from_numpy(y[:, :-1]).long(), mem, mmask)
    return float(loss), mem.numpy(), logits.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_imported_forward_matches_jax(cases, name):
    case = cases[name]
    if case.is_lm:
        tokens = np.random.default_rng(4).integers(0, V, size=(3, 9)).astype(np.int32)
        want = case.jm.apply(case.variables, jnp.asarray(tokens), method="logits")
        with torch.no_grad():
            got = case.tm.eval().logits(torch.from_numpy(tokens).long())
        assert_close_rel(got.numpy(), want, f"{name} logits")
        return
    for what, got, want in zip(("loss", "memory", "logits"), s2t_outputs_port(case),
                               s2t_outputs_jax(case)):
        assert_close_rel(got, want, f"{name} {what}")


@pytest.mark.parametrize("name", ["concat_after_front_ln_lookahead", "pre_norm_concat_after"])
def test_kv_cached_decoder_step_with_concat_after(cases, name):
    """Three cached beam steps (K = 3, a non-identity ancestry map) of the
    imported concat_after decoder against the JAX decoder's."""
    case = cases[name]
    f, m, _, _ = inputs(11)
    mem_j, mask_j = case.jm.apply(case.variables, jnp.asarray(f), jnp.asarray(m),
                                  method="encode")
    k, u_max = 3, 6
    cache_j = case.jm.apply(case.variables, mem_j, u_max, k, method="init_cache")
    with torch.no_grad():
        mem_t, mask_t = case.tm.encode(torch.from_numpy(f), torch.from_numpy(m))
        cache_t = case.tm.init_cache(mem_t, u_max, k)
    rng = np.random.default_rng(5)
    for step in range(3):
        tok = rng.integers(3, V, size=(B * k,)).astype(np.int32)
        src = rng.integers(0, k, size=(B, k, u_max)).astype(np.int32)
        logp_j, cache_j = case.jm.apply(case.variables, jnp.asarray(tok), cache_j,
                                        jnp.asarray(step, jnp.int32), mask_j, jnp.asarray(src),
                                        method="decode_step")
        with torch.no_grad():
            logp_t, cache_t = case.tm.decode_step(torch.from_numpy(tok).long(), cache_t, step,
                                                  mask_t, torch.from_numpy(src).long())
        assert_close_rel(logp_t.numpy(), logp_j, f"{name} step {step}")


def test_scan_layout_round_trips_and_matches_jax(cases):
    """A ``scan_layers`` JAX tree (stacked ``blocks``) loads into the port's
    per-block modules, ``params_to_jax`` restacks it bitwise, and the port's
    ``to_scan_layout`` / ``from_scan_layout`` equal the JAX package's."""
    case = cases["scan_layers"]
    jtree = case.variables
    assert "blocks" in jtree["params"]["encoder"] and "blocks" in jtree["params"]["decoder"]
    model = compat.load_into(build_model(case.cfg, device="cpu"), jtree)
    back = compat.params_to_jax(model)
    flat_a = dict(compat._flatten(back))
    flat_b = dict(compat._flatten(jtree))
    assert sorted(flat_a) == sorted(flat_b)
    assert all(np.array_equal(flat_a[k], np.asarray(flat_b[k])) for k in flat_b)
    for comp in ("encoder", "decoder"):
        unstacked = compat.from_scan_layout(jtree, comp)
        want = jax_compat.from_scan_layout(jtree, comp)
        assert dict(compat._flatten(unstacked)).keys() == dict(compat._flatten(want)).keys()
        assert all(np.array_equal(a, dict(compat._flatten(want))[k])
                   for k, a in compat._flatten(unstacked))
        restacked = compat.to_scan_layout(unstacked, comp)
        want2 = jax_compat.to_scan_layout(want, comp)
        flat_w = dict(compat._flatten(want2))
        assert all(np.array_equal(a, flat_w[k]) for k, a in compat._flatten(restacked))
        assert len(flat_w) == len(dict(compat._flatten(restacked)))


def test_non_reference_models_refuse_export():
    ctc = {"type": "ctc", "frontend": CASES["post_norm_tied_ctc"]["frontend"],
           "encoder": CASES["post_norm_tied_ctc"]["encoder"], "vocab_size": V}
    with pytest.raises(NotImplementedError, match="speech2text family"):
        compat.export_reference_checkpoint(build_model(ctc, device="cpu"), {"model": ctc})
    layer = s2t_cfg("conformer")
    layer["encoder"]["conv_norm_type"] = "layer"
    with pytest.raises(NotImplementedError, match="ref_compat"):
        compat.export_reference_checkpoint(build_model(layer, device="cpu"), {"model": layer})


def test_unsafe_payload_is_refused_by_name(tmp_path):
    path = str(tmp_path / "odd.pt")
    torch.save({"params": {}, "model": {"x": torch.zeros(1)}, "obj": object.__new__(Case)}, path)
    with pytest.raises(ValueError, match="odd.pt.*weights_only"):
        compat.load_reference_any(path)
