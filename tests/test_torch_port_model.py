"""The port's data, modules and model against the JAX package, on the CPU.

Each test makes its inputs with numpy from a seed, randomly initialises the
JAX ``SpeechToText`` at a small size, carries the weights over with
``compat.params_from_jax`` and feeds both packages the same arrays.
Tolerance for float32 model outputs: 1e-4 absolute (summation order differs
between XLA's and PyTorch's CPU kernels).
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.data import kaldi_io as jax_kaldi_io
from opentransformer_tpu.data import synth as jax_synth
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.ops import levenshtein as jax_levenshtein
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.data import kaldi_io, synth
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops import levenshtein, masks
from opentransformer_tpu_torch.utils import resolve_device

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "opentransformer_tpu_torch")


def small_cfg(normalize_before=False, vocab=50):
    return {
        "type": "speech2text", "frontend_type": "conv",
        "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4,
                     "out_channel": 8, "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2],
                     "dropout": 0.0},
        "encoder_type": "transformer",
        "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2,
                    "residual_dropout": 0.0, "activation": "glu",
                    "normalize_before": normalize_before},
        "decoder": {"vocab_size": vocab, "d_model": 32, "n_heads": 4, "d_ff": 48,
                    "memory_dim": 32, "n_blocks": 2, "residual_dropout": 0.0,
                    "activation": "glu", "normalize_before": normalize_before},
        "ctc_weight": 0.3,
    }


class Pair:
    """One small model in both packages with the same weights and inputs."""

    def __init__(self, normalize_before, seed=0):
        cfg = small_cfg(normalize_before)
        rng = np.random.default_rng(seed)
        b, t = 3, 60
        self.feats = rng.normal(size=(b, t, 20)).astype(np.float32)
        self.mask = np.arange(t)[None] < np.array([60, 45, 33])[:, None]
        self.targets = rng.integers(3, 50, size=(b, 8)).astype(np.int32)
        self.targets[:, 0] = 1
        self.jm = jax_build_model(cfg)
        self.params = self.jm.init(
            jax.random.PRNGKey(seed), jnp.asarray(self.feats), jnp.asarray(self.mask),
            jnp.asarray(self.targets), jnp.asarray([7] * b))
        self.tm = build_model(cfg, device="cpu")
        compat.load_into(self.tm, jax.tree_util.tree_map(np.asarray, self.params))

    def japply(self, *args, method):
        return self.jm.apply(self.params, *args, method=method)

    def encode(self):
        mem_j, mask_j = self.japply(jnp.asarray(self.feats), jnp.asarray(self.mask),
                                    method="encode")
        with torch.no_grad():
            mem_t, mask_t = self.tm.encode(torch.from_numpy(self.feats),
                                           torch.from_numpy(self.mask))
        return mem_j, mask_j, mem_t, mask_t


@pytest.fixture(scope="module", params=[False, True], ids=["post_norm", "pre_norm"])
def pair(request):
    return Pair(request.param)


def test_frontend_output_and_mask(pair):
    feats, mask = jnp.asarray(pair.feats), jnp.asarray(pair.mask)
    out_j, mask_j = pair.jm.apply(pair.params, feats, mask,
                                  method=lambda m, f, k: m.frontend(f, k))
    with torch.no_grad():
        out_t, mask_t = pair.tm.frontend(torch.from_numpy(pair.feats), torch.from_numpy(pair.mask))
    np.testing.assert_array_equal(np.asarray(mask_j), mask_t.numpy())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=ATOL)


def test_encoder_memory(pair):
    mem_j, mask_j, mem_t, mask_t = pair.encode()
    np.testing.assert_array_equal(np.asarray(mask_j), mask_t.numpy())
    np.testing.assert_allclose(mem_t.numpy(), np.asarray(mem_j), rtol=0, atol=ATOL)


def test_teacher_forced_logits(pair):
    mem_j, mask_j, mem_t, mask_t = pair.encode()
    tin = pair.targets[:, :-1]
    logits_j = pair.japply(jnp.asarray(tin), mem_j, mask_j, method="decode_full")
    with torch.no_grad():
        logits_t = pair.tm.decode_full(torch.from_numpy(tin).long(), mem_t, mask_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["decode_step", "decode_step_topk"])
def test_cached_decode_steps_with_ancestry(pair, fused):
    """Several cached steps at B·K rows with a random (non-identity) ancestry
    map: log-probs (or their fused top-k) match the JAX reference."""
    mem_j, mask_j, mem_t, mask_t = pair.encode()
    b, k, u_max, steps = 3, 3, 6, 4
    rng = np.random.default_rng(5)
    cache_j = pair.japply(mem_j, u_max, k, method="init_cache")
    with torch.no_grad():
        cache_t = pair.tm.init_cache(mem_t, u_max, k)
    for step in range(steps):
        tok = rng.integers(3, 50, size=(b * k,)).astype(np.int32)
        src = rng.integers(0, k, size=(b, k, u_max)).astype(np.int32)
        assert (src[:, :, : step + 1] != np.arange(k)[None, :, None]).any()
        args_j = (jnp.asarray(tok), cache_j, jnp.asarray(step, jnp.int32), mask_j,
                  jnp.asarray(src))
        with torch.no_grad():
            args_t = (torch.from_numpy(tok).long(), cache_t, step, mask_t,
                      torch.from_numpy(src).long())
            if fused:
                vals_j, idx_j, cache_j = pair.japply(*args_j, 5, method="decode_step_topk")
                vals_t, idx_t, cache_t = pair.tm.decode_step_topk(*args_t, 5)
                np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
                np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j), rtol=0, atol=ATOL)
            else:
                logp_j, cache_j = pair.japply(*args_j, method="decode_step")
                logp_t, cache_t = pair.tm.decode_step(*args_t)
                np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), rtol=0, atol=ATOL)


def test_params_round_trip_through_jax_layout():
    model = build_model(small_cfg(), device="cpu")
    tree = compat.params_to_jax(model)
    assert tree["params"]["decoder"]["block_0"]["slf_attn"]["qkv_proj"]["dense"]["kernel"].shape == (32, 96)
    assert tree["params"]["frontend"]["conv1"]["conv"]["kernel"].shape == (3, 3, 1, 4)
    back = compat.params_from_jax(tree)
    state = model.state_dict()
    assert sorted(back) == sorted(state)
    for name, val in state.items():
        assert torch.equal(back[name], val), name


def test_load_npz_matches_jax_loader():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_trained_synth", os.path.join(REPO, "tools", "export_trained_synth.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    path = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16.npz")
    ours = dict(compat._flatten(compat.load_npz(path)))
    theirs = dict(compat._flatten(tool.load_trained_params(path)))
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == np.float32
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_synth_is_bit_identical():
    assert synth.make_vocab() == jax_synth.make_vocab()
    np.testing.assert_array_equal(synth.make_patterns(), jax_synth.make_patterns())
    for split in ("train", "test"):
        for ours, theirs in zip(synth.gen_split(split, 3), jax_synth.gen_split(split, 3)):
            assert ours[0] == theirs[0] and ours[2] == theirs[2]
            assert ours[1].tobytes() == theirs[1].tobytes()


def test_write_corpus_reads_back_through_both_packages(tmp_path):
    synth.write_corpus(str(tmp_path), splits=("dev",), n_utts={"dev": 3})
    scp = kaldi_io.read_scp(str(tmp_path / "dev" / "feats.scp"))
    assert scp == jax_kaldi_io.read_scp(str(tmp_path / "dev" / "feats.scp"))
    for (utt, feats, _), (utt2, rx) in zip(synth.gen_split("dev", 3), scp.items()):
        assert utt == utt2
        np.testing.assert_array_equal(kaldi_io.load_mat(rx), feats)
        np.testing.assert_array_equal(jax_kaldi_io.load_mat(rx), feats)
    ours = list(kaldi_io.read_ark(str(tmp_path / "dev" / "feats.ark")))
    theirs = list(jax_kaldi_io.read_ark(str(tmp_path / "dev" / "feats.ark")))
    assert [u for u, _ in ours] == [u for u, _ in theirs]


def test_compressed_matrix_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rows, cols = 7, 5
    header = np.array([1], "<i4").tobytes() + np.array([-2.0, 5.0], "<f4").tobytes() \
        + np.array([rows, cols], "<i4").tobytes()
    percentiles = np.sort(rng.integers(0, 65536, size=(cols, 4)), axis=1).astype("<u2")
    codes = rng.integers(0, 256, size=(cols, rows)).astype(np.uint8)
    path = tmp_path / "cm.ark"
    path.write_bytes(b"utt1 \x00BCM " + header + percentiles.tobytes() + codes.tobytes())
    (utt, ours), = kaldi_io.read_ark(str(path))
    (_, theirs), = jax_kaldi_io.read_ark(str(path))
    assert utt == "utt1" and ours.shape == (rows, cols)
    np.testing.assert_array_equal(ours, theirs)


def test_masks_and_neg_inf():
    assert masks.NEG_INF == -1e9 and np.isfinite(masks.NEG_INF)
    pad = torch.from_numpy(np.arange(9)[None] < np.array([9, 4])[:, None])
    assert masks.subsample_mask(pad, 3, 2).tolist() == pad[:, 1::2].tolist()
    assert masks.mask_to_length(pad).tolist() == [9, 4]
    assert masks.causal_mask(3)[0, 0].tolist() == [[True, False, False], [True, True, False],
                                                   [True, True, True]]


@pytest.mark.parametrize("ref,hyp", [("abcde", "abxde"), ("", "ab"), ("kitten", "sitting"),
                                     ("aaaa", "")])
def test_edit_distance_matches_jax(ref, hyp):
    assert levenshtein.edit_distance(list(ref), list(hyp)) == \
        jax_levenshtein.edit_distance(list(ref), list(hyp))
    acc = levenshtein.ErrorRateAccumulator()
    acc.update(list(ref), list(hyp))
    assert acc.errors == levenshtein.edit_distances(list(ref), [list(hyp)])[0]


def test_unported_configs_raise():
    cfg = small_cfg()
    cfg["encoder"]["relative_positional"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model({"type": "ctc"}, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(root, f) for root, _, names in os.walk(PORT_DIR)
             for f in names if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "opentransformer_tpu")
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path} imports {mod}"


def test_port_imports_with_jax_unimportable(tmp_path):
    # a meta-path hook makes jax/flax/yaml/the JAX package fail to import
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'flax', 'yaml', 'opentransformer_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n")
    code = ("import importlib, pkgutil, opentransformer_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'opentransformer_tpu_torch.')]\n"
            "[importlib.import_module(m) for m in mods]\n"
            "import sys\n"
            "assert not any(k.split('.')[0] in ('jax', 'flax', 'yaml', 'opentransformer_tpu') for k in sys.modules)\n"
            "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
