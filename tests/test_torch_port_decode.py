"""The port's beam/greedy search and the anchor decode against the JAX package.

Decodes run on the same encoder memory (or the same padded features) in
both packages. Token ids must be identical; scores agree within 1e-4
(float32, summation order differs between XLA and PyTorch).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.recognize.base import SpeechToTextRecognizer as JaxRecognizer
from opentransformer_tpu.recognize.base import make_memory_search as jax_memory_search
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.data import synth
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer, make_memory_search
from opentransformer_tpu_torch.recognize.beam import length_penalty

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
VOCAB = 50


def _small_cfg():
    return {
        "type": "speech2text",
        "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
        "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu",
                    "residual_dropout": 0.0},
        "decoder": {"vocab_size": VOCAB, "d_model": 32, "n_heads": 4, "d_ff": 48,
                    "memory_dim": 32, "n_blocks": 2, "activation": "glu",
                    "residual_dropout": 0.0},
    }


@pytest.fixture(scope="module")
def memories():
    """A small random model in both packages and its encoder memory. The
    output layer is untied: a random tied embedding mostly copies its input
    token, so the decode would only repeat BOS; with this seed the beams
    differ and some end on EOS early."""
    cfg = _small_cfg()
    cfg["decoder"]["share_embedding"] = False
    rng = np.random.default_rng(0)
    b, t = 3, 60
    feats = rng.normal(size=(b, t, 20)).astype(np.float32)
    mask = np.arange(t)[None] < np.array([60, 47, 30])[:, None]
    jm = jax_build_model(cfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(mask),
        jnp.ones((b, 6), jnp.int32), jnp.asarray([5] * b)))
    tm = compat.load_into(build_model(cfg, device="cpu"), params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    mem_j, mask_j = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask), method="encode")
    with torch.no_grad():
        mem_t, mask_t = tm.encode(torch.from_numpy(feats), torch.from_numpy(mask))
    return jm, params, mem_j, mask_j, tm, mem_t, mask_t


@pytest.mark.parametrize("beam,eos_id", [(4, None), (4, -1), (4, VOCAB), (1, None), (1, -1)],
                         ids=["beam4", "beam4_no_eos", "beam4_oov_eos", "greedy", "greedy_no_eos"])
def test_search_matches_jax(memories, beam, eos_id):
    jm, params, mem_j, mask_j, tm, mem_t, mask_t = memories
    hyp_j = jax_memory_search(jm, beam, 10, eos_id=eos_id)(params, mem_j, mask_j)
    hyp_t = make_memory_search(tm, beam, 10, eos_id=eos_id)(mem_t, mask_t)
    np.testing.assert_array_equal(hyp_t.tokens.numpy(), np.asarray(hyp_j.tokens))
    np.testing.assert_array_equal(hyp_t.lengths.numpy(), np.asarray(hyp_j.lengths))
    np.testing.assert_allclose(hyp_t.scores.numpy(), np.asarray(hyp_j.scores), rtol=0, atol=1e-4)
    if beam > 1:
        assert (np.diff(hyp_t.scores.numpy(), axis=1) <= 0).all()


@pytest.mark.parametrize("beam", [1, 4])
def test_unfused_search_matches_fused(memories, beam):
    *_, tm, mem_t, mask_t = memories
    fused = make_memory_search(tm, beam, 10)(mem_t, mask_t)
    plain = make_memory_search(tm, beam, 10, fused_topk=False)(mem_t, mask_t)
    assert torch.equal(fused.tokens, plain.tokens)
    torch.testing.assert_close(fused.scores, plain.scores, rtol=0, atol=1e-5)


def test_length_penalty():
    lens = torch.tensor([1, 6, 20])
    expect = ((5.0 + lens.double()) / 6.0) ** 0.6
    torch.testing.assert_close(length_penalty(lens, 0.6), expect.float())


def _anchor_batch(n):
    utts = list(synth.gen_split("test", n))
    t = -(-max(u[1].shape[0] for u in utts) // 32) * 32
    feats = np.zeros((n, t, synth.FEAT_DIM), np.float32)
    mask = np.zeros((n, t), bool)
    for i, (_, x, _) in enumerate(utts):
        feats[i, : len(x)] = x
        mask[i, : len(x)] = True
    return utts, feats, mask


def test_anchor_one_best_matches_jax():
    """The committed anchor checkpoint in both packages: identical 1-best
    ids on the first 4 synthetic test utterances (beam 5, max_len 32, f32)."""
    with open(ANCHOR + ".manifest.json") as f:
        cfg = json.load(f)["model_cfg"]
    tree = compat.load_npz(ANCHOR + ".npz")
    _, feats, mask = _anchor_batch(4)

    jm = jax_build_model(cfg)
    jrec = JaxRecognizer(jm, jax.tree_util.tree_map(jnp.asarray, tree), beam_width=5, max_len=32)
    hyp_j = jrec.recognize_arrays(jnp.asarray(feats), jnp.asarray(mask))

    tm = compat.load_into(build_model(cfg, device="cpu"), tree)
    hyp_t = SpeechToTextRecognizer(tm, beam_width=5, max_len=32).recognize_arrays(
        torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_array_equal(hyp_t.tokens[:, 0].numpy(), np.asarray(hyp_j.tokens)[:, 0])
    np.testing.assert_allclose(hyp_t.scores[:, 0].numpy(), np.asarray(hyp_j.scores)[:, 0],
                               rtol=0, atol=1e-3)


def test_eval_cli_writes_results(tmp_path):
    data = tmp_path / "data"
    synth.write_corpus(str(data), splits=("test",), n_utts={"test": 4})
    out = tmp_path / "decode"
    rc = eval_cli.main([
        "--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
        "--feats", str(data / "test" / "feats.scp"), "--text", str(data / "test" / "text"),
        "--vocab", str(data / "vocab"), "-b", "2", "-bw", "3", "-ml", "32",
        "--decode_dir", str(out), "--device", "cpu"])
    assert rc == 0
    assert len((out / "predict.txt").read_text().splitlines()) == 4
    nbest = {}
    for line in (out / "predict.log").read_text().splitlines():
        utt, _, score = line.split()[:3]
        nbest.setdefault(utt, []).append(float(score.split("=")[1]))
    assert len(nbest) == 4 and all(len(s) == 3 for s in nbest.values())
    assert all(s == sorted(s, reverse=True) for s in nbest.values())
    result = (out / "RESULT").read_text().splitlines()
    assert result[0].startswith("CER ") and result[3].startswith("UTTS 4 ")
    cer = float(result[0].split()[1].rstrip("%"))
    assert cer < 5.0, result[0]
