"""LM shallow fusion and n-best rescoring in the port against the JAX package.

A small random speech2text model and a small random LM (transformer or
LSTM) exist in both packages with the same weights; both beam searches run
on the same encoder memory. N-best token ids and lengths must be identical;
scores agree within 1e-4 (float32, summation order differs between XLA and
PyTorch). The fused step runs the two-head top-k's plain version here (CPU
tensors); the CUDA kernel is held against it on the card
(``test_torch_port_gpu.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.recognize.base import lm_rescore as jax_lm_rescore
from opentransformer_tpu.recognize.base import make_memory_search as jax_memory_search
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.data import synth
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops import project_topk
from opentransformer_tpu_torch.recognize import base as port_base
from opentransformer_tpu_torch.recognize.base import lm_rescore, make_memory_search
from opentransformer_tpu_torch.recognize.beam import BeamHypotheses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
VOCAB = 50
MAX_LEN = 10
LM_WEIGHT = 0.5
MODEL_CFG = {
    "type": "speech2text",
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu",
                "residual_dropout": 0.0},
    # untied output layer: a random tied embedding mostly copies its input
    # token, and the decode would only repeat BOS
    "decoder": {"vocab_size": VOCAB, "d_model": 32, "n_heads": 4, "d_ff": 48,
                "memory_dim": 32, "n_blocks": 2, "activation": "glu",
                "residual_dropout": 0.0, "share_embedding": False},
}
LM_CFGS = {
    "transformer_lm": {"type": "transformer_lm", "vocab_size": VOCAB, "d_model": 16,
                       "n_heads": 2, "d_ff": 32, "num_blocks": 2, "share_embedding": False},
    "rnn_lm": {"type": "rnn_lm", "vocab_size": VOCAB, "num_layers": 2, "hidden_size": 24,
               "share_embedding": False},
}


@pytest.fixture(scope="module")
def memories():
    rng = np.random.default_rng(0)
    b, t = 3, 60
    feats = rng.normal(size=(b, t, 20)).astype(np.float32)
    mask = np.arange(t)[None] < np.array([60, 47, 30])[:, None]
    jm = jax_build_model(MODEL_CFG)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(mask),
        jnp.ones((b, 6), jnp.int32), jnp.asarray([5] * b)))
    tm = compat.load_into(build_model(MODEL_CFG, device="cpu"), params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    mem_j, mask_j = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask), method="encode")
    with torch.no_grad():
        mem_t, mask_t = tm.encode(torch.from_numpy(feats), torch.from_numpy(mask))
    return jm, params, mem_j, mask_j, tm, mem_t, mask_t


@pytest.fixture(scope="module", params=sorted(LM_CFGS))
def lms(request):
    cfg = LM_CFGS[request.param]
    jlm = jax_build_model(cfg)
    ones = jnp.ones((2, 8), jnp.int32)
    lm_params = jlm.init(jax.random.PRNGKey(7), ones, ones, jnp.asarray([8, 8], jnp.int32))
    tlm = compat.load_into(build_model(cfg, device="cpu"),
                           jax.tree_util.tree_map(np.asarray, lm_params))
    return jlm, lm_params, tlm


def _assert_same(hyp_t, hyp_j):
    np.testing.assert_array_equal(hyp_t.tokens.numpy(), np.asarray(hyp_j.tokens))
    np.testing.assert_array_equal(hyp_t.lengths.numpy(), np.asarray(hyp_j.lengths))
    np.testing.assert_allclose(hyp_t.scores.numpy(), np.asarray(hyp_j.scores), rtol=0, atol=1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("beam,eos_id", [(3, None), (3, -1), (1, None)],
                         ids=["beam3", "beam3_no_eos", "beam1"])
def test_fusion_search_matches_jax(memories, lms, beam, eos_id, fused):
    jm, params, mem_j, mask_j, tm, mem_t, mask_t = memories
    jlm, lm_params, tlm = lms
    hyp_j = jax_memory_search(jm, beam, MAX_LEN, lm=jlm, lm_params=lm_params,
                              lm_weight=LM_WEIGHT, eos_id=eos_id, fused_topk=fused)(
        params, mem_j, mask_j)
    hyp_t = make_memory_search(tm, beam, MAX_LEN, lm=tlm, lm_weight=LM_WEIGHT, eos_id=eos_id,
                               fused_topk=fused)(mem_t, mask_t)
    _assert_same(hyp_t, hyp_j)
    # beam 1 with an LM takes the beam path: length-penalized, not greedy sums
    assert tuple(hyp_t.tokens.shape) == (3, beam, MAX_LEN + 1)
    assert (np.diff(hyp_t.scores.numpy(), axis=1) <= 0).all()


def test_fusion_changes_the_result(memories, lms):
    """The LM really takes part: its weight moves scores, and weight 0
    through the fused two-head step gives the model's own decode."""
    *_, tm, mem_t, mask_t = memories
    tlm = lms[2]
    no_lm = make_memory_search(tm, 3, MAX_LEN)(mem_t, mask_t)
    zero = make_memory_search(tm, 3, MAX_LEN, lm=tlm, lm_weight=0.0)(mem_t, mask_t)
    fused = make_memory_search(tm, 3, MAX_LEN, lm=tlm, lm_weight=LM_WEIGHT)(mem_t, mask_t)
    assert torch.equal(zero.tokens, no_lm.tokens)
    torch.testing.assert_close(zero.scores, no_lm.scores, rtol=0, atol=1e-5)
    assert not torch.allclose(fused.scores, no_lm.scores, atol=1e-3)


@pytest.mark.parametrize("beam,fused,mismatch,expect", [
    (3, True, False, "fused"), (3, False, False, "unfused"), (3, True, True, "unfused"),
    (1, True, False, "fused"),
])
def test_which_step_the_search_takes(memories, lms, monkeypatch, beam, fused, mismatch, expect):
    """The fused two-head step needs ``fused_topk`` and equal vocabularies;
    otherwise the log-probs are materialized. The one-head fused step is
    never used with an LM."""
    *_, tm, mem_t, mask_t = memories
    tlm = lms[2]
    calls = {"two_head": 0, "one_head": 0}
    real2, real1 = project_topk.project2_logp_topk, project_topk.project_logp_topk

    def count2(*args):
        calls["two_head"] += 1
        return real2(*args)

    def count1(*args, **kwargs):
        calls["one_head"] += 1
        return real1(*args, **kwargs)

    monkeypatch.setattr(port_base, "project2_logp_topk", count2)
    monkeypatch.setattr("opentransformer_tpu_torch.models.decoder.project_logp_topk", count1)
    if mismatch:
        monkeypatch.setattr(tlm, "vocab_size", VOCAB + 1)
    make_memory_search(tm, beam, 4, lm=tlm, lm_weight=LM_WEIGHT, eos_id=-1,
                       fused_topk=fused)(mem_t, mask_t)
    assert calls["one_head"] == 0
    assert calls["two_head"] == (4 if expect == "fused" else 0)


def test_lm_rescore_matches_jax(memories, lms):
    jm, params, mem_j, mask_j, tm, mem_t, mask_t = memories
    jlm, lm_params, tlm = lms
    hyp_t = make_memory_search(tm, 3, MAX_LEN)(mem_t, mask_t)
    hyp_j = jax_memory_search(jm, 3, MAX_LEN)(params, mem_j, mask_j)
    _assert_same(hyp_t, hyp_j)
    res_t = lm_rescore(tlm, hyp_t, 2.0)
    res_j = jax_lm_rescore(None, jlm, lm_params, hyp_j, 2.0)
    _assert_same(res_t, res_j)
    assert (np.diff(res_t.scores.numpy(), axis=1) <= 0).all()
    # the weight is large enough that the LM reorders some n-best list
    assert not torch.equal(res_t.tokens, hyp_t.tokens)


def test_lm_rescore_keeps_order_on_ties():
    """Equal rescored values keep their order (stable sort), and only the
    tokens before ``lengths`` count."""
    tlm = build_model(LM_CFGS["rnn_lm"], device="cpu")
    tokens = torch.tensor([[[1, 5, 6, 2, 2], [1, 5, 6, 2, 9], [1, 7, 2, 2, 2]]])
    hyp = BeamHypotheses(tokens=tokens, scores=torch.tensor([[-1.0, -1.0, -1.0]]),
                         lengths=torch.tensor([[3, 3, 2]]))
    res = lm_rescore(tlm, hyp, 0.5)
    # slots 0 and 1 differ only past their length: same score, order kept
    assert res.scores[0, (res.tokens[0, :, 4] == 9).nonzero()[0, 0]] == \
        res.scores[0, (res.tokens[0, :, 1] == 5).nonzero()[0, 0]]
    first_of_pair = [i for i in range(3) if res.tokens[0, i, 1] == 5]
    assert res.tokens[0, first_of_pair[0], 4] == 2 and res.tokens[0, first_of_pair[1], 4] == 9


@pytest.mark.parametrize("lm_type", sorted(LM_CFGS))
def test_eval_cli_with_lm(tmp_path, lm_type):
    """``cli/eval.py -lm`` on a tiny corpus: a seeded random LM over the
    anchor's vocabulary, written as an npz, joins the beam; the artifacts
    appear and n-best scores come out sorted, with rescoring too."""
    with open(ANCHOR + ".manifest.json") as f:
        vocab = json.load(f)["model_cfg"]["decoder"]["vocab_size"]
    lm_cfg = dict(LM_CFGS[lm_type], vocab_size=vocab, share_embedding=True)
    torch.manual_seed(0)
    lm = build_model(lm_cfg, device="cpu")
    compat.save_npz(str(tmp_path / "lm.npz"), compat.params_to_jax(lm))
    (tmp_path / "lm.json").write_text(json.dumps(lm_cfg))
    data = tmp_path / "data"
    synth.write_corpus(str(data), splits=("test",), n_utts={"test": 4})

    def run(name, *extra):
        out = tmp_path / name
        rc = eval_cli.main([
            "--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
            "--feats", str(data / "test" / "feats.scp"), "--text", str(data / "test" / "text"),
            "--vocab", str(data / "vocab"), "-b", "2", "-bw", "3", "-ml", "32",
            "--decode_dir", str(out), "--device", "cpu",
            "-lm", str(tmp_path / "lm.npz"), "--lm_cfg", str(tmp_path / "lm.json"), *extra])
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
        return float(result[0].split()[1].rstrip("%")), nbest

    cer0, nbest0 = run("lmw0", "-lmw", "0.0")
    assert cer0 < 5.0  # weight 0: the model's own decode
    _, nbest1 = run("lmw", "-lmw", "0.1")
    assert nbest1 != nbest0
    _, nbest2 = run("resc", "-lmw", "0.1", "-lm_resc", "0.1")
    assert nbest2 != nbest1


def test_eval_cli_lm_needs_its_config(tmp_path):
    with pytest.raises(SystemExit, match="lm_cfg"):
        eval_cli.main(["--npz", "x.npz", "--model_cfg", "x.json", "--feats", "f", "--text", "t",
                       "--vocab", "v", "--decode_dir", str(tmp_path), "--device", "cpu",
                       "-lm", "lm.npz"])
