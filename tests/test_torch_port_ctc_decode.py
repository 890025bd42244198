"""The port's CTC decoding against the JAX package, on the CPU: the greedy
collapse, the Python and native prefix beams, n-gram fusion and joint
CTC/attention rescoring.

Inputs are made with numpy from a seed. The collapse and the decoders'
token sequences must be identical; decoder scores agree within 1e-5 (both
packages call the same C++ on the same float32 input, or the same numpy
search); the rescored scores within 1e-4 (float32 CTC recursions in XLA
and PyTorch) and the rescored order identical.
"""

import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.recognize import base as jax_base
from opentransformer_tpu.recognize import ctc_decode as jax_ctc
from opentransformer_tpu.recognize import native_ctc as jax_native
from opentransformer_tpu.recognize.beam import BeamHypotheses as JaxHyp
from opentransformer_tpu_torch.recognize import base, native_ctc
from opentransformer_tpu_torch.recognize.beam import BeamHypotheses
from opentransformer_tpu_torch.recognize.ctc_decode import (
    ctc_collapse_ids,
    ctc_greedy_decode,
    ctc_prefix_beam_search,
)


def random_logprobs(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32) * 2
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


# ------------------------------------------------------------ collapse
@pytest.mark.parametrize("ids,valid,want", [
    ([0, 3, 3, 0, 3, 5, 5, 5, 0], 9, [3, 3, 5]),      # a repeat after a blank counts again
    ([4, 4, 4, 4], 4, [4]),                          # no blank: one symbol
    ([0, 0, 0, 0], 4, []),                           # all blank
    ([2, 7, 9, 1], 4, [2, 7, 9, 1]),                 # nothing dropped: slot t-1 is kept
    ([6, 0, 6, 6, 8, 8], 4, [6, 6]),                 # frames past the mask are blank
    ([5, 5, 0, 0, 5, 0], 0, []),                     # an empty row
])
def test_collapse_ids_of_hand_made_rows(ids, valid, want):
    t = len(ids)
    ids_np = np.asarray([ids], np.int32)
    mask = np.arange(t)[None] < valid
    tokens, lengths = ctc_collapse_ids(torch.from_numpy(ids_np), torch.from_numpy(mask))
    assert lengths.tolist() == [len(want)] and tokens.dtype == torch.int32
    assert tokens[0].tolist() == want + [0] * (t - len(want))
    jt, jl = jax_ctc.ctc_collapse_ids(jnp.asarray(ids_np), jnp.asarray(mask))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(0)
    lp = random_logprobs(rng, 4, 30, 6)
    lp[:, :, 0] += 1.0  # blanks common, as in a trained head
    lp[1, 3:5] = lp[1, 3]  # a tie on one frame: smallest id wins
    mask = np.arange(30)[None] < np.array([30, 22, 9, 1])[:, None]
    tokens, lengths = ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(mask))
    jt, jl = jax_ctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(mask))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    assert lengths.max() > 2


# ---------------------------------------------------------- prefix beams
@pytest.mark.parametrize("beam,prune", [(1, 6), (4, 3), (8, 6)])
def test_python_prefix_beam_matches_jax(beam, prune):
    rng = np.random.default_rng(beam)
    lp = random_logprobs(rng, 14, 6)
    got = ctc_prefix_beam_search(lp, 12, beam_width=beam, prune_k=prune)
    want = jax_ctc.ctc_prefix_beam_search(lp, 12, beam_width=beam, prune_k=prune)
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-12)


def test_native_dense_beam_matches_the_python_search_and_jax():
    rng = np.random.default_rng(1)
    b, t, v = 5, 20, 9
    lp = random_logprobs(rng, b, t, v)
    counts = np.array([20, 17, 12, 5, 1], np.int32)
    got = native_ctc.ctc_beam_decode(lp, counts, beam_width=6, prune_k=v, nbest=3)
    want = jax_native.ctc_beam_decode(lp, counts, beam_width=6, prune_k=v, nbest=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in range(b):
        py = ctc_prefix_beam_search(lp[i], counts[i], beam_width=6, prune_k=v)
        assert tuple(got[0][i, 0, : got[1][i, 0]].tolist()) == py[0][0]
        np.testing.assert_allclose(got[2][i, 0], py[0][1], rtol=0, atol=1e-4)


def test_native_sparse_beam_matches_jax_and_the_dense_beam():
    """Candidates as the fused top-k gives them: with N = prune_k the sparse
    search equals the dense one."""
    rng = np.random.default_rng(2)
    b, t, v, n = 4, 25, 40, 8
    lp = random_logprobs(rng, b, t, v)
    order = np.argsort(-lp, axis=-1, kind="stable")[:, :, :n]
    cand_lp = np.take_along_axis(lp, order, -1)
    counts = np.array([25, 21, 14, 3], np.int32)
    args = (cand_lp, order.astype(np.int32), lp[:, :, 0], counts)
    got = native_ctc.ctc_beam_decode_sparse(*args, beam_width=5, nbest=2)
    want = jax_native.ctc_beam_decode_sparse(*args, beam_width=5, nbest=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dense = native_ctc.ctc_beam_decode(lp, counts, beam_width=5, prune_k=n, nbest=2)
    np.testing.assert_array_equal(got[0], dense[0])
    np.testing.assert_allclose(got[2], dense[2], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="shapes"):
        native_ctc.ctc_beam_decode_sparse(cand_lp, order[:, :, :2].astype(np.int32),
                                          lp[:, :, 0], counts)
    with pytest.raises(ValueError, match="frame counts"):  # past the frames the C++ reads
        native_ctc.ctc_beam_decode_sparse(*args[:3], counts + 1)
    with pytest.raises(ValueError, match="frame counts"):
        native_ctc.ctc_beam_decode(lp, counts[:2])


ARPA = textwrap.dedent("""\
    \\data\\
    ngram 1=4
    ngram 2=2

    \\1-grams:
    -0.5\ta\t-0.3
    -1.5\tb\t-0.3
    -0.6\tc\t-0.3
    -0.5\t<s>\t-0.3

    \\2-grams:
    -2.0\ta b
    -0.1\ta c

    \\end\\
""")


@pytest.mark.parametrize("alpha,beta", [(0.0, 0.0), (1.0, 0.0), (2.0, 0.5)])
def test_ngram_fusion_matches_jax(tmp_path, alpha, beta):
    """A biased bigram flips an ambiguous frame from b to c as alpha grows;
    both packages load the same ARPA file (and its binary cache) and fuse
    it identically."""
    path = str(tmp_path / "lm.arpa")
    with open(path, "w") as f:
        f.write(ARPA)
    units = ["<blank>", "<s/e>", "<unk>", "a", "b", "c"]
    # frame 0: 'a'; frame 1: b slightly above c
    probs = np.array([[0.04, 0.01, 0.01, 0.90, 0.02, 0.02],
                      [0.04, 0.01, 0.01, 0.02, 0.49, 0.43]], np.float32)
    lp = np.log(probs)[None]
    counts = np.array([2], np.int32)
    lm = native_ctc.NgramLM(path, units)
    jlm = jax_native.NgramLM(path, units)
    assert lm.order == jlm.order == 2
    got = native_ctc.ctc_beam_decode(lp, counts, beam_width=4, prune_k=6, alpha=alpha,
                                     beta=beta, lm=lm, nbest=2)
    want = jax_native.ctc_beam_decode(lp, counts, beam_width=4, prune_k=6, alpha=alpha,
                                      beta=beta, lm=jlm, nbest=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    best = got[0][0, 0, : got[1][0, 0]].tolist()
    assert best == ([3, 4] if alpha == 0.0 else [3, 5])
    assert os.path.exists(path + ".otbin")  # the binary cache, read by the next load
    cached = native_ctc.NgramLM(path, units)
    again = native_ctc.ctc_beam_decode(lp, counts, beam_width=4, prune_k=6, alpha=alpha,
                                       beta=beta, lm=cached, nbest=2)
    for g, w in zip(again, got):
        np.testing.assert_array_equal(g, w)
    lm.close()
    cached.close()


def test_native_library_that_cannot_be_built_raises(tmp_path, monkeypatch):
    """No silent fallback to the Python search: a failed build raises."""
    monkeypatch.setattr(native_ctc, "NATIVE_DIR", str(tmp_path))  # no Makefile there
    monkeypatch.setattr(native_ctc, "SO_PATH", str(tmp_path / "libctc_decoder.so"))
    with pytest.raises(RuntimeError, match="make"):
        native_ctc.ctc_beam_decode(np.zeros((1, 2, 3), np.float32), np.array([2], np.int32))


# ------------------------------------------------------------ rescoring
def rescoring_case(seed=0, b=3, k=4, u=7, t=12, v=9):
    """CTC logits f32[B, T, V], a frame mask, and an n-best list in the
    beam's layout (BOS ⧺ y ⧺ EOS…, lengths = 1 + len(y)); one hypothesis
    is too long for its frames (optax's finite ~1e5 cost)."""
    rng = np.random.default_rng(seed)
    logits = (2 * rng.normal(size=(b, t, v))).astype(np.float32)
    mask = np.arange(t)[None] < np.array([12, 9, 5])[:, None]
    tokens = np.full((b, k, u), 1, np.int64)
    lengths = rng.integers(1, u, size=(b, k))
    lengths[2, 1] = u - 1  # 6 labels + EOS in 5 frames
    for i in range(b):
        for j in range(k):
            tokens[i, j, 1 : lengths[i, j]] = rng.integers(2, v, size=lengths[i, j] - 1)
    tokens[0, 2, 2] = tokens[0, 2, 1]  # a repeated label
    scores = np.sort(rng.normal(size=(b, k)).astype(np.float32) * 3, axis=1)[:, ::-1].copy()
    return logits, mask, tokens, scores, lengths


@pytest.mark.parametrize("weight", [0.3, 0.7])
def test_ctc_rescore_scores_match_jax(weight):
    logits, mask, tokens, scores, lengths = rescoring_case()
    got = base.ctc_rescore_scores(
        torch.from_numpy(logits), torch.from_numpy(mask),
        BeamHypotheses(torch.from_numpy(tokens), torch.from_numpy(scores),
                       torch.from_numpy(lengths)), weight)
    want = jax_base.ctc_rescore_scores(
        jnp.asarray(logits), jnp.asarray(mask),
        JaxHyp(jnp.asarray(tokens, jnp.int32), jnp.asarray(scores),
               jnp.asarray(lengths, jnp.int32)), weight)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-4)
    assert (np.diff(got.scores.numpy(), axis=1) <= 0).all()
    assert got.scores.numpy().min() < -1e4  # the infeasible hypothesis, finite
    order_changed = (got.tokens.numpy() != tokens).any()
    assert order_changed  # the CTC scores re-rank the list
