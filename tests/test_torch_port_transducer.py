"""The port's transducer against the JAX package, on the CPU.

The prediction network (sequence and step), the joint (full, step and
``step_argmax``), the greedy lattice walk (ids exact, with and without its
caps binding), the mAES beam (ids exact, scores within 1e-5 relative)
without an LM and with an LSTM or a transformer LM fused, the transformer
LM's decode step at per-row positions, the streaming and multi-stream
recognizers (against JAX's and against the port's offline greedy, a slot
reused), ``build_recognizer``, the eval CLI, the weights' round trip, and
the committed full-width fixture's first utterance (the port alone).

The module runs PyTorch on one thread: its ops are small, and the suite
runs several test processes at once, where PyTorch's default of one
thread a core oversubscribes the CPU many times over.

Small models (d32, 2 encoder blocks, a 2-layer d32 predictor, d_joint 24,
V = 40, chunk 4, left 2), inputs from numpy seeds, the JAX weights carried
over by ``compat``, the joint's blank bias raised by 0.65 so that the greedy
walk both emits and blanks. Tolerances: float32 module outputs within 1e-5
absolute (XLA and PyTorch sum in other orders); token ids equal; beam
scores within 1e-5 relative; the fixture at ``chip_smoke``'s limits.
"""

import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.recognize import multistream as jax_ms
from opentransformer_tpu.recognize import online as jax_online
from opentransformer_tpu.recognize.base import make_lm_adapter as jax_lm_adapter
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.data import write_vocab
from opentransformer_tpu_torch.data.kaldi_io import write_ark
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize import multistream, online
from opentransformer_tpu_torch.recognize.base import (
    TransducerRecognizer,
    build_recognizer,
    make_lm_adapter,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ATOL = 1e-5
SCORE_RTOL = 1e-5
F_IN, D, V = 12, 32, 40
BLANK_BIAS = 0.65
CFG = {"type": "transducer", "frontend_type": "conv",
       "frontend": {"input_size": F_IN, "output_size": D, "mid_channel": 4, "out_channel": 8},
       "encoder_type": "transformer",
       "encoder": {"d_model": D, "n_heads": 2, "d_ff": 48, "n_blocks": 2, "residual_dropout": 0.0,
                   "activation": "glu", "chunk_size": 4, "left_chunks": 2},
       "vocab_size": V, "predictor": {"num_layers": 2, "d_model": D, "dropout": 0.1},
       "d_joint": 24, "joint_t_block": -1}
LM_CFGS = {
    "rnn_lm": {"type": "rnn_lm", "vocab_size": V, "num_layers": 2, "hidden_size": 32,
               "share_embedding": True},
    "transformer_lm": {"type": "transformer_lm", "vocab_size": V, "num_blocks": 2, "d_model": 32,
                       "n_heads": 2, "d_ff": 48, "share_embedding": False},
}
LENS = (97, 60, 81)
BEAM = dict(beam_width=4, max_symbols=60, expansions=2)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(port model on the CPU, JAX model, JAX variables, JAX-layout numpy
    params) with the same seeded weights."""
    model = build_model(CFG, device="cpu")
    params = chip_smoke.seeded_transducer_params(model, 0, BLANK_BIAS)
    compat.load_into(model, params)
    return model, jax_build_model(CFG), jax.tree_util.tree_map(jnp.asarray, params), params


@pytest.fixture(scope="module")
def inputs():
    """Three ragged utterances [3, 97, F] (zero past their end) and masks."""
    rng = np.random.default_rng(1)
    x = np.zeros((len(LENS), max(LENS), F_IN), np.float32)
    for i, n in enumerate(LENS):
        x[i, :n] = rng.normal(size=(n, F_IN))
    return x, np.arange(max(LENS))[None] < np.array(LENS)[:, None]


@pytest.fixture(scope="module")
def lms():
    """{kind: (port LM, JAX LM, JAX variables)} with the same seeded weights."""
    out = {}
    for i, (kind, cfg) in enumerate(LM_CFGS.items()):
        lm = build_model(cfg, device="cpu")
        params = chip_smoke.seeded_params(lm, 4 + i)
        compat.load_into(lm, params)
        out[kind] = (lm, jax_build_model(cfg), jax.tree_util.tree_map(jnp.asarray, params))
    return out


@pytest.fixture(scope="module")
def greedy(pair, inputs):
    """The JAX package's greedy ids of ``inputs`` → [utt] lists."""
    _, jm, variables, _ = pair
    tokens, n = jm.apply(variables, *map(jnp.asarray, inputs), 200, 8, method="greedy_decode")
    return [np.asarray(tokens)[i, :k].tolist() for i, k in enumerate(np.asarray(n))]


def port_inputs(inputs):
    return torch.from_numpy(inputs[0]), torch.from_numpy(inputs[1])


# ------------------------------------------------------------------ modules
def test_prediction_network_matches_jax(pair):
    model, jm, variables, _ = pair
    tokens = np.random.default_rng(2).integers(0, V, size=(3, 6))
    want = jm.apply(variables, jnp.asarray(tokens), method=lambda m, t: m.predictor(t))
    with torch.no_grad():
        close(model.predictor(torch.from_numpy(tokens)), want)
        state, hidden = model.init_decode_state(3)
        jstate, jhidden = jm.apply(variables, 3, method="init_decode_state")
        close(state, jstate)
        for step in range(3):  # BOS-primed steps equal the sequence's positions 1..
            state, hidden = model.predictor.decode_step(torch.from_numpy(tokens[:, step]), hidden)
            jstate, jhidden = jm.apply(variables, jnp.asarray(tokens[:, step]), jhidden,
                                       method=lambda m, t, h: m.predictor.decode_step(t, h))
            close(state, jstate)
            for (c, h), (jc, jh) in zip(hidden, jhidden):
                close(c, jc)
                close(h, jh)


@pytest.mark.parametrize("what", ["forward", "step", "step_argmax"])
def test_joint_network_matches_jax(pair, what):
    model, jm, variables, _ = pair
    rng = np.random.default_rng(3)
    if what == "forward":
        enc, pred = rng.normal(size=(2, 5, D)), rng.normal(size=(2, 4, D))
    else:
        enc, pred = rng.normal(size=(64, D)), rng.normal(size=(64, D))
    enc, pred = enc.astype(np.float32), pred.astype(np.float32)
    fn = {"forward": lambda m, e, p: m.joint(e, p), "step": lambda m, e, p: m.joint.step(e, p),
          "step_argmax": lambda m, e, p: m.joint.step_argmax(e, p)}[what]
    want = np.asarray(jm.apply(variables, jnp.asarray(enc), jnp.asarray(pred), method=fn))
    with torch.no_grad():
        got = getattr(model.joint, "forward" if what == "forward" else what)(
            torch.from_numpy(enc), torch.from_numpy(pred))
    if what == "step_argmax":
        assert got.tolist() == want.tolist()
    else:
        close(got, want)


def test_forward_raises_and_names_the_roadmap(pair, inputs):
    """The forward used to raise: it is now the RNN-T loss, JAX's to 1e-5
    relative on the ragged inputs (eval mode: no predictor dropout). An MoE
    encoder, which raised too, now builds and adds its load-balance loss as
    JAX's does (the port's weights carried over; 1e-5 relative)."""
    model, jm, variables, _ = pair
    rng = np.random.default_rng(8)
    ulens = np.array([5, 0, 9])
    targets = np.zeros((len(LENS), 12), np.int32)
    targets[:, 0] = 1
    for i, u in enumerate(ulens):
        targets[i, 1 : 1 + u] = rng.integers(3, V, size=u)
        targets[i, 1 + u] = 1
    tlen = (ulens + 1).astype(np.int32)
    want, _ = jm.apply(variables, *map(jnp.asarray, (*inputs, targets, tlen)))
    with torch.no_grad():
        got, aux = model(*port_inputs(inputs), torch.from_numpy(targets), torch.from_numpy(tlen))
    assert aux == {} and abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    moe = dict(CFG, encoder=dict(CFG["encoder"], moe_experts=2), moe_aux_weight=0.05)
    moe_model = build_model(moe, device="cpu")
    args = (*inputs, targets, tlen)
    want, jaux = jax.jit(jax_build_model(moe).apply)(compat.params_to_jax(moe_model),
                                                     *map(jnp.asarray, args))
    with torch.no_grad():
        got, aux = moe_model(*port_inputs(inputs), torch.from_numpy(targets),
                             torch.from_numpy(tlen))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert abs(aux["moe_aux"].item() - float(jaux["moe_aux"])) <= 1e-5 * float(jaux["moe_aux"])


def test_params_round_trip_and_match_the_jax_tree(pair, inputs):
    model, jm, _, params = pair
    x, m = map(jnp.asarray, inputs)
    targets = jnp.ones((len(LENS), 5), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, m, targets,
                                            jnp.full((len(LENS),), 4, jnp.int32)))
    want = {"/".join(map(str, k)): v.shape for k, v in compat._flatten(shapes)}
    got = {"/".join(k): v.shape for k, v in compat._flatten(compat.params_to_jax(model))}
    assert got == want
    back = compat.params_from_jax(compat.params_to_jax(model))
    assert back.keys() == model.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    assert "predictor/lstm_1/cell/ii/kernel" in "\n".join(want)


# ------------------------------------------------------------------ decoders
def test_greedy_decode_matches_jax(pair, inputs, greedy):
    model = pair[0]
    it0 = model.greedy_iterations
    tokens, n = model.greedy_decode(*port_inputs(inputs), 200, 8)
    got = [tokens[i, :k].tolist() for i, k in enumerate(n.tolist())]
    assert got == greedy
    lengths = [len(g) for g in greedy]
    assert 0 < min(lengths) and max(lengths) < 8 * 23  # emits, blanks, and no cap binds
    assert model.greedy_iterations - it0 >= max(lengths)


@pytest.mark.parametrize("max_symbols,max_per_frame", [(5, 8), (200, 1)])
def test_greedy_caps_match_jax(pair, inputs, max_symbols, max_per_frame):
    model, jm, variables, _ = pair
    want = jm.apply(variables, *map(jnp.asarray, inputs), max_symbols, max_per_frame,
                    method="greedy_decode")
    tokens, n = model.greedy_decode(*port_inputs(inputs), max_symbols, max_per_frame)
    assert tokens.tolist() == np.asarray(want[0]).tolist()
    assert n.tolist() == np.asarray(want[1]).tolist()


@pytest.mark.parametrize("kind", ["none", "rnn_lm", "transformer_lm"])
def test_beam_decode_matches_jax(pair, inputs, lms, kind):
    model, jm, variables, _ = pair
    lm_init = lm_step = jlm_init = jlm_step = None
    weight = 0.0
    if kind != "none":
        lm, jlm, jlm_vars = lms[kind]
        lm_init, lm_step = make_lm_adapter(lm, BEAM["max_symbols"])
        jlm_init, jlm_step = jax_lm_adapter(jlm, jlm_vars, BEAM["max_symbols"])
        weight = 0.3
    args = (BEAM["beam_width"], BEAM["max_symbols"], BEAM["expansions"])
    want = jm.apply(variables, *map(jnp.asarray, inputs), *args, jlm_init, jlm_step, weight,
                    method="beam_decode")
    tokens, lens, scores = model.beam_decode(*port_inputs(inputs), *args, lm_init, lm_step,
                                             weight)
    assert tokens.tolist() == np.asarray(want[0]).tolist()
    assert lens.tolist() == np.asarray(want[1]).tolist()
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[2]), rtol=SCORE_RTOL, atol=0)
    assert (scores[:, :-1] >= scores[:, 1:]).all() and lens.max() > 0


@pytest.mark.parametrize("index", [[0, 3, 7, 11, 12], 5], ids=["per-row", "scalar"])
def test_transformer_lm_decode_step_matches_jax(lms, index):
    """Per-row positions (12 lies past the 12-position cache: nothing is
    written there, as the JAX package's one-hot write) and a scalar one."""
    lm, jlm, jvars = lms["transformer_lm"]
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, V, size=5)
    cache = [{key: rng.normal(size=(5, 2, 12, 16)).astype(np.float32) for key in ("k", "v")}
             for _ in range(2)]
    want_lp, want_cache = jlm.apply(jvars, jnp.asarray(tokens),
                                    jax.tree_util.tree_map(jnp.asarray, cache),
                                    jnp.asarray(index), method="decode_step")
    port_cache = [{key: torch.from_numpy(val.copy()) for key, val in lc.items()} for lc in cache]
    idx = torch.tensor(index) if isinstance(index, list) else index
    with torch.no_grad():
        got_lp, got_cache = lm.decode_step(torch.from_numpy(tokens), port_cache, idx)
    close(got_lp, want_lp)
    for g, w in zip(got_cache, want_cache):
        for key in ("k", "v"):
            close(g[key], w[key])


# --------------------------------------------------------------- streaming
def _streamed_texts(rec, x, lens):
    return [" ".join(map(str, chip_smoke.feed_stream(rec, x[i: i + 1, :n])))
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def streamed(pair, inputs):
    """Each utterance alone through the port's and JAX's
    ``StreamingTransducerRecognizer`` → (port texts, JAX texts)."""
    model, jm, variables, _ = pair
    x, _ = inputs
    return (_streamed_texts(online.StreamingTransducerRecognizer(model), x, LENS),
            _streamed_texts(jax_online.StreamingTransducerRecognizer(jm, variables), x, LENS))


def test_streaming_recognizer_matches_jax_and_the_offline_greedy(pair, inputs, streamed):
    model = pair[0]
    x, mask = inputs
    got, want = streamed
    assert got == want
    offline = chip_smoke.offline_transducer_ids(model, x, mask,
                                                {"max_symbols": 10_000, "max_per_frame": 8})
    assert got == [" ".join(map(str, ids)) for ids in offline]
    assert any(got)


def test_online_adapter_decodes_a_transducer(pair, inputs, streamed):
    model = pair[0]
    adapter = online.OnlineRecognizerAdapter("transducer", model, max_per_frame=8)
    texts, scores = adapter.recognize(*port_inputs(inputs))
    assert [t[0] for t in texts] == streamed[0] and scores.shape == (len(LENS), 1)


def test_multistream_transducer_matches_single_streams_and_jax(pair, inputs, streamed):
    """Two slots for three ragged utterances and utterance 0 again: two
    slots take a second stream; every FINAL equals the stream decoded
    alone, and JAX's server gives the same."""
    model, jm, variables, _ = pair
    x, mask = inputs
    ms = multistream.MultiStreamTransducer(model, n_streams=2)
    slots, finals = chip_smoke.multistream_reuse(ms, x, mask)
    assert [finals[i] for i in range(len(LENS))] == streamed[0] and finals["again"] == finals[0]
    assert ms.free_slots() == 2 and sorted(slots.values()) == [0, 0, 1, 1]
    jslots, jfinals = chip_smoke.multistream_reuse(
        jax_ms.MultiStreamTransducer(jm, variables, n_streams=2), x, mask)
    assert jfinals == finals and jslots == slots


# ----------------------------------------------------------- recognizer, CLI
def test_build_recognizer_transducer(pair, inputs, greedy, caplog, lms):
    model = pair[0]
    rec = build_recognizer("transducer", model, args={"beam_width": 1, "max_len": 200})
    assert isinstance(rec, TransducerRecognizer)
    texts, scores = rec.recognize(*port_inputs(inputs))
    assert [t[0] for t in texts] == [" ".join("<UNK>" for _ in g) for g in greedy]
    assert scores.shape == (len(LENS), 1) and not scores.any()
    rec = build_recognizer("transducer", model, args={"beam_width": 4, "nbest": 2,
                                                      "max_len": 60})
    texts, scores = rec.recognize(*port_inputs(inputs))
    want = model.beam_decode(*port_inputs(inputs), 4, 60, 2)[2][:, :2]
    assert len(texts[0]) == 2 and np.array_equal(scores, want.numpy())
    with caplog.at_level(logging.WARNING):
        build_recognizer("transducer", model, lm=lms["rnn_lm"][0], args={"beam_width": 1})
    assert "greedy" in caplog.text and "ignores the LM" in caplog.text


@pytest.mark.parametrize("name,flags", [
    ("greedy", ["-md", "greedy"]),
    ("beam", ["-bw", "4", "-nb", "3", "-ml", "60"]),
    ("beam+lm", ["-bw", "4", "-nb", "2", "-ml", "60", "-lmw", "0.3"]),
])
def test_eval_cli_decodes_a_transducer(tmp_path, pair, inputs, lms, name, flags):
    model, _, _, params = pair
    x, mask = inputs
    units = {"<PAD>": 0, "<S/E>": 1, "<UNK>": 2, **{f"u{i}": i for i in range(3, V)}}
    write_vocab(units, str(tmp_path / "vocab"))
    utts = {f"utt{i}": x[i, :n] for i, n in enumerate(LENS)}
    write_ark(str(tmp_path / "feats.ark"), utts, str(tmp_path / "feats.scp"))
    (tmp_path / "text").write_text("".join(f"{u} u5 u9\n" for u in utts))
    compat.save_npz(str(tmp_path / "w.npz"), params, dtype=np.float32)
    (tmp_path / "cfg.json").write_text(json.dumps({"model": CFG}))
    lm = None
    if "-lmw" in flags:
        lm = lms["transformer_lm"][0]
        compat.save_npz(str(tmp_path / "lm.npz"), compat.params_to_jax(lm), dtype=np.float32)
        (tmp_path / "lm.json").write_text(json.dumps(LM_CFGS["transformer_lm"]))
        flags = [*flags, "-lm", str(tmp_path / "lm.npz"), "--lm_cfg", str(tmp_path / "lm.json")]
    out = tmp_path / "decode"
    rc = eval_cli.main(["--npz", str(tmp_path / "w.npz"), "--model_cfg", str(tmp_path / "cfg.json"),
                        "--feats", str(tmp_path / "feats.scp"), "--text", str(tmp_path / "text"),
                        "--vocab", str(tmp_path / "vocab"), "-b", "2", "--decode_dir", str(out),
                        "--device", "cpu", *flags])
    assert rc == 0
    idx2unit = {i: u for u, i in units.items()}
    args = vars(eval_cli.build_argparser().parse_args(
        ["--npz", "x", "--model_cfg", "x", "--feats", "x", "--text", "x", "--vocab", "x",
         "--decode_dir", "x", *flags]))
    if args["mode"] == "greedy":
        args["beam_width"] = 1
    rec = build_recognizer("transducer", model, lm=lm, args=args, idx2unit=idx2unit)
    want, width = [], 0
    for s in range(0, len(LENS), 2):
        names = list(utts)[s: s + 2]
        feats, m, _ = eval_cli.collate([utts[u] for u in names])
        texts, _ = rec.recognize(torch.from_numpy(feats), torch.from_numpy(m))
        want += [f"{u} {t[0]}".rstrip() for u, t in zip(names, texts)]
        width = len(texts[0])
    got = [line.rstrip() for line in (out / "predict.txt").read_text().splitlines()]
    assert got == want
    nbest = {}
    for line in (out / "predict.log").read_text().splitlines():
        utt, _, score = line.split()[:3]
        nbest.setdefault(utt, []).append(float(score.split("=")[1]))
    assert width == {"greedy": 1, "beam": 3, "beam+lm": 2}[name]
    assert all(len(s) == width and s == sorted(s, reverse=True) for s in nbest.values())
    assert (out / "RESULT").read_text().splitlines()[3].startswith(f"UTTS {len(LENS)} ")


# --------------------------------------------------------- committed fixture
def test_port_matches_the_committed_fixture_at_full_width():
    """The port alone, without JAX, against ``transducer_seeded.jax.json``:
    the first utterance at full width (memory, path log-probs, greedy ids,
    the plain beam's n-best, whose 1-best holds labels, the streamed ids),
    at chip_smoke's limits."""
    fixture = chip_smoke.load_transducer_fixture()
    c = fixture["inputs"]
    feats, mask, targets = chip_smoke.transducer_inputs(c)
    feats, mask, targets = feats[:1], mask[:1], targets[:1]
    model, _ = chip_smoke.seeded_transducer("transducer", c, device="cpu", want=fixture)
    out = chip_smoke.transducer_outputs(model, feats, mask, targets, c)
    want = {k: v[:1] for k, v in fixture["results"]["transducer"].items()
            if k in ("memory", "logp", "greedy")}
    got = chip_smoke.transducer_parity(out, want)
    assert got["memory"] <= chip_smoke.TRANSDUCER_MEMORY_ATOL and got["frames_differ"] == 0
    assert got["logp"] <= chip_smoke.TRANSDUCER_LOGP_ATOL and got["ids_differ"] == 0
    assert out["iterations"] > 0 and all(out["greedy"])
    beam = chip_smoke.transducer_beam(model, feats, mask, c)
    want = {k: v[:1] for k, v in fixture["results"]["transducer"]["beam"]["none"].items()}
    got = chip_smoke.beam_parity(beam, want)
    assert got["nbest_differ"] == 0 and got["unsorted"] == 0 and len(beam["ids"][0][0]) > 0
    assert got["score_rtol"] <= chip_smoke.TRANSDUCER_SCORE_RTOL
    model, _ = chip_smoke.seeded_transducer("transducer_streaming", c, device="cpu",
                                            want=fixture)
    rec = online.StreamingTransducerRecognizer(model, max_per_frame=c["max_per_frame"])
    assert (chip_smoke.streamed_transducer_ids(rec, feats, mask)
            == fixture["results"]["transducer_streaming"]["streamed"][:1])
