"""The port's CTC loss, CTC head and CTC model against the JAX package, on
the CPU.

Inputs are made with numpy from a seed; small models are initialised in
JAX and carried over with ``compat.params_from_jax``. The JAX package runs
as its own tests run it here: ``project_logp_topk`` through its XLA path.
Tolerances:

* the CTC loss of each sequence 1e-5 relative, optax's finite value on an
  infeasible row included; its gradient 1e-5 of the gradient's scale on
  every feasible row. On an infeasible row the recursion's states sit near
  -1e5, where float32's spacing is 2**-7, so each weight exp(a - total) of
  the gradient carries ~1% rounding in either package: each package's
  float32 gradient lies ~3e-3 of the scale from a float64 evaluation, and
  that row's gradient is held to 1e-2 of the scale;
* frame logits, log-probs and losses of the models 1e-4 absolute (the
  repository's model tolerance: XLA and PyTorch sum in other orders), top-k
  ids identical;
* the hybrid loss and every gradient of a small model 1e-5 relative; one
  full update of the anchor configuration (JAX-initialised) against the
  JAX Trainer 1e-5 on every parameter, as ``test_torch_port_train.py``
  holds the baseline's. The update is SGD with momentum: Adam's first step
  moves each parameter by about ±lr whatever the size of its gradient, so
  a weight whose decayed gradient is ~1e-7 (4 of the CTC head's 541,824
  here) steps by the sign of float32 rounding; Adam itself is held by the
  baseline's test;
* the committed CTC fixture's first 20 utterances: ids identical.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.ops.loss import ctc_loss as jax_ctc_loss
from opentransformer_tpu.recognize import base as jax_base
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer
from opentransformer_tpu.train.trainer import TrainState, wave_speech_batch
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.cli.eval import collate
from opentransformer_tpu_torch.data import synth
from opentransformer_tpu_torch.data.device_pipeline import collate_waveforms, make_device_frontend
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.models.speech2text import CTCModel
from opentransformer_tpu_torch.ops.loss import ctc_loss, ctc_neg_log_likelihood
from opentransformer_tpu_torch.recognize import base
from opentransformer_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
sys.path.insert(0, os.path.join(REPO, "tools"))
from torch_port_ctc_parity import best_ids, ctc_model_cfg  # noqa: E402

ATOL = 1e-4
VOCAB = 50
N_CHECKED = 20


def small_cfg(kind="speech2text", lookahead=0):
    cfg = {
        "type": "speech2text",
        "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8,
                     "dropout": 0.0},
        "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2,
                    "activation": "glu", "residual_dropout": 0.0},
        "decoder": {"vocab_size": VOCAB, "d_model": 32, "n_heads": 4, "d_ff": 48,
                    "memory_dim": 32, "n_blocks": 2, "activation": "glu",
                    "residual_dropout": 0.0},
        "ctc_weight": 0.3, "lookahead_steps": lookahead,
    }
    if kind == "ctc":
        return dict(ctc_model_cfg(cfg), lookahead_steps=lookahead)
    return cfg


def model_inputs(seed=0, b=3, t=60):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 20)).astype(np.float32)
    mask = np.arange(t)[None] < np.array([60, 45, 33])[:b, None]
    ulens = np.array([6, 4, 3])[:b]  # y + EOS fits each utterance's 14, 10, 7 frames
    targets = np.zeros((b, ulens.max() + 2), np.int32)
    for i, u in enumerate(ulens):
        targets[i, 0] = 1
        targets[i, 1 : 1 + u] = rng.integers(3, VOCAB, size=u)
        targets[i, 1 + u] = 1
    targets[0, 3] = targets[0, 2]  # a repeated label
    return feats, mask, targets, (ulens + 1).astype(np.int32)


def pair(cfg, seed=0):
    """(JAX model, its params as numpy, the port's model with the same weights)."""
    jm = jax_build_model(cfg)
    args = model_inputs(seed)
    params = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), *map(jnp.asarray, args)))
    return jm, params, compat.load_into(build_model(cfg, device="cpu"), params)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ------------------------------------------------------------------ loss
def ctc_case():
    """Logits f32[5, 9, 7] and the labels of five sequences: a repeated
    label, padded frames, both, an infeasible one (6 labels in 4 frames:
    optax's finite ~1e5) and an empty one."""
    rng = np.random.default_rng(0)
    logits = (2 * rng.normal(size=(5, 9, 7))).astype(np.float32)
    labels = np.array([[4, 6, 6, 0, 0, 0], [2, 5, 3, 1, 0, 0], [2, 3, 3, 2, 4, 0],
                       [3, 2, 2, 4, 4, 1], [0, 0, 0, 0, 0, 0]], np.int32)
    logit_lens = np.array([9, 6, 7, 4, 9], np.int32)
    label_lens = np.array([3, 4, 5, 6, 0], np.int32)
    return logits, labels, logit_lens, label_lens


def test_ctc_neg_log_likelihood_matches_optax_per_sequence():
    logits, labels, logit_lens, label_lens = ctc_case()
    logit_pad = np.arange(logits.shape[1])[None] >= logit_lens[:, None]
    label_pad = np.arange(labels.shape[1])[None] >= label_lens[:, None]
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_pad, np.float32),
                                     jnp.asarray(labels), jnp.asarray(label_pad, np.float32)))
    got = ctc_neg_log_likelihood(torch.from_numpy(logits), torch.from_numpy(logit_pad),
                                 torch.from_numpy(labels), torch.from_numpy(label_pad)).numpy()
    assert 1e5 < want[3] < 1.1e5  # optax's finite value where no alignment exists
    assert (np.delete(want, 3) < 100).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # F.ctc_loss gives inf there: the port must not stand on it
    f = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(logit_lens).long(),
        torch.from_numpy(label_lens).long(), reduction="none")
    assert torch.isinf(f[3]) and np.isfinite(got[3])


def test_ctc_loss_and_gradient_match_jax():
    logits, labels, logit_lens, label_lens = ctc_case()
    args = [jnp.asarray(a) for a in (logit_lens, labels, label_lens)]
    loss_j, grad_j = jax.value_and_grad(lambda x: jax_ctc_loss(x, *args))(jnp.asarray(logits))
    grad_j = np.asarray(grad_j)
    x = torch.from_numpy(logits).requires_grad_()
    loss_t = ctc_loss(x, *(torch.from_numpy(a) for a in (logit_lens, labels, label_lens)))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    scale = np.abs(grad_j).max()
    infeasible = 3
    for row in range(logits.shape[0]):
        tol = 1e-2 if row == infeasible else 1e-5
        np.testing.assert_allclose(x.grad[row].numpy(), grad_j[row], rtol=0, atol=tol * scale,
                                   err_msg=f"row {row}")


def test_aligned_batches_take_the_native_loss_and_match_jax():
    """Without the infeasible row every sequence aligns: ``ctc_loss`` takes
    ``F.ctc_loss`` and still gives JAX's loss and gradient to 1e-5; with it,
    the recursion (the test above)."""
    from opentransformer_tpu_torch.ops.loss import all_aligned

    logits, labels, logit_lens, label_lens = (np.delete(a, 3, axis=0) for a in ctc_case())
    pad = lambda lens, n: torch.arange(n)[None] >= torch.from_numpy(lens)[:, None]  # noqa: E731
    assert all_aligned(torch.from_numpy(logit_lens), torch.from_numpy(labels),
                       pad(label_lens, labels.shape[1]))
    full = ctc_case()
    assert not all_aligned(torch.from_numpy(full[2]), torch.from_numpy(full[1]),
                           pad(full[3], full[1].shape[1]))
    args = [jnp.asarray(a) for a in (logit_lens, labels, label_lens)]
    loss_j, grad_j = jax.value_and_grad(lambda x: jax_ctc_loss(x, *args))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss_t = ctc_loss(x, *(torch.from_numpy(a) for a in (logit_lens, labels, label_lens)))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    scale = np.abs(np.asarray(grad_j)).max()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), rtol=0, atol=1e-5 * scale)


# -------------------------------------------------------------- CTC head
@pytest.mark.parametrize("lookahead", [0, 2])
def test_ctc_head_of_speech2text_matches_jax(lookahead):
    cfg = small_cfg(lookahead=lookahead)
    jm, params, tm = pair(cfg)
    feats, mask = model_inputs()[:2]
    memory = jm.apply(params, jnp.asarray(feats), jnp.asarray(mask), method="encode")[0]
    mem_t = torch.from_numpy(np.array(memory))
    logits_j = jm.apply(params, memory, method="ctc_logits")
    with torch.no_grad():
        logits_t = tm.ctc_logits(mem_t)
        vals_t, ids_t, blank_t = tm.ctc.project_topk(mem_t, 5, with_label=0)
        vals1_t, ids1_t = tm.ctc.project_topk(mem_t, 1)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=ATOL)
    vals_j, ids_j, blank_j = jm.apply(
        params, memory, method=lambda m, x: m.assistor.project_topk(x, 5, with_label=0))
    vals1_j, ids1_j = jm.apply(params, memory,
                               method=lambda m, x: m.assistor.project_topk(x, 1))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(ids1_t.numpy(), np.asarray(ids1_j))
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(vals1_t.numpy(), np.asarray(vals1_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(blank_t.numpy(), np.asarray(blank_j), rtol=0, atol=ATOL)
    if lookahead:
        conv = params["params"]["ctc"]["look_ahead_conv"]["kernel"]
        assert conv.shape == (lookahead + 1, 1, 32)
        assert tuple(tm.ctc.look_ahead_conv.weight.shape) == (32, 1, lookahead + 1)


@pytest.mark.parametrize("lookahead", [0, 2])
def test_ctc_model_matches_jax(lookahead):
    jm, params, tm = pair(small_cfg("ctc", lookahead), seed=1)
    assert isinstance(tm, CTCModel)
    feats, mask, targets, tlen = model_inputs(seed=1)
    jx = [jnp.asarray(a) for a in (feats, mask)]
    tx = [torch.from_numpy(a) for a in (feats, mask)]
    with torch.no_grad():
        lp_t, m_t = tm.recognize_logits(*tx)
        ids_t, _ = tm.recognize_argmax(*tx)
        vals_t, top_t, blank_t, _ = tm.recognize_topk(*tx, 8)
        loss_t = tm(*tx, torch.from_numpy(targets).long(), torch.from_numpy(tlen).long())[0]
    lp_j, m_j = jm.apply(params, *jx, method="recognize_logits")
    ids_j, _ = jm.apply(params, *jx, method="recognize_argmax")
    vals_j, top_j, blank_j, _ = jm.apply(params, *jx, 8, method="recognize_topk")
    loss_j = jm.apply(params, *jx, jnp.asarray(targets), jnp.asarray(tlen))[0]
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(top_t.numpy(), np.asarray(top_j))
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(blank_t.numpy(), np.asarray(blank_j), rtol=0, atol=ATOL)
    assert abs(loss_t.item() - float(loss_j)) <= ATOL


def test_hybrid_loss_and_every_gradient_match_jax():
    cfg = small_cfg(lookahead=2)
    jm, params, tm = pair(cfg, seed=2)
    args = model_inputs(seed=2)

    def loss_fn(p):
        loss, aux = jm.apply({"params": p}, *map(jnp.asarray, args))
        return loss, aux

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["params"])
    loss_t, aux_t = tm(*(torch.from_numpy(a) for a in args[:2]),
                       *(torch.from_numpy(a).long() for a in args[2:]))
    loss_t.backward()
    assert sorted(aux_t) == sorted(aux_j) == ["att_loss", "ctc_loss"]
    for got, want in ((loss_t, loss_j), *((aux_t[k], aux_j[k]) for k in aux_j)):
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    got = flat(compat.params_to_jax(_grads_as_params(tm))["params"])
    want = flat(jax.tree_util.tree_map(np.asarray, grads_j))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5 * scale, err_msg=key)


def _grads_as_params(model):
    """A copy of ``model`` whose parameters hold their ``.grad``."""
    import copy

    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), clone.parameters()):
            q.copy_(p.grad)
    return clone


def anchor_cfg_no_dropout():
    """The anchor's model configuration with dropout off (the two packages
    draw different dropout masks)."""
    with open(ANCHOR + ".manifest.json") as f:
        cfg = json.load(f)["model_cfg"]
    cfg = json.loads(json.dumps(cfg))
    cfg["encoder"]["residual_dropout"] = cfg["decoder"]["residual_dropout"] = 0.0
    return cfg


def test_one_hybrid_update_of_the_anchor_matches_jax_trainer():
    """The anchor's configuration from a JAX initialisation: one update of
    two accumulated micro-batches of seeded waveforms at the hybrid loss
    (w = 0.3), clipping at 5, SGD with momentum and weight decay at the
    Noam rate of step 1."""
    from opentransformer_tpu.data.device_pipeline import make_device_frontend as jax_frontend

    cfg = anchor_cfg_no_dropout()
    data_cfg = {"num_mel_bins": 40, "normalization": True, "spec_augment": False}
    train_cfg = {"optimizer_type": "sgd",
                 "optimizer": {"momentum": 0.9, "weight_decay": 1.0e-2},
                 "scheduler_type": "transformer",
                 "scheduler": {"model_size": 128, "warmup_steps": 4, "factor": 1.0},
                 "clip_grad": 5, "accum_steps": 2, "grad_noise": 0.0, "epochs": 1}
    rng = np.random.default_rng(5)
    batches = []
    for s in range(2):
        items = []
        for i in range(2):
            n = int(rng.uniform(0.8, 1.2) * 16000)
            t = np.arange(n) / 16000.0
            w = (0.05 * rng.normal(size=n) + 0.2 * np.sin(2 * np.pi * (200 + 90 * i) * t))
            y = list(rng.integers(3, 4233, size=rng.integers(4, 8)))
            items.append((f"b{s}-{i}", w.astype(np.float32), n, y, len(y)))
        batches.append(collate_waveforms(items))
    jfront = jax_frontend(data_cfg)

    def preprocess(waveforms, wave_lengths, targets, targets_length, *, rng, train):
        feats, mask = jfront(waveforms, wave_lengths, rng, train=train)
        return feats, mask, targets, targets_length

    jm = jax_build_model(cfg)
    jt = JaxTrainer(train_cfg, jm, batch_fn=wave_speech_batch, preprocess_fn=preprocess)
    init_args = preprocess(*wave_speech_batch(batches[0]), rng=None, train=False)
    params0 = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(jax.random.PRNGKey(3),
                                                                *init_args))
    jparams = jax.tree_util.tree_map(jnp.asarray, params0)
    state = TrainState(params=jparams, opt_state=jt.tx.init(jparams["params"]),
                       nan_skips=jnp.zeros((), jnp.int32))
    opt0 = jax.tree_util.tree_map(np.array, state.opt_state)
    grad_fn, update_fn = jt._build_grad_fn(), jt._build_update_fn()
    variables, gacc, losses_j = state.params, jt._zeros_like_grads(state.params), []
    for i, batch in enumerate(batches):
        variables, gacc, loss, _ = grad_fn(variables, gacc, wave_speech_batch(batch),
                                           jax.random.PRNGKey(i), None)
        losses_j.append(float(loss))
    lr = jt.schedule(1, 0)
    gnorm_j = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(gacc))))
    new_vars, _, skips, _ = update_fn(variables, opt0, gacc, state.nan_skips, lr,
                                      jax.random.PRNGKey(9))
    assert int(skips) == 0 and gnorm_j > train_cfg["clip_grad"]  # the clip acts

    model = compat.load_into(build_model(cfg, device="cpu"), params0)
    trainer = Trainer(train_cfg, model, make_device_frontend(data_cfg, "cpu"),
                      torch.Generator().manual_seed(0))
    model.train()
    for batch in batches:
        trainer.micro_step(batch)
    rec = trainer.update()
    assert rec["applied"] and rec["lr"] == lr
    np.testing.assert_allclose(rec["losses"], losses_j, rtol=1e-5)
    assert abs(rec["gnorm"] - gnorm_j) <= 1e-5 * gnorm_j
    got = flat(compat.params_to_jax(model)["params"])
    want = flat(jax.tree_util.tree_map(np.asarray, new_vars["params"]))
    before = flat(params0["params"])
    assert max(float(np.abs(want[k] - before[k]).max()) for k in want) > 10 * 1e-5
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5, err_msg=key)


# ----------------------------------------------------- weights, registry
def test_ctc_model_loads_from_a_speech2text_tree_without_its_decoder():
    with open(ANCHOR + ".manifest.json") as f:
        cfg = json.load(f)["model_cfg"]
    tree = compat.load_npz(ANCHOR + ".npz")
    ccfg = ctc_model_cfg(cfg)
    model = compat.load_ctc_from_speech2text(build_model(ccfg, device="cpu"), tree)
    s2t = compat.load_into(build_model(cfg, device="cpu"), tree)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, s2t.state_dict()[name], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Unexpected"):  # load_into stays strict
        compat.load_into(build_model(ccfg, device="cpu"), tree)
    extra = {"params": dict(tree["params"], lm={"w": np.zeros(3, np.float32)})}
    with pytest.raises(RuntimeError, match="Unexpected"):
        compat.load_ctc_from_speech2text(build_model(ccfg, device="cpu"), extra)
    ctc = dict(tree["params"]["ctc"])
    ctc["output_layer"] = {"dense": {"kernel": ctc["output_layer"]["dense"]["kernel"]}}
    missing = {"params": dict(tree["params"], ctc=ctc)}
    with pytest.raises(RuntimeError, match="Missing"):
        compat.load_ctc_from_speech2text(build_model(ccfg, device="cpu"), missing)
    with pytest.raises(KeyError, match="decoder"):
        compat.load_ctc_from_speech2text(build_model(ccfg, device="cpu"),
                                         {"params": {"ctc": tree["params"]["ctc"]}})


@pytest.mark.parametrize("kind", ["speech2text", "ctc"])
def test_lookahead_weights_round_trip_through_the_jax_layout(kind):
    """The port's weights in the JAX layout have the JAX model's names and
    shapes, and load back unchanged."""
    cfg = small_cfg(kind, lookahead=3)
    tm = build_model(cfg, device="cpu")
    tree = compat.params_to_jax(tm)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, model_inputs()))
    shapes = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), shapes)
    assert {k: v.shape for k, v in flat(tree).items()} == \
        {k: v.shape for k, v in flat(shapes).items()}
    back = compat.load_into(build_model(cfg, device="cpu"), tree)
    for name, p in tm.state_dict().items():
        torch.testing.assert_close(back.state_dict()[name], p, rtol=0, atol=0)


def test_registry_builds_ctc_and_keeps_lookahead_to_a_ctc_head():
    model = build_model(small_cfg("ctc", lookahead=2), device="cpu")
    assert isinstance(model, CTCModel) and model.ctc.lookahead_steps == 2
    cfg = small_cfg(lookahead=2)
    cfg["ctc_weight"] = 0.0
    with pytest.raises(ValueError, match="CTC head"):
        build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="CTC head"):
        base.SpeechToTextRecognizer(build_model(dict(cfg, lookahead_steps=0), device="cpu"),
                                    ctc_weight=0.3)


# ------------------------------------------- the anchor and its fixture
@pytest.fixture(scope="module")
def fixture_batch():
    """The first 20 utterances, padded to the frame count of the batch of
    100 they were decoded in (the fixture's batching)."""
    with open(ANCHOR + ".jax_ctc.json", encoding="utf-8") as f:
        fixture = json.load(f)["decodes"]
    size = fixture["greedy"]["decode"]["batch_size"]
    batch = list(synth.gen_split("test", size))
    _, _, lens = collate([u[1] for u in batch])
    x, mask, _ = collate([u[1] for u in batch[:N_CHECKED]])
    frames = -(-max(lens) // 32) * 32
    x = np.pad(x, ((0, 0), (0, frames - x.shape[1]), (0, 0)))
    mask = np.pad(mask, ((0, 0), (0, frames - mask.shape[1])))
    return fixture, [u[0] for u in batch[:N_CHECKED]], x, mask


@pytest.mark.parametrize("name", ["greedy", "beam", "ctcw"])
def test_fixture_first_utterances_equal_jax_and_port(fixture_batch, name):
    from torch_port_ctc_parity import DECODES, recognizers

    fixture, utts, x, mask = fixture_batch
    want = fixture[name]
    assert want["decode"] == dict(DECODES[name], batch_size=100)
    assert list(want["utts"]) == [f"test{i:05d}" for i in range(500)]
    jax_texts, port_texts = recognizers(name)
    best_j, best_t = best_ids(jax_texts(x, mask)), best_ids(port_texts(x, mask))
    for i, utt in enumerate(utts):
        assert best_j[i] == want["utts"][utt], utt
        assert best_t[i] == want["utts"][utt], utt


@pytest.mark.parametrize("name,flags", [
    ("greedy", ["-md", "greedy"]),
    ("beam", ["-bw", "5", "-prune", "32", "-nb", "3"]),
    ("ctcw", ["-bw", "3", "-ml", "32", "-ctcw", "0.3"]),
])
def test_eval_cli_decodes_ctc_models_and_rescores(tmp_path, name, flags):
    data = tmp_path / "data"
    synth.write_corpus(str(data), splits=("test",), n_utts={"test": 4})
    model_cfg = ANCHOR + ".manifest.json"
    if name != "ctcw":
        with open(model_cfg) as f:
            cfg = ctc_model_cfg(json.load(f)["model_cfg"])
        model_cfg = str(tmp_path / "ctc.json")
        with open(model_cfg, "w") as f:
            json.dump(cfg, f)
    out = tmp_path / "decode"
    rc = eval_cli.main([
        "--npz", ANCHOR + ".npz", "--model_cfg", model_cfg,
        "--feats", str(data / "test" / "feats.scp"), "--text", str(data / "test" / "text"),
        "--vocab", str(data / "vocab"), "-b", "2", "--decode_dir", str(out),
        "--device", "cpu", *flags])
    assert rc == 0
    assert len((out / "predict.txt").read_text().splitlines()) == 4
    nbest = {}
    for line in (out / "predict.log").read_text().splitlines():
        utt, _, score = line.split()[:3]
        nbest.setdefault(utt, []).append(float(score.split("=")[1]))
    width = {"greedy": 1, "beam": 3, "ctcw": 3}[name]
    assert len(nbest) == 4 and all(len(s) == width for s in nbest.values())
    assert all(s == sorted(s, reverse=True) for s in nbest.values())
    result = (out / "RESULT").read_text().splitlines()
    assert result[0].startswith("CER ") and result[3].startswith("UTTS 4 ")
    assert float(result[0].split()[1].rstrip("%")) < 5.0, result[0]


def test_jax_and_port_ctc_recognizers_agree_on_a_small_model(tmp_path):
    """Greedy, beam 4 (n-best 3) and beam 4 with a bigram fused, of a small
    random CTC model with a look-ahead conv: identical texts, n-best scores
    within 1e-4."""
    jm, params, tm = pair(small_cfg("ctc", lookahead=2), seed=3)
    feats, mask = model_inputs(seed=3)[:2]
    units = {i: f"u{i}" for i in range(VOCAB)}
    arpa = str(tmp_path / "lm.arpa")
    with open(arpa, "w") as f:
        f.write("\\data\\\nngram 1=3\nngram 2=1\n\n\\1-grams:\n-0.5\tu5\t-0.3\n"
                "-1.0\tu9\t-0.3\n-0.5\t<s>\t-0.3\n\n\\2-grams:\n-0.1\tu5 u9\n\n"
                "\\end\\\n")
    for args in ({"beam_width": 1}, {"beam_width": 4, "nbest": 3, "prune_k": 10},
                 {"beam_width": 4, "nbest": 2, "prune_k": 10, "ngram_lm": arpa,
                  "alpha": 0.5, "beta": 0.2}):
        jrec = jax_base.build_recognizer("ctc", jm, jax.tree_util.tree_map(jnp.asarray, params),
                                         args=args, idx2unit=units)
        trec = base.build_recognizer("ctc", tm, args=args, idx2unit=units)
        texts_j, scores_j = jrec.recognize(jnp.asarray(feats), jnp.asarray(mask))
        texts_t, scores_t = trec.recognize(torch.from_numpy(feats), torch.from_numpy(mask))
        assert texts_t == texts_j, args
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=0, atol=1e-4)


def test_speech2text_recognizer_rescores_as_jax_at_beam_1_and_with_an_lm():
    """-ctcw at beam 1 runs the beam path (length-penalised scores), without
    and with a transformer LM fused: ids identical, scores within 1e-4."""
    jm, params, tm = pair(dict(small_cfg(lookahead=2),
                               decoder=dict(small_cfg()["decoder"], share_embedding=False)),
                          seed=4)
    lm_cfg = {"type": "transformer_lm", "vocab_size": VOCAB, "d_model": 16, "n_heads": 2,
              "d_ff": 32, "num_blocks": 2, "share_embedding": False}
    jlm = jax_build_model(lm_cfg)
    ones = jnp.ones((2, 8), jnp.int32)
    lm_params = jax.tree_util.tree_map(np.asarray, jlm.init(
        jax.random.PRNGKey(7), ones, ones, jnp.asarray([8, 8], jnp.int32)))
    tlm = compat.load_into(build_model(lm_cfg, device="cpu"), lm_params)
    feats, mask = model_inputs(seed=4)[:2]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for beam, with_lm in ((1, False), (1, True)):
        kw = dict(beam_width=beam, max_len=8, ctc_weight=0.3)
        jrec = jax_base.SpeechToTextRecognizer(
            jm, jparams, lm=jlm if with_lm else None,
            lm_params=jax.tree_util.tree_map(jnp.asarray, lm_params) if with_lm else None, **kw)
        trec = base.SpeechToTextRecognizer(tm, lm=tlm if with_lm else None, **kw)
        hyp_j = jrec.recognize_arrays(jnp.asarray(feats), jnp.asarray(mask))
        hyp_t = trec.recognize_arrays(torch.from_numpy(feats), torch.from_numpy(mask))
        np.testing.assert_array_equal(hyp_t.tokens.numpy(), np.asarray(hyp_j.tokens))
        np.testing.assert_array_equal(hyp_t.lengths.numpy(), np.asarray(hyp_j.lengths))
        np.testing.assert_allclose(hyp_t.scores.numpy(), np.asarray(hyp_j.scores), rtol=0,
                                   atol=1e-4)
