"""Training every model family the port decodes, against the JAX package, on
the CPU: the RNN-T loss, the transducer's blocked joint and training loss,
BatchNorm in training, one Trainer update of a transducer, a BatchNorm
conformer, a ``ctc`` model and each LM, the text data, the LM configs, and a
one-epoch CLI rehearsal of each family with a checkpoint that reloads and a
decode that runs.

The module runs PyTorch on one thread (the suite runs several test
processes at once). Inputs come from numpy seeds; the JAX weights are
carried over by ``compat``; every dropout rate is 0 where the two packages
are compared, so both runs are deterministic. Tolerances: the RNN-T loss
1e-5 relative, its gradient w.r.t. the log-probs 1e-5 absolute (both are
float32 sums in other orders); the blocked joint's log-probs 1e-5 absolute;
a model's loss 1e-5 relative and every parameter's gradient 1e-5 relative
to its tensor's scale; BatchNorm outputs 1e-5 absolute in float32 and one
bfloat16 rounding step (2^-8 relative) under bfloat16, its statistics 1e-6
absolute; one update's parameters 1e-5 (but for elements where Adam's
first step turns rounding into a full step, see the test) and running
statistics 1e-6 absolute; the text data exactly.
"""

import copy
import itertools
import json
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader
from opentransformer_tpu.data.loader import collate_text as jax_collate_text
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.ops.rnnt_loss import rnnt_loss as jax_rnnt_loss
from opentransformer_tpu.ops.rnnt_loss import rnnt_loss_from_blank_emit as jax_rnnt_blank_emit
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer
from opentransformer_tpu.train.trainer import TrainState, default_speech_batch, lm_batch
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.config import CONF_DIR, load_config
from opentransformer_tpu_torch.data.datasets import TextDataset
from opentransformer_tpu_torch.data.loader import FeatureLoader, collate_speech, collate_text
from opentransformer_tpu_torch.models.modules import BatchNorm
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops.rnnt_loss import rnnt_loss, rnnt_loss_from_blank_emit
from opentransformer_tpu_torch.train.trainer import Trainer, feature_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from test_torch_port_train import TRAIN_CFG, flat  # noqa: E402
from test_transducer import brute_force_rnnt  # noqa: E402

ATOL = 1e-5
F_IN, D, V = 12, 32, 40
FRONT = {"input_size": F_IN, "output_size": D, "mid_channel": 4, "out_channel": 8}
TRANSFORMER = {"d_model": D, "n_heads": 2, "d_ff": 48, "n_blocks": 2, "residual_dropout": 0.0}
CONFORMER = {"d_model": D, "n_heads": 2, "d_ff": 48, "nblocks": 1, "cov_kernel_size": 5,
             "residual_dropout": 0.0, "conv_norm_type": "batch"}
CFGS = {
    "transducer": {"type": "transducer", "frontend_type": "conv", "frontend": FRONT,
                   "encoder_type": "transformer", "encoder": TRANSFORMER, "vocab_size": V,
                   "predictor": {"num_layers": 2, "d_model": D, "dropout": 0.0}, "d_joint": 24},
    "batch_norm_conformer": {
        "type": "speech2text", "frontend_type": "conv", "frontend": FRONT,
        "encoder_type": "conformer", "encoder": CONFORMER, "ctc_weight": 0.3,
        "decoder": {"vocab_size": V, "d_model": D, "n_heads": 2, "d_ff": 48, "memory_dim": D,
                    "n_blocks": 1, "residual_dropout": 0.0, "activation": "glu"}},
    "ctc": {"type": "ctc", "frontend_type": "conv", "frontend": FRONT,
            "encoder_type": "transformer", "encoder": TRANSFORMER, "vocab_size": V,
            "lookahead_steps": 2},
    "transformer_lm": {"type": "transformer_lm", "vocab_size": V, "num_blocks": 2, "d_model": D,
                       "n_heads": 2, "d_ff": 48, "residual_dropout": 0.0, "smoothing": 0.1},
    "rnn_lm": {"type": "rnn_lm", "vocab_size": V, "num_layers": 2, "hidden_size": D,
               "dropout": 0.0, "smoothing": 0.1, "share_embedding": False},
}
LM_TYPES = ("transformer_lm", "rnn_lm")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def close_rel(got, want, rel=1e-5, key=""):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=rel * scale,
                               err_msg=key)


def grad_tree(model):
    """The parameters' ``.grad`` in the JAX layout."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), clone.parameters()):
            q.copy_(p.grad)
    return compat.params_to_jax(clone)["params"]


# ------------------------------------------------------------------ RNN-T loss
LOSS_CASES = {  # (T, U, frame lengths, label lengths): a U = 0 row and a T_b = 1 row
    "ragged": (9, 6, [9, 1, 5, 7, 3], [6, 0, 3, 2, 6]),
    "long_frames": (40, 3, [40, 17, 1], [3, 3, 0]),
    "long_labels": (6, 24, [6, 6, 2, 1], [24, 11, 0, 5]),
}


def lattice(t, u, b, seed, v=7, wider=2):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, u + 1, v)).astype(np.float32) * 3.0
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.integers(1, v, (b, u + wider)).astype(np.int32)  # wider than U: tolerated
    return lp, labels


def rnnt_float64(lp, labels, t_lens, u_lens):
    """Loss and gradient w.r.t. the log-probs in float64, by the forward
    (α) and backward (β) variables of each lattice: d loss / d lp(t, u, k)
    is minus the posterior of the arc that reads it."""
    lp = lp.astype(np.float64)
    loss, grad = np.zeros(lp.shape[0]), np.zeros_like(lp)
    for i, (t_n, u_n) in enumerate(zip(t_lens, u_lens)):
        lpb = lp[i, :, :, 0]
        em = np.take_along_axis(lp[i, :, :-1], labels[i, None, : lp.shape[2] - 1, None], -1)[..., 0]
        a = np.full((t_n, u_n + 1), -np.inf)
        bt = np.full((t_n + 1, u_n + 2), -np.inf)
        for t, u in itertools.product(range(t_n), range(u_n + 1)):
            a[t, u] = 0.0 if t == u == 0 else np.logaddexp(
                a[t - 1, u] + lpb[t - 1, u] if t else -np.inf,
                a[t, u - 1] + em[t, u - 1] if u else -np.inf)
        bt[t_n, u_n] = 0.0  # past the terminal blank
        for t, u in itertools.product(reversed(range(t_n)), reversed(range(u_n + 1))):
            bt[t, u] = np.logaddexp(bt[t + 1, u] + lpb[t, u] if t + 1 < t_n or u == u_n
                                    else -np.inf,
                                    bt[t, u + 1] + em[t, u] if u < u_n else -np.inf)
        ll = bt[0, 0]
        loss[i] = -ll
        for t, u in itertools.product(range(t_n), range(u_n + 1)):
            nxt = bt[t + 1, u] if t + 1 < t_n or u == u_n else -np.inf
            grad[i, t, u, 0] -= np.exp(a[t, u] + lpb[t, u] + nxt - ll)
            if u < u_n:
                grad[i, t, u, labels[i, u]] -= np.exp(a[t, u] + em[t, u] + bt[t, u + 1] - ll)
    return loss, grad


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_rnnt_loss_and_its_gradient_match_jax(case):
    """Loss and gradient against JAX and against float64. JAX's float32
    associative scan strays from the float64 gradient by up to 1.3e-5 on
    the 40-frame lattice, so the port's gradient may differ from JAX's by
    1e-5 plus JAX's own distance from float64, elementwise."""
    t, u, t_lens, u_lens = LOSS_CASES[case]
    lp, labels = lattice(t, u, len(t_lens), seed=len(case))
    t_lens, u_lens = np.asarray(t_lens, np.int32), np.asarray(u_lens, np.int32)

    def jax_sum(x):
        rows = jax_rnnt_loss(x, jnp.asarray(labels), jnp.asarray(t_lens), jnp.asarray(u_lens))
        return jnp.sum(rows), rows

    (_, want), want_grad = jax.value_and_grad(jax_sum, has_aux=True)(jnp.asarray(lp))
    want, want_grad = np.asarray(want), np.asarray(want_grad)
    loss64, grad64 = rnnt_float64(lp, labels, t_lens, u_lens)
    x = torch.tensor(lp, requires_grad=True)
    got = rnnt_loss(x, torch.from_numpy(labels), torch.from_numpy(t_lens),
                    torch.from_numpy(u_lens))
    got.sum().backward()
    grad = x.grad.numpy()
    assert got.dtype == torch.float32 and got.shape == (len(t_lens),)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), loss64, rtol=1e-5)
    np.testing.assert_allclose(grad, grad64, rtol=0, atol=1e-5)
    assert (np.abs(grad - want_grad) <= 1e-5 + np.abs(want_grad - grad64)).all()


def test_rnnt_loss_from_blank_emit_matches_jax():
    lp, labels = lattice(11, 5, 3, seed=7, wider=0)
    lp_blank = lp[..., 0]
    emit = np.take_along_axis(lp[:, :, :5, :], labels[:, None, :, None], axis=-1)[..., 0]
    t_lens, u_lens = np.array([11, 6, 2], np.int32), np.array([5, 2, 1], np.int32)
    want = np.asarray(jax_rnnt_blank_emit(*map(jnp.asarray, (lp_blank, emit, t_lens, u_lens))))
    got = rnnt_loss_from_blank_emit(*(torch.tensor(a) for a in (lp_blank, emit, t_lens, u_lens)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_rnnt_loss_matches_brute_force():
    b, t, u, v = 3, 4, 3, 6
    rng = np.random.default_rng(0)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(b, t, u + 1, v)).astype(
        np.float32)), dim=-1)
    labels = rng.integers(1, v, (b, u))
    t_lens, u_lens = np.array([4, 3, 2]), np.array([3, 2, 1])
    got = rnnt_loss(lp, torch.from_numpy(labels), torch.from_numpy(t_lens),
                    torch.from_numpy(u_lens))
    want = [brute_force_rnnt(lp[i].numpy(), labels[i], t_lens[i], u_lens[i]) for i in range(b)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# ----------------------------------------------------------- the transducer
def speech_inputs(seed=0, lens=(60, 45, 30), ulens=(7, 0, 3), width=10):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lens), max(lens), F_IN), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.normal(size=(n, F_IN))
    mask = np.arange(max(lens))[None] < np.asarray(lens)[:, None]
    targets = np.zeros((len(lens), width), np.int32)
    targets[:, 0] = 1
    for i, u in enumerate(ulens):
        targets[i, 1 : 1 + u] = rng.integers(3, V, size=u)
        targets[i, 1 + u] = 1
    return x, mask, targets, (np.asarray(ulens) + 1).astype(np.int32)


@pytest.fixture(scope="module")
def transducer():
    """(JAX model, JAX-layout numpy variables, inputs)."""
    jm = jax_build_model(CFGS["transducer"])
    args = speech_inputs()
    return jm, np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, args))), args


def port_model(cfg, variables):
    return compat.load_into(build_model(cfg, device="cpu"), variables)


def joint_inputs(seed=3, b=2, t=37, u1=6, de=D, dp=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, de)).astype(np.float32),
            rng.normal(size=(b, u1, dp)).astype(np.float32),
            rng.integers(0, V, (b, u1 - 1)).astype(np.int32))


@pytest.mark.parametrize("t_block", [1, 3, 16])
def test_blank_emit_log_probs_match_jax_and_the_full_joint(transducer, t_block):
    jm, variables, _ = transducer
    enc, pred, labels = joint_inputs()
    want = jm.apply(variables, *map(jnp.asarray, (enc, pred, labels)), t_block=t_block,
                    method=lambda m, *a, **k: m.joint.blank_emit_log_probs(*a, **k))
    joint = port_model(CFGS["transducer"], variables).joint
    e, p = torch.tensor(enc, requires_grad=True), torch.tensor(pred, requires_grad=True)
    lpb, em = joint.blank_emit_log_probs(e, p, torch.from_numpy(labels), t_block=t_block)
    for got, w in zip((lpb, em), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)
    # the full joint's slices, and the same gradients through both
    lp = torch.log_softmax(joint(e, p), dim=-1)
    full_b = lp[..., 0]
    full_e = torch.gather(lp[:, :, :-1], 3, torch.from_numpy(labels).long()[:, None, :, None]
                          .expand(-1, lp.shape[1], -1, 1))[..., 0]
    np.testing.assert_allclose(lpb.detach().numpy(), full_b.detach().numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(em.detach().numpy(), full_e.detach().numpy(), rtol=0, atol=ATOL)
    g_blocked = torch.autograd.grad((lpb.sum() + em.sum()), (e, p))
    g_full = torch.autograd.grad((full_b.sum() + full_e.sum()), (e, p))
    for a, b in zip(g_blocked, g_full):
        close_rel(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def transducer_jax_losses(transducer):
    """JAX's loss and gradients at joint_t_block 0, 16 and -1."""
    _, variables, args = transducer
    out = {}
    for t_block in (0, 16, -1):
        jm = jax_build_model(dict(CFGS["transducer"], joint_t_block=t_block))
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
            {"params": p}, *map(jnp.asarray, args))[0]))(variables["params"])
        out[t_block] = (float(loss), np_tree(grads))
    return out


@pytest.mark.parametrize("t_block", [0, 16, -1])
def test_transducer_loss_and_every_gradient_match_jax(transducer, transducer_jax_losses,
                                                      t_block):
    _, variables, args = transducer
    want_loss, want_grads = transducer_jax_losses[t_block]
    model = port_model(dict(CFGS["transducer"], joint_t_block=t_block), variables).train()
    loss, aux = model(*(torch.from_numpy(a) for a in args))
    loss.backward()
    assert aux == {} and model.joint_t_block == t_block
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    got = flat(grad_tree(model))
    for key, w in flat(want_grads).items():
        close_rel(got[key], w, key=key)


def test_predictor_dropout_acts_between_layers_in_training():
    from opentransformer_tpu_torch.models.modules import set_dropout_generator
    from opentransformer_tpu_torch.models.transducer import TransducerPredictionNetwork

    net = TransducerPredictionNetwork(V, D, num_layers=2, dropout=0.5)
    tokens = torch.randint(0, V, (2, 5), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = net.eval()(tokens)
        net.train()
        set_dropout_generator(net, torch.Generator().manual_seed(1))
        a = net(tokens)
        set_dropout_generator(net, torch.Generator().manual_seed(1))
        b = net(tokens)
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    one = TransducerPredictionNetwork(V, D, num_layers=1, dropout=0.5).train()
    with torch.no_grad():  # one layer: no inter-layer dropout, no generator needed
        assert torch.equal(one(tokens), one.eval()(tokens))


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_training_matches_flax_mutable_batch_stats(dtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 11, 16)) * 2.0 + 0.7).astype(np.float32)
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    bn = fnn.BatchNorm(axis_name=None, dtype=jdtype)
    variables = np_tree(bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False))
    variables["params"]["scale"] = rng.uniform(0.5, 2, 16).astype(np.float32)
    variables["params"]["bias"] = rng.normal(size=16).astype(np.float32)
    variables["batch_stats"]["mean"] = rng.normal(size=16).astype(np.float32)
    variables["batch_stats"]["var"] = rng.uniform(0.5, 2, 16).astype(np.float32)
    xj = jnp.asarray(x, jdtype)
    want, new = bn.apply(variables, xj, use_running_average=False, mutable=["batch_stats"])
    tm = BatchNorm(16)
    compat.load_into(tm, variables).train()
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=dtype == "bfloat16"):
        got = tm(xt)
    assert got.dtype == xt.dtype and tm.running_mean.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    atol = ATOL if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    for key, buf in (("mean", tm.running_mean), ("var", tm.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(new["batch_stats"][key]), rtol=0,
                                   atol=1e-6)
    with torch.no_grad():  # eval: the running averages, left as they are
        stats = tm.running_mean.clone()
        tm.eval()(xt)
    assert torch.equal(tm.running_mean, stats)


# ------------------------------------------------------- one Trainer update
def speech_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(2):
        samples = []
        for i in range(3):
            n = int(rng.integers(30, 64))
            y = list(rng.integers(3, V, size=int(rng.integers(2, 7))))
            samples.append((f"u{k}{i}", rng.normal(size=(n, F_IN)).astype(np.float32), n, y,
                            len(y)))
        out.append(collate_speech(samples, pad_to_frames=64))
    return out


def text_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(2):
        samples = []
        for i in range(3):
            ids = [int(c) for c in rng.integers(3, V, size=int(rng.integers(2, 12)))]
            samples.append((f"s{k}{i}", ids, ids))
        out.append(collate_text(samples))
    return out


@pytest.mark.parametrize("family", list(CFGS))
def test_one_trainer_update_matches_jax_trainer(family):
    """Two micro-batches accumulated (``accum_steps`` 2), clipped at 5, Adam
    with weight decay at the Noam rate of step 1, from the same weights:
    the port's Trainer and the JAX Trainer's grad/update functions. A
    BatchNorm conformer's running statistics move on each micro-batch."""
    cfg = CFGS[family]
    is_lm = family in LM_TYPES
    batches = text_batches(5) if is_lm else speech_batches(5)
    batch_fn = lm_batch if is_lm else default_speech_batch
    jm = jax_build_model(cfg)
    jt = JaxTrainer(TRAIN_CFG, jm, batch_fn=batch_fn)
    vars0 = np_tree(jax.jit(jm.init)(jax.random.PRNGKey(3), *batch_fn(batches[0])))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, vars0),
                       opt_state=jt.tx.init(jax.tree_util.tree_map(jnp.asarray, vars0["params"])),
                       nan_skips=jnp.zeros((), jnp.int32))
    grad_fn, update_fn = jt._build_grad_fn(), jt._build_update_fn()
    variables, gacc, losses_j = state.params, jt._zeros_like_grads(state.params), []
    for i, batch in enumerate(batches):
        variables, gacc, loss, _ = grad_fn(variables, gacc, batch_fn(batch),
                                           jax.random.PRNGKey(i), None)
        losses_j.append(float(loss))
    lr = jt.schedule(1, 0)
    new_vars, _, skips, _ = update_fn(variables, np_tree(state.opt_state), gacc,
                                      state.nan_skips, lr, jax.random.PRNGKey(9))
    assert int(skips) == 0

    model = port_model(cfg, vars0)
    trainer = Trainer(TRAIN_CFG, model, None, torch.Generator().manual_seed(0))
    model.train()
    for batch in batches:
        trainer.micro_step(batch)
    rec = trainer.update()
    assert rec["applied"] and rec["lr"] == lr
    np.testing.assert_allclose(rec["losses"], losses_j, rtol=1e-5)
    got = compat.params_to_jax(model)
    want = np_tree(new_vars)
    assert sorted(got) == sorted(want) == (["batch_stats", "params"]
                                           if family == "batch_norm_conformer" else ["params"])
    # Adam's first step moves an element by lr·u/(|u| + eps), u the clipped
    # gradient plus weight decay: where u cancels to float32 rounding level
    # that ratio is rounding noise, so those elements (u below 1e-3 of its
    # tensor's median, at most 0.1% of all) are left out
    grads, p0 = flat(np_tree(gacc)), flat(vars0["params"])
    gnorm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    clip = min(1.0, TRAIN_CFG["clip_grad"] / (gnorm + 1e-6))
    wd = TRAIN_CFG["optimizer"]["weight_decay"]
    moved, left_out, total = 0.0, 0, 0
    for key, w in flat(want["params"]).items():
        u = np.abs(clip * grads[key] + wd * p0[key])
        keep = u >= 1e-3 * np.median(u)
        left_out, total = left_out + int((~keep).sum()), total + u.size
        moved = max(moved, float(np.abs(w - p0[key]).max()))
        np.testing.assert_allclose(flat(got["params"])[key][keep], w[keep], rtol=0, atol=1e-5,
                                   err_msg=key)
    assert moved > 10 * 1e-5 and left_out <= 1e-3 * total
    if "batch_stats" in want:
        moved = max(float(np.abs(w - flat(vars0["batch_stats"])[k]).max())
                    for k, w in flat(want["batch_stats"]).items())
        assert moved > 1e-3
        for key, w in flat(want["batch_stats"]).items():
            np.testing.assert_allclose(flat(got["batch_stats"])[key], w, rtol=0, atol=1e-6,
                                       err_msg=key)


# ------------------------------------------------------------------ text data
def write_text_corpus(root):
    os.makedirs(root, exist_ok=True)
    chip_smoke.make_ctc_corpus(root)
    with open(os.path.join(root, "text"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    # an unknown unit, and a line whose src and tgt files differ in order
    lines[3] = lines[3] + " zz"
    with open(os.path.join(root, "src"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "tgt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[::-1]) + "\n")
    return {"dataset_type": "text", "vocab": os.path.join(root, "vocab"),
            "src_vocab": os.path.join(root, "vocab"), "tgt_vocab": os.path.join(root, "vocab"),
            "batch_size": 8, "train": {"src": [os.path.join(root, "src")],
                                       "tgt": [os.path.join(root, "tgt")]}}


@pytest.mark.parametrize("reverse", [False, True])
def test_text_dataset_collate_and_loader_equal_jax(tmp_path, reverse):
    data = dict(write_text_corpus(str(tmp_path)), reverse=reverse)
    ours = TextDataset(data, data["train"])
    from opentransformer_tpu.data.datasets import TextDataset as JaxText

    theirs = JaxText(data, data["train"])
    assert [ours[i] for i in range(len(ours))] == [theirs[i] for i in range(len(theirs))]
    assert ours.index_length_pair() == theirs.index_length_pair()
    assert 2 in ours[3][1]  # UNK
    samples = [ours[i] for i in (0, 3, 7)]
    for a, b in zip(collate_text(samples), jax_collate_text(samples)):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        else:
            assert a == b
    cfg = {"data": data}
    port_loader, jax_loader = FeatureLoader(cfg, "train", seed=4), JaxLoader(cfg, "train", seed=4)
    for epoch in (0, 1):
        port_loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got, want = list(port_loader), list(jax_loader)
        assert len(got) == len(want) == 5
        for (ua, ia, ta), (ub, ib, tb) in zip(got, want):
            assert ua == ub and sorted(ia) == sorted(ib) and sorted(ta) == sorted(tb)
            assert all(np.array_equal(ia[k], ib[k]) for k in ia)
            assert all(np.array_equal(ta[k], tb[k]) for k in ta)


@pytest.mark.parametrize("name,yaml_name", [("transformer_lm", "transformer_lm.yaml"),
                                            ("rnn_lm", "rnnlm.yaml")])
def test_lm_configs_are_the_aishell_yamls(name, yaml_name):
    with open(os.path.join(REPO, "egs", "aishell", "conf", yaml_name), encoding="utf-8") as f:
        assert load_config(os.path.join(CONF_DIR, f"{name}.json")) == yaml.safe_load(f)


# ------------------------------------------------------- CLI rehearsals
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """chip_smoke's tiny corpus (40 utterances of 2-3 units, 16-dim features)
    and a kaldi training config for it."""
    root = str(tmp_path_factory.mktemp("families"))
    chip_smoke.make_ctc_corpus(root)
    cfg = chip_smoke.ctc_corpus_config(root, epochs=1)
    return root, cfg


def cli_train(tmp_path, cfg, model_cfg, name):
    cfg = json.loads(json.dumps(cfg))
    cfg["model"] = model_cfg
    conf = str(tmp_path / f"{name}.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    expdir = str(tmp_path / f"exp_{name}")
    trainer = run_cli.run(["-c", conf, "--expdir", expdir, "--device", "cpu", "-s", "3",
                           "--log_interval", "100"])
    losses = [x for r in trainer.history for x in r["losses"]]
    assert len(trainer.history) == len(FeatureLoader(cfg, "train", seed=3)) >= 2
    assert np.isfinite(losses).all() and trainer.nan_skips == 0
    return trainer, expdir


def reloads_to_the_same_ids(trainer, expdir, cfg, decode):
    fresh = compat.load_into(build_model(cfg["model"], device="cpu"),
                             compat.load_npz(os.path.join(expdir, "model.epoch.0", "params.npz")))
    feats, mask, _, _ = feature_args(next(iter(FeatureLoader(cfg, "train", is_eval=True))), "cpu")
    trainer.model.eval()
    got = [decode(m, feats, mask) for m in (trainer.model, fresh)]
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
    return got[0]


def eval_cli_run(tmp_path, root, expdir, tag, *flags):
    out = str(tmp_path / f"decode_{tag}")
    assert eval_cli.main(["--npz", os.path.join(expdir, "model.epoch.0", "params.npz"),
                          "--model_cfg", os.path.join(expdir, "config.json"),
                          "--feats", os.path.join(root, "feats.scp"),
                          "--text", os.path.join(root, "text"),
                          "--vocab", os.path.join(root, "vocab"), "--decode_dir", out,
                          "-b", "16", "-ml", "12", "--device", "cpu", *flags]) == 0
    with open(os.path.join(out, "predict.txt"), encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 40
    return out


@pytest.fixture(scope="module")
def trained_transducer(corpus, tmp_path_factory):
    root, cfg = corpus
    tmp = tmp_path_factory.mktemp("transducer_cli")
    trainer, expdir = cli_train(tmp, cfg, chip_smoke.tiny_transducer_cfg(), "transducer")
    return trainer, expdir, tmp


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_cli_trains_a_transducer_that_reloads_and_decodes(corpus, trained_transducer, mode):
    root, cfg = corpus
    trainer, expdir, tmp = trained_transducer
    cfg = dict(cfg, model=chip_smoke.tiny_transducer_cfg())
    if mode == "greedy":
        reloads_to_the_same_ids(trainer, expdir, cfg,
                                lambda m, f, k: m.greedy_decode(f, k, 12, 8))
        eval_cli_run(tmp, root, expdir, mode, "-md", "greedy")
    else:
        reloads_to_the_same_ids(trainer, expdir, cfg,
                                lambda m, f, k: m.beam_decode(f, k, 4, 12)[:2])
        eval_cli_run(tmp, root, expdir, mode, "-bw", "4", "-nb", "2")


def test_cli_trains_a_ctc_model_that_reloads_and_decodes(corpus, tmp_path):
    root, cfg = corpus
    model_cfg = dict(CFGS["ctc"], frontend=dict(FRONT, input_size=chip_smoke.CTC_CORPUS["feat_dim"]),
                     vocab_size=chip_smoke.CTC_CORPUS["vocab"])
    trainer, expdir = cli_train(tmp_path, cfg, model_cfg, "ctc")
    reloads_to_the_same_ids(trainer, expdir, dict(cfg, model=model_cfg),
                            lambda m, f, k: m.recognize_argmax(f, k))
    eval_cli_run(tmp_path, root, expdir, "ctc", "-md", "greedy")


@pytest.mark.parametrize("lm_type", LM_TYPES)
def test_cli_trains_an_lm_that_the_eval_cli_fuses(corpus, trained_transducer, tmp_path,
                                                 lm_type):
    """An LM trained on the corpus' transcripts through the training CLI
    (text dataset), reloaded, then fused into the transducer's beam by the
    eval CLI from its checkpoint directory (with its run's config.json)."""
    root, _ = corpus
    _, t_expdir, _ = trained_transducer
    data = {"dataset_type": "text", "vocab": os.path.join(root, "vocab"),
            "src_vocab": os.path.join(root, "vocab"), "tgt_vocab": os.path.join(root, "vocab"),
            "batch_size": 8, "train": {"src": [os.path.join(root, "text")],
                                       "tgt": [os.path.join(root, "text")]}}
    cfg = {"data": data, "train": chip_smoke.ctc_corpus_config(root, epochs=1)["train"]}
    lm_cfg = dict(CFGS[lm_type], vocab_size=chip_smoke.CTC_CORPUS["vocab"])
    trainer, expdir = cli_train(tmp_path, cfg, lm_cfg, lm_type)
    assert trainer.dev_probe_fn is None and trainer.frontend is None
    fresh = compat.load_into(build_model(lm_cfg, device="cpu"),
                             compat.load_npz(os.path.join(expdir, "model.epoch.0", "params.npz")))
    src = torch.from_numpy(next(iter(FeatureLoader(cfg, "train")))[1]["inputs"]).long()
    with torch.no_grad():
        assert torch.equal(trainer.model.eval().logits(src), fresh.logits(src))
    eval_cli_run(tmp_path, root, t_expdir, f"lm_{lm_type}", "-bw", "4", "-lm",
                 os.path.join(expdir, "model.epoch.0"),
                 "-lmw", "0.3")
