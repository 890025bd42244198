"""The port's training path against the JAX package, on the CPU.

Inputs (features, waveforms, targets, weights) are made with numpy from a
seed and fed to both packages. Tolerances: the label-smoothing loss on the
same logits 1e-6; the training loss and every gradient of a small model on
the same features 1e-5 relative to each tensor's scale (float32 on both
sides, summation orders differ); one full update (two accumulated
micro-batches from waveforms, clipping, weight decay, Noam) 1e-5 on every
parameter. Schedules are the same closed forms and must agree exactly;
loaders read the same files with the same seed and must give identical
batches.
"""

import copy
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
from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.ops.loss import label_smoothing_loss as jax_ls_loss
from opentransformer_tpu.train.scheduler import SCHEDULER_TYPES as JAX_SCHEDULERS
from opentransformer_tpu.train.scheduler import build_scheduler as jax_scheduler
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer
from opentransformer_tpu.train.trainer import TrainState
from opentransformer_tpu.train.trainer import wave_speech_batch
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.config import CONF_DIR, load_config
from opentransformer_tpu_torch.data import write_vocab
from opentransformer_tpu_torch.data.device_pipeline import collate_waveforms, make_device_frontend
from opentransformer_tpu_torch.data.loader import FeatureLoader
from opentransformer_tpu_torch.models.modules import Dropout, set_dropout_generator
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops.loss import label_smoothing_loss
from opentransformer_tpu_torch.train.checkpoint import Checkpointer
from opentransformer_tpu_torch.train.scheduler import SCHEDULER_TYPES, build_scheduler
from opentransformer_tpu_torch.train.trainer import Trainer, feature_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from export_trained_synth import load_trained_params  # noqa: E402

VOCAB = 40
MODEL_CFG = {
    "type": "speech2text", "frontend_type": "conv",
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8,
                 "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2], "dropout": 0.0},
    "encoder_type": "transformer",
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu",
                "pos_dropout": 0.0, "slf_attn_dropout": 0.0, "ffn_dropout": 0.0,
                "residual_dropout": 0.0},
    "decoder_type": "transformer",
    "decoder": {"vocab_size": VOCAB, "d_model": 32, "n_heads": 4, "d_ff": 48, "memory_dim": 32,
                "n_blocks": 2, "activation": "glu", "share_embedding": True, "pos_dropout": 0.0,
                "slf_attn_dropout": 0.0, "src_attn_dropout": 0.0, "ffn_dropout": 0.0,
                "residual_dropout": 0.0},
    "ctc_weight": 0.0, "smoothing": 0.1,
}
TRAIN_CFG = {"optimizer_type": "adam",
             "optimizer": {"lr": 0.001, "betas": [0.9, 0.98], "eps": 1.0e-9,
                           "weight_decay": 1.0e-2},
             "scheduler_type": "transformer",
             "scheduler": {"model_size": 32, "warmup_steps": 4, "factor": 1.0},
             "clip_grad": 5, "accum_steps": 2, "grad_noise": 0.0, "epochs": 2}
DATA_CFG = {"num_mel_bins": 20, "normalization": True, "spec_augment": False}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_close(got, want, rel=1e-5):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=rel * scale, err_msg=key)


def utterances(n, seed=0, min_s=0.4, max_s=1.2):
    """n (waveform, target ids) pairs: noise plus a tone, 8-12 units each."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = int(rng.uniform(min_s, max_s) * 16000)
        t = np.arange(m) / 16000.0
        w = 0.05 * rng.normal(size=m) + 0.2 * np.sin(2 * np.pi * (150 + 40 * i) * t)
        out.append((w.astype(np.float32), list(rng.integers(3, VOCAB, size=rng.integers(8, 13)))))
    return out


def wave_batch(utts, prefix="u"):
    return collate_waveforms([(f"{prefix}{i}", w, len(w), y, len(y))
                              for i, (w, y) in enumerate(utts)])


def write_corpus(root, n_train=8, n_dev=4, seed=0):
    """wav files + scp/text for a train and a dev split, and a vocab."""
    import scipy.io.wavfile as siw

    os.makedirs(root, exist_ok=True)
    write_vocab({"<PAD>": 0, "<S/E>": 1, "<UNK>": 2, **{f"c{i}": i for i in range(3, VOCAB)}},
                os.path.join(root, "vocab"))
    for split, n, s in (("train", n_train, seed), ("dev", n_dev, seed + 1)):
        scp, text = [], []
        for i, (w, y) in enumerate(utterances(n, s)):
            path = os.path.join(root, f"{split}{i}.wav")
            siw.write(path, 16000, (w * 32767).astype(np.int16))
            scp.append(f"{split}{i} {path}")
            text.append(f"{split}{i} " + " ".join(f"c{t}" for t in y))
        for name, lines in (("wav.scp", scp), ("text", text)):
            with open(os.path.join(root, f"{split}.{name}"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return {
        "data": {"dataset_type": "online", "extract_on_device": True,
                 "vocab": os.path.join(root, "vocab"), "batch_size": 4, "num_mel_bins": 20,
                 "normalization": True, "spec_augment": True, "num_workers": 2,
                 "spec_augment_config": {"freq_mask_num": 2, "time_mask_num": 2},
                 **{s: {"feat": [os.path.join(root, f"{s}.wav.scp")],
                        "text": [os.path.join(root, f"{s}.text")]} for s in ("train", "dev")}},
        "model": MODEL_CFG,
        "train": dict(TRAIN_CFG, scheduler_type="constant", scheduler={"lr": 1e-3}, accum_steps=1,
                      save_name="tiny"),
    }


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    cfg = write_corpus(root)
    conf = os.path.join(root, "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    return root, conf, cfg


@pytest.fixture(scope="module")
def trained(corpus):
    """The CLI run of two epochs on the tiny corpus."""
    root, conf, _ = corpus
    expdir = os.path.join(root, "exp")
    trainer = run_cli.run(["-c", conf, "--expdir", expdir, "--device", "cpu",
                           "--log_interval", "1", "-s", "7"])
    return trainer, expdir


# ------------------------------------------------------------- loss, grads
@pytest.mark.parametrize("smoothing", [0.1, 0.0, 0.3])
def test_label_smoothing_loss_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    targets = rng.integers(1, 50, size=(3, 7)).astype(np.int32)
    targets[1, 4:] = 0
    targets[2, 2:] = 0
    want = float(jax_ls_loss(jnp.asarray(logits), jnp.asarray(targets), smoothing))
    got = float(label_smoothing_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                     smoothing))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def jax_model_and_params(seed=0):
    rng = np.random.default_rng(seed)
    b, t = 3, 64
    feats = rng.normal(size=(b, t, 20)).astype(np.float32)
    mask = np.arange(t)[None] < np.array([64, 50, 37])[:, None]
    ulens = np.array([9, 6, 4])
    targets = np.zeros((b, 12), np.int32)
    for i, u in enumerate(ulens):
        targets[i, 0] = 1
        targets[i, 1 : 1 + u] = rng.integers(3, VOCAB, size=u)
        targets[i, 1 + u] = 1
    args = (feats, mask, targets, (ulens + 1).astype(np.int32))
    jm = jax_build_model(MODEL_CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), *map(jnp.asarray, args))
    return jm, jax.tree_util.tree_map(np.array, params), args


def grad_tree(model):
    """The parameters' ``.grad`` in the JAX layout."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), clone.parameters()):
            q.copy_(p.grad)
    return compat.params_to_jax(clone)["params"]


def test_training_loss_and_every_gradient_match_jax():
    jm, params, args = jax_model_and_params()

    def loss_fn(p):
        return jm.apply({"params": p}, *map(jnp.asarray, args), deterministic=False)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params["params"])
    model = compat.load_into(build_model(MODEL_CFG, device="cpu"), params).train()
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    feats, mask, targets, tlen = (torch.from_numpy(a) for a in args)
    loss_t, aux = model(feats, mask, targets.long(), tlen.long())
    loss_t.backward()
    assert aux == {}
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert_trees_close(grad_tree(model), jax.tree_util.tree_map(np.asarray, grads_j))


def test_one_full_update_matches_jax_trainer():
    """Two micro-batches of waveforms accumulated, clipped at 5, Adam with
    weight decay at the Noam rate of step 1: the port's Trainer and the JAX
    Trainer's grad/update functions from the same parameters."""
    batches = [wave_batch(utterances(3, seed=s), prefix=f"b{s}-") for s in (10, 11)]
    jfront = jax_frontend(DATA_CFG)

    def preprocess(waveforms, wave_lengths, targets, targets_length, *, rng, train):
        feats, mask = jfront(waveforms, wave_lengths, rng, train=train)
        return feats, mask, targets, targets_length

    jm = jax_build_model(MODEL_CFG)
    jt = JaxTrainer(TRAIN_CFG, jm, batch_fn=wave_speech_batch, preprocess_fn=preprocess)
    # JaxTrainer.init_state without its eager (slow) init: jitted
    init_args = preprocess(*wave_speech_batch(batches[0]), rng=None, train=False)
    params0 = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(jax.random.PRNGKey(3), *init_args))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params0),
                       opt_state=jt.tx.init(jax.tree_util.tree_map(jnp.asarray, params0["params"])),
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
    assert int(skips) == 0 and gnorm_j > TRAIN_CFG["clip_grad"]  # the clip acts

    model = compat.load_into(build_model(MODEL_CFG, device="cpu"), params0)
    trainer = Trainer(TRAIN_CFG, model, make_device_frontend(DATA_CFG, "cpu"),
                      torch.Generator().manual_seed(0))
    model.train()
    for batch in batches:
        trainer.micro_step(batch)
    rec = trainer.update()
    assert rec["step"] == 1 and rec["lr"] == lr and rec["applied"] and trainer.global_step == 2
    np.testing.assert_allclose(rec["losses"], losses_j, rtol=1e-5)
    assert abs(rec["gnorm"] - gnorm_j) <= 1e-5 * gnorm_j
    got = compat.params_to_jax(model)["params"]
    want = jax.tree_util.tree_map(np.asarray, new_vars["params"])
    moved = max(float(np.abs(flat(want)[k] - flat(params0["params"])[k]).max())
                for k in flat(want))
    assert moved > 10 * 1e-5  # the update is large against the tolerance
    for key, w in flat(want).items():
        np.testing.assert_allclose(flat(got)[key], w, rtol=0, atol=1e-5, err_msg=key)


def test_non_finite_gradient_skips_the_whole_update():
    jm, params, args = jax_model_and_params()
    model = compat.load_into(build_model(MODEL_CFG, device="cpu"), params)
    trainer = Trainer(dict(TRAIN_CFG, accum_steps=1), model, None,
                      torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decoder.output_bias[3] = float("nan")
    before = copy.deepcopy(model.state_dict())
    loss, _ = model(*feature_args((None, {"inputs": args[0], "mask": args[1]},
                                   {"targets": args[2], "targets_length": args[3]}), "cpu"))
    loss.backward()
    trainer._window = [loss.detach()]
    rec = trainer.update()
    assert not rec["applied"] and trainer.nan_skips == 1 and trainer.global_step == 2
    assert trainer.optimizer.state_dict()["state"] == {}  # Adam's count untouched
    after = model.state_dict()
    for k, v in before.items():
        assert torch.equal(torch.nan_to_num(after[k]), torch.nan_to_num(v)), k
    assert all(p.grad is None for p in model.parameters())


def test_grad_noise_is_scaled_by_accum_steps():
    model = build_model(MODEL_CFG, device="cpu")
    trainer = Trainer(dict(TRAIN_CFG, grad_noise=0.5, accum_steps=4, clip_grad=0,
                           scheduler_type="constant", scheduler={"lr": 0.0},
                           optimizer_type="sgd", optimizer={}), model, None,
                      torch.Generator().manual_seed(0))
    seen = {}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    trainer.optimizer.step = lambda: seen.update(
        std=float(torch.cat([p.grad.flatten() for p in model.parameters()]).std()))
    trainer._window = [torch.tensor(1.0)]
    trainer.update()
    assert abs(seen["std"] - 0.5 / 4) < 0.005


def test_dropout_acts_in_training_only_and_draws_from_its_generator():
    drop = Dropout(0.25)
    x = torch.ones(4000)
    assert torch.equal(drop.eval()(x), x)
    drop.train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(y, drop(x))
    assert set(y.unique().tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.03
    cfg = json.loads(json.dumps(MODEL_CFG))
    cfg["encoder"]["residual_dropout"] = cfg["decoder"]["residual_dropout"] = 0.1
    model = build_model(cfg, device="cpu")
    assert sum(isinstance(m, Dropout) and m.p == 0.1 for m in model.modules()) == 2 + 2


# -------------------------------------------------------------- schedules
SCHED_CFGS = {
    "constant": {"lr": 1e-3},
    "step-linear": {"final_step": 1000, "start_lr": 1e-3, "final_lr": 1e-5},
    "epoch-linear": {"final_epoch": 5, "start_lr": 1e-3, "final_lr": 1e-5},
    "exp": {"final_step": 1000, "start_lr": -3.0, "final_lr": -9.0},
    "step-exp": {"init_lr": 0.5, "decay_factor": 1.001, "min_lr": 1e-4},
    "transformer": {"model_size": 256, "warmup_steps": 12000, "factor": 1.0},
    "linear-warmup-exp-decay": {"warmup_steps": 100, "decay_start": 500, "peak_lr": 0.1,
                                "final_lr": 1e-5, "decay_factor": 0.999},
}


@pytest.mark.parametrize("kind", SCHEDULER_TYPES)
def test_scheduler_matches_jax_on_a_grid(kind):
    assert set(SCHEDULER_TYPES) == set(JAX_SCHEDULERS) == set(SCHED_CFGS)
    ours, theirs = build_scheduler(SCHED_CFGS[kind], kind), jax_scheduler(SCHED_CFGS[kind], kind)
    for step in (0, 1, 2, 5, 99, 100, 101, 499, 500, 501, 1000, 5000, 12000, 40000):
        for epoch in (0, 1, 3, 10):
            assert ours(step, epoch) == theirs(step, epoch), (step, epoch)


# ----------------------------------------------------------- data, config
def test_committed_json_config_is_the_yaml_with_extract_on_device():
    port = load_config(os.path.join(CONF_DIR, "transformer_baseline.json"))
    with open(os.path.join(REPO, "egs", "aishell", "conf", "transformer_baseline.yaml")) as f:
        ref = yaml.safe_load(f)
    assert port["data"].pop("extract_on_device") is True
    assert port == ref


@pytest.mark.parametrize("split,perturb", [("train", False), ("train", True), ("dev", False)])
def test_loader_batches_equal_jax(corpus, split, perturb):
    """Same files and seed: the same batches, in the same order, every epoch
    (with speed and volume perturbation of the training waveforms too)."""
    _, _, cfg = corpus
    cfg = json.loads(json.dumps(cfg))
    cfg["data"]["spec_augment"] = False
    cfg["data"]["speed_perturb"] = cfg["data"]["volume_perturb"] = perturb
    cfg["data"]["num_workers"] = 0  # one draw order of the per-sample generators
    is_eval = split == "dev"
    ours = FeatureLoader(cfg, split, is_eval=is_eval, seed=5)
    theirs = JaxLoader(cfg, split, is_eval=is_eval, seed=5)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for (u1, i1, t1), (u2, i2, t2) in zip(got, want):
            assert u1 == u2
            for a, b in ((i1, i2), (t1, t2)):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------- the CLI
def test_cli_trains_two_epochs_and_writes_reloadable_checkpoints(trained):
    trainer, expdir = trained
    names = set(os.listdir(expdir))
    assert {"model.epoch.0", "model.epoch.1", "model.best", "config.json", "conf.json"} <= names
    for e in (0, 1):
        assert set(os.listdir(os.path.join(expdir, f"model.epoch.{e}"))) == {
            "params.npz", "optimizer.pt", "extra.json"}
    assert [r["step"] for r in trainer.history] == [1, 2, 3, 4]
    assert trainer.nan_skips == 0 and len(trainer.dev_losses) == 2
    assert all(np.isfinite(r["losses"]).all() for r in trainer.history)
    with open(os.path.join(expdir, "model.epoch.1", "extra.json")) as f:
        assert json.load(f) == {"global_step": 5, "nan_skips": 0}
    ck = Checkpointer(expdir)
    assert ck.list_epochs() == [0, 1]
    fresh = compat.load_into(build_model(MODEL_CFG, device="cpu"),
                             ck.load_params(ck.epoch_path(1)))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    opt = torch.load(os.path.join(expdir, "model.epoch.1", "optimizer.pt"))
    assert opt["state"][0]["step"] == 4


def test_checkpoint_reads_in_the_jax_package(trained, corpus):
    """params.npz through the JAX tools' reader into the JAX model gives the
    port's deterministic loss on a dev batch."""
    trainer, expdir = trained
    _, _, cfg = corpus
    batch = next(iter(FeatureLoader(cfg, "dev", is_eval=True)))
    args = feature_args(batch, "cpu")
    trainer.model.eval()
    with torch.no_grad():
        loss_t = float(trainer.model(*args)[0])
    tree = load_trained_params(os.path.join(expdir, "model.epoch.1", "params.npz"))
    apply = jax.jit(jax_build_model(MODEL_CFG).apply)
    loss_j, _ = apply(tree, *(jnp.asarray(a.numpy()) for a in args))
    assert abs(loss_t - float(loss_j)) <= 1e-4 * abs(loss_t)


def test_trained_params_round_trip_through_the_jax_layout(trained):
    model = trained[0].model
    tree = compat.params_to_jax(model)
    back = compat.params_from_jax(tree)
    state = model.state_dict()
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_cli_needs_a_card_unless_told_the_cpu(corpus):
    _, conf, _ = corpus
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli.run(["-c", conf, "--expdir", os.path.join(corpus[0], "never")])


@pytest.mark.parametrize("flags", [
    ["--tp", "2"], ["--pp", "2"], ["--pp-schedule", "1f1b"], ["--pp-micro-batches", "2"],
    ["--ep", "2"], ["--multihost"], ["-n", "2"]],
    ids=lambda f: f[0])
def test_flags_not_ported_raise(flags, monkeypatch):
    """The parallelism flags, the last options that raised, are ported: each
    sets the run's (data, model, pipe, expert) mesh as the JAX CLI's does
    (``--pp-micro-batches`` alone changes nothing: it applies to 1F1B;
    ``--multihost`` takes the world size from torchrun's environment)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = {"model": {"encoder_type": "transformer",
                     "encoder": {"scan_layers": True, "n_blocks": 4, "moe_experts": 2}}}
    want = {"--tp": (1, 2, 1, 1), "--pp": (1, 1, 2, 1), "--pp-schedule": (1, 1, 1, 1),
            "--pp-micro-batches": None, "--ep": (1, 1, 1, 2), "--multihost": (2, 1, 1, 1),
            "-n": (2, 1, 1, 1)}[flags[0]]
    args = run_cli.build_argparser().parse_args(["-c", "never-read.json", "--device", "cpu",
                                                 *flags])
    assert run_cli.mesh_dims(args, cfg) == want


@pytest.mark.parametrize("form", ["dir", "file"])
def test_init_model_warm_starts_the_weights(trained, corpus, tmp_path, form):
    """``-im`` (not ported before the anchor recipe) loads a checkpoint
    directory's params.npz, or an npz, over the seeded initial weights."""
    _, expdir = trained
    src = os.path.join(expdir, "model.epoch.1")
    _, _, cfg = corpus
    cfg = json.loads(json.dumps(cfg))
    cfg["train"]["epochs"] = 0
    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    argv = ["-c", conf, "--expdir", str(tmp_path / "exp"), "--device", "cpu", "-s", "7"]
    fresh = run_cli.run(argv).model.state_dict()
    warm = run_cli.run(argv + ["-im", src if form == "dir" else
                               os.path.join(src, "params.npz")]).model.state_dict()
    want = compat.load_into(build_model(MODEL_CFG, device="cpu"),
                            compat.load_npz(os.path.join(src, "params.npz"))).state_dict()
    assert all(torch.equal(warm[k], v) for k, v in want.items())
    assert not all(torch.equal(fresh[k], v) for k, v in want.items())


@pytest.mark.parametrize("section,key,value", [
    ("train", "pp_schedule", "1f1b"), ("train", "pp_micro_batches", 2),
], ids=lambda v: str(v) if not isinstance(v, dict) else "dict")
def test_config_options_not_ported_raise(corpus, tmp_path, section, key, value):
    """The train section's pipeline options are ported: ``pp_schedule:
    1f1b`` without a mesh raises the JAX trainer's refusal, and
    ``pp_micro_batches`` alone is read only under 1F1B (the run trains)."""
    _, _, cfg = corpus
    cfg = json.loads(json.dumps(cfg))
    cfg[section][key] = value
    cfg["train"]["epochs"] = 1
    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    argv = ["-c", conf, "--expdir", str(tmp_path / "exp"), "--device", "cpu"]
    if key == "pp_schedule":
        with pytest.raises(ValueError, match="pp_schedule=1f1b needs a mesh with a pipe axis"):
            run_cli.run(argv)
    else:
        trainer = run_cli.run(argv)
        assert trainer.pipeline is None and trainer.history and trainer.nan_skips == 0


def kaldi_copy(cfg, root):
    """The online corpus' splits as kaldi arks of their host log-fbank."""
    from opentransformer_tpu_torch.data.datasets import AudioDataset
    from opentransformer_tpu_torch.data.kaldi_io import write_ark

    out = json.loads(json.dumps(cfg))
    out["data"].update(dataset_type="kaldi", extract_on_device=False)
    for split in ("train", "dev"):
        ds = AudioDataset(cfg["data"], cfg["data"][split], is_eval=True)
        ark, scp = os.path.join(root, f"{split}.ark"), os.path.join(root, f"{split}.scp")
        write_ark(ark, {ds[i][0]: ds[i][1] for i in range(len(ds))}, scp)
        out["data"][split]["feat"] = [scp]
    return out


def _probe_ran(t, cfg):
    return [r["epoch"] for r in t.dev_probe_fn.records] == [0] and t.dev_probe_fn.records[0][
        "utts"] > 0


def _host_features(t, cfg):
    return t.frontend is None and t.resident is None


def _bucketed(t, cfg):
    from opentransformer_tpu_torch.data.bucket import BySequenceLengthSampler

    loader = FeatureLoader(cfg, "train", seed=7)
    boundaries = {b for b, _ in loader.sampler}
    return (isinstance(loader.sampler, BySequenceLengthSampler) and boundaries == {100, 200}
            and t.frontend is not None)


def _hybrid(t, cfg):
    return hasattr(t.model, "ctc") and all(set(r["aux"]) == {"ctc_loss", "att_loss"}
                                           for r in t.history)


def _fused(t, cfg):
    from opentransformer_tpu_torch.train.trainer import FusedAdam

    opt = t.optimizer
    return (isinstance(opt, FusedAdam) and opt.count == len(t.history)
            and all(p.data_ptr() >= opt.flat.data_ptr() for p in t.model.parameters()))


def _host_noise(t, cfg):
    return t.frontend is None and FeatureLoader(cfg, "train").dataset.gaussian_noise == 0.1


def _psf(t, cfg):
    return t.frontend is None and FeatureLoader(cfg, "train").dataset.feature_extractor == "psf"


HOST = {"extract_on_device": False}

# each option that the training CLI raised on before it was ported (the
# anchor recipe's, then the round trip's): its flags or config overrides,
# and what it now does
OPTIONS_NOW_PORTED = {
    "fused_update": ([], {"train": {"fused_update": True}}, _fused),
    "async_save": ([], {"train": {"async_save": True}},
                   lambda t, c: t.checkpointer.async_save and t.checkpointer.list_epochs() == [0]),
    "--async-save": (["--async-save"], {}, lambda t, c: t.checkpointer.async_save),
    "gaussian_noise": ([], {"data": {**HOST, "gaussian_noise": 0.1}}, _host_noise),
    "feature_extractor_psf": ([], {"data": {**HOST, "feature_extractor": "psf"}}, _psf),
    "device_resident_online": ([], {"data": {"device_resident": True}},
                               lambda t, c: t.resident is None and t.frontend is not None),
    "-ms": (["-ms"], {}, lambda t, c: t.mixspeech and all(r.get("aux") is None
                                                          for r in t.history)),
    "-tfs": (["-tfs", "5"], {}, lambda t, c: t.history[0]["step"] == 5),
    "--visual": (["--visual"], {}, lambda t, c: t.visualizer is not None),
    "-mp": (["-mp"], {}, lambda t, c: t.autocast_dtype == torch.bfloat16),
    "--steps-per-exec": (["--steps-per-exec", "2"], {}, lambda t, c: t.steps_per_exec == 2),
    "dev_cer_probe": ([], {"train": {"dev_cer_probe": True},
                           "data": {"extract_on_device": False}}, _probe_ran),
    "steps_per_exec": ([], {"train": {"steps_per_exec": 2}},
                       lambda t, c: t.steps_per_exec == 2 and t.global_step == 3),
    "dtype": ([], {"train": {"dtype": "bfloat16"}},
              lambda t, c: t.autocast_dtype == torch.bfloat16),
    "ctc_weight": ([], {"model": {"ctc_weight": 0.3}}, _hybrid),
    "bucket": ([], {"data": {"bucket": {"bucket_boundaries": [100, 200]}}}, _bucketed),
    "dataset_type_kaldi": ([], "kaldi", _host_features),
    "extract_on_device_false": ([], {"data": {"extract_on_device": False}}, _host_features),
}


@pytest.mark.parametrize("option", sorted(OPTIONS_NOW_PORTED))
def test_options_once_not_ported_now_train(corpus, tmp_path, option):
    """One epoch through the CLI with the option: finite losses, and the
    option's effect on the trainer."""
    flags, overrides, check = OPTIONS_NOW_PORTED[option]
    _, _, cfg = corpus
    if overrides == "kaldi":
        cfg = kaldi_copy(cfg, str(tmp_path))
    else:
        cfg = json.loads(json.dumps(cfg))
        for section, values in overrides.items():
            cfg[section].update(values)
    cfg["train"]["epochs"] = 1
    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    trainer = run_cli.run(["-c", conf, "--expdir", str(tmp_path / "exp"), "--device", "cpu",
                           "-s", "7", *flags])
    losses = [x for r in trainer.history for x in r["losses"]]
    n_batches = len(FeatureLoader(cfg, "train", seed=7))
    assert len(trainer.history) == n_batches >= 2
    assert np.isfinite(losses).all() and trainer.nan_skips == 0
    assert check(trainer, cfg)


def test_adam_moment_dtype_and_yaml_configs_raise(tmp_path):
    """``adam_m_dtype`` (raising before it was ported) now stores Adam's
    first moment in bfloat16 and its second in float32; a YAML config still
    raises."""
    from opentransformer_tpu_torch.train.scheduler import AdamMoments, build_optimizer

    p = torch.nn.Parameter(torch.zeros(2))
    opt = build_optimizer([p], {"adam_m_dtype": "bfloat16"})
    p.grad = torch.ones(2)
    opt.param_groups[0]["lr"] = 0.1
    opt.step()
    st = opt.state[p]
    assert isinstance(opt, AdamMoments) and st["exp_avg"].dtype == torch.bfloat16
    assert st["exp_avg_sq"].dtype == torch.float32 and float(p.detach()[0]) < 0
    with pytest.raises(ValueError, match="adam_m_dtype"):
        build_optimizer([p], {"adam_m_dtype": "int8"})
    with pytest.raises(ValueError, match="JSON"):
        load_config(str(tmp_path / "conf.yaml"))


def test_cli_on_the_jax_device_pipeline_corpus(tmp_path):
    """The corpus and config of tests/test_device_pipeline.py's training
    smoke (8 half-second noise wavs, units a/b, a d16 model that leaves
    memory_dim out), as JSON: two epochs on the CPU, both checkpoints."""
    import scipy.io.wavfile as siw

    rng = np.random.default_rng(0)
    write_vocab({"<PAD>": 0, "<S/E>": 1, "<UNK>": 2, "a": 3, "b": 4}, str(tmp_path / "vocab"))
    scp, text = [], []
    for i in range(8):
        p = str(tmp_path / f"w{i}.wav")
        siw.write(p, 16000, (rng.normal(size=8000).astype(np.float32) * 0.05 * 32767)
                  .astype(np.int16))
        scp.append(f"u{i} {p}")
        text.append(f"u{i} a b")
    (tmp_path / "wav.scp").write_text("\n".join(scp) + "\n")
    (tmp_path / "text").write_text("\n".join(text) + "\n")
    cfg = {
        "data": {"dataset_type": "online", "extract_on_device": True,
                 "vocab": str(tmp_path / "vocab"), "batch_size": 4, "num_mel_bins": 20,
                 "normalization": True, "spec_augment": True,
                 "train": {"feat": [str(tmp_path / "wav.scp")], "text": [str(tmp_path / "text")]}},
        "model": {"type": "speech2text", "frontend_type": "conv",
                  "frontend": {"input_size": 20, "output_size": 16, "mid_channel": 4,
                               "out_channel": 8, "kernel_size": [[3, 3], [3, 3]],
                               "stride": [2, 2]},
                  "encoder_type": "transformer",
                  "encoder": {"d_model": 16, "n_heads": 2, "d_ff": 32, "n_blocks": 1},
                  "decoder_type": "transformer",
                  "decoder": {"vocab_size": 5, "d_model": 16, "n_heads": 2, "d_ff": 32,
                              "n_blocks": 1, "share_embedding": True},
                  "smoothing": 0.1},
        "train": {"optimizer_type": "adam", "optimizer": {}, "scheduler_type": "constant",
                  "scheduler": {"lr": 1e-3}, "epochs": 2, "save_name": "dev"},
    }
    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    expdir = str(tmp_path / "exp")
    assert run_cli.main(["-c", conf, "-n", "1", "--expdir", expdir, "--log_interval", "100",
                         "--device", "cpu"]) == 0
    ck = Checkpointer(expdir)
    assert ck.list_epochs() == [0, 1]
    compat.load_into(build_model(cfg["model"], device="cpu"), ck.load_params(ck.epoch_path(1)))
