"""The training CLI's resuming and supervision, MixSpeech, the fused and
bfloat16-moment updates, and the data options of the round-trip slice,
against the JAX package on the CPU.

Resuming: the JAX package's ``-ct`` run (the corpus and config of
``tests/test_e2e.py``, no random draws in training) gives exactly the
uninterrupted run's parameters (max |diff| 0.0 over two epochs with Noam
and weight decay, checked with the JAX CLI), so the port's resumed run is
held to its own uninterrupted run within 1e-6; ``-ios`` restores the global
step, the lr and Adam's moments exactly. One MixSpeech update at an
injected λ is held to the JAX trainer's at 1e-5 relative to each tensor's
scale; the fused and bfloat16-moment updates at the tolerances of
``tests/test_fused_update.py`` (rtol 5e-3, atol 1e-4). ``logfbank_psf`` within 1e-5 of
JAX's, the ESPnet loader's batches equal to JAX's, the host
``gaussian_noise`` equal to JAX's arrays and within 5% of its setting in
mean and std, and absent on evaluation splits.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from opentransformer_tpu.data.datasets import AudioDataset as JaxAudioDataset
from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.ops.fbank import logfbank_psf as jax_logfbank_psf
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer
from opentransformer_tpu.train.trainer import default_speech_batch
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.data.datasets import AudioDataset
from opentransformer_tpu_torch.data.kaldi_io import write_ark
from opentransformer_tpu_torch.data.loader import FeatureLoader
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops.fbank import logfbank_psf
from opentransformer_tpu_torch.train.checkpoint import Checkpointer
from opentransformer_tpu_torch.train.trainer import FusedAdam, Trainer
from tests.test_e2e import make_config, make_corpus
from tests.test_torch_port_train import MODEL_CFG, flat, jax_model_and_params, write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The JAX e2e corpus (24 utterances, 3 batches an epoch) and its config
    as JSON, with Noam and weight decay as in the JAX check."""
    root = str(tmp_path_factory.mktemp("e2e"))
    make_corpus(root, n_utts=24)
    with open(make_config(root, epochs=2)) as f:
        cfg = yaml.safe_load(f)
    cfg["train"].update(scheduler_type="transformer",
                        scheduler={"model_size": 48, "warmup_steps": 4})
    cfg["train"]["optimizer"]["weight_decay"] = 1e-3
    return root, cfg


def write_conf(path, cfg, **train):
    cfg = json.loads(json.dumps(cfg))
    cfg["train"].update(train)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def cli(conf, expdir, *flags):
    return run_cli.run(["-c", conf, "--expdir", expdir, "--device", "cpu",
                        "--log_interval", "100", *flags])


def params_of(expdir, epoch):
    return flat(compat.load_npz(os.path.join(expdir, f"model.epoch.{epoch}", "params.npz")))


def test_resume_equals_the_uninterrupted_run(e2e, tmp_path):
    root, cfg = e2e
    two = write_conf(str(tmp_path / "two.json"), cfg, epochs=2)
    one = write_conf(str(tmp_path / "one.json"), cfg, epochs=1)
    full = cli(two, str(tmp_path / "full"))
    first = cli(one, str(tmp_path / "res"))
    resumed = cli(two, str(tmp_path / "res"), "-ct", "-im", "ignored.npz")
    assert first.global_step == 4 and resumed.history[0]["step"] == 4
    assert [r["epoch"] for r in resumed.history] == [1, 1, 1]
    assert [r["lr"] for r in resumed.history] == [r["lr"] for r in full.history[3:]]
    want, got = params_of(str(tmp_path / "full"), 1), params_of(str(tmp_path / "res"), 1)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
    o_full = full.optimizer.state_dict()["state"]
    o_res = resumed.optimizer.state_dict()["state"]
    for i, st in o_full.items():
        torch.testing.assert_close(o_res[i]["exp_avg_sq"], st["exp_avg_sq"], rtol=0, atol=1e-9)


def test_init_optim_state_and_counters(e2e, tmp_path):
    """``-ios`` restores the moments and the global step exactly; ``-tfe``
    and ``-tfs`` then set the counters (the next epoch and the lr's step)."""
    root, cfg = e2e
    one = write_conf(str(tmp_path / "one.json"), cfg, epochs=1)
    src = cli(one, str(tmp_path / "src"))
    saved = Checkpointer(str(tmp_path / "src")).load_optimizer(
        str(tmp_path / "src" / "model.epoch.0"), "cpu")
    none = write_conf(str(tmp_path / "none.json"), cfg, epochs=0)
    t = cli(none, str(tmp_path / "ios"), "-ios", str(tmp_path / "src" / "model.epoch.0"))
    assert t.global_step == src.global_step == 4
    got = t.optimizer.state_dict()["state"]
    for i, st in saved["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][k], st[k]), (i, k)
        assert float(got[i]["step"]) == float(st["step"]) == 3
    two = write_conf(str(tmp_path / "two.json"), cfg, epochs=2)
    t = cli(two, str(tmp_path / "tf"), "-tfe", "1", "-tfs", "9")
    assert [r["epoch"] for r in t.history] == [1, 1, 1]
    assert [r["step"] for r in t.history] == [9, 10, 11]
    assert t.history[0]["lr"] == t.schedule(9, 1)


def test_supervise_restarts_after_the_injected_fault(e2e, tmp_path, monkeypatch):
    """``--supervise 1`` with the fault armed at step 5 (after epoch 1's first update) and
    asynchronous saves: the first child crashes once, the second resumes
    from epoch 0's checkpoint and finishes; each child appends its record."""
    root, cfg = e2e
    conf = write_conf(str(tmp_path / "three.json"), cfg, epochs=3)
    marker, record = str(tmp_path / "fault.marker"), str(tmp_path / "record.jsonl")
    monkeypatch.setenv("OT_FAULT_INJECT_STEP", "5")
    monkeypatch.setenv("OT_FAULT_INJECT_MARKER", marker)
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = run_cli.main(["-c", conf, "--expdir", str(tmp_path / "exp"), "--device", "cpu",
                       "--log_interval", "100", "--async-save", "--supervise", "1",
                       "--record", record])
    assert rc == 0 and open(marker).read() == "5"
    assert Checkpointer(str(tmp_path / "exp")).list_epochs() == [0, 1, 2]
    with open(record) as f:
        runs = [json.loads(line) for line in f]
    assert len(runs) == 2
    crashed, resumed = runs
    assert "fault injection" in crashed["error"] and crashed["resumed_from"] is None
    assert crashed["first_step"] == 1 and crashed["next_step"] == 5  # 4 updates done
    with open(str(tmp_path / "exp" / "model.epoch.0" / "extra.json")) as f:
        saved_step = json.load(f)["global_step"]
    assert resumed["error"] is None and resumed["resumed_from"] == 0
    assert resumed["first_step"] == saved_step == 4 and resumed["next_step"] == 10
    assert resumed["epochs"] == [1, 2] and len(resumed["losses"]) == 6
    assert all(np.isfinite(r["losses"]).all() and r["nan_skips"] == 0 for r in runs)


def test_async_save_snapshots_and_reloads_after_wait(tmp_path):
    model = build_model(MODEL_CFG, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    ck = Checkpointer(str(tmp_path), async_save=True)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    ck.save(0, model, opt, extra={"global_step": 7})
    with torch.no_grad():  # training goes on while the thread writes
        for p in model.parameters():
            p.add_(1.0)
    back = compat.params_from_jax(ck.load_params(ck.epoch_path(0)))  # waits first
    assert ck._thread is None
    assert all(torch.equal(back[k], v) for k, v in want.items())
    assert ck.load_extra(ck.epoch_path(0)) == {"global_step": 7}
    assert ck.restore_latest() == (0, ck.epoch_path(0))
    assert not os.path.exists(ck.epoch_path(0) + ".tmp")


def test_profile_writes_a_trace(e2e, tmp_path):
    root, cfg = e2e
    one = write_conf(str(tmp_path / "one.json"), cfg, epochs=1)
    cli(one, str(tmp_path / "exp"), "--profile", str(tmp_path / "prof"))
    with open(str(tmp_path / "prof" / "trace.json")) as f:
        assert len(json.load(f)["traceEvents"]) > 0


# ----------------------------------------------- updates against the JAX trainer
TCFG = {"optimizer_type": "adam",
        "optimizer": {"betas": [0.9, 0.98], "eps": 1e-4, "weight_decay": 1e-6},
        "scheduler_type": "constant", "scheduler": {"lr": 1e-3}, "epochs": 1,
        "clip_grad": 5.0, "accum_steps": 1}


def host_batch(args):
    feats, mask, targets, tlen = args
    return (None, {"inputs": feats, "mask": mask}, {"targets": targets, "targets_length": tlen})


@functools.lru_cache(maxsize=2)
def jax_grad_fn(mixspeech: bool):
    """The JAX trainer's jitted gradient step (shared by the update cases:
    it does not depend on the optimizer)."""
    return JaxTrainer(TCFG, jax_build_model(MODEL_CFG), is_mixspeech=mixspeech)._build_grad_fn()


def jax_updates(train_cfg, params0, batches, mixspeech=False):
    """The JAX trainer's updates, one a batch → (params, optimizer state,
    losses, the last batch's gradient)."""
    jt = JaxTrainer(train_cfg, jax_build_model(MODEL_CFG), is_mixspeech=mixspeech)
    variables = jax.tree_util.tree_map(jnp.asarray, params0)
    opt = (jt._init_flat_opt_state(variables["params"]) if jt.fused_update
           else jt.tx.init(variables["params"]))
    grad_fn, update_fn = jax_grad_fn(mixspeech), jt._build_update_fn()
    nan_skips, losses = jnp.zeros((), jnp.int32), []
    for i, batch in enumerate(batches):
        gacc = jt._zeros_like_grads(variables)
        variables, gacc, loss, _ = grad_fn(variables, gacc, default_speech_batch(batch),
                                           jax.random.PRNGKey(i), None)
        grads = jax.tree_util.tree_map(np.array, gacc)
        losses.append(float(loss))
        variables, opt, _, _ = update_fn(variables, opt, gacc, nan_skips,
                                         jt.schedule(i + 1, 0), jax.random.PRNGKey(100 + i))
    return jax.tree_util.tree_map(np.asarray, variables["params"]), opt, losses, grads


def port_updates(train_cfg, params0, batches):
    model = compat.load_into(build_model(MODEL_CFG, device="cpu"), params0).train()
    trainer = Trainer(train_cfg, model, None, torch.Generator().manual_seed(0))
    recs = []
    for batch in batches:
        trainer.micro_step(batch)
        recs.append(trainer.update())
    return compat.params_to_jax(model)["params"], trainer, recs


@pytest.mark.parametrize("fused,m_dtype", [(True, None), (True, "bfloat16"),
                                           (False, "bfloat16")],
                         ids=["fused", "fused_bf16_m", "bf16_m"])
def test_fused_and_bf16_moment_updates_match_jax(fused, m_dtype):
    """Two updates with clip and weight decay on host features."""
    _, params0, _ = jax_model_and_params(0)
    batches = [host_batch(jax_model_and_params(s)[2]) for s in (1, 2)]
    opt_cfg = dict(TCFG["optimizer"], **({"adam_m_dtype": m_dtype} if m_dtype else {}))
    cfg = dict(TCFG, fused_update=fused, optimizer=opt_cfg)
    want, jopt, jlosses, _ = jax_updates(cfg, params0, batches)
    got, trainer, recs = port_updates(cfg, params0, batches)
    # the first loss is before any update; later ones follow parameters
    # that differ within the update tolerance (bf16 rounding of the moment)
    losses = [r["losses"][0] for r in recs]
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for key, w in flat(want).items():
        np.testing.assert_allclose(flat(got)[key], w, rtol=5e-3, atol=1e-4, err_msg=key)
    want_m = jnp.bfloat16 if m_dtype else jnp.float32
    if fused:
        opt = trainer.optimizer
        assert isinstance(opt, FusedAdam) and opt.count == int(jopt.count) == 2
        assert jopt.mu.dtype == want_m and opt.mu.dtype == getattr(torch, m_dtype or "float32")
        assert opt.mu.shape == jopt.mu.shape and opt.nu.dtype == torch.float32
        # parameters and gradients are views into the flat buffers
        ptrs = [p.data_ptr() for p in trainer.model.parameters()]
        base, end = opt.flat.data_ptr(), opt.flat.data_ptr() + 4 * opt.flat.numel()
        assert all(base <= q < end for q in ptrs)
        gbase = opt.grad.data_ptr()
        assert all(gbase <= p.grad.data_ptr() < gbase + 4 * opt.grad.numel()
                   for p in trainer.model.parameters())
    else:
        st = next(iter(trainer.optimizer.state.values()))
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        adam = next(s for s in jopt if hasattr(s, "mu"))
        assert jax.tree_util.tree_leaves(adam.mu)[0].dtype == jnp.bfloat16


def test_fused_update_skips_a_non_finite_gradient():
    _, params0, args = jax_model_and_params(0)
    model = compat.load_into(build_model(MODEL_CFG, device="cpu"), params0)
    trainer = Trainer(dict(TCFG, fused_update=True), model, None,
                      torch.Generator().manual_seed(0))
    before = trainer.optimizer.flat.clone()
    trainer.optimizer.grad.fill_(float("nan"))
    trainer._window = [torch.tensor(1.0)]
    rec = trainer.update()
    assert not rec["applied"] and trainer.nan_skips == 1 and trainer.optimizer.count == 0
    assert torch.equal(trainer.optimizer.flat, before) and trainer.optimizer.mu.abs().sum() == 0
    assert float(trainer.optimizer.grad.abs().sum()) == 0.0  # zeroed in place for the next window


def test_mixspeech_update_matches_jax_at_an_injected_lambda(monkeypatch):
    """Four rows mixed in two pairs at λ = 0.3 (JAX's Beta draw replaced by
    the constant): the loss and every gradient to 1e-5 relative to each
    tensor's scale, and the parameters after the clipped Adam update to
    1e-5."""
    lam = 0.3
    _, params0, _ = jax_model_and_params(0)
    rng = np.random.default_rng(21)
    feats = rng.normal(size=(4, 64, 20)).astype(np.float32)
    mask = np.arange(64)[None] < np.array([64, 40, 52, 30])[:, None]
    targets = np.zeros((4, 12), np.int32)
    ulens = np.array([9, 5, 7, 3])
    for i, u in enumerate(ulens):
        targets[i, 0] = 1
        targets[i, 1 : 1 + u] = rng.integers(3, 40, size=u)
        targets[i, 1 + u] = 1
    batches = [host_batch((feats, mask, targets, (ulens + 1).astype(np.int32)))]
    monkeypatch.setattr(jax.random, "beta",
                        lambda key, a, b, *args, **kw: jnp.asarray(lam, jnp.float32))
    want, _, jlosses, jgrads = jax_updates(TCFG, params0, batches, mixspeech=True)
    model = compat.load_into(build_model(MODEL_CFG, device="cpu"), params0).train()
    trainer = Trainer(TCFG, model, None, torch.Generator().manual_seed(0), mixspeech=True)
    trainer.mix_lambda = lambda: torch.tensor(lam)
    trainer.micro_step(batches[0])
    assert abs(trainer._window[0].item() - jlosses[0]) <= 1e-5 * abs(jlosses[0])
    grads = compat.params_to_jax(model, {n: p.grad for n, p in model.named_parameters()})
    for key, w in flat(jgrads).items():
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(flat(grads["params"])[key], w, rtol=0, atol=1e-5 * scale,
                                   err_msg=key)
    trainer.update()
    got = compat.params_to_jax(model)["params"]
    for key, w in flat(want).items():
        np.testing.assert_allclose(flat(got)[key], w, rtol=0, atol=1e-5, err_msg=key)


def test_mixspeech_lambda_is_arcsine_distributed():
    """λ ~ Beta(0.5, 0.5) from the trainer's generator: mean 1/2, variance
    1/8, and the arcsine CDF at 0.1 (0.2048)."""
    gen = torch.Generator().manual_seed(0)
    from opentransformer_tpu_torch.train.trainer import beta_half

    lam = torch.stack([beta_half(gen, "cpu") for _ in range(20000)]).numpy()
    assert abs(lam.mean() - 0.5) < 0.01 and abs(lam.var() - 0.125) < 0.005
    assert abs((lam < 0.1).mean() - 2 / np.pi * np.arcsin(np.sqrt(0.1))) < 0.01


# -------------------------------------------------------------------- data
def test_logfbank_psf_matches_jax():
    rng = np.random.default_rng(3)
    for n, mel in ((16000, 40), (4321, 26), (300, 80)):
        w = rng.normal(size=n).astype(np.float32)
        np.testing.assert_allclose(logfbank_psf(w, num_mel_bins=mel),
                                   jax_logfbank_psf(w, num_mel_bins=mel), rtol=0, atol=1e-5)


def test_espnet_batches_equal_jax(tmp_path):
    """data.json splits through both loaders, SpecAugment on in training."""
    rng = np.random.default_rng(5)
    feats = {f"u{i}": rng.normal(size=(int(rng.integers(30, 90)), 16)).astype(np.float32)
             for i in range(10)}
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    write_ark(ark, feats, scp)
    from opentransformer_tpu_torch.data.kaldi_io import read_scp

    rx = read_scp(scp)
    utts = {u: {"input": [{"feat": rx[u], "shape": list(f.shape)}],
                "output": [{"tokenid": " ".join(str(t) for t in rng.integers(3, 12, 4))}]}
            for u, f in feats.items()}
    (tmp_path / "data.json").write_text(json.dumps({"utts": utts}))
    (tmp_path / "vocab").write_text("".join(f"u{i} {i}\n" for i in range(12)))
    data = {"dataset_type": "espnet", "batch_size": 4, "vocab": str(tmp_path / "vocab"),
            "spec_augment": True, "spec_augment_config": {"freq_mask_rate": 0.2},
            "train": {"json": [str(tmp_path / "data.json")]}}
    for is_eval in (False, True):
        ours = list(FeatureLoader({"data": data}, "train", is_eval=is_eval, seed=3))
        theirs = list(JaxLoader({"data": data}, "train", is_eval=is_eval, seed=3))
        assert len(ours) == len(theirs) == 3
        for (u1, i1, t1), (u2, i2, t2) in zip(ours, theirs):
            assert list(u1) == list(u2)
            for k in ("inputs", "mask", "inputs_length"):
                np.testing.assert_array_equal(i1[k], np.asarray(i2[k]), err_msg=k)
            for k in ("targets", "targets_length"):
                np.testing.assert_array_equal(t1[k], np.asarray(t2[k]), err_msg=k)


@pytest.fixture(scope="module")
def noise_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("noise"))
    cfg = write_corpus(root, n_train=60, n_dev=2, seed=4)
    return cfg["data"]


def test_gaussian_noise_equals_jax_and_keeps_its_statistics(noise_corpus):
    sigma = 0.5
    data = dict(noise_corpus, extract_on_device=False, gaussian_noise=sigma, normalization=False,
                spec_augment=False, speed_perturb=False, volume_perturb=False)
    split = data["train"]
    noisy = AudioDataset(data, split, rng=np.random.default_rng(9))
    jax_noisy = JaxAudioDataset(data, split, rng=np.random.default_rng(9))
    clean = AudioDataset(data, split, is_eval=True)
    offsets = []
    for i in range(len(noisy)):
        a, b, c = noisy[i][1], jax_noisy[i][1], clean[i][1]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        d = a - c
        assert np.allclose(d, d[:1], atol=1e-4)  # one offset a mel bin, every frame
        offsets.append(d[0])
    offsets = np.concatenate(offsets)
    assert offsets.size >= 1000
    assert abs(offsets.mean()) <= 0.05 * sigma and abs(offsets.std() - sigma) <= 0.05 * sigma
    evaluated = AudioDataset(data, split, is_eval=True, rng=np.random.default_rng(9))
    assert evaluated.gaussian_noise == 0.0
    np.testing.assert_array_equal(evaluated[0][1], clean[0][1])
