"""The anchor recipe's pieces in the port against the JAX package, on the CPU.

A tiny kaldi corpus (40 training utterances of 30-200 frames x 40, one of
them longer than the last of two bucket boundaries, 12 dev utterances,
speaker CMVN stats, a ``feat-to-len`` file) is read by both packages with
the same seeds, and a d32 model with one encoder and one decoder block and
40 units goes through both. Tolerances:

  * the bucketing sampler's batches, the kaldi dataset's arrays (with and
    without ``additive_noise_std``, with host SpecAugment, with CMVN), the
    loaders' batches, the resident corpus in each storage dtype and its
    gather with noise off: exactly equal;
  * the resident gather with noise 0.3 (the card's generator, not JAX's
    PRNG): pads stay 0, the valid frames' residual has mean within 0.02 of 0
    and std within 3% of 0.3;
  * one bfloat16 update against the JAX Trainer's with the model built in
    bfloat16: loss within 2e-2 relative, global gradient norm within 5e-2
    relative, cosine of the flattened gradients at least 0.99;
  * ``steps_per_exec = 3`` over 6 same-shape batches against the JAX
    Trainer's multi-step program: parameters within 1e-5 at Adam eps 1e-4,
    the same ``global_step`` and the same lr sequence; at the anchor's eps
    of 1e-9 the same step and lrs, and the parameters whose gradient never
    fell to float32 rounding level within 1e-4, all but 0.1% within 1e-5;
  * the dev greedy-CER probe: the same CER on the same weights, in float32;
  * the average of two checkpoints: equal to the JAX Checkpointer's float64
    mean cast to float32.

The last test runs the training CLI with all of the anchor's options at the
tiny width for 2 epochs, averages, and decodes the average with the eval CLI.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from opentransformer_tpu.cli.run import make_dev_cer_probe as jax_probe
from opentransformer_tpu.data.bucket import BySequenceLengthSampler as JaxSampler
from opentransformer_tpu.data.datasets import KaldiDataset as JaxKaldi
from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader
from opentransformer_tpu.data.resident import make_resident_preprocess
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer
from opentransformer_tpu.train.trainer import TrainState, default_speech_batch
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import average as average_cli
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.config import CONF_DIR, load_config
from opentransformer_tpu_torch.data import write_vocab
from opentransformer_tpu_torch.data.bucket import BySequenceLengthSampler
from opentransformer_tpu_torch.data.datasets import KaldiDataset
from opentransformer_tpu_torch.data.kaldi_io import write_ark
from opentransformer_tpu_torch.data.loader import FeatureLoader
from opentransformer_tpu_torch.data.resident import ResidentCorpus
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.train.checkpoint import Checkpointer
from opentransformer_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, FEAT = 40, 40
BOUNDARIES = [96, 192]
OVERLONG = 260  # frames of the one utterance past the last boundary
MODEL_CFG = {
    "type": "speech2text", "frontend_type": "conv",
    "frontend": {"input_size": FEAT, "output_size": 32, "in_channel": 1, "mid_channel": 4,
                 "out_channel": 8, "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2],
                 "dropout": 0.0, "act_func_type": "relu"},
    "encoder_type": "transformer",
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 64, "n_blocks": 1, "activation": "glu",
                "normalize_before": False, "relative_positional": False, "pos_dropout": 0.0,
                "slf_attn_dropout": 0.0, "ffn_dropout": 0.0, "residual_dropout": 0.0},
    "decoder_type": "transformer",
    "decoder": {"vocab_size": VOCAB, "d_model": 32, "n_heads": 4, "d_ff": 64, "memory_dim": 32,
                "n_blocks": 1, "activation": "glu", "share_embedding": True, "pos_dropout": 0.0,
                "slf_attn_dropout": 0.0, "src_attn_dropout": 0.0, "ffn_dropout": 0.0,
                "residual_dropout": 0.0},
    "ctc_weight": 0.3, "smoothing": 0.1,
}
TRAIN_CFG = {"optimizer_type": "adam",
             "optimizer": {"lr": 1.0, "betas": [0.9, 0.98], "eps": 1.0e-9, "weight_decay": 1.0e-6},
             "scheduler_type": "linear-warmup-exp-decay",
             "scheduler": {"warmup_steps": 4, "peak_lr": 3.0e-3, "decay_start": 5,
                           "final_lr": 1.0e-5, "decay_factor": 0.5},
             "clip_grad": 5, "epochs": 2, "accum_steps": 1, "dev_cer_batches": 4,
             "dev_cer_max_len": 12, "save_name": "tiny_anchor"}

torch.set_num_threads(1)


def utterance(rng, frames):
    """A [frames, 40] pattern sequence with 3-8 units from c3 … c39."""
    units = rng.integers(3, VOCAB, size=rng.integers(3, 9))
    pat = rng.normal(size=(VOCAB, FEAT)).astype(np.float32)
    rows = np.repeat(units, -(-frames // len(units)))[:frames]
    return pat[rows] + 0.1 * rng.normal(size=(frames, FEAT)).astype(np.float32), units


def write_kaldi_corpus(root, n_train=40, n_dev=12, seed=0):
    """arks, scps, texts, vocab, utt2spk, speaker CMVN stats and feat-to-len
    of a train and a dev split; returns the config's data section."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    write_vocab({"<PAD>": 0, "<S/E>": 1, "<UNK>": 2, **{f"c{i}": i for i in range(3, VOCAB)}},
                os.path.join(root, "vocab"))
    data = {"vocab": os.path.join(root, "vocab")}
    for split, n in (("train", n_train), ("dev", n_dev)):
        feats, text, spk, lens = {}, [], [], []
        for i in range(n):
            utt = f"{split}{i:03d}"
            frames = OVERLONG if (split, i) == ("train", 7) else int(rng.integers(30, 201))
            feats[utt], units = utterance(rng, frames)
            text.append(f"{utt} " + " ".join(f"c{u}" for u in units))
            spk.append(f"{utt} spk{i % 3}")
            if i != 2:  # one utterance the lengths file lacks: read from its ark
                lens.append(f"{utt} {frames}")
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        write_ark(os.path.join(d, "feats.ark"), feats, os.path.join(d, "feats.scp"))
        stats = {}
        for s in range(3):
            x = np.concatenate([f for u, f in feats.items() if int(u[-3:]) % 3 == s]).astype(
                np.float64)
            stats[f"spk{s}"] = np.stack([np.append(x.sum(0), len(x)),
                                         np.append((x ** 2).sum(0), 0.0)])
        write_ark(os.path.join(d, "cmvn.ark"), stats, os.path.join(d, "cmvn.scp"))
        for name, lines in (("text", text), ("utt2spk", spk), ("feat-to-len", lens)):
            with open(os.path.join(d, name), "w") as f:
                f.write("\n".join(lines) + "\n")
        data[split] = {"feat": [os.path.join(d, "feats.scp")], "text": [os.path.join(d, "text")]}
    return data


def split_dict(data, split, cmvn=False, lengths=False):
    d = os.path.dirname(data[split]["feat"][0])
    out = dict(data[split])
    if cmvn:
        out.update(utt2spk=[os.path.join(d, "utt2spk")], cmvn=[os.path.join(d, "cmvn.scp")])
    if lengths:
        out["feat-to-len"] = os.path.join(d, "feat-to-len")
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kaldi"))
    data = write_kaldi_corpus(root)
    cfg = {"data": {**data, "batch_size": 4, "dataset_type": "kaldi", "device_resident": True,
                    "additive_noise_std": 0.3, "spec_augment": False, "num_workers": 2,
                    "bucket": {"bucket_boundaries": BOUNDARIES, "drop_last": True,
                               "overlong_pad_multiple": 64}},
           "model": MODEL_CFG, "train": dict(TRAIN_CFG)}
    return root, cfg


def host_cfg(cfg, **data):
    """The config with the host feature path (no resident corpus)."""
    out = json.loads(json.dumps(cfg))
    out["data"].update(device_resident=False, **data)
    return out


# ------------------------------------------------------------- the sampler
SAMPLER_CASES = {
    "batch_size": dict(batch_size=4),
    "drop_last": dict(batch_size=3, drop_last=True),
    "bucket_batch_size": dict(bucket_batch_sizes=[5, 3]),
    "max_frames": dict(max_frames_one_batch=500),
    "overlong_quanta": dict(batch_size=2, overlong_pad_multiple=100),
    "rm_long": dict(batch_size=4, rm_the_long_sents=True),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_bucket_sampler_batches_equal_jax(corpus, case):
    pairs = KaldiDataset(corpus[1]["data"], corpus[1]["data"]["train"]).index_length_pair()
    kw = dict(bucket_boundaries=BOUNDARIES, seed=5, **SAMPLER_CASES[case])
    ours, theirs = BySequenceLengthSampler(pairs, **kw), JaxSampler(pairs, **kw)
    assert sorted(ours.buckets) == sorted(theirs.buckets)
    assert (max(ours.buckets) > BOUNDARIES[-1]) != (case == "rm_long")
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) > 1 and list(ours) == list(theirs)


# ------------------------------------------------------------- the dataset
DATASET_CASES = {
    "clean": dict(is_eval=False, params={}),
    "noise": dict(is_eval=False, params={"additive_noise_std": 0.3}),
    "noise_eval": dict(is_eval=True, params={"additive_noise_std": 0.3}),
    "specaug_cmvn": dict(is_eval=False, cmvn=True,
                         params={"spec_augment": True, "additive_noise_std": 0.1,
                                 "spec_augment_config": {"time_mask_num": 3}}),
    "normalized_max_target": dict(is_eval=False, lengths=True,
                                  params={"normalization": True, "max_target_length": 6}),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_kaldi_dataset_equals_jax(corpus, case):
    c = DATASET_CASES[case]
    data = corpus[1]["data"]
    params = {"vocab": data["vocab"], **c["params"]}
    dd = split_dict(data, "train", c.get("cmvn", False), c.get("lengths", False))
    ours = KaldiDataset(params, dd, is_eval=c["is_eval"], rng=np.random.default_rng(3))
    theirs = JaxKaldi(params, dd, is_eval=c["is_eval"], rng=np.random.default_rng(3))
    assert len(ours) == len(theirs) > 0
    assert len(ours) < 40 if "max_target_length" in params else len(ours) == 40
    assert ours.index_length_pair() == theirs.index_length_pair()
    clean = KaldiDataset({"vocab": data["vocab"]}, dd, is_eval=True)
    changed = 0
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3] and a[4] == b[4]
        assert a[1].dtype == b[1].dtype == np.float32 and np.array_equal(a[1], b[1])
        assert ours.target_row(i) == theirs.target_row(i)
        changed += not np.array_equal(a[1], clean[clean.file_list.index(ours.file_list[i])][1])
    assert changed == (0 if case in ("clean", "noise_eval") else len(ours))


@pytest.mark.parametrize("split", ["train", "dev"])
def test_kaldi_bucket_loader_batches_equal_jax(corpus, split):
    """Host features with the training noise, bucketed and padded to each
    boundary (the dev split buckets too and drops its short batch)."""
    cfg = host_cfg(corpus[1], num_workers=0)
    is_eval = split == "dev"
    ours = FeatureLoader(cfg, split, is_eval=is_eval, seed=4)
    theirs = JaxLoader(cfg, split, is_eval=is_eval, seed=4)
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(theirs) > 0
        for (u1, i1, t1), (u2, i2, t2) in zip(got, want):
            assert u1 == u2
            for k in ("inputs", "inputs_length", "mask"):
                assert np.array_equal(i1[k], i2[k]), k
            for k in t2:
                assert np.array_equal(t1[k], t2[k]), k
    # each bucket drops its short batch, the dev split's too
    kept = sum(len(v) // 4 * 4 for v in ours.sampler.buckets.values())
    assert sum(len(u) for u, _, _ in got) == kept < len(ours.dataset)


# ------------------------------------------------------ the resident corpus
@pytest.fixture(scope="module")
def resident_pair(corpus):
    cfg = corpus[1]
    ours, theirs = FeatureLoader(cfg, "train", seed=4), JaxLoader(cfg, "train", seed=4)
    assert ours.device_resident and theirs.device_resident
    return ours, theirs


@pytest.mark.parametrize("dtype", ["float16", "float32", "bfloat16"])
def test_resident_corpus_build_equals_jax(resident_pair, dtype):
    ours, theirs = resident_pair
    corpus, lens = ours.build_resident_corpus(dtype)
    want, want_lens = theirs.build_resident_corpus(dtype)
    assert corpus.shape == want.shape and np.array_equal(lens, want_lens)
    # the over-long utterance rounds T_max up to the pad multiple
    assert corpus.shape[1] == -(-OVERLONG // 64) * 64
    assert str(corpus.dtype) == f"torch.{dtype}"
    assert np.array_equal(corpus.float().numpy(), np.asarray(want, np.float32))
    # the dataset's noise is back on after the clean read
    assert ours.dataset.additive_noise_std == 0.3


def test_resident_gather_equals_jax_without_noise(resident_pair, corpus):
    ours, theirs = resident_pair
    corpus_t, lens = ours.build_resident_corpus()
    corpus_j, lens_j = theirs.build_resident_corpus()
    batches = list(ours)
    assert "corpus_idx" in batches[0][1] and batches[0][1].keys() == {"corpus_idx"}
    assert [b[0] for b in batches] == [b[0] for b in theirs]
    fn, _ = make_resident_preprocess(corpus[1]["data"], corpus_j, lens_j)
    res = ResidentCorpus(corpus[1]["data"], corpus_t, lens, "cpu")
    assert res.nbytes == corpus_t.numel() * 2
    for _, inputs, tg in batches[:3]:
        idx = inputs["corpus_idx"]
        x, m, y, yl = res(idx, tg["targets"], tg["targets_length"], train=False)
        xj, mj, yj, ylj = fn(jnp.asarray(idx), jnp.asarray(tg["targets"]),
                             jnp.asarray(tg["targets_length"]), rng=jax.random.PRNGKey(0),
                             train=False)
        assert x.dtype == torch.float32 and np.array_equal(x.numpy(), np.asarray(xj))
        assert np.array_equal(m.numpy(), np.asarray(mj))
        assert np.array_equal(y.numpy(), np.asarray(yj))
        assert np.array_equal(yl.numpy(), np.asarray(ylj))


def test_resident_noise_is_masked_with_the_asked_std(resident_pair, corpus):
    corpus_t, lens = resident_pair[0].build_resident_corpus("float32")
    res = ResidentCorpus(corpus[1]["data"], corpus_t, lens, "cpu")
    idx = np.arange(len(lens), dtype=np.int32)
    y, yl = np.zeros((len(idx), 8), np.int32), np.ones(len(idx), np.int32)
    clean, mask, _, _ = res(idx, y, yl, train=False)
    noisy, _, _, _ = res(idx, y, yl, torch.Generator().manual_seed(0), train=True)
    resid = (noisy - clean)
    assert torch.count_nonzero(resid[~mask]) == 0
    valid = resid[mask]
    assert valid.numel() > 100_000
    assert abs(float(valid.mean())) <= 0.02
    assert abs(float(valid.std()) - 0.3) <= 0.03 * 0.3
    again, _, _, _ = res(idx, y, yl, torch.Generator().manual_seed(1), train=True)
    assert not torch.equal(again, noisy)  # fresh noise on every gather


# -------------------------------------------------- updates against JAX
def fixed_batches(cfg, n, seed=4):
    """n host-feature training batches (noise on) of the largest bucket."""
    loader = FeatureLoader(host_cfg(cfg, bucket={"bucket_boundaries": [192],
                                                 "drop_last": True, "overlong_pad_multiple": 64},
                                    num_workers=0), "train", seed=seed)
    out = [b for b in loader if b[1]["inputs"].shape[1] == 192][:n]
    assert len(out) == n
    return out


@pytest.fixture(scope="module")
def params0(corpus):
    batch = fixed_batches(corpus[1], 1)[0]
    args = default_speech_batch(batch)
    variables = jax.jit(jax_build_model(MODEL_CFG).init)(jax.random.PRNGKey(3), *args)
    return jax.tree_util.tree_map(np.array, variables)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def port_model(params):
    return compat.load_into(build_model(MODEL_CFG, device="cpu"), params).train()


def test_bf16_update_matches_the_jax_bf16_trainer(corpus, params0):
    batch = fixed_batches(corpus[1], 1)[0]
    jm = jax_build_model(MODEL_CFG, dtype=jnp.bfloat16)
    jt = JaxTrainer(dict(TRAIN_CFG, dtype="bfloat16"), jm)
    variables = jax.tree_util.tree_map(jnp.asarray, params0)
    _, gacc, loss_j, aux_j = jt._build_grad_fn()(variables, jt._zeros_like_grads(variables),
                                                 default_speech_batch(batch),
                                                 jax.random.PRNGKey(0), None)
    g_j = flat(jax.tree_util.tree_map(np.asarray, gacc))

    model = port_model(params0)
    trainer = Trainer(dict(TRAIN_CFG, dtype="bfloat16"), model, None, torch.Generator())
    loss_t = float(trainer.micro_step(batch))
    assert trainer._window_aux[0].keys() == {"ctc_loss", "att_loss"}
    grads = {}
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        grads[name] = p.grad
    clone = port_model(params0)
    with torch.no_grad():
        for name, p in clone.named_parameters():
            p.copy_(grads[name])
    g_t = flat(compat.params_to_jax(clone)["params"])
    keys = sorted(g_j)
    assert keys == sorted(g_t)
    vj = np.concatenate([g_j[k].ravel() for k in keys])
    vt = np.concatenate([g_t[k].ravel() for k in keys])
    assert abs(loss_t - float(loss_j)) <= 2e-2 * abs(float(loss_j))
    for part in ("ctc_loss", "att_loss"):
        assert abs(float(trainer._window_aux[0][part]) - float(aux_j[part])) <= 2e-2 * abs(
            float(aux_j[part]))
    nj, nt = np.linalg.norm(vj), np.linalg.norm(vt)
    assert abs(nt - nj) <= 5e-2 * nj
    assert float(vj @ vt) / (nj * nt) >= 0.99
    rec = trainer.update()
    assert rec["applied"] and set(rec["aux"]) == {"ctc_loss", "att_loss"}
    assert rec["losses"][0] == pytest.approx(
        0.7 * rec["aux"]["att_loss"][0] + 0.3 * rec["aux"]["ctc_loss"][0], rel=1e-5)


class EpochList(list):
    def set_epoch(self, epoch):
        pass


# Adam's first update is lr·g/(|g| + eps). At the anchor's eps of 1e-9 it is
# lr·sign(g), so an element whose gradient is at float32 rounding level (8e-8
# against a median of 9e-3 in this run) moves by ±lr on a sign that the
# summation order decides; at 1e-4 the update is continuous in g.
MULTI_STEP_CFG = dict(TRAIN_CFG, steps_per_exec=3, epochs=1,
                      optimizer=dict(TRAIN_CFG["optimizer"], eps=1e-4))


def run_jax_multi_step(batches, params0, tcfg):
    """The JAX Trainer's multi-step program over ``batches``; the schedule's
    calls are recorded."""
    jt = JaxTrainer(tcfg, jax_build_model(MODEL_CFG), log_interval=10 ** 9)
    lrs = []
    schedule = jt.schedule

    def recorded(step, epoch):
        lrs.append(schedule(step, epoch))
        return lrs[-1]

    jt.schedule = recorded
    params = jax.tree_util.tree_map(jnp.asarray, params0)
    state = TrainState(params=params, opt_state=jt.tx.init(params["params"]),
                       nan_skips=jnp.zeros((), jnp.int32))
    state = jt.train(state, EpochList(batches), jax.random.PRNGKey(0))
    return batches, state, jt.global_step, lrs


@pytest.fixture(scope="module")
def jax_multi_step(corpus, params0):
    """steps_per_exec = 3 over 6 same-shape batches (Adam eps 1e-4)."""
    return run_jax_multi_step(fixed_batches(corpus[1], 6), params0, MULTI_STEP_CFG)


def port_multi_step(batches, params0, tcfg):
    """The port's run of ``tcfg`` over ``batches`` → (trainer, params, the
    least |gradient| each element had over the updates)."""
    model = port_model(params0)
    trainer = Trainer(tcfg, model, None, torch.Generator(), log_interval=10 ** 9)
    least = {n: torch.full_like(p, np.inf) for n, p in model.named_parameters()}
    step = trainer.optimizer.step

    def recording_step():
        for n, p in model.named_parameters():
            torch.minimum(least[n], p.grad.abs(), out=least[n])
        step()

    trainer.optimizer.step = recording_step
    trainer.train(EpochList(batches))
    clone = port_model(params0)
    with torch.no_grad():
        for n, p in clone.named_parameters():
            p.copy_(least[n])
    return (trainer, flat(compat.params_to_jax(model)["params"]),
            flat(compat.params_to_jax(clone)["params"]))


def test_steps_per_exec_matches_the_jax_multi_step_program(jax_multi_step, params0):
    batches, state, global_step, lrs = jax_multi_step
    trainer, got, _ = port_multi_step(batches, params0, MULTI_STEP_CFG)
    assert trainer.global_step == global_step == 7
    assert [r["lr"] for r in trainer.history] == lrs and len(set(lrs)) == 5
    assert [r["step"] for r in trainer.history] == list(range(1, 7))
    want = flat(jax.tree_util.tree_map(np.asarray, state.params["params"]))
    moved = max(float(np.abs(want[k] - flat(params0["params"])[k]).max()) for k in want)
    assert moved > 100 * 1e-5
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5, err_msg=key)


def test_steps_per_exec_at_the_anchor_eps_matches_jax(corpus, params0):
    """The same program at the anchor's Adam eps of 1e-9: the same global
    step and lrs, and the parameters held to JAX's except where an element's
    gradient fell to float32 rounding level (|g| ≤ 1e-4 × the median |g|) in
    some update. There Adam's step is lr·sign(g) and the sign is the
    summation order's; the attention key biases, whose gradient is zero but
    for rounding, are most of them (138 of 31,168 elements). Those steps
    move the forward pass a little, so a kept element is held to 1e-4 (the
    median element moves 0.038) and all but 0.1% of them to 1e-5."""
    tcfg = dict(TRAIN_CFG, steps_per_exec=3, epochs=1)
    assert tcfg["optimizer"]["eps"] == load_config(
        os.path.join(CONF_DIR, "anchor.json"))["train"]["optimizer"]["eps"]
    batches, state, global_step, lrs = run_jax_multi_step(
        fixed_batches(corpus[1], 6), params0, tcfg)
    trainer, got, least = port_multi_step(batches, params0, tcfg)
    assert trainer.global_step == global_step == 7
    assert [r["lr"] for r in trainer.history] == lrs
    want = flat(jax.tree_util.tree_map(np.asarray, state.params["params"]))
    floor = 1e-4 * float(np.median(np.concatenate([v.ravel() for v in least.values()])))
    keep = {k: least[k] > floor for k in want}
    diff = np.concatenate([np.abs(got[k] - w)[keep[k]] for k, w in want.items()])
    n_all = sum(w.size for w in want.values())
    assert n_all - diff.size <= 0.01 * n_all
    assert diff.max() <= 1e-4
    assert np.count_nonzero(diff > 1e-5) <= 1e-3 * diff.size


def test_dev_cer_probe_equals_jax(corpus, jax_multi_step):
    state = jax_multi_step[1]
    cfg = host_cfg(corpus[1])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    want = jax_probe(cfg, jax_build_model(MODEL_CFG), JaxLoader(cfg, "dev", is_eval=True),
                     max_batches=4)(params, 0)
    model = port_model(params).eval()
    probe = run_cli.DevCerProbe(cfg, model, FeatureLoader(cfg, "dev", is_eval=True), "cpu")
    got = probe(model, 0)
    rec = probe.records[0]
    assert got == want and 0.0 < got
    n_batches = len(probe.batches)
    assert rec["utts"] == 4 * n_batches and rec["tokens"] > 0 and n_batches <= 3
    # on the CPU the wrapper runs the plain version: no kernel launch
    assert 0 < rec["steps"] <= n_batches * TRAIN_CFG["dev_cer_max_len"] and rec["launches"] == 0


# ----------------------------------------------------------- averaging
def test_average_equals_the_jax_checkpointer(tmp_path, params0):
    rng = np.random.default_rng(0)
    trees = [params0, jax.tree_util.tree_map(
        lambda x: (x + rng.normal(size=x.shape)).astype(np.float32), params0)]
    ours, theirs = Checkpointer(str(tmp_path / "port")), JaxCheckpointer(str(tmp_path / "jax"))
    for e, tree in enumerate(trees):
        ours._write_params(ours.epoch_path(e), port_model(tree))
        theirs.save_params_only(f"model.epoch.{e}", tree["params"])
    assert average_cli.main([ours.expdir, "0", "1"]) == 0
    path = os.path.join(ours.expdir, "model.average.from0to1")
    want = flat(theirs.restore(theirs.average(0, 1))["params"])
    got = flat(ours.load_params(path)["params"])
    with np.load(os.path.join(path, "params.npz")) as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    assert ours.load_config() is None


# ------------------------------------------------------- config, the CLI
def test_anchor_json_is_the_anchor_yaml():
    with open(os.path.join(REPO, "egs", "synth_bench", "conf", "anchor.yaml")) as f:
        assert load_config(os.path.join(CONF_DIR, "anchor.json")) == yaml.safe_load(f)


def test_cli_rehearses_the_anchor_recipe(corpus, tmp_path):
    """The anchor's options at the tiny width: kaldi, bucket, resident,
    noise, bfloat16, steps_per_exec 24, the probe, the hybrid loss; then the
    average of both epochs decoded by the eval CLI."""
    anchor = load_config(os.path.join(CONF_DIR, "anchor.json"))
    cfg = json.loads(json.dumps(corpus[1]))
    for key in ("dataset_type", "device_resident", "additive_noise_std", "spec_augment"):
        cfg["data"][key] = anchor["data"][key]
    for key in ("dtype", "steps_per_exec", "dev_cer_probe", "accum_steps", "clip_grad"):
        cfg["train"][key] = anchor["train"][key]
    cfg["model"]["ctc_weight"] = anchor["model"]["ctc_weight"]
    conf = str(tmp_path / "anchor_tiny.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    expdir = str(tmp_path / "exp")
    trainer = run_cli.run(["-c", conf, "--expdir", expdir, "--device", "cpu", "-s", "7",
                           "--log_interval", "2"])
    assert trainer.autocast_dtype == torch.bfloat16 and trainer.steps_per_exec == 24
    assert trainer.resident is not None and trainer.nan_skips == 0
    losses = [x for r in trainer.history for x in r["losses"]]
    n_batches = len(FeatureLoader(cfg, "train", seed=7))
    assert len(trainer.history) == 2 * n_batches and np.isfinite(losses).all()
    assert all(set(r["aux"]) == {"ctc_loss", "att_loss"} for r in trainer.history)
    assert len(trainer.dev_losses) == 2 and np.isfinite(trainer.dev_losses).all()
    probe = trainer.dev_probe_fn
    assert [r["epoch"] for r in probe.records] == [0, 1]
    assert Checkpointer(expdir).load_config()["train"]["dtype"] == "bfloat16"

    average_cli.main([expdir, "0", "1"])
    avg = os.path.join(expdir, "model.average.from0to1")
    dec = str(tmp_path / "decode")
    data = cfg["data"]
    eval_cli.main(["--npz", os.path.join(avg, "params.npz"),
                   "--model_cfg", os.path.join(expdir, "config.json"),
                   "--feats", data["dev"]["feat"][0], "--text", data["dev"]["text"][0],
                   "--vocab", data["vocab"], "-b", "6", "-bw", "3", "-ml", "8",
                   "--decode_dir", dec, "--device", "cpu"])
    with open(os.path.join(dec, "RESULT")) as f:
        assert f.readline().startswith("CER ")
    with open(os.path.join(dec, "predict.log")) as f:
        scores = {}
        for line in f:
            utt, _, score = line.split()[:3]
            scores.setdefault(utt, []).append(float(score.split("=")[1]))
    assert len(scores) == 12 and all(s == sorted(s, reverse=True) for s in scores.values())
