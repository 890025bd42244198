"""The port's parallelism (``opentransformer_tpu_torch/parallel/``) against
the JAX package's mesh, on the CPU.

Each case runs in a real world of 2 or 4 ranks over Gloo
(``parallel.launch.spawn``; the worker functions below import no JAX): one
training micro-batch of seeded weights (``chip_smoke.seeded_params`` in
JAX's layout, through ``compat.params_from_jax``) on one global batch,
dropout and SpecAugment off. Rank 0 gathers the loss and the gradients to the one-card
layout. The JAX package's result is computed in the pytest process on the
virtual CPU devices (``tests/conftest.py``): a GSPMD step with
``param_shardings`` and ``batch_sharding`` for data, tensor, sharded-pipe
and expert parallelism (equal to one device's step on the global batch), or
``speech2text_1f1b_grad_fn`` for the 1F1B schedule (the mean over
microbatch and data shard). Tolerances are those ``tests/test_pipeline.py``
holds JAX's mesh to: loss rtol 1e-5, gradients rtol 5e-3 / atol 1e-5.

Then: ``steps_per_exec`` and the device-resident corpus on a data mesh
(the parameters after a few SGD updates against the JAX mesh trainer's),
gradient noise and MixSpeech on a data mesh (both ranks' parameters equal,
and equal to the port's one-process run: the two packages draw different
numbers), what each rank of a ``sharded`` pipe holds of the blocks,
a tensor x expert mesh with dropout and router jitter on against the
port's one-process step (the two packages draw different masks),
the checkpoint of a ``--tp 2 --pp 2`` CLI run decoded on one rank against
the unsharded model, ``pipeline_apply`` against the sequential stack, the
port's ``param_shardings`` against JAX's, and one ``--multihost`` world of
two processes joined through torchrun's environment.

The cases of one world size share a spawn, both worlds run while the
pytest process computes the JAX results (module fixtures), and PyTorch
runs on one thread a rank.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.parallel import launch
from opentransformer_tpu_torch.parallel.mesh import make_mesh
from opentransformer_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, V, F_IN = 32, 50, 20  # V divides 2: the embedding shards under tp 2
FRONT = {"input_size": F_IN, "output_size": D, "mid_channel": 4, "out_channel": 8,
         "dropout": 0.0}
ENC = {"d_model": D, "n_heads": 2, "d_ff": 48, "n_blocks": 2, "residual_dropout": 0.0,
       "scan_layers": True}
DEC = {"vocab_size": V, "d_model": D, "n_heads": 2, "d_ff": 48, "memory_dim": D,
       "n_blocks": 1, "residual_dropout": 0.0}
TCFG = {"optimizer_type": "adam", "optimizer": {}, "scheduler_type": "constant",
        "scheduler": {"lr": 1e-3}}


def s2t(enc=None, dec=None, ctc_weight=0.0, encoder_type="transformer"):
    e = dict(ENC, **(enc or {}))
    if encoder_type == "conformer":
        e = {"d_model": D, "n_heads": 2, "d_ff": 48, "nblocks": 2, "cov_kernel_size": 5,
             "residual_dropout": 0.0, "conv_norm_type": "batch", **(enc or {})}
    return {"type": "speech2text", "frontend_type": "conv", "frontend": FRONT,
            "encoder_type": encoder_type, "encoder": e, "decoder": dict(DEC, **(dec or {})),
            "ctc_weight": ctc_weight}


MOE = {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 1.0}
LM = {"type": "transformer_lm", "vocab_size": 20, "num_blocks": 2, "d_model": D, "n_heads": 2,
      "d_ff": 48, "residual_dropout": 0.0, "moe_experts": 2, "moe_top_k": 1,
      "moe_capacity_factor": 1.0}

# name -> (data, model, pipe, expert), model config, pipe schedule, microbatches, batch
CASES = {
    "dp_ragged_tokens": ((2, 1, 1, 1), s2t(), None, None, dict(ragged=True)),
    "dp_batchnorm_conformer": ((2, 1, 1, 1), s2t(encoder_type="conformer"), None, None, {}),
    "tp_glu": ((1, 2, 1, 1), s2t(dict(activation="glu")), None, None, {}),
    "tp_relpos": ((1, 2, 1, 1), s2t(dict(relative_positional=True)), None, None, {}),
    "tp_concat_after": ((1, 2, 1, 1), s2t(dict(concat_after=True), dict(concat_after=True)),
                        None, None, {}),
    "pp_sharded": ((1, 1, 2, 1), s2t(dec=dict(scan_layers=True, n_blocks=2)), "sharded", None,
                   {}),
    "pp_1f1b_pipe_only": ((1, 1, 2, 1), s2t(), "1f1b", 3, dict(b=6)),
    "ep_moe_encoder": ((1, 1, 1, 2), s2t(MOE), None, None, {}),
    "ep_moe_lm": ((1, 1, 1, 2), LM, None, None, dict(kind="text")),
    # 56 frames (14 after the frontend): every label sequence aligns, so the
    # CTC loss is not optax's ~1e5 of an infeasible one
    "pp_1f1b_dp_ctc": ((2, 1, 2, 1), s2t(dict(normalize_before=True), ctc_weight=0.3),
                       "1f1b", 2, dict(t=56)),
    "pp_1f1b_tp": ((1, 2, 2, 1), s2t(dict(activation="glu")), "1f1b", 2, dict(b=4)),
    "pp_1f1b_moe": ((2, 1, 2, 1), s2t(MOE), "1f1b", 2, {}),
    "mesh_tp_ep_moe": ((1, 2, 1, 2), s2t(dict(MOE, activation="glu")), None, None, {}),
    "pp_1f1b_tp_moe_concat": ((1, 2, 2, 1), s2t(dict(MOE, concat_after=True)), "1f1b", 2,
                              dict(b=4)),
}


def world_of(name):
    d, m, p, e = CASES[name][0]
    return d * m * p * e


def make_batch(spec):
    """A host batch (utt ids, inputs, targets) from a numpy seed: speech
    features with ragged frame counts, or LM text. ``ragged`` gives the
    second half of the rows three times the first half's tokens."""
    rng = np.random.default_rng(spec.get("seed", 0))
    b = spec.get("b", 8)
    if spec.get("kind") == "text":
        src = rng.integers(3, 20, (b, 7)).astype(np.int64)
        tgt = rng.integers(3, 20, (b, 7)).astype(np.int64)
        tgt[: b // 2, 5:] = 0  # PAD tails: the LM's token counts differ by row
        return None, {"inputs": src}, {"targets": tgt, "targets_length": np.full(b, 7)}
    t, u = spec.get("t", 28), 9
    feats = rng.normal(size=(b, t, F_IN)).astype(np.float32)
    lens = rng.integers(t - 12, t + 1, size=b)
    lens[0] = t
    mask = np.arange(t)[None] < lens[:, None]
    tl = rng.integers(2, 4, size=b) if spec.get("ragged") else rng.integers(2, u - 1, size=b)
    if spec.get("ragged"):
        tl[b // 2:] = u - 1
    tgt = np.zeros((b, u + 1), np.int64)
    for i in range(b):
        tgt[i, 0] = 1
        tgt[i, 1 : 1 + tl[i]] = rng.integers(3, V, size=tl[i])
        tgt[i, 1 + tl[i]] = 1
    return None, {"inputs": feats, "mask": mask}, {"targets": tgt, "targets_length": tl + 1}


def flat(tree, prefix="", leaf=lambda v: np.asarray(v, np.float64)):
    """A nested dict's leaves by their '/'-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/", leaf))
        else:
            out[prefix + k] = leaf(v)
    return out


# ------------------------------------------------------ the ranks' side
def _port_case(rank, name, tmp):
    dims, cfg, schedule, n_micro, spec = CASES[name]
    model = compat.load_into(build_model(cfg, device="cpu"),
                             compat.load_npz(os.path.join(tmp, f"{name}.params.npz")))
    model.train()
    trainer = Trainer(dict(TCFG, pp_schedule=schedule, pp_micro_batches=n_micro), model, None,
                      torch.Generator().manual_seed(0), mesh=make_mesh(*dims))
    loss = trainer.micro_step(make_batch(spec))
    aux = trainer._window_aux[0]
    trainer.parallel.sync_grads(trainer.optimizer)
    values = trainer.parallel.report(torch.stack([loss] + [aux[k] for k in sorted(aux)]).float())
    grads = trainer.parallel.gather_grads()
    state = trainer.parallel.gather_state()
    if trainer.parallel.blocks:  # what each pipe rank holds of each block after the step
        np.savez(os.path.join(tmp, f"{name}.rest{rank}.npz"), **{
            name: np.asarray([p.untyped_storage().nbytes(), p.grad is not None, p.requires_grad,
                              trainer.parallel.is_local(name)])
            for blk in trainer.parallel.blocks for name, p in zip(blk.names, blk.params)})
    if rank == 0:
        fresh = build_model(cfg, device="cpu")
        tree = compat.params_to_jax(fresh, {**state, **grads})
        out = {"loss": values[0].numpy()}
        out.update({f"aux/{k}": values[1 + i].numpy() for i, k in enumerate(sorted(aux))})
        out.update({f"tree/{k}": v for k, v in flat(tree).items()})
        np.savez(os.path.join(tmp, f"{name}.port.npz"), **out)


class EpochList(list):
    def set_epoch(self, epoch):
        pass


def _port_training(rank, name, tmp):
    """A data mesh of 2 trains the tiny kaldi corpus for an epoch
    (``TRAINING[name]``); rank 0 writes the final parameters."""
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.data.resident import ResidentCorpus

    with open(os.path.join(tmp, "train_conf.json")) as f:
        cfg = json.load(f)
    cfg["data"].update(TRAINING[name]["data"])
    tcfg = dict(cfg["train"], **TRAINING[name]["train"])
    model = compat.load_into(build_model(cfg["model"], device="cpu"),
                             compat.load_npz(os.path.join(tmp, "train.params.npz")))
    loader = FeatureLoader(cfg, "train", seed=3)
    resident = None
    if loader.device_resident:
        corpus, lens = loader.build_resident_corpus()
        resident = ResidentCorpus(cfg["data"], corpus, lens, "cpu")
    trainer = Trainer(tcfg, model, None, torch.Generator().manual_seed(0), log_interval=10 ** 9,
                      resident=resident, mesh=make_mesh(2, 1, 1, 1))
    trainer.train(loader)
    if rank == 0:
        fresh = build_model(cfg["model"], device="cpu")
        tree = compat.params_to_jax(fresh, trainer.model.state_dict())
        np.savez(os.path.join(tmp, f"{name}.port.npz"),
                 **{f"tree/{k}": v for k, v in flat(tree).items()},
                 steps=np.asarray([r["step"] for r in trainer.history]))


def noise_mix_training(tmp, mesh=None):
    """An epoch of SGD with gradient noise and MixSpeech on the tiny corpus
    (``TRAINING``'s model and weights): the trainer after it."""
    from opentransformer_tpu_torch.data.loader import FeatureLoader

    with open(os.path.join(tmp, "train_conf.json")) as f:
        cfg = json.load(f)
    model = compat.load_into(build_model(cfg["model"], device="cpu"),
                             compat.load_npz(os.path.join(tmp, "train.params.npz")))
    trainer = Trainer(dict(cfg["train"], grad_noise=0.05), model, None,
                      torch.Generator().manual_seed(0), log_interval=10 ** 9, mixspeech=True,
                      mesh=mesh)
    trainer.train(FeatureLoader(cfg, "train", seed=3))
    return trainer


def _port_noise_mix(rank, tmp):
    """``noise_mix_training`` on a data mesh of 2: each rank writes its
    parameters."""
    trainer = noise_mix_training(tmp, make_mesh(2, 1, 1, 1))
    np.savez(os.path.join(tmp, f"noise_mix.rank{rank}.npz"),
             **{n: p.detach().numpy() for n, p in trainer.model.named_parameters()})


def _port_pipeline_apply(rank, tmp):
    """``pipeline_apply`` over a pipe of 2: four encoder layers, three
    microbatches; rank 0 writes the outputs and every layer's gradient of
    sum(out²) (each stage's from its rank)."""
    from opentransformer_tpu_torch.models.encoder import TransformerEncoderLayer
    from opentransformer_tpu_torch.ops.collectives import all_reduce_
    from opentransformer_tpu_torch.parallel.pipeline import pipeline_apply

    torch.manual_seed(0)
    layers = [TransformerEncoderLayer(16, 2, 32, residual_dropout=0.0) for _ in range(4)]
    xs = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2, 6, 16)).astype(np.float32))
    mesh = make_mesh(1, 1, 2, 1)
    mine = layers[2 * mesh.index("pipe") : 2 * mesh.index("pipe") + 2]
    mask = torch.ones(2, 1, 1, 6, dtype=torch.bool)

    def stage(x):
        for layer in mine:
            x = layer(x, mask)
        return x

    out = pipeline_apply(stage, xs, mesh)
    (out ** 2).sum().backward()
    grads = [torch.cat([p.grad.reshape(-1) if p.grad is not None else torch.zeros(p.numel())
                        for p in layer.parameters()]) for layer in layers]
    for g in grads:  # each layer's gradient lives on its stage's rank
        all_reduce_(g, mesh.group("pipe"))
    if rank == 0:
        np.savez(os.path.join(tmp, "pipeline_apply.port.npz"), out=out.detach().numpy(),
                 **{f"grad{i}": g.numpy() for i, g in enumerate(grads)})
        torch.save([layer.state_dict() for layer in layers],
                   os.path.join(tmp, "pipeline_apply.layers.pt"))


# dropout, router jitter and the split hidden's masks on: a model x expert mesh
# of 2 x 2 against the port's own one-process step on the same generator seed
DROPOUT = ((1, 2, 1, 2), s2t(dict(MOE, activation="glu", ffn_dropout=0.2,
                                  residual_dropout=0.1, moe_router_jitter=0.05),
                             dict(ffn_dropout=0.2, residual_dropout=0.1)), None, None, {})


def dropout_step(mesh=None, tmp=None):
    """One micro-batch of DROPOUT's model (seeded weights) from the
    generator seed 5: (loss, one-card gradients)."""
    dims, cfg, _, _, spec = DROPOUT
    model = compat.load_into(build_model(cfg, device="cpu"),
                             compat.load_npz(os.path.join(tmp, "dropout.params.npz")))
    model.train()
    trainer = Trainer(dict(TCFG), model, None, torch.Generator().manual_seed(5), mesh=mesh)
    loss = trainer.micro_step(make_batch(spec))
    if mesh is None:
        return float(loss), {n: p.grad for n, p in model.named_parameters()}
    trainer.parallel.sync_grads(trainer.optimizer)
    return float(trainer.parallel.report(loss.reshape(1))[0]), trainer.parallel.gather_grads()


def _port_dropout(rank, tmp):
    loss, grads = dropout_step(make_mesh(*DROPOUT[0]), tmp)
    if rank == 0:
        torch.save((loss, grads), os.path.join(tmp, "dropout.port.pt"))


def _world(rank, jobs, tmp):
    torch.set_num_threads(1)
    for job in jobs:
        if job in CASES:
            _port_case(rank, job, tmp)
        elif job in TRAINING:
            _port_training(rank, job, tmp)
        elif job == "dropout":
            _port_dropout(rank, tmp)
        elif job == "noise_mix":
            _port_noise_mix(rank, tmp)
        else:
            _port_pipeline_apply(rank, tmp)


# ------------------------------------------------------ the JAX side
def jax_args(cfg, batch):
    import jax.numpy as jnp

    _, inputs, targets = batch
    if cfg["type"] == "transformer_lm":
        return (jnp.asarray(inputs["inputs"], jnp.int32),
                jnp.asarray(targets["targets"], jnp.int32),
                jnp.asarray(targets["targets_length"], jnp.int32))
    return (jnp.asarray(inputs["inputs"]), jnp.asarray(inputs["mask"]),
            jnp.asarray(targets["targets"], jnp.int32),
            jnp.asarray(targets["targets_length"], jnp.int32))


def jax_mesh_result(name, variables):
    """(loss, aux, grads tree, new batch_stats) of the JAX package's mesh."""
    import jax

    from opentransformer_tpu.models.registry import build_model as jax_build_model
    from opentransformer_tpu.parallel.mesh import (batch_sharding, make_mesh as jax_mesh,
                                                   param_shardings, replicated)
    from opentransformer_tpu.parallel.pipeline import speech2text_1f1b_grad_fn

    (d, m, p, e), cfg, schedule, n_micro, spec = CASES[name]
    model = jax_build_model(cfg)
    mesh = jax_mesh(n_data=d, n_model=m, n_pipe=p, n_expert=e,
                    devices=jax.devices()[: d * m * p * e])
    args = jax_args(cfg, make_batch(spec))
    if schedule == "1f1b":
        core = speech2text_1f1b_grad_fn(model, mesh, n_micro)
        with mesh:
            loss, grads, aux = jax.jit(core)(variables["params"], args, jax.random.PRNGKey(1))
        return float(loss), {k: float(v) for k, v in aux.items()}, grads, {}
    v = jax.device_put(variables, param_shardings(variables, mesh))
    args = jax.device_put(args, batch_sharding(mesh) if len(args[0]) % d == 0 else replicated(mesh))
    cols = [k for k in v if k != "params"]
    kw = {} if cfg["type"] == "transformer_lm" else {"train": True}

    def loss_fn(params, rest, args):
        out = model.apply({"params": params, **rest}, *args, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          **({"mutable": cols} if cols else {}), **kw)
        (loss, aux), new = out if cols else (out, {})
        return loss, (aux, new)

    (loss, (aux, new)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], {k: v[k] for k in cols}, args)
    aux = {k: float(x) for k, x in aux.items()}
    return float(loss), aux, grads, new.get("batch_stats", {})


def jax_mesh_training(name, cfg, params):
    """The JAX Trainer on a data mesh of 2 over the same epoch: its final
    parameters (the resident corpus through its preprocess, as its CLI)."""
    import jax

    from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader
    from opentransformer_tpu.data.resident import make_resident_preprocess
    from opentransformer_tpu.models.registry import build_model as jax_build_model
    from opentransformer_tpu.parallel.mesh import make_mesh as jax_mesh
    from opentransformer_tpu.train.trainer import (Trainer as JaxTrainer, TrainState,
                                                   resident_speech_batch)

    cfg = json.loads(json.dumps(cfg))
    cfg["data"].update(TRAINING[name]["data"])
    tcfg = dict(cfg["train"], **TRAINING[name]["train"])
    mesh = jax_mesh(n_data=2, devices=jax.devices()[:2])
    loader = JaxLoader(cfg, "train", seed=3)
    kw = {}
    if loader.device_resident:
        corpus, lens = loader.build_resident_corpus()
        fn, state = make_resident_preprocess(cfg["data"], corpus, lens, mesh=mesh)
        kw = dict(preprocess_fn=fn, preprocess_state=state, batch_fn=resident_speech_batch)
    jt = JaxTrainer(tcfg, jax_build_model(cfg["model"]), mesh=mesh, log_interval=10 ** 9, **kw)
    p = jax.tree_util.tree_map(jax.numpy.asarray, params)
    state = TrainState(params=p, opt_state=jt.tx.init(p["params"]),
                       nan_skips=jax.numpy.zeros((), jax.numpy.int32))
    state = jt.train(state, EpochList(loader), jax.random.PRNGKey(0))
    return flat(jax.tree_util.tree_map(np.asarray, state.params["params"]))


# the trainer-level cases on a data mesh of 2: SGD, so an update is linear in
# the gradient (Adam's first step is lr·sign(g) where g is at rounding level)
TRAINING = {
    "steps_per_exec_dp": dict(data={}, train={"steps_per_exec": 2}),
    "resident_dp": dict(data={"device_resident": True, "device_resident_dtype": "float32",
                              "additive_noise_std": 0.0}, train={}),
}
TRAIN_MODEL = {"type": "speech2text", "frontend_type": "conv",
               "frontend": dict(FRONT, input_size=16), "encoder_type": "transformer",
               "encoder": dict(ENC, scan_layers=False),
               "decoder": dict(DEC, vocab_size=10)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's (port npz, JAX result), the trainer-level cases' and
    ``pipeline_apply``'s: the two worlds run while JAX computes."""
    import chip_smoke

    tmp = str(tmp_path_factory.mktemp("parallel"))
    params = {}
    for name, (_, cfg, _, _, _) in CASES.items():
        params[name] = chip_smoke.seeded_params(build_model(cfg, device="cpu"), 7)
        compat.save_npz(os.path.join(tmp, f"{name}.params.npz"), params[name], dtype=np.float32)
    chip_smoke.make_ctc_corpus(tmp)
    train_cfg = chip_smoke.ctc_corpus_config(tmp, epochs=1)
    train_cfg["model"] = TRAIN_MODEL
    train_cfg["train"].update(optimizer_type="sgd", optimizer={"lr": 0.1}, clip_grad=5)
    with open(os.path.join(tmp, "train_conf.json"), "w") as f:
        json.dump(train_cfg, f)
    train_params = chip_smoke.seeded_params(build_model(TRAIN_MODEL, device="cpu"), 8)
    compat.save_npz(os.path.join(tmp, "train.params.npz"), train_params, dtype=np.float32)
    compat.save_npz(os.path.join(tmp, "dropout.params.npz"),
                    chip_smoke.seeded_params(build_model(DROPOUT[1], device="cpu"), 9),
                    dtype=np.float32)
    worlds = {w: [n for n in CASES if world_of(n) == w] for w in (2, 4)}
    worlds[2] += list(TRAINING) + ["pipeline_apply", "noise_mix"]
    worlds[4] += ["dropout"]
    contexts = [launch.spawn(_world, w, args=(jobs, tmp), join=False)
                for w, jobs in worlds.items()]
    jax_out = {name: jax_mesh_result(name, params[name]) for name in CASES}
    jax_out.update({name: jax_mesh_training(name, train_cfg, train_params)
                    for name in TRAINING})
    for ctx in contexts:
        launch.join_all(ctx)
    port = {n: dict(np.load(os.path.join(tmp, f"{n}.port.npz")))
            for n in list(CASES) + list(TRAINING) + ["pipeline_apply"]}
    port["pipeline_apply.layers"] = torch.load(os.path.join(tmp, "pipeline_apply.layers.pt"))
    port["dropout"] = torch.load(os.path.join(tmp, "dropout.port.pt"))
    port["dropout.one"] = dropout_step(tmp=tmp)
    port["pp_sharded.rest"] = [dict(np.load(os.path.join(tmp, f"pp_sharded.rest{r}.npz")))
                               for r in range(2)]
    port["noise_mix"] = [dict(np.load(os.path.join(tmp, f"noise_mix.rank{r}.npz")))
                         for r in range(2)]
    port["noise_mix.one"] = {n: p.detach().numpy()
                             for n, p in noise_mix_training(tmp).model.named_parameters()}
    return port, jax_out


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_equal_the_jax_mesh(results, name):
    port, jax_out = results
    got, (loss, aux, grads, stats) = port[name], jax_out[name]
    assert float(got["loss"]) == pytest.approx(loss, rel=1e-5)
    for k, v in aux.items():
        assert float(got[f"aux/{k}"]) == pytest.approx(v, rel=1e-5), k
    want = flat(grads)
    have = {k[len("tree/params/"):]: v for k, v in got.items() if k.startswith("tree/params/")}
    assert sorted(have) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(have[k], w, rtol=5e-3, atol=1e-5, err_msg=k)
    for k, w in flat(stats).items():  # BatchNorm's running averages moved by the global batch
        np.testing.assert_allclose(got[f"tree/batch_stats/{k}"], w, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(TRAINING))
def test_training_on_a_data_mesh_equals_the_jax_mesh_trainer(results, name):
    """An epoch of SGD updates (five batches of 8; ``steps_per_exec`` 2
    runs as single updates, the JAX trainer scans them) ends at the JAX
    mesh trainer's parameters."""
    port, jax_out = results
    got = {k[len("tree/params/"):]: v for k, v in port[name].items()
           if k.startswith("tree/params/")}
    want = jax_out[name]
    assert list(port[name]["steps"]) == [1, 2, 3, 4, 5]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5, err_msg=k)


def test_sharded_pipe_ranks_hold_only_their_blocks(results):
    """Under the ``sharded`` schedule a pipe rank keeps, after the step and
    the one-card gathers, the storage and the gradients of the blocks it
    owns alone; the other blocks' weights hold no storage, take no gradient
    and require none (their owner computes it)."""
    rest = results[0]["pp_sharded.rest"]
    assert sorted(rest[0]) == sorted(rest[1])
    for name in rest[0]:
        (bytes0, grad0, req0, local0), (bytes1, grad1, req1, local1) = rest[0][name], rest[1][name]
        assert local0 != local1, name  # one owner
        for nbytes, grad, req, local in (rest[0][name], rest[1][name]):
            assert bool(grad) == bool(req) == bool(local), name
            assert (nbytes > 0) == bool(local), name
    assert any(k.startswith("encoder.") for k in rest[0])
    assert any(k.startswith("decoder.") for k in rest[0])  # a scan_layers decoder too


def test_noise_and_mixspeech_on_a_data_mesh_are_one_device(results):
    """Gradient noise and MixSpeech's λ are the step's draws, alike on every
    rank: after an epoch of SGD on a data mesh of 2 both ranks hold the same
    parameters, and they are the one-process run's on the same seed."""
    (r0, r1), one = results[0]["noise_mix"], results[0]["noise_mix.one"]
    assert sorted(r0) == sorted(one)
    for name, want in one.items():
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
        np.testing.assert_allclose(r0[name], want, rtol=0, atol=1e-5, err_msg=name)


def test_pipeline_apply_equals_the_sequential_stack(results):
    """The GPipe building block (``tests/test_pipeline.py:30-64``): outputs
    and every layer's gradient equal the four layers run in sequence."""
    from opentransformer_tpu_torch.models.encoder import TransformerEncoderLayer

    port = results[0]
    torch.manual_seed(0)
    layers = [TransformerEncoderLayer(16, 2, 32, residual_dropout=0.0) for _ in range(4)]
    for layer, sd in zip(layers, port["pipeline_apply.layers"]):
        layer.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2, 6, 16)).astype(np.float32))
    mask = torch.ones(2, 1, 1, 6, dtype=torch.bool)
    outs = []
    for xb in x:
        for layer in layers:
            xb = layer(xb, mask)
        outs.append(xb)
    seq = torch.stack(outs)
    (seq ** 2).sum().backward()
    np.testing.assert_allclose(port["pipeline_apply"]["out"], seq.detach().numpy(),
                               rtol=2e-4, atol=2e-5)
    for i, layer in enumerate(layers):
        g = torch.cat([p.grad.reshape(-1) for p in layer.parameters()]).numpy()
        np.testing.assert_allclose(port["pipeline_apply"][f"grad{i}"], g, rtol=5e-3, atol=1e-4)


def test_tensor_and_expert_mesh_with_dropout_is_one_process(results):
    """Dropout in the attention, the residuals and the split FFN and expert
    hiddens, and router jitter: the tensor x expert ranks draw what one
    process draws (a split hidden's mask drawn whole), so the step's loss and
    gradients are the one-process step's."""
    (loss, grads), (want, ref) = results[0]["dropout"], results[0]["dropout.one"]
    assert loss == pytest.approx(want, rel=1e-5)
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=5e-3, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dims", [(1, 2, 1, 1), (2, 2, 2, 1), (1, 2, 1, 2)],
                         ids=lambda d: "x".join(map(str, d)))
def test_param_shardings_equal_jax(dims):
    """The port's rules over the flax paths give JAX's specs, replication of
    a non-dividing dimension (the 4233-row embedding) included."""
    import jax

    from opentransformer_tpu.parallel.mesh import make_mesh as jax_mesh
    from opentransformer_tpu.parallel.mesh import param_shardings as jax_shardings
    from opentransformer_tpu_torch.parallel.mesh import param_shardings

    d, m, p, e = dims
    cfg = s2t(dict(MOE) if e > 1 else None, dict(vocab_size=4233), ctc_weight=0.3)
    tree = compat.params_to_jax(build_model(cfg, device="cpu"))
    mesh = jax_mesh(n_data=d, n_model=m, n_pipe=p, n_expert=e,
                    devices=jax.devices()[: d * m * p * e])
    want = jax.tree_util.tree_map(lambda s: tuple(s.spec), jax_shardings(tree, mesh))
    got = param_shardings(tree, dict(mesh.shape))
    for path, spec in flat(want, leaf=tuple).items():
        assert tuple(got[path]) + (None,) * (len(spec) - len(got[path])) == \
            tuple(spec) + (None,) * (len(got[path]) - len(spec)), path
    assert got["params/decoder/embedding/embedding"] == (None, None)


# ------------------------------------------------------ CLI worlds
def cli_corpus(root, model_cfg, **train):
    """The tiny kaldi corpus and its config with ``model_cfg``; Adam's eps
    at 1e-3 keeps an update continuous in the gradient."""
    import chip_smoke

    chip_smoke.make_ctc_corpus(root)
    cfg = chip_smoke.ctc_corpus_config(root, epochs=1)
    cfg["model"] = model_cfg
    cfg["train"]["optimizer"] = {"lr": 3e-3, "eps": 1e-3}
    cfg["train"].update(train)
    conf = os.path.join(root, "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    return conf


def test_tp2_pp2_checkpoint_decodes_on_one_rank(tmp_path):
    """A ``--tp 2 --pp 2`` run (4 ranks, the sharded schedule) writes the
    one-card checkpoint: the same keys and shapes as an unsharded run's, its
    weights and Adam moments within float32 reduction order of them, and it
    decodes on one rank (``cli/eval.py -m``) to the unsharded model's n-best
    lists; ``-ct`` resumes it on the 4 ranks for a second epoch."""
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.train.checkpoint import Checkpointer

    conf = cli_corpus(str(tmp_path), dict(TRAIN_MODEL, encoder=dict(ENC)))
    exps = {k: str(tmp_path / k) for k in ("one", "tp2pp2")}
    base = ["-c", conf, "--device", "cpu", "--log_interval", "100"]
    assert run_cli.run(base + ["--expdir", exps["one"]]).global_step == 6
    assert run_cli.run(base + ["--expdir", exps["tp2pp2"], "--tp", "2", "--pp", "2"]) is None
    ck = {k: os.path.join(v, "model.epoch.0") for k, v in exps.items()}
    one, par = (compat.load_npz(os.path.join(c, "params.npz")) for c in ck.values())
    assert sorted(flat(one)) == sorted(flat(par))
    for k, w in flat(one).items():
        np.testing.assert_allclose(flat(par)[k], w, rtol=0, atol=2e-5, err_msg=k)
    opt = [Checkpointer(v).load_optimizer(c, "cpu") for v, c in zip(exps.values(), ck.values())]
    assert sorted(opt[0]["state"]) == sorted(opt[1]["state"])
    for i, st in opt[0]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(opt[1]["state"][i][key].numpy(), st[key].numpy(),
                                       rtol=1e-3, atol=1e-7, err_msg=f"{i}/{key}")
    logs = []
    for name, c in ck.items():
        assert eval_cli.main(["-m", c, "-bw", "3", "-ml", "8", "-d", "test", "--device", "cpu",
                              "-s", name]) == 0
        out = next(os.path.join(exps[name], d) for d in os.listdir(exps[name])
                   if d.startswith("decode_test"))
        with open(os.path.join(out, "predict.log")) as f:
            logs.append([line.split(" ", 3)[::3] for line in f])  # utt, hypothesis
    assert logs[0] == logs[1] and len(logs[0]) == 40 * 3
    with open(conf) as f:
        cfg = json.load(f)
    cfg["train"]["epochs"] = 2
    with open(conf, "w") as f:
        json.dump(cfg, f)
    assert run_cli.run(base + ["--expdir", exps["tp2pp2"], "--tp", "2", "--pp", "2", "-ct",
                               "--record", str(tmp_path / "rec.jsonl")]) is None
    with open(tmp_path / "rec.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["resumed_from"] == 0 and rec["first_step"] == 6 and rec["next_step"] == 11


@pytest.mark.parametrize("schedule", ["sharded", "1f1b"])
def test_pipe_dev_loss_and_probe_are_one_cards(tmp_path, schedule):
    """``--pp 2`` with a dev split and the greedy-CER probe: each stage
    fetches the blocks it does not own for the dev loss, and rank 0 probes a
    one-card model made from the gathered state; the dev loss, the probe's
    record and the losses are the single-process run's."""
    from opentransformer_tpu_torch.cli import run as run_cli

    conf = cli_corpus(str(tmp_path), dict(TRAIN_MODEL, encoder=dict(ENC)), dev_cer_probe=True)
    with open(conf) as f:
        cfg = json.load(f)
    cfg["data"]["dev"] = cfg["data"]["test"]
    with open(conf, "w") as f:
        json.dump(cfg, f)
    base = ["-c", conf, "--device", "cpu", "--log_interval", "100"]
    single = run_cli.run(base + ["--expdir", str(tmp_path / "one")])
    rec = str(tmp_path / "rec.jsonl")
    log_file = str(tmp_path / "pp.log")
    assert run_cli.run(base + ["--expdir", str(tmp_path / "pp"), "--pp", "2", "--pp-schedule",
                               schedule, "--record", rec, "--log_file", log_file]) is None
    with open(rec) as f:
        got = json.loads(f.readline())
    np.testing.assert_allclose(got["losses"], [x for r in single.history for x in r["losses"]],
                               rtol=1e-5)
    with open(log_file) as f:
        log = f.read()
    dev = single.dev_losses[0]
    probe = single.dev_probe_fn.records[0]
    assert f"epoch 0 dev loss {dev:.5f}" in log
    assert (f"epoch 0 dev greedy CER {probe['cer'] * 100:.2f}% ({probe['errors']}/"
            f"{probe['tokens']} tokens, {probe['utts']} utts)") in log


def test_multihost_joins_the_torchrun_world(tmp_path):
    """``--multihost``: two processes given torchrun's environment form one
    data mesh of 2, whose losses are the single-process run's."""
    from opentransformer_tpu_torch.cli import run as run_cli

    conf = cli_corpus(str(tmp_path), TRAIN_MODEL)
    single = run_cli.run(["-c", conf, "--device", "cpu", "--expdir", str(tmp_path / "one"),
                          "--log_interval", "100"])
    want = [x for r in single.history for x in r["losses"]]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(launch.free_port()),
               WORLD_SIZE="2", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    rec = str(tmp_path / "rec.jsonl")
    procs = [subprocess.Popen([sys.executable, "-m", "opentransformer_tpu_torch.cli.run", "-c",
                               conf, "--device", "cpu", "--expdir", str(tmp_path / "mh"),
                               "--multihost", "--record", rec, "--log_interval", "100"],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO)
             for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    with open(rec) as f:
        lines = f.readlines()
    assert len(lines) == 1  # rank 0 alone writes
    np.testing.assert_allclose(json.loads(lines[0])["losses"], want, rtol=1e-5)
