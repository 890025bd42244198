"""Per-host loading under ``--multihost`` against the JAX package.

``FeatureLoader(num_shards=n, shard_id=i)`` of the port against JAX's on a
kaldi and an online toy corpus (the same utterance ids, arrays, shapes and
padding for every shard, the empty-slice tail rule, the device-resident
corpus off with JAX's warning), and a 2-rank ``--multihost`` Gloo world
(torchrun's environment) whose data ranks read their shards: each step's
loss is held to 1e-5 relative, and each gradient to 1e-5 of its tensor's
largest element, of JAX's one-device step on the host-major global batch
(the shards' rows in shard order, as JAX's multihost trainer assembles
it), made here from JAX's loader. A batch the shards split unevenly (9
rows over 2) takes the gathered path, an even one (4 rows) the local one.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.data.loader import FeatureLoader
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.parallel import launch
from opentransformer_tpu_torch.parallel.mesh import make_mesh
from opentransformer_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_parallel import flat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
STEP_BATCH = 9  # 40 utterances: four batches of 9 (5 + 4 rows a shard) and one of 4
MODEL = {"type": "speech2text", "frontend_type": "conv",
         "frontend": {"input_size": 16, "output_size": 32, "mid_channel": 4, "out_channel": 8,
                      "dropout": 0.0},
         "encoder_type": "transformer",
         "encoder": {"d_model": 32, "n_heads": 2, "d_ff": 48, "n_blocks": 2,
                     "residual_dropout": 0.0},
         "decoder": {"vocab_size": 9, "d_model": 32, "n_heads": 2, "d_ff": 48, "memory_dim": 32,
                     "n_blocks": 1, "residual_dropout": 0.0}}


def kaldi_cfg(root: str, batch: int) -> dict:
    import chip_smoke

    os.makedirs(root, exist_ok=True)
    chip_smoke.make_ctc_corpus(root)
    cfg = chip_smoke.ctc_corpus_config(root, epochs=1)
    cfg["data"]["batch_size"] = batch
    return cfg


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The kaldi corpus in batches of 13 (13, 13, 13, 1: a tail smaller
    than any shard count) and the online one of waveforms in batches of 3."""
    from tests.test_torch_port_train import write_corpus

    root = tmp_path_factory.mktemp("shards")
    online = write_corpus(str(root / "online"), n_train=8)
    online["data"].update(batch_size=3, spec_augment=False, num_workers=0)
    return {"kaldi": kaldi_cfg(str(root / "kaldi"), 13), "online": online}


def batches(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["kaldi", "online"])
def test_shards_equal_jax(corpora, kind, n):
    from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader

    cfg = corpora[kind]
    whole = FeatureLoader(cfg, "train", seed=SEED)
    for epoch in (0, 1):
        full = [b[0] for b in batches(whole, epoch)]
        shards = []
        for i in range(n):
            ours = batches(FeatureLoader(cfg, "train", seed=SEED, num_shards=n, shard_id=i),
                           epoch)
            theirs = batches(JaxLoader(cfg, "train", seed=SEED, num_shards=n, shard_id=i),
                             epoch)
            assert len(ours) == len(theirs) == len(full)
            for (u1, i1, t1), (u2, i2, t2) in zip(ours, theirs):
                assert u1 == u2
                for a, b in ((i1, i2), (t1, t2)):
                    assert sorted(a) == sorted(b)
                    for k in a:
                        assert a[k].shape == b[k].shape, k
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            shards.append([b[0] for b in ours])
        for j, ids in enumerate(full):
            got = [shards[i][j] for i in range(n)]
            if len(ids) < n:  # the tail rule: a shard without rows reads row 0
                assert got == [ids[i:i + 1] or ids[:1] for i in range(n)]
            else:
                assert got == [ids[i::n] for i in range(n)]
    if kind == "kaldi":  # the corpus' 1-row tail batch is in every epoch
        assert min(len(ids) for ids in full) == 1


def test_resident_is_off_with_jax_warning(corpora, caplog):
    from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader

    cfg = json.loads(json.dumps(corpora["kaldi"]))
    cfg["data"]["device_resident"] = True
    assert FeatureLoader(cfg, "train").device_resident
    assert JaxLoader(cfg, "train").device_resident
    messages = []
    for cls in (FeatureLoader, JaxLoader):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            loader = cls(cfg, "train", num_shards=2, shard_id=1)
        assert not loader.device_resident
        messages.append([r.getMessage() for r in caplog.records if "device_resident" in
                         r.getMessage()])
    assert messages[0] == messages[1] and len(messages[0]) == 1


# ------------------------------------------------------ the 2-rank world
def rank_main(tmp: str) -> None:
    """One rank of the torchrun world: its data shard of each batch of
    epoch 0, one step each at the initial weights (gradients cleared in
    between); rank 0 writes each step's loss and one-card gradients."""
    launch.init_from_env("gloo")
    try:
        with open(os.path.join(tmp, "conf.json")) as f:
            cfg = json.load(f)
        mesh = make_mesh(2, 1, 1, 1)
        loader = FeatureLoader(cfg, "train", seed=SEED, num_shards=mesh.size("data"),
                               shard_id=mesh.index("data"))
        model = compat.load_into(build_model(cfg["model"], device="cpu"),
                                 compat.load_npz(os.path.join(tmp, "params.npz"))).train()
        trainer = Trainer(cfg["train"], model, None, torch.Generator().manual_seed(0),
                          log_interval=10 ** 9, mesh=mesh, data_shards=True)
        out = {}
        for j, batch in enumerate(batches(loader, 0)):
            trainer.optimizer.zero_grad(set_to_none=True)
            loss = trainer.micro_step(batch)
            trainer.parallel.sync_grads(trainer.optimizer)
            loss = trainer.parallel.report(loss.reshape(1).float().clone())
            grads = trainer.parallel.gather_grads()
            trainer._window, trainer._window_aux = [], []
            out[f"{j}/loss"] = loss.numpy()
            out[f"{j}/rows"] = np.asarray(len(batch[0]))
            tree = compat.params_to_jax(build_model(cfg["model"], device="cpu"), grads)
            out.update({f"{j}/{k}": v for k, v in flat(tree["params"]).items()})
        if mesh.rank == 0:
            np.savez(os.path.join(tmp, "port.npz"), **out)
    finally:
        launch.shutdown()


def jax_steps(cfg: dict, params: dict) -> list:
    """(loss, flat gradients) of JAX's one-device step on each host-major
    global batch of epoch 0: shard i's rows (JAX's rule) in shard order,
    read and collated as one batch by JAX's loader."""
    import jax
    import jax.numpy as jnp

    from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader
    from opentransformer_tpu.data.loader import collate_speech
    from opentransformer_tpu.models.registry import build_model as jax_build_model

    loader = JaxLoader(cfg, "train", seed=SEED)
    loader.set_epoch(0)
    model = jax_build_model(cfg["model"])

    @jax.jit
    def step(p, feats, mask, tgt, tlen):
        def loss_fn(p):
            loss, _ = model.apply({"params": p}, feats, mask, tgt, tlen, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)}, train=True)
            return loss
        return jax.value_and_grad(loss_fn)(p)

    out = []
    for boundary, idxs in loader.sampler:
        order = [k for i in range(2) for k in (idxs[i::2] or [idxs[0]])]
        _, inputs, targets = collate_speech([loader.dataset[k] for k in order],
                                            pad_to_frames=boundary,
                                            target_pad_multiple=loader.target_pad_multiple)
        loss, grads = step(params["params"], jnp.asarray(inputs["inputs"]),
                           jnp.asarray(inputs["mask"]), jnp.asarray(targets["targets"], jnp.int32),
                           jnp.asarray(targets["targets_length"], jnp.int32))
        out.append((float(loss), flat(jax.tree_util.tree_map(np.asarray, grads)), len(order)))
    return out


def test_multihost_shards_step_equals_jax_global_batch(tmp_path):
    """Two processes in torchrun's environment, each reading its data shard:
    every step equals JAX's one-device step on the host-major global batch."""
    import chip_smoke

    tmp = str(tmp_path)
    cfg = kaldi_cfg(os.path.join(tmp, "corpus"), STEP_BATCH)
    cfg["model"] = MODEL
    with open(os.path.join(tmp, "conf.json"), "w") as f:
        json.dump(cfg, f)
    params = chip_smoke.seeded_params(build_model(MODEL, device="cpu"), 3)
    compat.save_npz(os.path.join(tmp, "params.npz"), params, dtype=np.float32)
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(launch.free_port()),
               WORLD_SIZE="2", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("from tests.test_torch_port_loader_shards import rank_main; "
            f"rank_main({tmp!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    try:
        want = jax_steps(cfg, params)
    finally:
        rcs = [p.wait(timeout=300) for p in procs]
    assert rcs == [0, 0]
    got = dict(np.load(os.path.join(tmp, "port.npz")))
    assert sorted(w[2] for w in want) == [4, 9, 9, 9, 9]
    assert [int(got[f"{j}/rows"]) for j in range(len(want))] == [-(-w[2] // 2) for w in want]
    for j, (loss, grads, _) in enumerate(want):
        assert float(got[f"{j}/loss"][0]) == pytest.approx(loss, rel=1e-5), j
        have = {k[len(f"{j}/"):]: v for k, v in got.items()
                if k.startswith(f"{j}/") and k not in (f"{j}/loss", f"{j}/rows")}
        assert sorted(have) == sorted(grads)
        for k, w in grads.items():
            np.testing.assert_allclose(have[k], w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=f"{j} {k}")
