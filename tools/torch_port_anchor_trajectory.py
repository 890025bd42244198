"""The anchor recipe's first updates in both packages, from the same weights
on the same batches: where do the two training trajectories part?

    python tools/torch_port_anchor_trajectory.py [--updates 624] [--data DIR]
        [--out egs/synth_bench/anchor_trajectory.json]

Trains ``opentransformer_tpu_torch/conf/anchor.json`` on the CPU with the
JAX package's Trainer (its grad and update functions, jitted) and with the
port's, update by update, from the JAX package's initial weights
(``PRNGKey(1234)``, as ``tools/jax_anchor_init.py`` makes them) on the
batches of the JAX package's loader (its bucketing sampler and batch order,
seed 1234), the first 2 epochs (624 updates) of the full synthetic corpus by
default. So that both runs are deterministic, the additive noise,
SpecAugment and dropout are off, the features stream from the host (not the
device-resident corpus), and both run in float32 (bfloat16 rounds
differently in XLA and under autocast from the first update) with one
update an execution (``steps_per_exec`` runs the same arithmetic). Writes
both per-update loss curves, their relative differences and the first
update where they part by more than 1e-3 relative. It imports JAX, so it
runs where JAX is (not on the card's machine); ``--data`` defaults to a
temporary directory holding the corpus written by
``opentransformer_tpu_torch.data.synth``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from opentransformer_tpu.data.loader import FeatureLoader as JaxLoader  # noqa: E402
from opentransformer_tpu.models.registry import build_model as jax_build_model  # noqa: E402
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from opentransformer_tpu.train.trainer import TrainState, default_speech_batch  # noqa: E402
from opentransformer_tpu_torch import compat  # noqa: E402
from opentransformer_tpu_torch.config import CONF_DIR, load_config  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

PART_RTOL = 1e-3
OUT = os.path.join(REPO, "egs", "synth_bench", "anchor_trajectory.json")


def deterministic(cfg: dict, data: str) -> dict:
    """``cfg`` with its data under ``data`` and every random draw off:
    no noise, SpecAugment or dropout, host features, float32, one update
    an execution."""
    cfg = json.loads(json.dumps(cfg))
    d = cfg["data"]
    d.update(vocab=os.path.join(data, "vocab"), additive_noise_std=0.0, spec_augment=False,
             device_resident=False, num_workers=0)
    for split in ("train", "dev", "test"):
        d.pop(split, None)
    d["train"] = {"feat": [os.path.join(data, "train", "feats.scp")],
                  "text": [os.path.join(data, "train", "text")]}
    for section in ("frontend", "encoder", "decoder"):
        for key in list(cfg["model"].get(section, {})):
            if "dropout" in key:
                cfg["model"][section][key] = 0.0
    cfg["train"].update(dtype="float32", steps_per_exec=1)
    return cfg


def jax_init(model_cfg: dict, seed: int) -> dict:
    """The JAX package's initial weights (``model.init(PRNGKey(seed))`` on a
    two-utterance batch, as ``tools/jax_anchor_init.py``), numpy."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from jax_anchor_init import small_batch

    args = small_batch(int(model_cfg["frontend"]["input_size"]),
                       int(model_cfg["decoder"]["vocab_size"]))
    variables = jax.jit(jax_build_model(model_cfg).init)(jax.random.PRNGKey(seed),
                                                         *map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.array, variables)


def trajectories(cfg: dict, updates: int, seed: int = 1234, log_every: int = 0):
    """(JAX losses, port losses, seconds) of the first ``updates`` updates of
    ``cfg`` (already made deterministic) from JAX's ``PRNGKey(seed)``
    weights on the JAX loader's batches (epochs in turn, reshuffled)."""
    torch.manual_seed(seed)
    variables = jax_init(cfg["model"], seed)
    jm = jax_build_model(cfg["model"])
    jt = JaxTrainer(cfg["train"], jm, batch_fn=default_speech_batch, log_interval=10 ** 9)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    state = TrainState(params=jparams, opt_state=jt.tx.init(jparams["params"]),
                       nan_skips=jnp.zeros((), jnp.int32))
    grad_fn, update_fn = jt._build_grad_fn(), jt._build_update_fn()
    jvars, opt, skips = state.params, state.opt_state, state.nan_skips

    model = compat.load_into(build_model(cfg["model"], device="cpu"), variables).train()
    trainer = Trainer(cfg["train"], model, None, torch.Generator().manual_seed(seed),
                      log_interval=10 ** 9)
    loader = JaxLoader(cfg, "train", seed=seed)
    losses_j, losses_t = [], []
    t0 = time.time()
    epoch, step = 0, 1
    while len(losses_j) < updates:
        loader.set_epoch(epoch)
        for batch in loader:
            if len(losses_j) == updates:
                break
            gacc = jt._zeros_like_grads(jvars)
            jvars, gacc, loss, _ = grad_fn(jvars, gacc, default_speech_batch(batch),
                                           jax.random.PRNGKey(step), None)
            jvars, opt, skips, _ = update_fn(jvars, opt, gacc, skips, jt.schedule(step, epoch),
                                             jax.random.PRNGKey(step))
            losses_j.append(float(loss))
            trainer.global_epoch = epoch
            trainer.micro_step(batch)
            losses_t.append(trainer.update(epoch)["losses"][0])
            if log_every and len(losses_j) % log_every == 0:
                print(f"update {len(losses_j)}: JAX {losses_j[-1]:.6f} port {losses_t[-1]:.6f} "
                      f"({time.time() - t0:.0f} s)", flush=True)
            step += 1
        epoch += 1
    if int(skips) or trainer.nan_skips:
        raise RuntimeError(f"NaN skips: JAX {int(skips)}, port {trainer.nan_skips}")
    return losses_j, losses_t, time.time() - t0


def relative(losses_j, losses_t) -> list:
    return [abs(t - j) / abs(j) for j, t in zip(losses_j, losses_t)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--updates", type=int, default=624, help="2 epochs of the synthetic corpus")
    p.add_argument("--data", default=None, help="synthetic corpus (written if missing)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--out", default=OUT)
    p.add_argument("--log_every", type=int, default=24)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="anchor_trajectory_") as tmp:
        data = args.data or os.path.join(tmp, "synth")
        if not os.path.exists(os.path.join(data, "train", "feats.scp")):
            from opentransformer_tpu_torch.data import synth

            synth.write_corpus(data, splits=("train",))
        cfg = deterministic(load_config(os.path.join(CONF_DIR, "anchor.json")), data)
        losses_j, losses_t, seconds = trajectories(cfg, args.updates, args.seed, args.log_every)
    rel = relative(losses_j, losses_t)
    parted = next((i + 1 for i, r in enumerate(rel) if r > PART_RTOL), None)
    summary = {
        "what": "conf/anchor.json, both packages on the CPU, float32, noise, SpecAugment "
                "and dropout off, host features, JAX's PRNGKey(seed) weights and batch order",
        "script": "tools/torch_port_anchor_trajectory.py", "seed": args.seed,
        "updates": args.updates, "seconds": seconds, "part_rtol": PART_RTOL,
        "first_update_parted": parted, "max_rel_first_100": max(rel[:100]),
        "max_rel": max(rel), "jax": losses_j, "port": losses_t, "rel": rel}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(summary, f)
        f.write("\n")
    print(f"{args.updates} updates in {seconds:.0f} s; first update past {PART_RTOL} relative: "
          f"{parted}; max relative difference {max(rel):.3e}; wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
