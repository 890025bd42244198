"""The JAX package's initial anchor weights as an npz the port loads, so
that the port's recipe can train from the very weights the JAX recipe
starts from.

    python tools/jax_anchor_init.py OUT.npz [--seed 1234]

The JAX training CLI initializes the model with ``model.init(PRNGKey(seed),
...)`` (``opentransformer_tpu/cli/run.py``, default seed 1234); this does
the same for ``egs/synth_bench/conf/anchor.yaml``'s model on the CPU, on a
two-utterance batch (the parameters' values do not depend on the batch),
and writes them in float32 with ``compat.save_npz``. It then loads them
into the port's model (strictly: every parameter present) and prints the
parameter count and the two packages' loss on that batch in float32 with
dropout off, which must agree. Pass the npz to
``tools/torch_anchor_recipe.py --init_model`` (or the training CLI's
``-im``). It runs where JAX is; the npz is not kept in git.
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from opentransformer_tpu.models.registry import build_model as jax_build_model  # noqa: E402
from opentransformer_tpu_torch import compat  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402

ANCHOR_YAML = os.path.join(REPO, "egs", "synth_bench", "conf", "anchor.yaml")


def small_batch(n_feat: int, vocab: int):
    """Two utterances of 96 and 64 frames with 5 and 3 labels (BOS … EOS)."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 96, n_feat)).astype(np.float32)
    mask = np.arange(96)[None] < np.array([96, 64])[:, None]
    targets = np.zeros((2, 7), np.int32)
    targets[0, :7] = [1, *rng.integers(3, vocab, 5), 2]
    targets[1, :5] = [1, *rng.integers(3, vocab, 3), 2]
    return feats, mask, targets, np.array([6, 4], np.int32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", help="the npz to write")
    p.add_argument("--seed", type=int, default=1234, help="the JAX training CLI's -s")
    args = p.parse_args(argv)
    with open(ANCHOR_YAML, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    model_cfg = cfg["model"]
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[
        str(cfg["train"].get("dtype", "float32"))]
    n_feat = int(model_cfg["frontend"]["input_size"])
    feats, mask, targets, lengths = small_batch(n_feat, int(model_cfg["decoder"]["vocab_size"]))
    variables = jax.jit(jax_build_model(model_cfg, dtype=dtype).init)(
        jax.random.PRNGKey(args.seed), jnp.asarray(feats), jnp.asarray(mask),
        jnp.asarray(targets), jnp.asarray(lengths))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    compat.save_npz(args.out, variables, dtype=np.float32)

    model = compat.load_into(build_model(model_cfg, device="cpu"), compat.load_npz(args.out))
    model.eval()
    loss_j, _ = jax_build_model(model_cfg).apply(
        variables, jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(targets),
        jnp.asarray(lengths), deterministic=True)
    with torch.no_grad():
        loss_t, _ = model(torch.from_numpy(feats), torch.from_numpy(mask),
                          torch.from_numpy(targets).long(), torch.from_numpy(lengths).long())
    n = sum(x.numel() for x in model.parameters())
    print(f"wrote {args.out}: {n} parameters (seed {args.seed}); loss on a small batch "
          f"JAX {float(loss_j):.6f}, port {float(loss_t):.6f}")
    if abs(float(loss_t) - float(loss_j)) > 1e-4 * abs(float(loss_j)):
        raise SystemExit("the port's loss differs from JAX's: the npz does not carry over")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
