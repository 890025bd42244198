"""The committed conformer configs at full width with seeded weights, in both
the JAX package and the PyTorch port, on the CPU, in float32.

    python tools/torch_port_conformer_parity.py
    python tools/torch_port_conformer_parity.py \
        --write egs/synth_bench/trained/conformer_seeded.jax.json

For ``conformer_baseline`` and ``conformer_streaming`` (chunked attention,
causal conv; encoded offline) from ``opentransformer_tpu_torch/conf``: the
weights come from ``chip_smoke.seeded_params`` (numpy, one seed, the JAX
layout; the two configs have the same shapes and get the same weights),
the inputs from ``chip_smoke.conformer_inputs`` (16 utterances of 300-500
frames x 80 mel, targets of 8-24 units). Both packages compute the
encoder memory projected on a seeded unit vector, the teacher-forced
log-probs of the targets and the beam-5 1-best ids over 24 forced steps
(EOS disabled). Prints the largest differences and the number of
utterances whose ids differ, and fails above ``chip_smoke``'s limits.
``--write PATH`` then writes the JAX package's numbers, the seeds, the
configs and checksums of the weights and inputs (no weights) as a JSON
fixture: ``chip_smoke.py`` phase 9a holds the card
to it, on a machine without JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from opentransformer_tpu.models.registry import build_model as jax_build_model  # noqa: E402
from opentransformer_tpu.recognize.base import make_memory_search  # noqa: E402
from opentransformer_tpu_torch import compat  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402


def jax_outputs(cfg: dict, params: dict, feats, mask, targets, steps: int, beam: int,
                probe_seed: int) -> dict:
    """The JAX package's memory projection, teacher-forced log-probs and
    1-best ids (as ``chip_smoke.conformer_outputs``)."""
    jm = jax_build_model(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, params)
    memory, memory_mask = jm.apply(variables, jnp.asarray(feats), jnp.asarray(mask),
                                   method="encode")
    proj = memory @ chip_smoke.memory_probe(memory.shape[-1], probe_seed)
    tg = jnp.asarray(targets, jnp.int32)
    logits = jm.apply(variables, tg[:, :-1], memory, memory_mask, method="decode_full")
    logp = jnp.take_along_axis(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1),
                               tg[:, 1:, None], axis=-1)[..., 0]
    hyp = make_memory_search(jm, beam, steps, eos_id=-1)(variables, memory, memory_mask)
    return {"memory": np.asarray(proj), "memory_mask": np.asarray(memory_mask),
            "logp": np.asarray(logp), "ids": np.asarray(hyp.tokens)[:, 0, 1:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write", default=None, help="write the JAX package's numbers here")
    args = p.parse_args(argv)

    c = dict(chip_smoke.CONFORMER_INPUTS)
    feats, mask, targets = chip_smoke.conformer_inputs(
        c["inputs_seed"], c["utts"], c["frames"], c["min_frames"], c["min_units"],
        c["max_units"], c["mel"])
    ulen = (targets[:, 1:] != 0).sum(axis=1)  # units + EOS scored per utterance
    fixture = {"what": "the encoder memory projected on a seeded unit vector (each "
                       "utterance's frames), teacher-forced log-probs of seeded targets (its "
                       "units + EOS) and beam-5 1-best ids over 24 forced steps (EOS "
                       "disabled) of the JAX package on the CPU in float32, the committed "
                       "conformer configs with seeded weights",
               "tool": "tools/torch_port_conformer_parity.py --write",
               "inputs": c, "configs": {}, "checksums": {}, "results": {}}
    fixture["checksums"]["feats"] = chip_smoke.checksum([feats])
    fixture["checksums"]["targets"] = chip_smoke.checksum([targets])
    worst = {}
    for name in chip_smoke.CONFORMERS:
        cfg = chip_smoke.conformer_model_cfg(name)
        model = build_model(cfg, device="cpu")
        params = chip_smoke.seeded_params(model, c["weights_seed"])
        compat.load_into(model, params)
        fixture["configs"][name] = cfg
        fixture["checksums"]["weights"] = chip_smoke.checksum(params)
        inputs = (feats, mask, targets, c["steps"], c["beam"], c["probe_seed"])
        jout = jax_outputs(cfg, params, *inputs)
        tout = chip_smoke.conformer_outputs(model, *inputs)
        frames = jout["memory_mask"].sum(axis=1)
        want = {"memory": [[round(float(x), 6) for x in row[:n]]
                           for row, n in zip(jout["memory"], frames)],
                "logp": [[round(float(x), 6) for x in row[:n]]
                         for row, n in zip(jout["logp"], ulen)],
                "ids": jout["ids"].tolist()}
        got = chip_smoke.conformer_parity(tout, want)
        worst[name] = got
        print(f"{name}: {sum(x.numel() for x in model.parameters())} parameters; port vs JAX "
              f"on the CPU: {got} (log-probs from {float(jout['logp'].min()):.2f} to "
              f"{float(jout['logp'].max()):.2f}; JAX 1-best of utterance 0 "
              f"{want['ids'][0]})", flush=True)
        fixture["results"][name] = want
    bad = [n for n, got in worst.items() if not chip_smoke.conformer_parity_ok(got)]
    if bad:
        print(f"the port's CPU path disagrees with JAX beyond the limits on {bad}")
        return 1
    if args.write:
        with open(args.write, "w", encoding="utf-8") as f:
            json.dump(fixture, f, separators=(",", ":"))
            f.write("\n")
        print(f"wrote {args.write} ({os.path.getsize(args.write)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
