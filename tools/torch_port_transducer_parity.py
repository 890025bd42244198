"""The committed transducer configs at full width with seeded weights, in both
the JAX package and the PyTorch port, on the CPU, in float32.

    python tools/torch_port_transducer_parity.py
    python tools/torch_port_transducer_parity.py \
        --write egs/synth_bench/trained/transducer_seeded.jax.json

For ``transducer`` and ``transducer_streaming`` from
``opentransformer_tpu_torch/conf`` (the aishell recipes: d256, 12 blocks, a
1-layer d256 LSTM predictor, d_joint 256, V=4233, 40 mel; the streaming one
with chunk 16, left 4): the weights come from
``chip_smoke.seeded_transducer_params`` (numpy, one seed, the JAX layout,
the joint's output kernel scaled by ``joint_scale`` and its blank bias
raised by ``blank_bias``; the two configs have the same shapes and get the
same weights), the inputs from
``chip_smoke.transducer_inputs`` (16 utterances of 300-500 frames x 40 mel,
targets of 8-24 units). Both packages compute, for ``transducer``: the
encoder memory projected on a seeded unit vector, the teacher-forced joint
log-probs along a monotone lattice path (``chip_smoke.path_logp``), the
greedy ids, and the beam-4 n-best (2 expansions a frame) without an LM and
with a seeded ``rnn_lm`` and ``transformer_lm`` fused at 0.3; for
``transducer_streaming``: the greedy ids of each utterance streamed alone
in 64-frame feeds. Prints the differences and fails above ``chip_smoke``'s
limits; also reports the share of JAX's greedy lattice steps at which blank
is the argmax (frames over frames plus tokens: every frame ends in one
blank step, every token is one step), which ``blank_bias`` is chosen to put
between 30% and 70%, and fails unless JAX's beam 1-bests hold labels as
``chip_smoke``'s phase 11b requires (``joint_scale`` is chosen for that).
``--write PATH`` then writes the JAX package's numbers,
the seeds, the configs and checksums of the weights and inputs (no weights)
as the JSON fixture that ``chip_smoke.py`` phase 11 holds the card to, on a
machine without JAX.
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
from opentransformer_tpu.recognize import online as jax_online  # noqa: E402
from opentransformer_tpu.recognize.base import make_lm_adapter as jax_lm_adapter  # noqa: E402
from opentransformer_tpu_torch.recognize.online import (  # noqa: E402
    StreamingTransducerRecognizer,
)


def jax_outputs(jm, variables, feats, mask, targets, c: dict) -> dict:
    """The JAX package's memory projection, path log-probs and greedy ids
    (as ``chip_smoke.transducer_outputs``)."""
    memory, memory_mask = jm.apply(variables, jnp.asarray(feats), jnp.asarray(mask),
                                   method="encode")
    proj = np.asarray(memory @ chip_smoke.memory_probe(memory.shape[-1], c["probe_seed"]))
    frames = np.asarray(memory_mask).sum(axis=1)
    logp = []
    for i, (n, u) in enumerate(zip(frames, chip_smoke.target_units(targets))):
        logits = jm.apply(variables, memory[i: i + 1, :n], jnp.asarray(targets[i: i + 1, : u + 1]),
                          method=lambda m, e, p: m.joint(e, m.predictor(p)))
        lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))[0]
        logp.append(chip_smoke.path_logp(lp, targets[i, 1: 1 + u], int(n)))
    greedy = jax.jit(lambda v, x, m: jm.apply(v, x, m, c["max_symbols"], c["max_per_frame"],
                                              method="greedy_decode"))
    tokens, n = greedy(variables, jnp.asarray(feats), jnp.asarray(mask))
    tokens, n = np.asarray(tokens), np.asarray(n)
    return {"memory": proj, "memory_mask": np.asarray(memory_mask), "logp": logp,
            "greedy": [tokens[i, : n[i]].tolist() for i in range(len(n))]}


def jax_beam(jm, variables, feats, mask, c: dict, lm_cfg=None, lm_params=None) -> dict:
    """The JAX package's beam n-best (as ``chip_smoke.transducer_beam``)."""
    lm_init = lm_step = None
    weight = 0.0
    if lm_cfg is not None:
        lm_init, lm_step = jax_lm_adapter(jax_build_model(lm_cfg),
                                          jax.tree_util.tree_map(jnp.asarray, lm_params),
                                          c["beam_max_symbols"])
        weight = c["lm_weight"]
    beam = jax.jit(lambda v, x, m: jm.apply(v, x, m, c["beam"], c["beam_max_symbols"],
                                            c["expansions"], lm_init, lm_step, weight,
                                            method="beam_decode"))
    tokens, lens, scores = (np.asarray(a) for a in beam(variables, jnp.asarray(feats),
                                                        jnp.asarray(mask)))
    return {"ids": [[tokens[i, j, : lens[i, j]].tolist() for j in range(tokens.shape[1])]
                    for i in range(tokens.shape[0])],
            "scores": scores.tolist()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write", default=None, help="write the JAX package's numbers here")
    args = p.parse_args(argv)

    c = dict(chip_smoke.TRANSDUCER_INPUTS)
    feats, mask, targets = chip_smoke.transducer_inputs(c)
    fixture = {"what": "the JAX package on the CPU in float32, the committed transducer configs "
                       "with seeded weights (joint output kernel scaled by inputs.joint_scale, "
                       "blank bias raised by inputs.blank_bias): the encoder "
                       "memory projected on a seeded unit vector (each utterance's frames), the "
                       "teacher-forced joint log-probs along a monotone lattice path (label and "
                       "blank at each point, then the final blank), greedy ids, beam n-best ids "
                       "and scores without and with a seeded LM fused; for "
                       "transducer_streaming the greedy ids of each utterance streamed alone",
               "tool": "tools/torch_port_transducer_parity.py --write",
               "inputs": c, "configs": {}, "checksums": {}, "results": {}}
    fixture["checksums"]["feats"] = chip_smoke.checksum([feats])
    fixture["checksums"]["targets"] = chip_smoke.checksum([targets])
    failures = []

    name = chip_smoke.TRANSDUCERS[0]
    model, params = chip_smoke.seeded_transducer(name, c, device="cpu")
    fixture["configs"][name] = chip_smoke.conformer_model_cfg(name)
    fixture["checksums"]["weights"] = chip_smoke.checksum(params)
    jm = jax_build_model(fixture["configs"][name])
    variables = jax.tree_util.tree_map(jnp.asarray, params)
    jout = jax_outputs(jm, variables, feats, mask, targets, c)
    tout = chip_smoke.transducer_outputs(model, feats, mask, targets, c)
    frames = jout["memory_mask"].sum(axis=1)
    want = {"memory": [[round(float(x), 6) for x in row[:n]]
                       for row, n in zip(jout["memory"], frames)],
            "logp": [[round(x, 6) for x in row] for row in jout["logp"]],
            "greedy": jout["greedy"]}
    tokens = sum(map(len, want["greedy"]))
    want["blank_share"] = float(frames.sum() / (frames.sum() + tokens))
    got = chip_smoke.transducer_parity(tout, want)
    print(f"{name}: {sum(x.numel() for x in model.parameters())} parameters; port vs JAX on the "
          f"CPU: {got}; JAX greedy {tokens} tokens over {int(frames.sum())} frames, blank the "
          f"argmax at {100 * want['blank_share']:.1f}% of the lattice steps; port greedy loop "
          f"{tout['iterations']} iterations", flush=True)
    if (got["memory"] > chip_smoke.TRANSDUCER_MEMORY_ATOL or got["frames_differ"]
            or got["logp"] > chip_smoke.TRANSDUCER_LOGP_ATOL
            or got["ids_differ"] > chip_smoke.TRANSDUCER_GREEDY_LIMIT):
        failures.append(f"{name} greedy")
    if not 0.3 <= want["blank_share"] <= 0.7:
        failures.append(f"blank share {want['blank_share']:.3f} outside 30-70%")
    want["beam"] = {}
    for kind in ("none", *chip_smoke.TRANSDUCER_LMS):
        lm = lm_params = lm_cfg = None
        if kind != "none":
            lm, lm_params = chip_smoke.seeded_lm(kind, c, device="cpu")
            lm_cfg = chip_smoke.TRANSDUCER_LMS[kind]
            fixture["checksums"][kind] = chip_smoke.checksum(lm_params)
        jb = jax_beam(jm, variables, feats, mask, c, lm_cfg, lm_params)
        tb = chip_smoke.transducer_beam(model, feats, mask, c, lm)
        got = chip_smoke.beam_parity(tb, jb)
        print(f"{name} beam {c['beam']}, LM {kind}: port vs JAX {got}; JAX 1-best lengths "
              f"{sorted({len(h[0]) for h in jb['ids']})}, n-best lengths "
              f"{sorted({len(x) for h in jb['ids'] for x in h})}", flush=True)
        if (got["best_differ"] > chip_smoke.TRANSDUCER_BEAM_LIMIT or got["unsorted"]
                or got["score_rtol"] > chip_smoke.TRANSDUCER_SCORE_RTOL):
            failures.append(f"{name} beam {kind}")
        best = [len(h[0]) for h in jb["ids"]]
        if not chip_smoke.beam_holds_labels(best):
            failures.append(f"{name} beam {kind}: 1-best lengths {best}")
        want["beam"][kind] = {"ids": jb["ids"],
                              "scores": [[round(x, 4) for x in row] for row in jb["scores"]]}
    fixture["results"][name] = want

    name = chip_smoke.TRANSDUCERS[1]
    model, params = chip_smoke.seeded_transducer(name, c, device="cpu")
    fixture["configs"][name] = chip_smoke.conformer_model_cfg(name)
    if chip_smoke.checksum(params) != fixture["checksums"]["weights"]:
        failures.append(f"{name}: other weights than {chip_smoke.TRANSDUCERS[0]}")
    jm = jax_build_model(fixture["configs"][name])
    jrec = jax_online.StreamingTransducerRecognizer(
        jm, jax.tree_util.tree_map(jnp.asarray, params), max_per_frame=c["max_per_frame"])
    jstream = chip_smoke.streamed_transducer_ids(jrec, feats, mask)
    tstream = chip_smoke.streamed_transducer_ids(
        StreamingTransducerRecognizer(model, max_per_frame=c["max_per_frame"]), feats, mask)
    differ = sum(a != b for a, b in zip(tstream, jstream))
    print(f"{name} streamed greedy: port vs JAX ids differ on {differ} of {len(jstream)} "
          f"({sum(map(len, jstream))} JAX tokens)", flush=True)
    if differ > chip_smoke.TRANSDUCER_GREEDY_LIMIT:
        failures.append(f"{name} streamed")
    fixture["results"][name] = {"streamed": jstream}

    if failures:
        print(f"the port's CPU path disagrees with JAX beyond the limits: {failures}")
        return 1
    if args.write:
        with open(args.write, "w", encoding="utf-8") as f:
            json.dump(fixture, f, separators=(",", ":"))
            f.write("\n")
        print(f"wrote {args.write} ({os.path.getsize(args.write)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
