"""The streamed encode, streamed CTC and long-form encode of the committed
``conformer_streaming`` config at full width with seeded weights, in both
the JAX package and the PyTorch port, on the CPU, in float32.

    python tools/torch_port_stream_parity.py
    python tools/torch_port_stream_parity.py \
        --write egs/synth_bench/trained/conformer_streaming.jax_stream.json

The weights, the 16 utterances and the probe are those of
``conformer_seeded.jax.json`` (read from it, checksums checked), so the two
fixtures cannot drift apart. Both packages compute:

  1. the encoder memory of the 16 utterances streamed through
     ``MultiStreamAttention`` (16 slots, one opened a tick, so that the
     rows are ragged; features pushed whole and windowed by the server),
     projected on the seeded unit vector. JAX's must equal the offline
     chunk-masked projection of ``conformer_seeded.jax.json`` wherever the
     two encodes see the same frames (the offline mask counts one frame
     more for some lengths, which changes that utterance's last chunk);
  2. the greedy CTC ids of a ``ctc`` model of the same encoder with a
     seeded head through ``MultiStreamCTC`` (16 staggered slots);
  3. ``encode_windowed``'s memory projection (window 1200, context 200) of
     2 seeded utterances of 2,500-3,000 frames.

Fails when the port's CPU path is off JAX by more than ``chip_smoke``'s
limits; ``--write PATH`` then writes JAX's numbers, the seeds and checksums
(no weights) as the fixture that ``chip_smoke.py`` phase 10 holds the card to.
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
from opentransformer_tpu.recognize import multistream as jax_ms  # noqa: E402
from opentransformer_tpu.recognize.streaming import encode_windowed as jax_windowed  # noqa: E402

NAME = "conformer_streaming"


def jax_memory(ms, slots, probe) -> list:
    """Each utterance's memory as the JAX server accumulated it on the host
    (its slot's buffer), projected on ``probe``."""
    return [np.asarray(ms._mem[slots[i]].view(), np.float32) @ probe for i in range(len(slots))]


def jax_stream(cfg, params, feats, mask, probe, ctc_cfg, ctc_params):
    """JAX's streamed memory projections (1.) and MultiStreamCTC ids (2.)."""
    jm = jax_build_model(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, params)
    n = len(feats)
    ms = jax_ms.MultiStreamAttention(jm, variables, n_streams=n, **chip_smoke.STREAM_SEARCH)
    slots, _ = chip_smoke.staggered(ms, feats, mask)
    memory = jax_memory(ms, slots, probe)
    jc = jax_build_model(ctc_cfg)
    ms = jax_ms.MultiStreamCTC(jc, jax.tree_util.tree_map(jnp.asarray, ctc_params), n_streams=n)
    _, finals = chip_smoke.staggered(ms, feats, mask)
    return memory, [[int(x) for x in finals[i].split()] for i in range(n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write", default=None, help="write the JAX package's numbers here")
    args = p.parse_args(argv)

    offline = chip_smoke.load_conformer_fixture()
    c = offline["inputs"]
    feats, mask, _ = chip_smoke.fixture_inputs(offline)
    probe = chip_smoke.memory_probe(384, c["probe_seed"])
    model = chip_smoke.seeded_conformer(NAME, offline, device="cpu")
    params = chip_smoke.seeded_params(model, c["weights_seed"])
    ctc_model, ctc_params = chip_smoke.seeded_stream_ctc(device="cpu")
    long_feats, long_mask = chip_smoke.long_form_inputs()
    cfg = offline["configs"][NAME]

    jmem, jids = jax_stream(cfg, params, feats, mask, probe, chip_smoke.stream_ctc_cfg(),
                            ctc_params)
    jm = jax_build_model(cfg)
    lw = chip_smoke.LONG_FORM
    lmem, lmask = jax_windowed(jm, jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(long_feats), long_mask.sum(axis=1),
                               lw["window"], lw["context"])
    lproj = np.asarray(lmem) @ probe
    lframes = np.asarray(lmask).sum(axis=1)

    # 1. JAX's streamed memory against its offline chunk-masked encode
    chunk = cfg["encoder"]["chunk_size"]
    worst_offline = 0.0
    for i, mem in enumerate(jmem):
        want = np.asarray(offline["results"][NAME]["memory"][i], np.float32)
        agree = len(mem) if len(want) == len(mem) else (len(mem) - 1) // chunk * chunk
        worst_offline = max(worst_offline, float(np.abs(mem[:agree] - want[:agree]).max()))
    print(f"JAX streamed vs JAX offline (chunk-masked, fixture): max|d| {worst_offline:.3e} "
          f"over the frames both encodes see; frames {[len(m) for m in jmem]} (offline "
          f"{[len(m) for m in offline['results'][NAME]['memory']]})", flush=True)
    if worst_offline > chip_smoke.STREAM_OFFLINE_ATOL:
        print(f"JAX's streamed memory is not its offline one (limit "
              f"{chip_smoke.STREAM_OFFLINE_ATOL:.0e})")
        return 1

    fixture = {
        "what": "conformer_streaming at full width with the seeded weights, utterances and "
                "probe of conformer_seeded.jax.json, JAX package on the CPU in float32: the "
                "encoder memory streamed through MultiStreamAttention (16 staggered slots) "
                "projected on the probe; greedy CTC ids of a ctc model of the same encoder "
                "with a seeded head through MultiStreamCTC (16 staggered slots); "
                "encode_windowed's memory projection of 2 long utterances",
        "tool": "tools/torch_port_stream_parity.py --write",
        "inputs": {"offline_fixture": os.path.relpath(chip_smoke.CONFORMER_FIXTURE, REPO),
                   "chunk_frames": chip_smoke.STREAM_CHUNK_FRAMES, "ctc_weights_seed":
                   chip_smoke.STREAM_CTC_SEED, "long_form": lw},
        "checksums": {"weights": offline["checksums"]["weights"],
                      "ctc_weights": chip_smoke.checksum(ctc_params),
                      "long_feats": chip_smoke.checksum([long_feats])},
        "stream": {"memory": [[round(float(x), 6) for x in m] for m in jmem]},
        "ctc": {"ids": jids},
        "long_form": {"memory": [[round(float(x), 6) for x in row[:n]]
                                 for row, n in zip(lproj, lframes)]},
    }

    out = chip_smoke.stream_outputs(model, ctc_model, feats, mask, probe, long_feats, long_mask)
    got = chip_smoke.stream_parity(out, fixture)
    print(f"port vs JAX on the CPU: {got}; JAX's CTC id lengths {[len(x) for x in jids]}",
          flush=True)
    if not chip_smoke.stream_parity_ok(got):
        print("the port's CPU path disagrees with JAX beyond chip_smoke's limits")
        return 1
    if args.write:
        with open(args.write, "w", encoding="utf-8") as f:
            json.dump(fixture, f, separators=(",", ":"))
            f.write("\n")
        print(f"wrote {args.write} ({os.path.getsize(args.write)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
