"""Decode the full synthetic test split with the committed anchor weights in
both the JAX package and the PyTorch port, on the CPU, in float32.

    python tools/torch_port_anchor_parity.py [--n_utts 500] [-b 100]
    python tools/torch_port_anchor_parity.py --write egs/synth_bench/trained/anchor_synth_f16.jax_1best.json

Both packages see the same padded batches (the port's eval-CLI collation)
at beam 5, length penalty 0.6, max_len 32. Prints each package's CER with
its error count, and the number of utterances whose 1-best ids differ.
``--write PATH`` also writes the JAX package's 1-best ids (after BOS, up to
EOS, PAD dropped) of every utterance as a JSON fixture: ``chip_smoke.py``
holds the card's decodes against it, on a machine without JAX.
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
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from opentransformer_tpu.models.registry import build_model as jax_build_model  # noqa: E402
from opentransformer_tpu.recognize.base import SpeechToTextRecognizer as JaxRecognizer  # noqa: E402
from opentransformer_tpu_torch import compat  # noqa: E402
from opentransformer_tpu_torch.cli.eval import collate  # noqa: E402
from opentransformer_tpu_torch.data import EOS, PAD, synth  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.ops.levenshtein import ErrorRateAccumulator  # noqa: E402
from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer  # noqa: E402

ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
UNIT_OFFSET = synth.make_vocab()[synth.unit_names()[0]]  # unit index -> vocab id


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_utts", type=int, default=500)
    p.add_argument("-b", "--batch_size", type=int, default=100)
    p.add_argument("--write", default=None,
                   help="write the JAX package's 1-best ids as a JSON fixture here")
    args = p.parse_args(argv)

    with open(ANCHOR + ".manifest.json") as f:
        cfg = json.load(f)["model_cfg"]
    tree = compat.load_npz(ANCHOR + ".npz")
    jrec = JaxRecognizer(jax_build_model(cfg), jax.tree_util.tree_map(jnp.asarray, tree),
                         beam_width=5, max_len=32, penalty=0.6)
    trec = SpeechToTextRecognizer(compat.load_into(build_model(cfg, device="cpu"), tree),
                                  beam_width=5, max_len=32, penalty=0.6)

    utts = list(synth.gen_split("test", args.n_utts))
    acc = {"jax": ErrorRateAccumulator(), "port": ErrorRateAccumulator()}
    differ = 0
    jax_ids = {}
    for s in range(0, len(utts), args.batch_size):
        chunk = utts[s : s + args.batch_size]
        x, mask, _ = collate([u[1] for u in chunk])
        best_j = np.asarray(jrec.recognize_arrays(jnp.asarray(x), jnp.asarray(mask)).tokens)[:, 0]
        best_t = trec.recognize_arrays(torch.from_numpy(x), torch.from_numpy(mask)).tokens[:, 0]
        best_t = best_t.numpy()
        for i, (_, _, ref) in enumerate(chunk):
            ref = [UNIT_OFFSET + t for t in ref]
            for name, best in (("jax", best_j[i]), ("port", best_t[i])):
                acc[name].update(ref, _strip(best))
            jax_ids[chunk[i][0]] = _strip(best_j[i])
            differ += int(not np.array_equal(best_j[i], best_t[i]))
        print(f"decoded {s + len(chunk)} utts: JAX {acc['jax'].errors} errors, "
              f"port {acc['port'].errors} errors, 1-best ids differ on {differ}", flush=True)
    for name, a in acc.items():
        print(f"{name} CER {a.rate * 100:.2f}% ({a.errors}/{a.tokens})")
    print(f"utterances whose 1-best ids differ: {differ}/{len(utts)}")
    if args.write:
        write_fixture(args.write, jax_ids, args.batch_size, acc["jax"])
        print(f"wrote the JAX package's 1-best ids of {len(jax_ids)} utterances to {args.write}")
    return 0


def write_fixture(path: str, ids: dict, batch_size: int, acc) -> None:
    """JSON with the decode settings and one line per utterance."""
    head = {"what": "1-best ids (after BOS, up to EOS, PAD dropped) of the JAX package "
                    "on the CPU in float32, anchor_synth_f16 on the synthetic test split",
            "tool": "tools/torch_port_anchor_parity.py --write",
            "decode": {"beam": 5, "penalty": 0.6, "max_len": 32, "batch_size": batch_size},
            "cer": f"{acc.rate * 100:.2f}% ({acc.errors}/{acc.tokens})"}
    lines = [f"  {json.dumps(utt)}: {json.dumps(best)}" for utt, best in ids.items()]
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(head, indent=1)[:-2] + ',\n "utts": {\n' + ",\n".join(lines)
                + "\n }\n}\n")


def _strip(ids) -> list[int]:
    """1-best ids after BOS up to EOS, PAD dropped (as the recognizers' translate)."""
    out = []
    for i in np.asarray(ids)[1:].tolist():
        if i == EOS:
            break
        if i != PAD:
            out.append(int(i))
    return out


if __name__ == "__main__":
    raise SystemExit(main())
