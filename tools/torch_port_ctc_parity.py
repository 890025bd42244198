"""CTC decodes of the synthetic test split with the committed anchor weights
in both the JAX package and the PyTorch port, on the CPU, in float32.

    python tools/torch_port_ctc_parity.py [--n_utts 500] [-b 100]
    python tools/torch_port_ctc_parity.py \
        --write egs/synth_bench/trained/anchor_synth_f16.jax_ctc.json

Three decodes, each through both packages' recognizers on the same padded
batches (the port's eval-CLI collation):

  greedy   the anchor's frontend, encoder and CTC head as a ``ctc`` model
           (the decoder's weights left out), greedy CTC;
  beam     the same model, the native sparse prefix beam of width 5 over
           each frame's top 32 candidates;
  ctcw     the speech2text anchor, attention beam 5, length penalty 0.6,
           max_len 32, joint CTC/attention rescoring at weight 0.3.

Prints each package's CER with its error count and the number of
utterances whose 1-best ids differ. ``--write PATH`` also writes the JAX
package's 1-best ids of each decode (as the recognizers translate them: up
to EOS, PAD and blank dropped) as a JSON fixture: ``chip_smoke.py`` holds
the card's CTC decodes against it, on a machine without JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from opentransformer_tpu.models.registry import build_model as jax_build_model  # noqa: E402
from opentransformer_tpu.recognize import base as jax_base  # noqa: E402
from opentransformer_tpu_torch import compat  # noqa: E402
from opentransformer_tpu_torch.cli.eval import collate  # noqa: E402
from opentransformer_tpu_torch.data import synth  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.ops.levenshtein import ErrorRateAccumulator  # noqa: E402
from opentransformer_tpu_torch.recognize import base  # noqa: E402

ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
UNIT_OFFSET = synth.make_vocab()[synth.unit_names()[0]]  # unit index -> vocab id
# each decode's settings, as the eval CLI's flags name them
DECODES = {
    "greedy": {"model": "ctc", "beam_width": 1},
    "beam": {"model": "ctc", "beam_width": 5, "prune_k": 32},
    "ctcw": {"model": "speech2text", "beam_width": 5, "penalty": 0.6, "max_len": 32,
             "ctc_weight": 0.3},
}
# the recognizers translate ids through this map, so their texts are the ids
ID_UNITS = {i: str(i) for i in range(4233)}


def ctc_model_cfg(cfg: dict) -> dict:
    """The anchor's frontend, encoder and CTC head as a ``ctc`` model."""
    return {"type": "ctc", "frontend_type": cfg.get("frontend_type", "conv"),
            "frontend": cfg["frontend"], "encoder_type": cfg.get("encoder_type", "transformer"),
            "encoder": cfg["encoder"], "vocab_size": cfg["decoder"]["vocab_size"]}


def recognizers(name: str):
    """(JAX recognize(x, mask) → texts, port recognize(x, mask) → texts) of a decode."""
    with open(ANCHOR + ".manifest.json") as f:
        cfg = json.load(f)["model_cfg"]
    tree = compat.load_npz(ANCHOR + ".npz")
    dec = dict(DECODES[name])
    if dec.pop("model") == "ctc":
        cfg = ctc_model_cfg(cfg)
        jtree = {"params": {k: v for k, v in tree["params"].items() if k != "decoder"}}
        tmodel = compat.load_ctc_from_speech2text(build_model(cfg, device="cpu"), tree)
    else:
        jtree = tree
        tmodel = compat.load_into(build_model(cfg, device="cpu"), tree)
    jrec = jax_base.build_recognizer(cfg["type"], jax_build_model(cfg),
                                     jax.tree_util.tree_map(jnp.asarray, jtree),
                                     args=dec, idx2unit=ID_UNITS)
    trec = base.build_recognizer(cfg["type"], tmodel, args=dec, idx2unit=ID_UNITS)

    def jax_texts(x, mask):
        return jrec.recognize(jnp.asarray(x), jnp.asarray(mask))[0]

    def port_texts(x, mask):
        return trec.recognize(torch.from_numpy(x), torch.from_numpy(mask))[0]

    return jax_texts, port_texts


def best_ids(texts) -> list[list[int]]:
    """1-best texts of ``ID_UNITS`` → ids."""
    return [[int(u) for u in nbest[0].split()] for nbest in texts]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_utts", type=int, default=500)
    p.add_argument("-b", "--batch_size", type=int, default=100)
    p.add_argument("--decodes", nargs="+", default=list(DECODES), choices=list(DECODES))
    p.add_argument("--write", default=None,
                   help="write the JAX package's 1-best ids as a JSON fixture here")
    args = p.parse_args(argv)

    utts = list(synth.gen_split("test", args.n_utts))
    fixture = {}
    for name in args.decodes:
        jax_texts, port_texts = recognizers(name)
        acc = {"jax": ErrorRateAccumulator(), "port": ErrorRateAccumulator()}
        differ, jax_ids = 0, {}
        for s in range(0, len(utts), args.batch_size):
            chunk = utts[s : s + args.batch_size]
            x, mask, _ = collate([u[1] for u in chunk])
            best_j, best_t = best_ids(jax_texts(x, mask)), best_ids(port_texts(x, mask))
            for i, (utt, _, ref) in enumerate(chunk):
                ref = [UNIT_OFFSET + t for t in ref]
                acc["jax"].update(ref, best_j[i])
                acc["port"].update(ref, best_t[i])
                jax_ids[utt] = best_j[i]
                differ += int(best_j[i] != best_t[i])
            print(f"{name}: decoded {s + len(chunk)} utts: JAX {acc['jax'].errors} errors, "
                  f"port {acc['port'].errors} errors, 1-best ids differ on {differ}", flush=True)
        for pkg, a in acc.items():
            print(f"{name} {pkg} CER {a.rate * 100:.2f}% ({a.errors}/{a.tokens})")
        print(f"{name}: utterances whose 1-best ids differ: {differ}/{len(utts)}")
        fixture[name] = {"decode": dict(DECODES[name], batch_size=args.batch_size),
                         "cer": f"{acc['jax'].rate * 100:.2f}% "
                                f"({acc['jax'].errors}/{acc['jax'].tokens})",
                         "utts": jax_ids}
    if args.write:
        write_fixture(args.write, fixture)
        print(f"wrote the JAX package's 1-best ids of {args.decodes} to {args.write}")
    return 0


def write_fixture(path: str, decodes: dict) -> None:
    """JSON with each decode's settings and CER, one line per utterance."""
    head = json.dumps({
        "what": "1-best ids (as the recognizers translate them: up to EOS, PAD and blank "
                "dropped) of the JAX package on the CPU in float32, anchor_synth_f16 on the "
                "synthetic test split; greedy and beam decode the anchor's frontend, encoder "
                "and CTC head as a ctc model",
        "tool": "tools/torch_port_ctc_parity.py --write"}, indent=1)[:-2]
    parts = []
    for name, d in decodes.items():
        lines = [f"   {json.dumps(utt)}: {json.dumps(ids)}" for utt, ids in d["utts"].items()]
        parts.append(f'  {json.dumps(name)}: {{\n   "decode": {json.dumps(d["decode"])},\n'
                     f'   "cer": {json.dumps(d["cer"])},\n   "utts": {{\n'
                     + ",\n".join(lines) + "\n   }\n  }")
    with open(path, "w", encoding="utf-8") as f:
        f.write(head + ',\n "decodes": {\n' + ",\n".join(parts) + "\n }\n}\n")


if __name__ == "__main__":
    raise SystemExit(main())
