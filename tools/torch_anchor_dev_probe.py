#!/usr/bin/env python
"""Teacher-forced and free-running measures of a speech2text npz on the
synthetic dev split, with the port on the card (``--device cpu`` runs the
kernels' plain versions on the CPU instead).

    python tools/torch_anchor_dev_probe.py --npz W.npz --data DATA \\
        [--model_cfg egs/synth_bench/trained/anchor_synth_f16.manifest.json] [--device cpu]

``DATA`` holds the corpus' vocab and dev split (``python -m
opentransformer_tpu_torch.data.synth DATA --splits dev``). The dev split is
batched as the anchor recipe's dev loader batches it (``conf/anchor.json``:
bucket 1152, batches of 64, ``drop_last``: 192 utterances). Printed: the
mean dev loss and its attention and CTC parts, the teacher-forced token
accuracy, the probability of EOS at each utterance's true end (mean, and
the share below 0.5), and the greedy decode of the recipe's dev CER probe
(``max_len`` 32): CER, greedy steps, hypotheses that never emit EOS, and
the hypothesis-minus-reference length histogram; with the device, the
card's name and power limit, and the probe's kernel-1 launches (its greedy
step is kernel 1 at k = 1). It compares a model the port trained with the
committed anchor the JAX package trained. Several ``--npz`` are measured in
turn, one JSON line each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from opentransformer_tpu_torch.cli.eval import load_model_cfg  # noqa: E402
from opentransformer_tpu_torch.cli.run import DevCerProbe  # noqa: E402
from opentransformer_tpu_torch.compat import load_into, load_npz  # noqa: E402
from opentransformer_tpu_torch.config import CONF_DIR, load_config  # noqa: E402
from opentransformer_tpu_torch.data import EOS, PAD  # noqa: E402
from opentransformer_tpu_torch.data.loader import FeatureLoader  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.train.trainer import feature_args  # noqa: E402
from opentransformer_tpu_torch.utils import resolve_device  # noqa: E402
from torch_anchor_recipe import card_line  # noqa: E402


def measure(npz: str, model_cfg: str, cfg: dict, device) -> dict:
    """The measures of one npz (see the module docstring)."""
    model = build_model(load_model_cfg(model_cfg), device=device)
    load_into(model, load_npz(npz)).eval()
    loader = FeatureLoader(cfg, "dev", is_eval=True)
    losses, correct, tokens, eos_p = [], 0, 0, []
    with torch.no_grad():
        for batch in loader:
            feats, mask, targets, lengths = feature_args(batch, device)
            loss, aux = model(feats, mask, targets, lengths)
            losses.append((float(loss), float(aux["att_loss"]), float(aux["ctc_loss"])))
            memory, memory_mask = model.encode(feats, mask)
            logp = torch.log_softmax(model.decode_full(targets[:, :-1], memory, memory_mask), -1)
            out = targets[:, 1:]
            valid = out != PAD
            correct += int(((logp.argmax(-1) == out) & valid).sum())
            tokens += int(valid.sum())
            ends = (lengths - 1).long()  # EOS's position in targets[:, 1:]
            eos_p += logp[torch.arange(len(ends), device=ends.device), ends, EOS].exp().tolist()
    probe = DevCerProbe(cfg, model, loader, device)
    lens = []
    with torch.no_grad():
        for _, feats, mask in probe.batches:
            hyp = probe.recognizer.recognize_arrays(feats, mask)
            lens += (hyp.lengths[:, 0] - 1).tolist()
    ref = [len(probe.targets_dict[u]) for utt_ids, _, _ in probe.batches for u in utt_ids]
    cer = probe(model, 0)
    diff = np.array(lens) - np.array(ref)
    return {
        "npz": npz, "device": str(device), "utts": len(ref),
        "dev_loss": float(np.mean([x[0] for x in losses])),
        "att_loss": float(np.mean([x[1] for x in losses])),
        "ctc_loss": float(np.mean([x[2] for x in losses])),
        "teacher_forced_token_accuracy": correct / tokens,
        "eos_prob_at_end_mean": float(np.mean(eos_p)),
        "eos_prob_at_end_below_half": float(np.mean(np.array(eos_p) < 0.5)),
        "greedy_cer": cer, "greedy_steps": probe.records[0]["steps"],
        "probe_kernel1_launches": probe.records[0]["launches"],
        "greedy_without_eos": int(sum(n >= probe.max_len for n in lens)),
        "greedy_len_diff": {int(k): int(v) for k, v in zip(*np.unique(diff, return_counts=True))},
    }


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--npz", required=True, nargs="+")
    p.add_argument("--data", required=True, help="corpus directory with vocab and dev/")
    p.add_argument("--model_cfg", default=os.path.join(
        REPO, "egs", "synth_bench", "trained", "anchor_synth_f16.manifest.json"))
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(os.path.join(CONF_DIR, "anchor.json"))
    cfg["data"]["vocab"] = os.path.join(args.data, "vocab")
    cfg["data"]["dev"] = {"feat": [os.path.join(args.data, "dev", "feats.scp")],
                          "text": [os.path.join(args.data, "dev", "text")]}
    if device.type == "cuda":
        print(card_line())
    out = []
    for npz in args.npz:
        out.append(measure(npz, args.model_cfg, cfg, device))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
