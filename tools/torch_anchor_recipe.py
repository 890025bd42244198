#!/usr/bin/env python
"""The anchor recipe on the PyTorch port: stages 0-2 of
``egs/synth_bench/anchor.sh`` through ``opentransformer_tpu_torch``.

    python tools/torch_anchor_recipe.py [--epochs 80] [--stage 0] [--device cpu]
        [--dtype float32] [--seed 1234] [--expdir DIR] [--init_model NPZ]

  0. generate the synthetic corpus into ``--data`` (default
     ``egs/synth_bench/data``) with ``python -m
     opentransformer_tpu_torch.data.synth`` if its vocab is missing;
  1. train ``opentransformer_tpu_torch/conf/anchor.json`` (``--epochs``
     overrides its 80 and ``--dtype`` its bfloat16; the data paths are
     rewritten when ``--data`` is not the default) through the port's
     training CLI with ``--seed`` into ``--expdir`` (default
     ``egs/synth_bench/exp_anchor_torch``), from the CLI's seeded initial
     weights or, with ``--init_model``, from an npz's (for example the JAX
     package's initial anchor weights, ``tools/jax_anchor_init.py``);
  2. average epochs ``end-5 … end-1``, decode the test split as anchor.sh
     does (``cli/eval.py -m EXP/model.average.fromXtoY -bw 5 -pn 0.6 -ml 32
     -b 100 -d test``, into JAX's ``decode_test_bw5_pn0.6_ml32_avgX-Y``),
     then export the average as the f16 npz and manifest of
     ``tools/export_trained_synth.py`` (``tools/torch_export_trained_synth.py``)
     to ``--export`` (default ``EXP/anchor_synth_f16.npz``).

It prints the decode's RESULT and a summary: the train loss, dev loss and
dev greedy CER of every epoch, seconds per update (host clock, the gaps
between updates after the first epoch), peak device memory, the resident
corpus' bytes and upload time, and the card's name and power limit. The
summary is also written as JSON to ``--summary`` if given. The committed
``egs/synth_bench/trained/anchor_synth_f16.npz`` is written only when
``--export`` names it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULT_DATA = "egs/synth_bench/data"


def card_line() -> str:
    """``name, power limit`` of the card as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "nvidia-smi not available"


def write_config(epochs: int, data: str, path: str, dtype: str | None = None) -> dict:
    from opentransformer_tpu_torch.config import CONF_DIR, load_config

    cfg = load_config(os.path.join(CONF_DIR, "anchor.json"))
    cfg["train"]["epochs"] = int(epochs)
    if dtype:
        cfg["train"]["dtype"] = dtype
    if data != DEFAULT_DATA:
        d = cfg["data"]
        d["vocab"] = os.path.join(data, "vocab")
        for split in ("train", "dev", "test"):
            d[split] = {"feat": [os.path.join(data, split, "feats.scp")],
                        "text": [os.path.join(data, split, "text")]}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=1)
    return cfg


def summarize(trainer) -> dict:
    """Per-epoch losses and probe CERs, seconds per update after the first
    epoch, and the resident corpus' size and upload time."""
    epochs = sorted({r["epoch"] for r in trainer.history})
    train_loss = []
    for e in epochs:
        losses = [x for r in trainer.history if r["epoch"] == e for x in r["losses"]]
        train_loss.append(sum(losses) / len(losses))
    later = [r for r in trainer.history if r["epoch"] > epochs[0]]
    gaps = [b["time"] - a["time"] for a, b in zip(later, later[1:]) if a["epoch"] == b["epoch"]]
    probe = trainer.dev_probe_fn
    return {
        "epochs": len(epochs), "updates": len(trainer.history), "nan_skips": trainer.nan_skips,
        "train_loss": train_loss, "dev_loss": list(trainer.dev_losses),
        "dev_greedy_cer": [r["cer"] for r in probe.records] if probe else [],
        "probe_steps": [r["steps"] for r in probe.records] if probe else [],
        "probe_launches": [r["launches"] for r in probe.records] if probe else [],
        "seconds_per_update": sorted(gaps)[len(gaps) // 2] if gaps else None,
        "resident_bytes": trainer.resident.nbytes if trainer.resident else None,
        "resident_upload_seconds": trainer.resident.upload_seconds if trainer.resident else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train, average and decode the anchor on the port")
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--stage", type=int, default=0, help="first stage to run (0-2)")
    p.add_argument("--data", default=DEFAULT_DATA, help="corpus directory")
    p.add_argument("--expdir", default="egs/synth_bench/exp_anchor_torch")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="the training forward's precision (default: the config's bfloat16)")
    p.add_argument("--seed", type=int, default=1234, help="the training CLI's -s")
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--init_model", default=None, help="the training CLI's -im")
    p.add_argument("--summary", default=None, help="also write the summary JSON here")
    p.add_argument("--export", default=None,
                   help="the f16 npz of stage 2 (default: EXP/anchor_synth_f16.npz)")
    args = p.parse_args(argv)
    os.chdir(REPO)  # the config's data paths are relative to the repository

    import torch

    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.train.checkpoint import Checkpointer

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_export_trained_synth

    cuda = args.device in (None, "cuda")
    summary = {"card": card_line() if cuda else args.device, "seed": args.seed,
               "dtype": args.dtype or "bfloat16", "init_model": args.init_model}
    if args.stage <= 0 and not os.path.exists(os.path.join(args.data, "vocab")):
        t0 = time.time()
        subprocess.run([sys.executable, "-m", "opentransformer_tpu_torch.data.synth", args.data],
                       check=True)
        summary["corpus_seconds"] = time.time() - t0
    os.makedirs(os.path.join(args.expdir, "conf"), exist_ok=True)
    conf = os.path.join(args.expdir, "conf", "anchor.json")
    write_config(args.epochs, args.data, conf, args.dtype)
    if args.stage <= 1:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        trainer = run_cli.run(["-c", conf, "--expdir", args.expdir, "-s", str(args.seed),
                               "--log_interval", str(args.log_interval),
                               *(["--device", args.device] if args.device else []),
                               *(["-im", args.init_model] if args.init_model else [])])
        summary["train_seconds"] = time.time() - t0
        summary.update(summarize(trainer))
        if cuda:
            summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del trainer
    end = args.epochs
    start, stop = max(end - 5, 0), end - 1
    avg = Checkpointer(args.expdir).average(start, stop)
    decode_dir = os.path.join(args.expdir, f"decode_test_bw5_pn0.6_ml32_avg{start}-{stop}")
    t0 = time.time()
    eval_cli.main(["-m", avg, "-b", "100", "-bw", "5", "-pn", "0.6", "-ml", "32", "-d", "test",
                   *(["--device", args.device] if args.device else [])])
    summary["decode_seconds"] = time.time() - t0
    export = args.export or os.path.join(args.expdir, "anchor_synth_f16.npz")
    torch_export_trained_synth.main([avg, export, "--result", os.path.join(decode_dir, "RESULT"),
                                     "--embed-model-cfg"])
    summary["export"] = export
    with open(os.path.join(decode_dir, "RESULT"), encoding="utf-8") as f:
        result = f.read()
    summary["result"] = result.splitlines()
    summary["average"] = f"{start}-{stop}"
    print(result, end="")
    for e in range(len(summary.get("train_loss", []))):
        cer = summary["dev_greedy_cer"][e] if summary["dev_greedy_cer"] else float("nan")
        print(f"epoch {e}: train loss {summary['train_loss'][e]:.5f}, dev loss "
              f"{summary['dev_loss'][e]:.5f}, dev greedy CER {100 * cer:.2f}%")
    print(json.dumps(summary))
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)), exist_ok=True)
        with open(args.summary, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
