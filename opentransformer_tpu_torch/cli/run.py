"""Training CLI (counterpart of ``opentransformer_tpu/cli/run.py``).

Trains a ``speech2text`` model from raw waveforms: the online dataset with
``data.extract_on_device: true`` ships padded waveforms, and the feature
stage (fused fbank kernel, CMVN, SpecAugment) runs on the device before the
teacher-forced loss. Checkpoints go to ``<expdir>/model.epoch.N`` with the
config beside them (``train/checkpoint.py``); the dev split, if the config
has one, is scored by its mean loss after every epoch.

    python -m opentransformer_tpu_torch.cli.run \\
        -c opentransformer_tpu_torch/conf/transformer_baseline.json --expdir EXP

The config is JSON with the JAX package's sections and keys. It runs on the
CUDA card unless ``--device cpu`` is given. The JAX CLI's other options
(mixed precision, resuming, warm starts, parallelism, multi-host,
supervision, multi-step execution, asynchronous saves, TensorBoard,
profiling, MixSpeech, start epoch/step overrides, pipeline schedules) are not
ported: each raises when given a value other than its default; ``-r``,
``-vb``, ``-ol``, ``-p`` and ``-g`` are accepted and ignored, as there.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil

import torch

from ..config import load_config
from ..data.device_pipeline import make_device_frontend
from ..data.loader import FeatureLoader
from ..models.registry import build_model
from ..train.checkpoint import Checkpointer
from ..train.trainer import Trainer
from ..utils import resolve_device

logger = logging.getLogger(__name__)

# (flags, default) of the JAX CLI's options that are not ported; each
# raises when given another value
_NOT_PORTED = [
    (("-mp", "--mixed_precision"), False),
    (("-ct", "--continue_training"), False),
    (("-im", "--init_model"), None),
    (("-ios", "--init_optim_state"), None),
    (("--tp",), 1),
    (("--pp",), 1),
    (("--pp-schedule",), None),
    (("--pp-micro-batches",), None),
    (("--ep",), 1),
    (("--multihost",), False),
    (("--supervise",), 0),
    (("--steps-per-exec",), None),
    (("--async-save",), False),
    (("--visual",), False),
    (("--profile",), None),
    (("-ms", "--mixspeech"), False),
    (("-tfe", "--from_epoch"), 0),
    (("-tfs", "--from_step"), 0),
]


def _dest(flags) -> str:
    return flags[-1].lstrip("-").replace("-", "_")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a speech2text model on the port")
    p.add_argument("-c", "--config", type=str, required=True, help="JSON config")
    p.add_argument("-s", "-se", "--seed", type=int, default=1234)
    p.add_argument("--expdir", type=str, default=None)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("-kl", "-knpt", "--keep_last_n_checkpoints", type=int, default=30)
    p.add_argument("-debug", "--debug", action="store_true",
                   help="stop each epoch after 30 micro-batches")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("-l", "--logging_level", type=str, default="INFO")
    p.add_argument("-lg", "--log_file", type=str, default=None)
    p.add_argument("-n", "--ngpu", type=int, default=0,
                   help="cards for data parallelism: 0 or 1 (one card)")
    for flags in (("-r", "--local_rank"), ("-vb", "--verbose"), ("-ol", "--opt_level"),
                  ("-p", "--parallel_mode"), ("-g", "--gpus")):
        p.add_argument(*flags, default=None, help="accepted for reference-CLI parity; ignored")
    for flags, default in _NOT_PORTED:
        if isinstance(default, bool):
            p.add_argument(*flags, dest=_dest(flags), action="store_true",
                           help="not ported (raises)")
        else:
            p.add_argument(*flags, dest=_dest(flags), default=default,
                           type=int if isinstance(default, int) else str,
                           help="not ported (raises on a non-default value)")
    return p


def _check_not_ported(args) -> None:
    for flags, default in _NOT_PORTED:
        if getattr(args, _dest(flags)) != default:
            raise NotImplementedError(
                f"{'/'.join(flags)} is not ported to opentransformer_tpu_torch yet "
                "(see ROADMAP.md, Queue 1 items 5 and 12)")
    if args.ngpu > 1:
        raise NotImplementedError(
            f"-n {args.ngpu}: data parallelism over several cards is not ported to "
            "opentransformer_tpu_torch yet (see ROADMAP.md, Queue 1 item 12)")


def run(argv=None) -> Trainer:
    """Parse ``argv``, train, and return the trainer (its ``history``,
    ``dev_losses`` and ``nan_skips`` describe the run)."""
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logging_level.upper(), logging.INFO),
                        format="%(asctime)s - %(levelname)s - %(message)s", force=True)
    if args.log_file:
        handler = logging.FileHandler(args.log_file)
        handler.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        logging.getLogger().addHandler(handler)
    _check_not_ported(args)
    cfg = load_config(args.config)
    model_cfg, data_cfg, train_cfg = cfg["model"], cfg["data"], cfg["train"]
    if model_cfg.get("type") != "speech2text":
        raise NotImplementedError(
            f"training model type {model_cfg.get('type')!r} is not ported to "
            "opentransformer_tpu_torch yet (see ROADMAP.md, Queue 1 item 5)")
    if float(model_cfg.get("ctc_weight", 0.0)) > 0.0:
        raise NotImplementedError(
            "training with the hybrid CTC loss (model.ctc_weight > 0) through the CLI is not "
            "ported to opentransformer_tpu_torch yet (see ROADMAP.md, Queue 1: training)")
    if not data_cfg.get("extract_on_device", False):
        raise NotImplementedError(
            "training from host features is not ported to opentransformer_tpu_torch yet "
            "(see ROADMAP.md, Queue 1 item 6); set data.extract_on_device: true")
    device = resolve_device(args.device)
    expdir = args.expdir or os.path.join("egs_exp", train_cfg.get("save_name", "exp"))
    os.makedirs(expdir, exist_ok=True)
    shutil.copy(args.config, os.path.join(expdir, os.path.basename(args.config)))

    torch.manual_seed(args.seed)  # the model's initial weights
    model = build_model(model_cfg, dtype=torch.float32, device=device)
    logger.info("model: %d parameters on %s", sum(p.numel() for p in model.parameters()), device)
    loader = FeatureLoader(cfg, "train", seed=args.seed)
    logger.info("train loader: %d batches", len(loader))
    dev_loader = None
    if "dev" in data_cfg:
        # the dev split stays on the host feature path
        dev_loader = FeatureLoader(cfg, "dev", is_eval=True, seed=args.seed)
        logger.info("dev loader: %d batches", len(dev_loader))
    trainer = Trainer(
        train_cfg, model, make_device_frontend(data_cfg, device),
        torch.Generator(device=device).manual_seed(args.seed),
        checkpointer=Checkpointer(expdir, config=cfg), log_interval=args.log_interval,
        keep_last_n=args.keep_last_n_checkpoints, dev_loader=dev_loader, is_debug=args.debug)
    trainer.train(loader)
    return trainer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
