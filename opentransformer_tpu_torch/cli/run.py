"""Training CLI (counterpart of ``opentransformer_tpu/cli/run.py``).

Trains every model type the port decodes: a ``speech2text`` model (with
the hybrid CTC loss when ``model.ctc_weight`` > 0), a ``ctc`` model and a
``transducer`` (the RNN-T loss) from either speech input the JAX package
takes, and the language models ``transformer_lm`` and ``rnn_lm`` from a
text dataset (``dataset_type: text``: src/tgt token files, batches of
src = BOS ⧺ tokens and tgt = tokens ⧺ EOS; no device frontend). Speech
comes as:

  * raw waveforms (``dataset_type: online`` with ``data.extract_on_device:
    true``): the feature stage (fused fbank kernel, CMVN, SpecAugment) runs
    on the device before the teacher-forced loss;
  * precomputed kaldi features (``dataset_type: kaldi``) or host log-fbank
    of the online dataset, streamed from the host, or with
    ``data.device_resident: true`` uploaded once to the card and gathered
    there per batch (``data/resident.py``).

``data.bucket`` batches by length (``data/bucket.py``); ``train.dtype:
bfloat16`` (or ``-mp``) runs the forward under bfloat16 autocast over
float32 weights; ``train.steps_per_exec`` (or ``--steps-per-exec``) is
accepted and runs as that many single updates (``train/trainer.py``);
``train.dev_cer_probe`` decodes a ``speech2text`` model's first
``dev_cer_batches`` dev batches greedily after every epoch and logs
``epoch N dev greedy CER``; ``-im`` warm-starts the weights from a
``params.npz`` (or a checkpoint directory; a ``ctc`` model takes a hybrid
speech2text's, its decoder left out).
Checkpoints go to ``<expdir>/model.epoch.N`` with the config beside them
(``train/checkpoint.py``); the dev split, if the config has one, is scored
by its mean loss after every epoch.

    python -m opentransformer_tpu_torch.cli.run \\
        -c opentransformer_tpu_torch/conf/anchor.json --expdir EXP
    python -m opentransformer_tpu_torch.cli.run \\
        -c opentransformer_tpu_torch/conf/rnn_lm.json --expdir LM_EXP

The config is JSON with the JAX package's sections and keys. It runs on the
CUDA card unless ``--device cpu`` is given. The JAX CLI's other options
(resuming, optimizer-state warm starts, parallelism, multi-host,
supervision, asynchronous saves, TensorBoard, profiling, MixSpeech, start
epoch/step overrides, pipeline schedules) are not ported: each raises when
given a value other than its default; ``-r``, ``-vb``, ``-ol``, ``-p`` and
``-g`` are accepted and ignored, as there.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import time

import torch

from ..compat import load_ctc_from_speech2text, load_into, load_npz
from ..config import load_config
from ..data import load_idx2unit_map
from ..data.device_pipeline import make_device_frontend
from ..data.loader import FeatureLoader
from ..data.resident import ResidentCorpus
from ..models.registry import build_model
from ..ops.levenshtein import ErrorRateAccumulator
from ..ops.project_topk import project_logp_topk
from ..recognize.base import SpeechToTextRecognizer
from ..train.checkpoint import Checkpointer
from ..train.trainer import Trainer, feature_args
from ..utils import resolve_device

logger = logging.getLogger(__name__)

STILL_LACKING = "What training and decoding still lack"
PARALLELISM = "Parallelism"
# (flags, default, the ROADMAP.md Queue 1 item) of the JAX CLI's options
# that are not ported; each raises when given another value
_NOT_PORTED = [
    (("-ct", "--continue_training"), False, STILL_LACKING),
    (("-ios", "--init_optim_state"), None, STILL_LACKING),
    (("--tp",), 1, PARALLELISM),
    (("--pp",), 1, PARALLELISM),
    (("--pp-schedule",), None, PARALLELISM),
    (("--pp-micro-batches",), None, PARALLELISM),
    (("--ep",), 1, PARALLELISM),
    (("--multihost",), False, PARALLELISM),
    (("--supervise",), 0, STILL_LACKING),
    (("--async-save",), False, STILL_LACKING),
    (("--visual",), False, STILL_LACKING),
    (("--profile",), None, STILL_LACKING),
    (("-ms", "--mixspeech"), False, STILL_LACKING),
    (("-tfe", "--from_epoch"), 0, STILL_LACKING),
    (("-tfs", "--from_step"), 0, STILL_LACKING),
]


def _dest(flags) -> str:
    return flags[-1].lstrip("-").replace("-", "_")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a model on the port")
    p.add_argument("-c", "--config", type=str, required=True, help="JSON config")
    p.add_argument("-s", "-se", "--seed", type=int, default=1234)
    p.add_argument("--expdir", type=str, default=None)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("-kl", "-knpt", "--keep_last_n_checkpoints", type=int, default=30)
    p.add_argument("-debug", "--debug", action="store_true",
                   help="stop each epoch after 30 micro-batches")
    p.add_argument("-mp", "--mixed_precision", action="store_true",
                   help="bfloat16 autocast over float32 weights (train.dtype: bfloat16)")
    p.add_argument("--steps-per-exec", type=int, default=None,
                   help="train.steps_per_exec: runs as that many single updates")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("-im", "--init_model", type=str, default=None,
                   help="warm-start the weights from a params.npz, or a checkpoint "
                        "directory holding one (model.epoch.N)")
    p.add_argument("-l", "--logging_level", type=str, default="INFO")
    p.add_argument("-lg", "--log_file", type=str, default=None)
    p.add_argument("-n", "--ngpu", type=int, default=0,
                   help="cards for data parallelism: 0 or 1 (one card)")
    for flags in (("-r", "--local_rank"), ("-vb", "--verbose"), ("-ol", "--opt_level"),
                  ("-p", "--parallel_mode"), ("-g", "--gpus")):
        p.add_argument(*flags, default=None, help="accepted for reference-CLI parity; ignored")
    for flags, default, _ in _NOT_PORTED:
        if isinstance(default, bool):
            p.add_argument(*flags, dest=_dest(flags), action="store_true",
                           help="not ported (raises)")
        else:
            p.add_argument(*flags, dest=_dest(flags), default=default,
                           type=int if isinstance(default, int) else str,
                           help="not ported (raises on a non-default value)")
    return p


def _check_not_ported(args) -> None:
    for flags, default, item in _NOT_PORTED:
        if getattr(args, _dest(flags)) != default:
            raise NotImplementedError(
                f"{'/'.join(flags)} is not ported to opentransformer_tpu_torch yet "
                f"(see ROADMAP.md, Queue 1: {item})")
    if args.ngpu > 1:
        raise NotImplementedError(
            f"-n {args.ngpu}: data parallelism over several cards is not ported to "
            f"opentransformer_tpu_torch yet (see ROADMAP.md, Queue 1: {PARALLELISM})")


class DevCerProbe:
    """Greedy-decode CER over the first ``max_batches`` dev batches, after
    every epoch (``make_dev_cer_probe`` of the JAX CLI): one beam-1
    recognizer over the training model with ``max_len = dev_cer_max_len``;
    its greedy step is kernel 1 at k = 1. ``records`` holds, per call, the
    CER, errors, tokens, utterances, greedy steps, kernel-1 launches and
    host seconds."""

    def __init__(self, cfg: dict, model, dev_loader, device, max_batches: int = 4):
        self.idx2unit = load_idx2unit_map(cfg["data"]["vocab"])
        self.max_len = int(cfg["train"].get("dev_cer_max_len", 32))
        self.recognizer = SpeechToTextRecognizer(model, beam_width=1, max_len=self.max_len,
                                                 idx2unit=self.idx2unit)
        self.batches = []
        for i, batch in enumerate(dev_loader):
            if i >= max_batches:
                break
            feats, mask, _, _ = feature_args(batch, device)
            self.batches.append((batch[0], feats, mask))
        self.targets_dict = getattr(dev_loader.dataset, "targets_dict", {})
        self.records: list[dict] = []

    def __call__(self, model, epoch: int) -> float:
        if model is not self.recognizer.model:
            raise ValueError("the probe decodes the model it was built with")
        cer = ErrorRateAccumulator()
        n_utts = steps = 0
        launches0 = project_logp_topk.launches
        t0 = time.time()
        for utt_ids, feats, mask in self.batches:
            hyp = self.recognizer.recognize_arrays(feats, mask)
            # the greedy loop stops once every row has emitted EOS
            steps += min(int(hyp.lengths.max()), self.max_len)
            texts = self.recognizer.nbest_translate(hyp.tokens[:, :, 1:].cpu().numpy())
            for i, utt in enumerate(utt_ids):
                ref = " ".join(self.idx2unit.get(t, "<UNK>")
                               for t in self.targets_dict.get(utt, []))
                cer.update(ref.split(), texts[i][0].split())
                n_utts += 1
        self.records.append({"epoch": epoch, "cer": cer.rate, "errors": cer.errors,
                             "tokens": cer.tokens, "utts": n_utts, "steps": steps,
                             "launches": project_logp_topk.launches - launches0,
                             "seconds": time.time() - t0})
        logger.info("epoch %d dev greedy CER %.2f%% (%d/%d tokens, %d utts)",
                    epoch, cer.rate * 100, cer.errors, cer.tokens, n_utts)
        return cer.rate


def run(argv=None) -> Trainer:
    """Parse ``argv``, train, and return the trainer (its ``history``,
    ``dev_losses`` and ``nan_skips`` describe the run;
    ``trainer.dev_probe_fn`` is the ``DevCerProbe``, if any, and
    ``trainer.resident`` the device-resident corpus, if any)."""
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logging_level.upper(), logging.INFO),
                        format="%(asctime)s - %(levelname)s - %(message)s", force=True)
    if args.log_file:
        handler = logging.FileHandler(args.log_file)
        handler.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        logging.getLogger().addHandler(handler)
    _check_not_ported(args)
    cfg = load_config(args.config)
    model_cfg, data_cfg, train_cfg = cfg["model"], cfg["data"], dict(cfg["train"])
    if args.mixed_precision:
        train_cfg["dtype"] = "bfloat16"
    if args.steps_per_exec:
        train_cfg["steps_per_exec"] = int(args.steps_per_exec)
    device = resolve_device(args.device)
    expdir = args.expdir or os.path.join("egs_exp", train_cfg.get("save_name", "exp"))
    os.makedirs(expdir, exist_ok=True)
    shutil.copy(args.config, os.path.join(expdir, os.path.basename(args.config)))

    torch.manual_seed(args.seed)  # the model's initial weights
    # float32 master weights; train.dtype sets the forward's autocast
    model = build_model(model_cfg, dtype=torch.float32, device=device)
    if args.init_model:
        path = args.init_model
        if os.path.isdir(path):
            path = os.path.join(path, "params.npz")
        tree = load_npz(path)
        if model_cfg["type"] == "ctc" and "decoder" in tree.get("params", tree):
            load_ctc_from_speech2text(model, tree)  # a hybrid speech2text's weights
        else:
            load_into(model, tree)
        logger.info("initialized model weights from %s", path)
    logger.info("model: %d parameters on %s", sum(p.numel() for p in model.parameters()), device)
    loader = FeatureLoader(cfg, "train", seed=args.seed)
    logger.info("train loader: %d batches", len(loader))
    frontend = make_device_frontend(data_cfg, device) if loader.extract_on_device else None
    resident = None
    if loader.device_resident:
        corpus, lens = loader.build_resident_corpus()
        resident = ResidentCorpus(data_cfg, corpus, lens, device)
        del corpus  # the card's copy is the working one
    dev_loader = None
    if "dev" in data_cfg:
        # the dev split stays on the host feature path
        dev_loader = FeatureLoader(cfg, "dev", is_eval=True, seed=args.seed)
        logger.info("dev loader: %d batches", len(dev_loader))
    probe = None
    if (dev_loader is not None and not loader.extract_on_device
            and model_cfg["type"] == "speech2text"
            and bool(train_cfg.get("dev_cer_probe", False))):
        probe = DevCerProbe(cfg, model, dev_loader, device,
                            max_batches=int(train_cfg.get("dev_cer_batches", 4)))
        logger.info("per-epoch dev greedy-CER probe enabled")
    trainer = Trainer(
        train_cfg, model, frontend, torch.Generator(device=device).manual_seed(args.seed),
        checkpointer=Checkpointer(expdir, config=cfg), log_interval=args.log_interval,
        keep_last_n=args.keep_last_n_checkpoints, dev_loader=dev_loader, is_debug=args.debug,
        resident=resident, dev_probe_fn=probe)
    trainer.train(loader)
    return trainer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
