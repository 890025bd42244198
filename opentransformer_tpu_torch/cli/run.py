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
``train.fused_update`` runs the update on flat buffers, ``-ms`` trains with
MixSpeech; ``train.dev_cer_probe`` decodes a ``speech2text`` model's first
``dev_cer_batches`` dev batches greedily after every epoch and logs
``epoch N dev greedy CER``. Checkpoints go to ``<expdir>/model.epoch.N``
with the config beside them (``train/checkpoint.py``; written by a thread
with ``--async-save`` or ``train.async_save``); the dev split, if the
config has one, is scored by its mean loss after every epoch.

Starting points, as in the JAX CLI: ``-im`` warm-starts the weights from a
``params.npz``, a checkpoint directory, an expdir (its newest epoch) or a
reference ``.pt`` (a ``ctc`` model takes a hybrid speech2text's, its
decoder left out); ``-ios DIR`` restores the optimizer state and the global
step of a ``model.epoch.N``; ``-ct`` resumes from the newest checkpoint of
the expdir (weights, optimizer, global step, next epoch) and then ignores
``-im`` and ``-ios``; ``-tfe`` / ``-tfs`` set the epoch and step counters.
``--supervise N`` runs the training as a child process and restarts it
with ``-ct`` up to N times after a crash. ``--profile DIR`` writes a
``torch.profiler`` trace of the run to ``DIR/trace.json``, ``--visual``
TensorBoard scalars to ``<expdir>/tb``, and ``--record FILE`` appends one
JSON line a process (its steps, losses and kernel launches; a supervised
run's children each add theirs).

    python -m opentransformer_tpu_torch.cli.run \\
        -c opentransformer_tpu_torch/conf/anchor.json --expdir EXP
    python -m opentransformer_tpu_torch.cli.run -c CONF.json --expdir EXP -im model.epoch.79.pt
    python -m opentransformer_tpu_torch.cli.run -c CONF.json --expdir EXP --supervise 3
    python -m opentransformer_tpu_torch.cli.run \\
        -c opentransformer_tpu_torch/conf/rnn_lm.json --expdir LM_EXP

The config is JSON with the JAX package's sections and keys. It runs on the
CUDA card unless ``--device cpu`` is given; ``-r``, ``-vb``, ``-ol``, ``-p``
and ``-g`` are accepted and ignored, as in the JAX CLI.

Parallelism (``parallel/``), the JAX CLI's options: a mesh of ``-n`` data
ranks (default: the cards over tp·pp·ep, at least one) × ``--tp`` tensor ×
``--pp`` pipeline × ``--ep`` expert ranks, one process a rank
(``parallel/launch.py``: spawned on this host, or with ``--multihost``
the world ``torchrun`` describes, where each data rank reads only its
shard of every batch, as JAX's hosts do). ``--pp-schedule`` is ``sharded``
(default) or ``1f1b`` with ``--pp-micro-batches`` microbatches. Rank 0
writes the logs, checkpoints (the one-card layout) and the record. The
ranks' collectives run on NCCL for the card and Gloo for the CPU. Without
any of these options the run is the single-process one; ``-n 1`` is a
world of one rank.

    python -m opentransformer_tpu_torch.cli.run -c CONF.json --expdir EXP -n 4
    python -m opentransformer_tpu_torch.cli.run -c CONF.json --expdir EXP --tp 2 --pp 2 \\
        --pp-schedule 1f1b --pp-micro-batches 4
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from .. import compat
from ..config import load_config
from ..data import load_idx2unit_map
from ..data.device_pipeline import make_device_frontend
from ..data.loader import FeatureLoader
from ..data.resident import ResidentCorpus
from ..models.registry import build_model
from ..models.speech2text import CTCModel
from ..ops.fbank_kernel import spec_mel
from ..ops.levenshtein import ErrorRateAccumulator
from ..ops.project_topk import project2_logp_topk, project_logp_topk
from ..parallel import launch
from ..parallel.mesh import make_mesh
from ..recognize.base import SpeechToTextRecognizer
from ..train.checkpoint import Checkpointer
from ..train.trainer import Trainer, feature_args
from ..train.utils import Visualizer
from ..utils import resolve_device
from .eval import load_checkpoint, load_weights

logger = logging.getLogger(__name__)

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
                   help="warm-start the weights from a params.npz, a checkpoint directory "
                        "(model.epoch.N), an expdir (its newest epoch) or a reference .pt")
    p.add_argument("-ios", "--init_optim_state", type=str, default=None,
                   help="restore the optimizer state and global step of a model.epoch.N")
    p.add_argument("-ct", "--continue_training", action="store_true",
                   help="resume from the expdir's newest checkpoint")
    p.add_argument("-tfe", "--from_epoch", type=int, default=0,
                   help="start the epoch counter here")
    p.add_argument("-tfs", "--from_step", type=int, default=0,
                   help="start the scheduler's global step here")
    p.add_argument("-ms", "--mixspeech", action="store_true",
                   help="MixSpeech: mix rows in pairs at Beta(0.5, 0.5)")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help="run the training as a child process and restart it with -ct up to N "
                        "times after a crash")
    p.add_argument("--async-save", action="store_true",
                   help="write checkpoints from a thread (also train.async_save)")
    p.add_argument("--visual", action="store_true",
                   help="write TensorBoard scalars to <expdir>/tb")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of the run to DIR/trace.json")
    p.add_argument("--record", type=str, default=None,
                   help="append one JSON line about this process's run to this file")
    p.add_argument("-l", "--logging_level", type=str, default="INFO")
    p.add_argument("-lg", "--log_file", type=str, default=None)
    p.add_argument("-n", "--ngpu", type=int, default=0,
                   help="data-parallel ranks (0: the cards over tp x pp x ep, at least one)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline degree over a scan_layers transformer encoder's blocks")
    p.add_argument("--pp-schedule", type=str, default=None, choices=("sharded", "1f1b"),
                   help="'sharded' (stage-sharded weights and Adam moments, one device's "
                        "numbers) or '1f1b' (interleaved pipeline with a recomputed backward)")
    p.add_argument("--pp-micro-batches", type=int, default=None,
                   help="microbatches a step for --pp-schedule 1f1b (default: the pp degree)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (must divide encoder.moe_experts)")
    p.add_argument("--multihost", action="store_true",
                   help="join the world torchrun describes in the environment")
    for flags, kind, default in ((("-r", "--local_rank"), int, 0), (("-vb", "--verbose"), int, 0),
                                 (("-ol", "--opt_level"), str, "O1"),
                                 (("-p", "--parallel_mode"), str, "dp"),
                                 (("-g", "--gpus"), str, None)):
        p.add_argument(*flags, type=kind, default=default,
                       help="accepted for reference-CLI parity; ignored")
    return p


def mesh_dims(args, cfg) -> tuple[int, int, int, int] | None:
    """(data, model, pipe, expert) of the run's mesh, after the JAX CLI's
    checks (its messages), or None for a run without parallelism options."""
    if not (args.ngpu or args.multihost or args.pp_schedule
            or args.tp * args.pp * args.ep > 1):
        return None
    if args.ep > 1:
        n_experts = int(cfg["model"].get("encoder", {}).get("moe_experts", 0))
        if n_experts % args.ep != 0:
            raise SystemExit(f"--ep {args.ep} requires encoder.moe_experts "
                             f"divisible by it (got {n_experts})")
    if args.pp > 1:
        enc = cfg["model"].get("encoder", {})
        if (cfg["model"].get("encoder_type", "transformer") != "transformer"
                or not enc.get("scan_layers", False)):
            raise SystemExit("--pp requires a transformer encoder with "
                             "scan_layers: true (stacked layer params)")
        if int(enc.get("n_blocks", 12)) % args.pp != 0:
            raise SystemExit(f"--pp {args.pp} must divide encoder.n_blocks="
                             f"{enc.get('n_blocks', 12)} (else stages would "
                             "silently replicate)")
    rest = args.tp * args.pp * args.ep
    if args.multihost:
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit("--multihost needs torchrun's environment (WORLD_SIZE, RANK, "
                             "MASTER_ADDR, MASTER_PORT)")
        n_data = args.ngpu or max(int(os.environ["WORLD_SIZE"]) // rest, 1)
    else:
        cards = torch.cuda.device_count() if (args.device or "cuda").startswith("cuda") else 1
        n_data = args.ngpu or max(cards // rest, 1)
    return n_data, args.tp, args.pp, args.ep


class DevCerProbe:
    """Greedy-decode CER over the first ``max_batches`` dev batches, after
    every epoch (``make_dev_cer_probe`` of the JAX CLI): one beam-1
    recognizer over the training model with ``max_len = dev_cer_max_len``;
    its greedy step is kernel 1 at k = 1. ``records`` holds, per call, the
    CER, errors, tokens, utterances, greedy steps, kernel-1 launches and
    host seconds. A sharded run's trainer passes its one-card state dict in
    place of the model (``model=None`` here): a one-card model built from
    ``cfg`` decodes it, and is dropped after the call."""

    def __init__(self, cfg: dict, model, dev_loader, device, max_batches: int = 4):
        self.idx2unit = load_idx2unit_map(cfg["data"]["vocab"])
        self.max_len = int(cfg["train"].get("dev_cer_max_len", 32))
        self.model_cfg, self.device = cfg["model"], device
        self.recognizer = None if model is None else self._recognizer(model)
        self.batches = []
        for i, batch in enumerate(dev_loader):
            if i >= max_batches:
                break
            feats, mask, _, _ = feature_args(batch, device)
            self.batches.append((batch[0], feats, mask))
        self.targets_dict = getattr(dev_loader.dataset, "targets_dict", {})
        self.records: list[dict] = []

    def _recognizer(self, model):
        return SpeechToTextRecognizer(model, beam_width=1, max_len=self.max_len,
                                      idx2unit=self.idx2unit)

    def __call__(self, model, epoch: int) -> float:
        recognizer = self.recognizer
        if isinstance(model, dict):  # a sharded run's one-card state
            one_card = build_model(self.model_cfg, dtype=torch.float32, device=self.device)
            one_card.load_state_dict(model)
            recognizer = self._recognizer(one_card.eval())
        elif recognizer is None or model is not recognizer.model:
            raise ValueError("the probe decodes the model it was built with")
        cer = ErrorRateAccumulator()
        n_utts = steps = 0
        launches0 = project_logp_topk.launches
        t0 = time.time()
        for utt_ids, feats, mask in self.batches:
            hyp = recognizer.recognize_arrays(feats, mask)
            # the greedy loop stops once every row has emitted EOS
            steps += min(int(hyp.lengths.max()), self.max_len)
            texts = recognizer.nbest_translate(hyp.tokens[:, :, 1:].cpu().numpy())
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


def supervise(args, argv) -> int:
    """Run the training in a child process; after a non-zero exit, run it
    again with ``-ct`` (from the newest checkpoint, or from the start if
    none was written), up to ``--supervise`` times. Returns the last
    child's exit code."""
    src = list(sys.argv[1:] if argv is None else argv)
    child, skip = [], False
    for a in src:
        if skip:
            skip = False
        elif a == "--supervise":
            skip = True
        elif not a.startswith("--supervise="):
            child.append(a)
    has_ct = bool({"-ct", "--continue_training"} & set(child))
    attempt = 0
    while True:
        cmd = [sys.executable, "-m", "opentransformer_tpu_torch.cli.run", *child]
        if attempt > 0 and not has_ct:
            cmd.append("-ct")
        t0 = time.time()
        rc = subprocess.call(cmd)
        if rc == 0:
            if attempt:
                logger.info("supervised training completed after %d restart(s)", attempt)
            return 0
        attempt += 1
        if attempt > args.supervise:
            logger.error("training failed (rc=%s); restart budget %d spent", rc, args.supervise)
            return rc
        logger.warning("training crashed (rc=%s) after %.0f s; restart %d/%d resumes from the "
                       "newest checkpoint", rc, time.time() - t0, attempt, args.supervise)


def resume(args, trainer: Trainer, ck: Checkpointer, model, device) -> int | None:
    """``-ct`` (the newest checkpoint's weights, optimizer, step and next
    epoch), else ``-im`` and ``-ios``; then ``-tfe`` / ``-tfs``. Returns
    the epoch resumed from, if any."""
    latest = ck.restore_latest() if args.continue_training else None
    resumed = None
    if args.continue_training and (args.init_model or args.init_optim_state):
        logger.warning("-ct takes precedence: -im and -ios are ignored when resuming")
    if latest is not None:
        epoch, path = latest
        load_state(trainer, compat.params_from_jax(ck.load_params(path)))
        load_optimizer(trainer, ck.load_optimizer(path, device))
        trainer.global_epoch = epoch + 1
        trainer.global_step = int(ck.load_extra(path).get("global_step", 1))
        logger.info("resumed from epoch %d (global step %d)", epoch, trainer.global_step)
        resumed = epoch
    elif not args.continue_training:
        if args.init_model:
            state, _ = load_checkpoint(args.init_model, None)
            load_state(trainer, state)
            logger.info("initialized model weights from %s", args.init_model)
        if args.init_optim_state:
            path = args.init_optim_state.rstrip("/")
            src = Checkpointer(os.path.dirname(os.path.abspath(path)))
            load_optimizer(trainer, src.load_optimizer(path, device))
            trainer.global_step = int(src.load_extra(path).get("global_step",
                                                              trainer.global_step))
            logger.info("restored the optimizer state from %s", path)
    if args.from_epoch:
        trainer.global_epoch = args.from_epoch
    if args.from_step:
        trainer.global_step = args.from_step
    return resumed


def load_state(trainer: Trainer, state: dict) -> None:
    """A one-card state dict into the trainer's model (on a mesh each rank
    keeps its slices; a ``ctc`` model leaves a speech2text's decoder out)."""
    if trainer.parallel is None:
        load_weights(trainer.model, state)
        return
    if isinstance(trainer.model, CTCModel):
        state = {k: v for k, v in state.items() if not k.startswith("decoder.")}
    trainer.parallel.load_state(state)


def load_optimizer(trainer: Trainer, state: dict) -> None:
    if trainer.parallel is None:
        trainer.optimizer.load_state_dict(state)
    else:
        trainer.parallel.load_optimizer_state(trainer.optimizer, state)


def write_record(path: str, trainer: Trainer, resumed: int | None, first_step: int,
                 error) -> None:
    """One JSON line about this process's run: the epoch it resumed from
    (or null), its first and next global step, its epochs, micro-batch
    losses, NaN skips and the kernels' launch counts, and the error it
    ended with, if any."""
    history = trainer.history
    rec = {"pid": os.getpid(), "resumed_from": resumed,
           "first_step": first_step, "next_step": trainer.global_step,
           "epochs": sorted({r["epoch"] for r in history}),
           "losses": [x for r in history for x in r["losses"]],
           "nan_skips": trainer.nan_skips,
           "launches": {"fbank_spec_mel": spec_mel.launches,
                        "project_logp_topk": project_logp_topk.launches,
                        "project2_logp_topk": project2_logp_topk.launches},
           "error": None if error is None else f"{type(error).__name__}: {error}"}
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec) + "\n")


def run(argv=None) -> Trainer | None:
    """Parse ``argv``, train, and return the trainer (its ``history``,
    ``dev_losses`` and ``nan_skips`` describe the run;
    ``trainer.dev_probe_fn`` is the ``DevCerProbe``, if any, and
    ``trainer.resident`` the device-resident corpus, if any). A world of
    several local ranks is spawned, and None is returned."""
    args = build_argparser().parse_args(argv)
    _setup_logging(args)
    cfg = load_config(args.config)
    dims = mesh_dims(args, cfg)
    if dims is None:
        return train(args, cfg)
    backend = launch.default_backend(resolve_device(args.device).type)
    world = dims[0] * dims[1] * dims[2] * dims[3]
    if args.multihost:
        local_rank = launch.init_from_env(backend)
        try:
            if dist.get_world_size() != world:
                raise SystemExit(f"the mesh {dims} needs {world} ranks, torchrun started "
                                 f"{dist.get_world_size()}")
            return train(args, cfg, dims, local_rank)
        finally:
            launch.shutdown()
    if world == 1:
        launch.init_single(backend)
        try:
            return train(args, cfg, dims)
        finally:
            launch.shutdown()
    logger.info("spawning %d ranks: data %d x model %d x pipe %d x expert %d (%s)",
                world, *dims, backend)
    launch.spawn(_rank_train, world, args=(args, dims), backend=backend)
    return None


def _setup_logging(args, rank: int = 0) -> None:
    level = getattr(logging, args.logging_level.upper(), logging.INFO)
    logging.basicConfig(level=level if rank == 0 else max(level, logging.WARNING),
                        format="%(asctime)s - %(levelname)s - %(message)s", force=True)
    if args.log_file and rank == 0:
        handler = logging.FileHandler(args.log_file)
        handler.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        logging.getLogger().addHandler(handler)


def _rank_train(rank: int, args, dims) -> None:
    _setup_logging(args, rank)
    train(args, load_config(args.config), dims, rank)


def train(args, cfg, dims=None, local_rank: int = 0) -> Trainer:
    """One process's training: the whole run, or one rank of a mesh of
    ``dims`` (its collectives' world initialized)."""
    model_cfg, data_cfg, train_cfg = cfg["model"], cfg["data"], dict(cfg["train"])
    if args.mixed_precision:
        train_cfg["dtype"] = "bfloat16"
    if args.steps_per_exec:
        train_cfg["steps_per_exec"] = int(args.steps_per_exec)
    if args.pp_schedule:
        train_cfg["pp_schedule"] = args.pp_schedule
    if args.pp_micro_batches:
        train_cfg["pp_micro_batches"] = int(args.pp_micro_batches)
    device = resolve_device(args.device)
    mesh = None
    if dims is not None:
        if device.type == "cuda":
            device = launch.rank_device("cuda", local_rank)
        mesh = make_mesh(*dims)
        logger.info("mesh %s over %d ranks (%s)", mesh.shape, mesh.world, dist.get_backend())
    rank0 = launch.is_rank0()
    expdir = args.expdir or os.path.join("egs_exp", train_cfg.get("save_name", "exp"))
    os.makedirs(expdir, exist_ok=True)
    if rank0:
        shutil.copy(args.config, os.path.join(expdir, os.path.basename(args.config)))

    torch.manual_seed(args.seed)  # the model's initial weights
    # float32 master weights; train.dtype sets the forward's autocast
    model = build_model(model_cfg, dtype=torch.float32, device=device)
    logger.info("model: %d parameters on %s", sum(p.numel() for p in model.parameters()), device)
    # --multihost: each data rank reads its shard of every batch (the JAX
    # CLI's per-host slicing); the ranks of one data index read the same rows
    shard_kw = {}
    if args.multihost and mesh is not None and mesh.size("data") > 1:
        shard_kw = {"num_shards": mesh.size("data"), "shard_id": mesh.index("data")}
    loader = FeatureLoader(cfg, "train", seed=args.seed, **shard_kw)
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
        # a sharded model is probed through a one-card copy made for each call
        sharded = mesh is not None and args.tp * args.pp * args.ep > 1
        probe = DevCerProbe(cfg, None if sharded else model, dev_loader, device,
                            max_batches=int(train_cfg.get("dev_cer_batches", 4)))
        logger.info("per-epoch dev greedy-CER probe enabled")
    ck = Checkpointer(expdir, config=cfg if rank0 else None,
                      async_save=args.async_save or bool(train_cfg.get("async_save", False)))
    trainer = Trainer(
        train_cfg, model, frontend, torch.Generator(device=device).manual_seed(args.seed),
        checkpointer=ck, log_interval=args.log_interval,
        keep_last_n=args.keep_last_n_checkpoints, dev_loader=dev_loader, is_debug=args.debug,
        resident=resident, dev_probe_fn=probe, mixspeech=args.mixspeech,
        visualizer=Visualizer(os.path.join(expdir, "tb")) if args.visual and rank0 else None,
        mesh=mesh, data_shards=bool(shard_kw))
    resumed = resume(args, trainer, ck, model, device)
    first_step, error = trainer.global_step, None
    profiler = None
    if args.profile and rank0:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
    try:
        trainer.train(loader)
    except BaseException as e:
        error = e
        raise
    finally:
        ck.wait()  # never leave a checkpoint half written
        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        if trainer.visualizer is not None:
            trainer.visualizer.close()
        if args.record and rank0:
            write_record(args.record, trainer, resumed, first_step, error)
    return trainer


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.supervise:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s - %(levelname)s - %(message)s", force=True)
        return supervise(args, argv)
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
