"""Decoding CLI (counterpart of ``opentransformer_tpu/cli/eval.py``).

Two sources of weights and data, one of which is given:

  * ``-m`` as the JAX CLI takes it: a training run's expdir (its newest
    ``model.epoch.N``), a checkpoint directory (``model.epoch.N``,
    ``model.average.fromXtoY``) with the run's ``config.json`` beside it,
    or a reference OpenTransformer ``.pt`` (``compat.load_reference_any``;
    ``-c`` then gives the config, else the one embedded in the file). The
    config's ``-d`` split (default ``test``) is read through
    ``FeatureLoader(cfg, split, is_eval=True, batch_size=-b)``, and the
    results go to ``<expdir>/decode_<split>_bw<bw>_pn<pn>_ml<ml>[_lm<lmw>]
    [_<suffix>][_avg<X>-<Y>]``, JAX's name (the directory of the ``.pt`` or
    checkpoint is the expdir);
  * ``--npz`` with ``--model_cfg`` (a JSON model config, an export
    manifest with ``model_cfg``, or a run's ``config.json``), a kaldi
    ``--feats`` scp, ``--text``, ``--vocab`` and ``--decode_dir``: the
    npz export of ``tools/export_trained_synth.py`` or a checkpoint's
    ``params.npz``.

It decodes with batched beam search and writes the JAX CLI's artifacts:
``predict.txt`` (1-best), ``predict.log`` (n-best with scores) and
``RESULT`` (corpus CER, oracle CER, RTF). ``-ns N`` stops after the batch
that reaches N utterances (``-debug`` after the one that reaches 10;
``-pf``, ``-test``, ``-resc`` and ``-rw`` are accepted and ignored, as in
the JAX CLI), ``-sba`` ranks each n-best list by score /
(tokens + 1), ``-ld`` is the length penalty's lamda, ``--profile DIR``
writes a ``torch.profiler`` trace of the decode loop (``DIR/trace.json``)
and the port's spans recorded in it (``DIR/spans.json``, on the host's
``perf_counter_ns`` with ``offset_ns``, the trace's clock minus it).
With ``-lm`` (an npz with ``--lm_cfg``, a training checkpoint directory of
``cli/run.py`` whose run's ``config.json`` sits beside it, or a reference
LM ``.pt``) an external language model (``transformer_lm`` or ``rnn_lm``)
joins the beam by shallow fusion at weight ``-lmw``; ``-lm_resc W`` also
rescores the n-best list by the LM's mean token log-prob; ``-ctcw W``
rescores it jointly with the model's CTC head (a hybrid-trained model such
as the anchor).

A ``ctc`` model config decodes with the CTC head alone: greedy at ``-bw 1``
or ``-md greedy``, else the native prefix beam of width ``-bw`` over each
frame's top ``-prune`` candidates, with ``-nb`` n-best and optional n-gram
fusion (``-ngram ARPA -alpha A -beta B``). Its weights may be a speech2text
checkpoint's (the anchor's): the decoder's arrays are then left out.

A ``transducer`` model config decodes greedily at ``-bw 1`` or ``-md
greedy`` (kernel 1 at k = 1 in every lattice step, at most ``-mt``
emissions a frame) or with the mAES beam of width ``-bw`` (``-nb`` n-best,
an LM fused at ``-lmw``); ``-ml`` caps the tokens an utterance.

    # anchor.sh's decode, on a training run (or -m EXP/model.average.from75to79)
    python -m opentransformer_tpu_torch.cli.eval -m EXP -bw 5 -pn 0.6 -ml 32 -b 100 -d test
    # a reference checkpoint, with a config whose data section names the split
    python -m opentransformer_tpu_torch.cli.eval -m model.epoch.79.pt -c CONF.json -d test
    # an npz export
    python -m opentransformer_tpu_torch.cli.eval \\
        --npz egs/synth_bench/trained/anchor_synth_f16.npz \\
        --model_cfg egs/synth_bench/trained/anchor_synth_f16.manifest.json \\
        --feats DATA/test/feats.scp --text DATA/test/text --vocab DATA/vocab \\
        -b 100 -bw 5 -pn 0.6 -ml 32 --decode_dir OUT
    # with LM shallow fusion
    python -m opentransformer_tpu_torch.cli.eval ... -lm LM.npz --lm_cfg LM.json -lmw 0.1
    python -m opentransformer_tpu_torch.cli.eval ... -lm LM_EXP/model.epoch.0 -lmw 0.1
    python -m opentransformer_tpu_torch.cli.eval ... -lm lm.epoch.9.pt -lmw 0.1
    # joint CTC/attention rescoring
    python -m opentransformer_tpu_torch.cli.eval ... -ctcw 0.3
    # the anchor's CTC head as a ctc model (CTC.json: type ctc, the anchor's
    # frontend and encoder sections, vocab_size 4233), greedy or prefix beam 5
    python -m opentransformer_tpu_torch.cli.eval --model_cfg CTC.json ... -md greedy
    python -m opentransformer_tpu_torch.cli.eval --model_cfg CTC.json ... -bw 5 -prune 32

``--online`` decodes each utterance as a stream, fed chunk by chunk
through the streamed encode (a chunked-attention model with a conv
frontend): greedy frame-synchronous CTC for a ``ctc`` model, the resumed
greedy lattice walk for a ``transducer``, the incremental beam re-decode
for ``speech2text`` (``recognize/online.py``).
``--long_form`` encodes inputs longer than ``--window`` frames in
overlapping windows with ``--context`` frames each side
(``recognize/streaming.py``; ``speech2text`` only, other models decode
offline with a warning). ``-p2w`` joins sentencepiece pieces in the output.
``-n N`` decodes on N ranks (``parallel/launch.py``, one process a card,
cards shared round-robin when there are fewer): the rows of each batch are
split over them, the weights whole on each; a batch they do not divide is
decoded whole by rank 0, and rank 0 gathers the n-best lists in the
loader's order and writes the files, which are a one-rank decode's (the
timings aside). With ``--online`` / ``--long_form``, ``-n`` is ignored with
a warning.

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import compat, profiling
from ..config import load_config
from ..data import UNK, load_idx2unit_map, load_vocab
from ..data.kaldi_io import load_mat, read_scp
from ..data.loader import FeatureLoader
from ..models.registry import build_model
from ..models.speech2text import CTCModel
from ..parallel import launch
from ..train.checkpoint import Checkpointer
from ..ops.levenshtein import ErrorRateAccumulator, edit_distances
from ..ops.project_topk import project2_logp_topk, project_logp_topk
from ..recognize.base import build_recognizer, lm_rescore
from ..utils import resolve_device

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRAME_PAD_MULTIPLE = 32


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Decode with a trained model on the port")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-m", "--load_model",
                     help="expdir, checkpoint directory (model.epoch.N / "
                          "model.average.fromXtoY) or reference .pt")
    src.add_argument("--npz",
                     help="flattened npz of the JAX-layout params (an export, or params.npz of "
                          "a training checkpoint); needs --model_cfg, --feats, --text, --vocab "
                          "and --decode_dir")
    p.add_argument("-c", "--config", default=None,
                   help="JSON run config for -m (default: the run's config.json, or the one "
                        "embedded in a .pt)")
    p.add_argument("-d", "--decode_set", default="test", help="the config's split to decode (-m)")
    p.add_argument("--model_cfg", default=None,
                   help="--npz: JSON model config, an export manifest with a model_cfg key, or "
                        "a training run's config.json")
    p.add_argument("--feats", default=None, help="--npz: kaldi feats.scp")
    p.add_argument("--text", default=None, help="--npz: reference transcripts (utt unit ...)")
    p.add_argument("--vocab", default=None, help="--npz: 'unit idx' vocab file")
    p.add_argument("--decode_dir", default=None,
                   help="output directory (--npz; with -m it replaces JAX's name under the "
                        "expdir)")
    p.add_argument("-b", "--batch_size", type=int, default=None,
                   help="utterances a batch (default: the config's data.batch_size with -m, "
                        "16 with --npz)")
    p.add_argument("-bw", "--beam_width", type=int, default=5,
                   help="attention beam width; for a ctc model the prefix-beam width, for a "
                        "transducer the mAES beam width (1: greedy)")
    p.add_argument("-nb", "--nbest", type=int, default=1,
                   help="n-best size of the CTC prefix beam and of the transducer beam")
    p.add_argument("-pn", "--penalty", type=float, default=0.6)
    p.add_argument("-ld", "--lamda", type=float, default=5.0,
                   help="length penalty ((lamda + len) / (lamda + 1)) ** penalty")
    p.add_argument("-ml", "--max_len", type=int, default=100,
                   help="most decode steps (speech2text) or tokens an utterance (transducer)")
    p.add_argument("-md", "--mode", default="beam", choices=["beam", "greedy"],
                   help="'greedy' sets the beam width to 1")
    p.add_argument("-ctcw", "-cw", "--ctc_weight", type=float, default=0.0,
                   help="joint CTC/attention n-best rescoring weight (the model needs a CTC "
                        "head: trained with ctc_weight > 0)")
    p.add_argument("-ngram", "--ngram_lm", default=None,
                   help="n-gram LM for the CTC prefix beam (ARPA text, .otbin cache or "
                        "KenLM probing binary)")
    p.add_argument("-alpha", "--alpha", type=float, default=0.1,
                   help="n-gram LM weight (CTC prefix beam)")
    p.add_argument("-beta", "--beta", type=float, default=0.0,
                   help="insertion bonus (CTC prefix beam)")
    p.add_argument("-prune", "--prune_k", type=int, default=32,
                   help="candidates per frame for the CTC prefix beam, taken on the device")
    p.add_argument("-lm", "--load_language_model", default=None,
                   help="flattened npz of an LM's JAX params (needs --lm_cfg), a training "
                        "checkpoint directory (model.epoch.N) of cli/run.py (its run's "
                        "config.json is read), or a reference LM .pt")
    p.add_argument("--lm_cfg", default=None,
                   help="JSON config of the LM (type transformer_lm or rnn_lm), or a "
                        "manifest with a model_cfg key (default with a directory -lm: the "
                        "run's config.json)")
    p.add_argument("-lmw", "--lm_weight", type=float, default=0.1,
                   help="shallow-fusion weight of the LM's log-probs in the beam")
    p.add_argument("-lm_resc", "--lm_rescore_weight", type=float, default=0.0,
                   help="post-beam n-best LM rescoring weight (0: off)")
    p.add_argument("-mt", "--max_tokens_per_chunk", type=int, default=8,
                   help="transducer: max emissions per encoder frame")
    p.add_argument("-p2w", "--piece2word", action="store_true",
                   help="join sentencepiece pieces: strip spaces, '\u2581' -> space")
    p.add_argument("--online", action="store_true",
                   help="streaming decode over a chunked-attention encoder: frame-synchronous "
                        "for ctc and transducer, incremental beam re-decode for speech2text")
    p.add_argument("--long_form", action="store_true",
                   help="windowed encoding for long audio (speech2text)")
    p.add_argument("--window", type=int, default=1200, help="long-form window frames")
    p.add_argument("--context", type=int, default=200, help="long-form context frames")
    p.add_argument("-sba", "--sort_by_avg_score", action="store_true",
                   help="rank each n-best list by score / (tokens + 1) instead of score")
    p.add_argument("-ns", "--num_sample", type=int, default=0,
                   help="stop after the batch that reaches this many utterances (0: all)")
    p.add_argument("-debug", "--debug", action="store_true",
                   help="stop after the batch that reaches 10 utterances")
    p.add_argument("-pf", "--path_fusion", action="store_true",
                   help="accepted for reference-CLI parity (transducer path fusion was "
                        "vestigial upstream); ignored")
    p.add_argument("-test", "--test", action="store_true",
                   help="accepted for reference-CLI parity; ignored")
    p.add_argument("-resc", "--apply_rescoring", action="store_true",
                   help="accepted for parity; use -ctcw for working joint CTC/attention "
                        "rescoring")
    p.add_argument("-rw", "--rescore_weight", type=float, default=1.0,
                   help="accepted for parity (see -ctcw / -lm_resc)")
    p.add_argument("-s", "--suffix", default=None, help="appended to the decode directory's name")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of the decode loop to DIR/trace.json "
                        "and the port's spans to DIR/spans.json")
    p.add_argument("-n", "--ngpu", type=int, default=1,
                   help="ranks to decode on (one process a card, the rows of each batch "
                        "split over them; a card is shared when there are fewer)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--record", default=None,
                   help="append one JSON line a rank (its rank, rows decoded and kernel "
                        "launches) to this file")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p


LANG_TAGS = ("<PESN>", "<VIET>", "<SWAH>")


def postprocess(text: str, piece2word: bool = False) -> str:
    """Output-side text normalization: language tags stripped, and with
    ``piece2word`` sentencepiece pieces joined (spaces dropped, '\u2581' →
    space)."""
    for tag in LANG_TAGS:
        text = text.replace(tag, " ")
    if piece2word:
        text = text.replace(" ", "").replace("\u2581", " ").strip()
    return " ".join(text.split())


def model_section(cfg: dict) -> dict:
    """The model section of a model config, of an export manifest
    (``model_cfg``) or of a run config (``model``)."""
    if "model_cfg" in cfg:
        return cfg["model_cfg"]
    if "type" not in cfg and "model" in cfg:
        return cfg["model"]
    return cfg


def load_model_cfg(path: str) -> dict:
    """``model_section`` of a JSON file: a model config, an export manifest
    or a training run's ``config.json``."""
    with open(path, encoding="utf-8") as f:
        return model_section(json.load(f))


def load_checkpoint(path: str, model_cfg: dict | None = None) -> tuple[dict, dict | None]:
    """(the port's state dict, the run's config or None) of ``-m`` / ``-lm``:
    a reference ``.pt`` (its embedded config; ``model_cfg`` overrides the
    embedded model section for the conversion), a checkpoint directory
    ``model.*`` (its run's ``config.json`` beside it), an expdir (its newest
    ``model.epoch.N``) or an npz (no config)."""
    path = path.rstrip("/")
    if path.endswith(".pt"):
        if not os.path.isfile(path):
            raise SystemExit(f"error: checkpoint file not found: {path}")
        state, cfg = compat.load_reference_any(path, model_cfg)
        return state, (cfg or None)
    if path.endswith(".npz"):
        return compat.params_from_jax(compat.load_npz(path)), None
    if os.path.basename(path).startswith("model."):
        if not os.path.isdir(path):
            raise SystemExit(f"error: checkpoint directory not found: {path}")
        ck = Checkpointer(os.path.dirname(os.path.abspath(path)))
    else:
        ck = Checkpointer(path)
        epochs = ck.list_epochs()
        if not epochs:
            raise SystemExit(f"error: no model.epoch.N checkpoints under {path}")
        path = ck.epoch_path(epochs[-1])
    return compat.params_from_jax(ck.load_params(path)), ck.load_config()


def load_weights(model, state: dict):
    """Strict load of a port state dict; a ``ctc`` model takes a hybrid
    speech2text's without its ``decoder`` scope."""
    if isinstance(model, CTCModel):
        state = {k: v for k, v in state.items() if not k.startswith("decoder.")}
    model.load_state_dict(state, strict=True)
    return model


def load_lm(path: str, lm_cfg: str | None, dtype, device):
    """The ``-lm`` model: an npz with ``--lm_cfg``, a checkpoint directory
    with its run's ``config.json`` (``--lm_cfg`` overrides it), or a
    reference LM ``.pt`` with its embedded config."""
    state, cfg = load_checkpoint(path)
    if lm_cfg:
        cfg = load_model_cfg(lm_cfg)
    elif cfg is None:
        raise SystemExit(f"error: no config comes with -lm {path}; pass --lm_cfg (the LM's "
                         "JSON config)")
    return load_weights(build_model(model_section(cfg), dtype=dtype, device=device), state)


def load_model_and_lm(load_model: str, config: str | None = None,
                      load_language_model: str | None = None, lm_cfg: str | None = None,
                      dtype=torch.float32, device=None):
    """The loading path of the eval and serve CLIs' ``-m``: (model, run
    config, LM or None). The config is ``-c`` if given, else the one the
    checkpoint carries."""
    dev = resolve_device(device)
    cfg = load_config(config) if config else None
    state, embedded = load_checkpoint(load_model, cfg["model"] if cfg else None)
    cfg = cfg or embedded
    if cfg is None:
        raise SystemExit(f"error: no config comes with {load_model}; pass -c")
    model = load_weights(build_model(cfg["model"], dtype=dtype, device=dev), state)
    lm = None
    if load_language_model:
        lm = load_lm(load_language_model, lm_cfg, dtype, dev)
    return model, cfg, lm


def decode_dir_name(args) -> str:
    """JAX's decode directory for ``-m``: under the expdir (the directory
    of a checkpoint or a .pt), named from the flags."""
    name = f"decode_{args.decode_set}_bw{args.beam_width}_pn{args.penalty}_ml{args.max_len}"
    if args.load_language_model:
        name += f"_lm{args.lm_weight}"
    if args.suffix:
        name += f"_{args.suffix}"
    base = os.path.basename(args.load_model.rstrip("/"))
    m = re.search(r"from(\d+)to(\d+)", base)
    if m:
        name += f"_avg{m.group(1)}-{m.group(2)}"
    expdir = args.load_model.rstrip("/")
    if base.startswith("model.") or expdir.endswith(".pt"):
        expdir = os.path.dirname(expdir)
    return os.path.join(expdir, name)


def read_text(path: str) -> dict[str, list[str]]:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def collate(mats: list[np.ndarray]):
    """Zero-pad features to the batch maximum, rounded up to a multiple of
    32 frames → (float32 [B, T, F], bool [B, T], frame counts)."""
    lens = [m.shape[0] for m in mats]
    t = -(-max(lens) // FRAME_PAD_MULTIPLE) * FRAME_PAD_MULTIPLE
    x = np.zeros((len(mats), t, mats[0].shape[1]), np.float32)
    mask = np.zeros((len(mats), t), bool)
    for i, m in enumerate(mats):
        x[i, : lens[i]] = m
        mask[i, : lens[i]] = True
    return x, mask, lens


def npz_batches(args, idx2unit):
    """The ``--npz`` source: (utt ids, features, mask, frames, reference
    texts) of each ``-b`` utterances of ``--feats``, in scp order."""
    unit2idx = load_vocab(args.vocab)
    scp = list(read_scp(args.feats).items())
    refs = read_text(args.text)
    for s in range(0, len(scp), args.batch_size or 16):
        chunk = scp[s : s + (args.batch_size or 16)]
        x, mask, lens = collate([load_mat(rx) for _, rx in chunk])
        texts = [" ".join(idx2unit.get(unit2idx.get(u, UNK), "<UNK>") for u in refs.get(utt, []))
                 for utt, _ in chunk]
        yield [utt for utt, _ in chunk], x, mask, sum(lens), texts


def split_batches(loader, idx2unit):
    """The ``-m`` source: the config split's batches through its loader,
    with the reference texts of their target ids."""
    targets = getattr(loader.dataset, "targets_dict", {})
    for utt_ids, inputs, _ in loader:
        texts = [" ".join(idx2unit.get(t, "<UNK>") for t in targets.get(utt, []))
                 for utt in utt_ids]
        yield (list(utt_ids), inputs["inputs"], inputs["mask"],
               int(np.sum(inputs["inputs_length"])), texts)


def _decode_rows(recognize, x, mask, rank: int, world: int):
    """One batch over the ranks: each decodes its contiguous rows (rank 0
    the whole batch when the ranks do not divide it), and rank 0 gathers
    the (texts, scores) in row order (None elsewhere)."""
    b = len(x)
    if b % world:
        part = recognize(x, mask) if rank == 0 else ([], [])
    else:
        per = b // world
        rows = slice(rank * per, (rank + 1) * per)
        texts, scores = recognize(x[rows], mask[rows])
        part = (list(texts), [np.asarray(sc) for sc in scores])
    parts = [None] * world if rank == 0 else None
    dist.gather_object(part, parts, dst=0)
    if rank:
        return None, None
    return ([t for p in parts for t in p[0]], [sc for p in parts for sc in p[1]])


def sort_by_avg_score(texts: list, scores):
    """An n-best list ranked by score / (tokens + 1) (the reference's -sba)."""
    order = sorted(range(len(texts)), key=lambda k: -scores[k] / max(len(texts[k].split()) + 1, 1))
    return [texts[k] for k in order], np.asarray([scores[k] for k in order])


DEBUG_UTTS = 10  # -debug stops after the batch that reaches this many


def stop_after(args, n_decoded: int) -> bool:
    """Whether ``-ns`` or ``-debug`` ends the decode after this batch."""
    return bool((args.num_sample and n_decoded >= args.num_sample)
                or (args.debug and n_decoded >= DEBUG_UTTS))


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    if args.npz:
        missing = [f for f in ("model_cfg", "feats", "text", "vocab", "decode_dir")
                   if getattr(args, f) is None]
        if missing:
            parser.error("--npz needs " + ", ".join("--" + f for f in missing))
    lm_path = args.load_language_model
    if lm_path and not (args.lm_cfg or os.path.isdir(lm_path) or lm_path.endswith(".pt")):
        raise SystemExit("error: -lm with an npz needs --lm_cfg (the LM's JSON config)")
    if args.mode == "greedy":
        args.beam_width = 1
    if args.ngpu > 1 and (args.online or args.long_form):
        logger.warning("-n %d is ignored with --online/--long_form (sequential session "
                       "decode); using one card", args.ngpu)
    elif args.ngpu > 1:
        resolve_device(args.device)  # no card: raise here, not in every rank
        # the ranks exchange host objects only (the n-best lists): Gloo
        launch.spawn(_rank_decode, args.ngpu, args=(args,), backend="gloo")
        return 0
    return decode(args)


def _rank_decode(rank: int, args) -> None:
    if rank:
        logging.getLogger().setLevel(logging.WARNING)
    decode(args, rank, args.ngpu)


def decode(args, rank: int = 0, world: int = 1) -> int:
    """Decode and score (``main`` after its checks). With ``world`` > 1
    this is one rank: it decodes its contiguous rows of each batch (a batch
    the ranks do not divide is decoded whole by rank 0), and rank 0 gathers
    the n-best lists in the loader's order and writes the files, which are
    then those of a one-rank decode."""
    dev = resolve_device(args.device)
    if dev.type == "cuda" and world > 1:
        dev = launch.rank_device("cuda", rank)
    dtype = DTYPES[args.dtype]
    if args.npz:
        model_cfg = load_model_cfg(args.model_cfg)
        model = load_weights(build_model(model_cfg, dtype=dtype, device=dev),
                             compat.params_from_jax(compat.load_npz(args.npz)))
        lm = None
        if args.load_language_model:
            lm = load_lm(args.load_language_model, args.lm_cfg, dtype, dev)
        idx2unit = load_idx2unit_map(args.vocab)
        batches = npz_batches(args, idx2unit)
        decode_dir = args.decode_dir
    else:
        model, cfg, lm = load_model_and_lm(args.load_model, args.config,
                                           args.load_language_model, args.lm_cfg, dtype, dev)
        model_cfg = cfg["model"]
        idx2unit = load_idx2unit_map(cfg["data"]["vocab"])
        loader = FeatureLoader(cfg, args.decode_set, is_eval=True, batch_size=args.batch_size)
        batches = split_batches(loader, idx2unit)
        decode_dir = args.decode_dir or decode_dir_name(args)
    model_type = model_cfg["type"]
    long_form = args.long_form and model_type == "speech2text"
    if args.long_form and not long_form:
        logger.warning("--long_form only applies to speech2text models; decoding offline")
    if args.online:
        from ..recognize.online import OnlineRecognizerAdapter

        recognizer = OnlineRecognizerAdapter(
            model_type, model, idx2unit=idx2unit, max_per_frame=args.max_tokens_per_chunk,
            beam_width=args.beam_width, max_len=args.max_len, penalty=args.penalty,
            lamda=args.lamda)
    elif long_form:
        from ..recognize.streaming import LongFormRecognizer

        recognizer = LongFormRecognizer(
            model, lm=lm, beam_width=args.beam_width, max_len=args.max_len,
            penalty=args.penalty, lamda=args.lamda, lm_weight=args.lm_weight,
            idx2unit=idx2unit, window=args.window, context=args.context)
    else:
        recognizer = build_recognizer(model_type, model, lm=lm, args=vars(args),
                                      idx2unit=idx2unit)
    if rank == 0:
        os.makedirs(decode_dir, exist_ok=True)

    profiler = None
    if args.profile and rank == 0:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        marker_ns = profiling.mark_clock(dev)
    def recognize(x, mask):
        feats = torch.as_tensor(x).to(dev)
        feat_mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
        if (args.lm_rescore_weight > 0.0 and lm is not None and model_type == "speech2text"
                and not args.online):
            hyp = lm_rescore(lm, recognizer.recognize_arrays(feats, feat_mask),
                             args.lm_rescore_weight)
            texts = recognizer.nbest_translate(hyp.tokens[:, :, 1:].cpu().numpy())
            return texts, hyp.scores.float().cpu().numpy()
        return recognizer.recognize(feats, feat_mask)

    cer, oracle = ErrorRateAccumulator(), ErrorRateAccumulator()
    accu_time, total_frames, n_decoded, rows = 0.0, 0, 0, 0
    launches0 = (project_logp_topk.launches, project2_logp_topk.launches)
    with contextlib.ExitStack() as files:
        if rank == 0:
            ftxt = files.enter_context(open(os.path.join(decode_dir, "predict.txt"), "w",
                                            encoding="utf-8"))
            flog = files.enter_context(open(os.path.join(decode_dir, "predict.log"), "w",
                                            encoding="utf-8"))
        for utt_ids, x, mask, frames, ref_texts in batches:
            t0 = time.time()
            if world == 1:
                texts, scores = recognize(x, mask)
            else:
                texts, scores = _decode_rows(recognize, x, mask, rank, world)
            accu_time += time.time() - t0
            b = len(utt_ids)  # this rank's rows of the batch (_decode_rows)
            if world == 1 or b % world == 0:
                rows += b // world
            elif rank == 0:
                rows += b
            if rank:
                n_decoded += len(utt_ids)
                if stop_after(args, n_decoded):
                    break
                continue
            total_frames += frames
            scores = [np.asarray(sc, dtype=np.float64) for sc in scores]
            for i, utt in enumerate(utt_ids):
                texts[i] = [postprocess(h, args.piece2word) for h in texts[i]]
                if args.sort_by_avg_score and len(texts[i]) > 1:
                    texts[i], scores[i] = sort_by_avg_score(texts[i], scores[i])
                best = texts[i][0]
                ftxt.write(f"{utt} {best}\n")
                ref = postprocess(ref_texts[i], args.piece2word).split()
                dists = edit_distances(ref, [h.split() for h in texts[i]])
                cer.update(ref, best.split())
                oracle.update(ref, texts[i][int(np.argmin(dists))].split())
                for k, (h, sc) in enumerate(zip(texts[i], scores[i])):
                    flog.write(f"{utt} nbest{k} score={float(sc):.4f} {h}\n")
                n_decoded += 1
            logger.info("decoded %d utts, CER %.2f%%", n_decoded, cer.rate * 100)
            if stop_after(args, n_decoded):
                break
    if args.record:
        with open(args.record, "a", encoding="utf-8") as f:
            f.write(json.dumps({"rank": rank, "rows": rows, "launches": {
                "project_logp_topk": project_logp_topk.launches - launches0[0],
                "project2_logp_topk": project2_logp_topk.launches - launches0[1]}}) + "\n")
    if rank:
        return 0
    if profiler is not None:
        profiling.synchronize(dev)
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        profiling.write_spans(os.path.join(args.profile, "spans.json"),
                              profiling.clock_offset_ns(profiler, marker_ns, dev))
        logger.info("profiler trace and spans written to %s", args.profile)

    # RTF: frames are 10 ms each
    rtf = accu_time / max(total_frames, 1) * 100
    with open(os.path.join(decode_dir, "RESULT"), "w", encoding="utf-8") as f:
        f.write(f"CER {cer.rate * 100:.2f}% ({cer.errors}/{cer.tokens})\n")
        f.write(f"ORACLE_CER {oracle.rate * 100:.2f}%\n")
        f.write(f"RTF {rtf:.6f}\n")
        f.write(f"UTTS {n_decoded} DECODE_SECONDS {accu_time:.3f}\n")
    logger.info("CER %.2f%% | oracle %.2f%% | RTF %.4f | results in %s",
                cer.rate * 100, oracle.rate * 100, rtf, decode_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
