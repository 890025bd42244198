"""Decoding CLI (counterpart of ``opentransformer_tpu/cli/eval.py``).

Loads an npz export of JAX-trained weights (``tools/export_trained_synth.py``
format) with its model config (a JSON file, or an export manifest carrying
``model_cfg``), decodes a kaldi feature scp with batched beam search and
writes the JAX CLI's artifacts into ``--decode_dir``: ``predict.txt``
(1-best), ``predict.log`` (n-best with scores) and ``RESULT`` (corpus CER,
oracle CER, RTF). With ``-lm LM.npz --lm_cfg LM.json``, or ``-lm`` and a
training checkpoint directory of ``cli/run.py`` (``model.epoch.N``, whose
run's ``config.json`` sits beside it), an external language model
(``transformer_lm`` or ``rnn_lm``) joins the beam by shallow fusion at
weight ``-lmw``;
``-lm_resc W`` also rescores the n-best list by the LM's mean token
log-prob; ``-ctcw W`` rescores it jointly with
the model's CTC head (a hybrid-trained model such as the anchor).

A ``ctc`` model config decodes with the CTC head alone: greedy at ``-bw 1``
or ``-md greedy``, else the native prefix beam of width ``-bw`` over each
frame's top ``-prune`` candidates, with ``-nb`` n-best and optional n-gram
fusion (``-ngram ARPA -alpha A -beta B``). Its weights may be a speech2text
npz (the anchor's): the decoder's arrays are then left out.

A ``transducer`` model config decodes greedily at ``-bw 1`` or ``-md
greedy`` (kernel 1 at k = 1 in every lattice step, at most ``-mt``
emissions a frame) or with the mAES beam of width ``-bw`` (``-nb`` n-best,
an LM fused at ``-lmw``); ``-ml`` caps the tokens an utterance.

    python -m opentransformer_tpu_torch.cli.eval \\
        --npz egs/synth_bench/trained/anchor_synth_f16.npz \\
        --model_cfg egs/synth_bench/trained/anchor_synth_f16.manifest.json \\
        --feats DATA/test/feats.scp --text DATA/test/text --vocab DATA/vocab \\
        -b 100 -bw 5 -pn 0.6 -ml 32 --decode_dir OUT

    # with LM shallow fusion
    python -m opentransformer_tpu_torch.cli.eval ... -lm LM.npz --lm_cfg LM.json -lmw 0.1
    python -m opentransformer_tpu_torch.cli.eval ... -lm LM_EXP/model.epoch.0 -lmw 0.1
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

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from ..compat import load_ctc_from_speech2text, load_into, load_npz
from ..data import UNK, load_idx2unit_map, load_vocab
from ..data.kaldi_io import load_mat, read_scp
from ..models.registry import build_model
from ..ops.levenshtein import ErrorRateAccumulator, edit_distances
from ..recognize.base import build_recognizer, lm_rescore
from ..utils import resolve_device

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRAME_PAD_MULTIPLE = 32


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Decode with JAX-trained weights on the port")
    p.add_argument("--npz", required=True,
                   help="flattened npz of the JAX params (an export, or params.npz of a "
                        "training checkpoint)")
    p.add_argument("--model_cfg", required=True,
                   help="JSON model config, an export manifest with a model_cfg key, or a "
                        "training run's config.json")
    p.add_argument("--feats", required=True, help="kaldi feats.scp")
    p.add_argument("--text", required=True, help="reference transcripts (utt unit unit ...)")
    p.add_argument("--vocab", required=True, help="'unit idx' vocab file")
    p.add_argument("--decode_dir", required=True, help="output directory")
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-bw", "--beam_width", type=int, default=5,
                   help="attention beam width; for a ctc model the prefix-beam width, for a "
                        "transducer the mAES beam width (1: greedy)")
    p.add_argument("-nb", "--nbest", type=int, default=1,
                   help="n-best size of the CTC prefix beam and of the transducer beam")
    p.add_argument("-pn", "--penalty", type=float, default=0.6)
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
                   help="flattened npz of an LM's JAX params (needs --lm_cfg), or a training "
                        "checkpoint directory (model.epoch.N) of cli/run.py (its run's "
                        "config.json is read)")
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
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
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


def load_model_cfg(path: str) -> dict:
    """The model section of a JSON model config, of an export manifest
    (``model_cfg``) or of a training run's ``config.json`` (``model``)."""
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    if "model_cfg" in cfg:
        return cfg["model_cfg"]
    if "type" not in cfg and "model" in cfg:
        return cfg["model"]
    return cfg


def lm_checkpoint(path: str, lm_cfg: str | None) -> tuple[str, str]:
    """(params npz, config path) of ``-lm``: an npz with ``--lm_cfg``, or a
    checkpoint directory ``model.*`` with its run's ``config.json`` beside
    it (``--lm_cfg`` overrides that)."""
    if not os.path.isdir(path):
        if not lm_cfg:
            raise SystemExit("error: -lm with an npz needs --lm_cfg (the LM's JSON config)")
        return path, lm_cfg
    cfg = lm_cfg or os.path.join(os.path.dirname(os.path.abspath(path)), "config.json")
    if not os.path.exists(cfg):
        raise SystemExit(f"error: no config.json beside {path}; pass --lm_cfg")
    return os.path.join(path, "params.npz"), cfg


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


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    lm_npz = lm_cfg = None
    if args.load_language_model:
        lm_npz, lm_cfg = lm_checkpoint(args.load_language_model, args.lm_cfg)
    if args.mode == "greedy":
        args.beam_width = 1
    dev = resolve_device(args.device)
    model_cfg = load_model_cfg(args.model_cfg)
    model_type = model_cfg["type"]
    model = build_model(model_cfg, dtype=DTYPES[args.dtype], device=dev)
    tree = load_npz(args.npz)
    if model_type == "ctc" and "decoder" in tree.get("params", tree):
        load_ctc_from_speech2text(model, tree)
    else:
        load_into(model, tree)
    lm = None
    if lm_npz is not None:
        lm = build_model(load_model_cfg(lm_cfg), dtype=DTYPES[args.dtype], device=dev)
        load_into(lm, load_npz(lm_npz))

    unit2idx = load_vocab(args.vocab)
    idx2unit = load_idx2unit_map(args.vocab)
    long_form = args.long_form and model_type == "speech2text"
    if args.long_form and not long_form:
        logger.warning("--long_form only applies to speech2text models; decoding offline")
    if args.online:
        from ..recognize.online import OnlineRecognizerAdapter

        recognizer = OnlineRecognizerAdapter(
            model_type, model, idx2unit=idx2unit, max_per_frame=args.max_tokens_per_chunk,
            beam_width=args.beam_width, max_len=args.max_len, penalty=args.penalty)
    elif long_form:
        from ..recognize.streaming import LongFormRecognizer

        recognizer = LongFormRecognizer(
            model, lm=lm, beam_width=args.beam_width, max_len=args.max_len,
            penalty=args.penalty, lm_weight=args.lm_weight, idx2unit=idx2unit,
            window=args.window, context=args.context)
    else:
        recognizer = build_recognizer(model_type, model, lm=lm, args=vars(args),
                                      idx2unit=idx2unit)
    scp = list(read_scp(args.feats).items())
    refs = read_text(args.text)
    os.makedirs(args.decode_dir, exist_ok=True)

    cer, oracle = ErrorRateAccumulator(), ErrorRateAccumulator()
    accu_time, total_frames, n_decoded = 0.0, 0, 0
    with open(os.path.join(args.decode_dir, "predict.txt"), "w", encoding="utf-8") as ftxt, \
            open(os.path.join(args.decode_dir, "predict.log"), "w", encoding="utf-8") as flog:
        for s in range(0, len(scp), args.batch_size):
            chunk = scp[s : s + args.batch_size]
            x, mask, lens = collate([load_mat(rx) for _, rx in chunk])
            t0 = time.time()
            feats, feat_mask = torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev)
            if (args.lm_rescore_weight > 0.0 and lm is not None and model_type == "speech2text"
                    and not args.online):
                hyp = lm_rescore(lm, recognizer.recognize_arrays(feats, feat_mask),
                                 args.lm_rescore_weight)
                texts = recognizer.nbest_translate(hyp.tokens[:, :, 1:].cpu().numpy())
                scores = hyp.scores.float().cpu().numpy()
            else:
                texts, scores = recognizer.recognize(feats, feat_mask)
            accu_time += time.time() - t0
            total_frames += sum(lens)
            for i, (utt, _) in enumerate(chunk):
                texts[i] = [postprocess(h, args.piece2word) for h in texts[i]]
                best = texts[i][0]
                ftxt.write(f"{utt} {best}\n")
                ref = postprocess(" ".join(idx2unit.get(unit2idx.get(u, UNK), "<UNK>")
                                           for u in refs.get(utt, [])), args.piece2word).split()
                dists = edit_distances(ref, [h.split() for h in texts[i]])
                cer.update(ref, best.split())
                oracle.update(ref, texts[i][int(np.argmin(dists))].split())
                for k, (h, sc) in enumerate(zip(texts[i], scores[i])):
                    flog.write(f"{utt} nbest{k} score={float(sc):.4f} {h}\n")
                n_decoded += 1
            logger.info("decoded %d utts, CER %.2f%%", n_decoded, cer.rate * 100)

    # RTF: frames are 10 ms each
    rtf = accu_time / max(total_frames, 1) * 100
    with open(os.path.join(args.decode_dir, "RESULT"), "w", encoding="utf-8") as f:
        f.write(f"CER {cer.rate * 100:.2f}% ({cer.errors}/{cer.tokens})\n")
        f.write(f"ORACLE_CER {oracle.rate * 100:.2f}%\n")
        f.write(f"RTF {rtf:.6f}\n")
        f.write(f"UTTS {n_decoded} DECODE_SECONDS {accu_time:.3f}\n")
    logger.info("CER %.2f%% | oracle %.2f%% | RTF %.4f | results in %s",
                cer.rate * 100, oracle.rate * 100, rtf, args.decode_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
