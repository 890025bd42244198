"""Decoding CLI (counterpart of ``opentransformer_tpu/cli/eval.py``).

Loads an npz export of JAX-trained weights (``tools/export_trained_synth.py``
format) with its model config (a JSON file, or an export manifest carrying
``model_cfg``), decodes a kaldi feature scp with batched beam search and
writes the JAX CLI's artifacts into ``--decode_dir``: ``predict.txt``
(1-best), ``predict.log`` (n-best with scores) and ``RESULT`` (corpus CER,
oracle CER, RTF).

    python -m opentransformer_tpu_torch.cli.eval \\
        --npz egs/synth_bench/trained/anchor_synth_f16.npz \\
        --model_cfg egs/synth_bench/trained/anchor_synth_f16.manifest.json \\
        --feats DATA/test/feats.scp --text DATA/test/text --vocab DATA/vocab \\
        -b 100 -bw 5 -pn 0.6 -ml 32 --decode_dir OUT

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

from ..compat import load_into, load_npz
from ..data import UNK, load_idx2unit_map, load_vocab
from ..data.kaldi_io import load_mat, read_scp
from ..models.registry import build_model
from ..ops.levenshtein import ErrorRateAccumulator, edit_distances
from ..recognize.base import SpeechToTextRecognizer
from ..utils import resolve_device

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRAME_PAD_MULTIPLE = 32


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Decode with JAX-trained weights on the port")
    p.add_argument("--npz", required=True, help="flattened float16 npz of the JAX params")
    p.add_argument("--model_cfg", required=True,
                   help="JSON model config, or an export manifest with a model_cfg key")
    p.add_argument("--feats", required=True, help="kaldi feats.scp")
    p.add_argument("--text", required=True, help="reference transcripts (utt unit unit ...)")
    p.add_argument("--vocab", required=True, help="'unit idx' vocab file")
    p.add_argument("--decode_dir", required=True, help="output directory")
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-bw", "--beam_width", type=int, default=5)
    p.add_argument("-pn", "--penalty", type=float, default=0.6)
    p.add_argument("-ml", "--max_len", type=int, default=100)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p


def load_model_cfg(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    return cfg.get("model_cfg", cfg)


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
    dev = resolve_device(args.device)
    model = build_model(load_model_cfg(args.model_cfg), dtype=DTYPES[args.dtype], device=dev)
    load_into(model, load_npz(args.npz))

    unit2idx = load_vocab(args.vocab)
    idx2unit = load_idx2unit_map(args.vocab)
    recognizer = SpeechToTextRecognizer(
        model, beam_width=args.beam_width, max_len=args.max_len, penalty=args.penalty,
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
            texts, scores = recognizer.recognize(torch.from_numpy(x).to(dev),
                                                 torch.from_numpy(mask).to(dev))
            accu_time += time.time() - t0
            total_frames += sum(lens)
            for i, (utt, _) in enumerate(chunk):
                best = texts[i][0]
                ftxt.write(f"{utt} {best}\n")
                ref = [idx2unit.get(unit2idx.get(u, UNK), "<UNK>") for u in refs.get(utt, [])]
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
