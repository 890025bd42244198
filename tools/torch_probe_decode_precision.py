#!/usr/bin/env python
"""Decode precision bisect on the PyTorch port
(counterpart of ``tools/probe_decode_precision.py``).

Decodes the synthetic test split (``opentransformer_tpu_torch.data.synth``)
in one padded batch (rows to a multiple of 128, frames to a multiple of 8;
beam 5, penalty 0.6, EOS 1, ``max_len`` = ``synth.MAX_TOKENS + 2`` = 30,
the corpus' longest, so no hypothesis is cut) under five precision
configurations, and appends one JSON line each to ``$OT_PROBE_OUT``
(default ``probe_results.jsonl`` in the temporary directory,
``tempfile.gettempdir()``; ``--out`` overrides it):

  f32        encoder f32,  decoder f32
  bf16       encoder bf16, decoder bf16
  enc32dec16 encoder f32,  decoder bf16 (the memory cast to bf16)
  enc16dec32 encoder bf16, decoder f32 (the memory cast to f32)
  round16    parameters rounded f32 -> bf16 -> f32, f32 compute

A precision is a model built in that dtype (``build_model(dtype=...)``, the
eval CLI's ``--dtype``); a split configuration encodes with one and
searches with the other. Each line holds the CER, the errors, and the
utterances whose 1-best ids differ from the JAX package's CPU float32 ids
(``--jax_ids``, default ``egs/synth_bench/trained/anchor_synth_f16.jax_1best.json``).
A configuration that fails writes an error line; after all of them it
prints ``ALL PROBES DONE`` and exits non-zero if any failed.

The weights are the committed anchor (``anchor_synth_f16.npz`` and its
manifest's ``model_cfg``); ``--npz`` / ``--model_cfg`` take others (the
flagship's ``flagship_synth_f16.npz`` where it exists). It runs on the
card unless ``--device cpu`` is given; ``wall_s`` is then CPU time.

    python tools/torch_probe_decode_precision.py [--utts 500] [--probes f32 bf16 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from opentransformer_tpu_torch import compat, profiling  # noqa: E402
from opentransformer_tpu_torch.cli.eval import load_model_cfg, load_weights  # noqa: E402
from opentransformer_tpu_torch.data import EOS, PAD, synth  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.ops.levenshtein import ErrorRateAccumulator  # noqa: E402
from opentransformer_tpu_torch.recognize.base import make_memory_search  # noqa: E402
from opentransformer_tpu_torch.utils import resolve_device  # noqa: E402

ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (name, encoder precision, decoder precision, parameters rounded to bf16)
PROBES = (("bf16", "bf16", "bf16", False), ("f32", "f32", "f32", False),
          ("enc32dec16", "f32", "bf16", False), ("enc16dec32", "bf16", "f32", False),
          ("round16", "f32", "f32", True))
BEAM, PENALTY = 5, 0.6
MAX_LEN = synth.MAX_TOKENS + 2


def test_batch(n_utts: int | None = None):
    """The test split in one padded batch → (utt ids, feats, mask, refs)."""
    utts = list(synth.gen_split("test", n_utts))
    n = len(utts)
    t_pad = synth.MAX_FRAMES + (-synth.MAX_FRAMES) % 8
    b_pad = n + (-n) % 128
    feats = np.zeros((b_pad, t_pad, synth.FEAT_DIM), np.float32)
    lengths = np.ones((b_pad,), np.int32)
    refs = []
    for i, (_, x, toks) in enumerate(utts):
        feats[i, : len(x)] = x
        lengths[i] = len(x)
        refs.append([t + 3 for t in toks])
    mask = np.arange(t_pad)[None, :] < lengths[:, None]
    return [u for u, _, _ in utts], feats, mask, refs


def one_best(tokens: np.ndarray) -> list:
    """Ids after BOS up to EOS, PAD dropped."""
    out = []
    for tok in tokens[1:]:
        if tok == EOS:
            break
        if tok != PAD:
            out.append(int(tok))
    return out


def run_probe(name, enc, dec, rounded, models, batch, want: dict | None, device) -> dict:
    ids, feats, mask, refs = batch
    t0 = time.time()
    enc_m, dec_m = models[(enc, rounded)], models[(dec, rounded)]
    search = make_memory_search(dec_m, BEAM, MAX_LEN, penalty=PENALTY, eos_id=EOS)
    x = torch.as_tensor(feats, device=device)
    m = torch.as_tensor(mask, device=device)
    with torch.inference_mode():
        memory, memory_mask = enc_m.encode(x, m)
        hyp = search(memory.to(DTYPES[dec]), memory_mask)
    tokens = hyp.tokens[:, 0].cpu().numpy()
    cer = ErrorRateAccumulator()
    off = []
    for i, utt in enumerate(ids):
        best = one_best(tokens[i])
        cer.update([str(t) for t in refs[i]], [str(t) for t in best])
        if want is not None and best != want.get(utt):
            off.append(utt)
    rec = {"probe": name, "enc": enc, "dec": dec, "cer_pct": round(cer.rate * 100, 3),
           "errs": cer.errors, "tokens": cer.tokens, "utts": len(ids),
           "ids_off_jax": None if want is None else len(off), "off_utts": off[:20],
           ("wall_s" if device.type == "cuda" else "cpu_wall_s"): round(time.time() - t0, 1)}
    return rec


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--npz", default=ANCHOR + ".npz")
    ap.add_argument("--model_cfg", default=ANCHOR + ".manifest.json",
                    help="JSON model config, or a manifest with a model_cfg key")
    ap.add_argument("--jax_ids", default=ANCHOR + ".jax_1best.json",
                    help="the JAX package's 1-best ids of these weights ('' : none)")
    ap.add_argument("--utts", type=int, default=None, help="the first N test utterances")
    ap.add_argument("--probes", nargs="+", default=[p[0] for p in PROBES],
                    choices=[p[0] for p in PROBES])
    ap.add_argument("--out", default=os.environ.get(
        "OT_PROBE_OUT", os.path.join(tempfile.gettempdir(), "probe_results.jsonl")))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_model_cfg(args.model_cfg)
    state = compat.params_from_jax(compat.load_npz(args.npz))
    rounded = {k: v.to(torch.bfloat16).to(torch.float32) if v.is_floating_point() else v
               for k, v in state.items()}
    want = None
    if args.jax_ids:
        with open(args.jax_ids, "r", encoding="utf-8") as f:
            want = json.load(f)["utts"]
    models = {}
    for name in args.probes:
        _, enc, dec, rnd = next(p for p in PROBES if p[0] == name)
        for prec in (enc, dec):
            if (prec, rnd) not in models:
                models[(prec, rnd)] = load_weights(
                    build_model(cfg, dtype=DTYPES[prec], device=device),
                    rounded if rnd else state)
    batch = test_batch(args.utts)
    failed = 0
    for name, enc, dec, rnd in PROBES:
        if name not in args.probes:
            continue
        try:
            rec = run_probe(name, enc, dec, rnd, models, batch, want, device)
        except Exception as e:  # recorded, and the exit code says so
            failed += 1
            rec = {"probe": name, "error": f"{type(e).__name__}: {e}"[:300]}
            print(f"probe {name} failed: {e}", flush=True)
        with open(args.out, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    if device.type == "cuda":
        print(profiling.card_line())
    print("ALL PROBES DONE", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
