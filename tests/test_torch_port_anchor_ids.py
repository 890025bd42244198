"""The committed JAX 1-best fixture of the anchor split against both packages.

``egs/synth_bench/trained/anchor_synth_f16.jax_1best.json`` holds the JAX
package's 1-best ids (CPU, float32, beam 5, penalty 0.6, max_len 32, batches
of 100) of the 500 synthetic test utterances; ``chip_smoke.py`` counts the
card's decodes that differ from it, on a machine without JAX. Here the
first 20 utterances are decoded again by the JAX recognizer and the port on
the CPU, padded to the frame count of the batch of 100 they were decoded in,
and must give the fixture's ids exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.recognize.base import SpeechToTextRecognizer as JaxRecognizer
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli.eval import collate
from opentransformer_tpu_torch.data import EOS, PAD, synth
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
N_CHECKED = 20


def _strip(ids) -> list:
    """Ids after BOS up to EOS, PAD dropped (the fixture's form)."""
    out = []
    for i in np.asarray(ids)[1:].tolist():
        if i == EOS:
            break
        if i != PAD:
            out.append(int(i))
    return out


def test_fixture_first_utterances_equal_jax_and_port():
    with open(ANCHOR + ".jax_1best.json", encoding="utf-8") as f:
        fixture = json.load(f)
    dec = fixture["decode"]
    assert (dec["beam"], dec["penalty"], dec["max_len"]) == (5, 0.6, 32)
    assert list(fixture["utts"]) == [f"test{i:05d}" for i in range(500)]

    batch = list(synth.gen_split("test", dec["batch_size"]))
    _, _, lens = collate([u[1] for u in batch])
    x, mask, _ = collate([u[1] for u in batch[:N_CHECKED]])
    frames = -(-max(lens) // 32) * 32  # the padded length of the whole first batch
    x = np.pad(x, ((0, 0), (0, frames - x.shape[1]), (0, 0)))
    mask = np.pad(mask, ((0, 0), (0, frames - mask.shape[1])))

    with open(ANCHOR + ".manifest.json", encoding="utf-8") as f:
        cfg = json.load(f)["model_cfg"]
    tree = compat.load_npz(ANCHOR + ".npz")
    jrec = JaxRecognizer(jax_build_model(cfg), jax.tree_util.tree_map(jnp.asarray, tree),
                         beam_width=5, max_len=32, penalty=0.6)
    trec = SpeechToTextRecognizer(compat.load_into(build_model(cfg, device="cpu"), tree),
                                  beam_width=5, max_len=32, penalty=0.6)
    best_j = np.asarray(jrec.recognize_arrays(jnp.asarray(x), jnp.asarray(mask)).tokens)[:, 0]
    best_t = trec.recognize_arrays(torch.from_numpy(x), torch.from_numpy(mask)).tokens[:, 0]
    for i, (utt, _, _) in enumerate(batch[:N_CHECKED]):
        assert _strip(best_j[i]) == fixture["utts"][utt], utt
        assert _strip(best_t[i].numpy()) == fixture["utts"][utt], utt
