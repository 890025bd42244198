"""Whisper large-v3 on the port: the ``speech2text`` model built from the
Whisper config keys (the ``whisper`` front end, the encoder's ``pos_style:
whisper``, learned decoder positions, no embedding scale, a bias-free tied
head, exact GELU, ``ln_eps`` 1e-5, ``pre_norm_residual: input``) held
against the plain reference ``opentransformer_tpu_torch/reference/whisper.py``
at a tiny size in float32 on the CPU; the recognizer's sliced encode; every
existing config's state dict as it was before these keys; the full-size
parameter count.

Each tolerance states its reason, and each is shown to fail when the port
is built with one of Whisper's details planted wrong: the tanh GELU, the
flax LayerNorm ε 1e-6, sinusoid-interleaved positions.
"""

from __future__ import annotations

import ast
import copy
import glob
import hashlib
import json
import math
import os

import pytest
import torch

from opentransformer_tpu_torch import profiling
from opentransformer_tpu_torch.config import CONF_DIR
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize import base
from opentransformer_tpu_torch.reference import whisper as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, FRAMES, MEL = 97, 40, 16
STEPS, BEAM, PENALTY = 6, 3, 0.6


def tiny_cfg() -> dict:
    """d64, 4 heads, 2 + 2 blocks, 16 mel, V 97: Whisper's keys at a tiny size."""
    layer = {"d_model": 64, "n_heads": 4, "d_ff": 256, "n_blocks": 2, "activation": "gelu_erf",
             "normalize_before": True, "pre_norm_residual": "input", "ln_eps": 1e-5,
             "slf_attn_dropout": 0.0, "ffn_dropout": 0.0, "residual_dropout": 0.0,
             "pos_dropout": 0.0}
    return {"type": "speech2text", "frontend_type": "whisper",
            "frontend": {"input_size": MEL, "output_size": 64, "act_func_type": "gelu_erf"},
            "encoder_type": "transformer", "encoder": {**layer, "pos_style": "whisper"},
            "decoder": {"vocab_size": V, **layer, "src_attn_dropout": 0.0,
                        "share_embedding": True, "pos_style": "learned", "max_positions": 32,
                        "output_bias": False}}


def seeded_weights(model) -> dict:
    """Normal draws by kind: LayerNorm gains near 1, biases 0.02 (the key
    biases too: the reference leaves them out, the softmax removes them),
    token and position embeddings 0.02 (Whisper's are small, so ε matters),
    matrices 1/sqrt(fan-in)."""
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, p in model.named_parameters():
        if p.dim() == 1:
            gain = "norm" in name and name.endswith("weight")
            out[name] = (1.0 if gain else 0.0) + (0.1 if gain else 0.02) * torch.randn(
                p.shape, generator=g)
        elif "embedding" in name:
            out[name] = 0.02 * torch.randn(p.shape, generator=g)
        else:
            out[name] = torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel())
    return out


CFG = tiny_cfg()
WEIGHTS = seeded_weights(build_model(CFG, device="cpu"))
FEATS = torch.randn(3, FRAMES, MEL, generator=torch.Generator().manual_seed(1))
MASK = torch.arange(FRAMES)[None] < torch.tensor([FRAMES, 31, 20])[:, None]
TOKENS = torch.randint(2, V, (3, 9), generator=torch.Generator().manual_seed(2))
TOKENS[:, 0] = ref.BOS


def tanh_gelu(c):
    c["frontend"]["act_func_type"] = "gelu"
    c["encoder"]["activation"] = c["decoder"]["activation"] = "gelu"


def flax_eps(c):
    c["encoder"]["ln_eps"] = c["decoder"]["ln_eps"] = 1e-6


def interleaved_decoder_positions(c):
    c["decoder"]["pos_style"] = "scaled"  # x·√d + the interleaved sinusoid


def interleaved_encoder_positions(c):
    c["encoder"]["pos_style"] = "scaled"  # x·√d + the interleaved sinusoid


def port(departure=None):
    cfg = copy.deepcopy(CFG)
    if departure is not None:
        departure(cfg)
    model = build_model(cfg, device="cpu")
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in WEIGHTS.items() if k in own}, strict=False)
    return model


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@torch.no_grad()
def ref_memory():
    return ref.encode(WEIGHTS, CFG, FEATS, MASK)


@torch.no_grad()
def encoder_err(model) -> float:
    memory, mask = model.encode(FEATS, MASK)
    want, want_mask = ref_memory()
    assert torch.equal(mask, want_mask)
    return rel(memory, want)


@torch.no_grad()
def forced_err(model) -> float:
    memory, mask = model.encode(FEATS, MASK)
    want = ref.decode_logits(WEIGHTS, CFG, TOKENS, *ref_memory())
    return rel(model.decode_full(TOKENS, memory, mask), want)


@torch.no_grad()
def cached_err(model) -> float:
    """Prefill (the cross keys and values projected once, ``init_cache``),
    then one cached beam step a position through the beam attention's
    plain versions, against the reference's whole forward; logits."""
    memory, mask = model.encode(FEATS, MASK)
    b, u = TOKENS.shape
    cache = model.init_cache(memory, u, 1)
    src = torch.zeros((b, 1, u), dtype=torch.long)
    w, bias = model.vocab_head()
    assert bias is None
    steps = []
    for i in range(u):
        h, cache = model.decode_hidden_step(TOKENS[:, i], cache, i, mask, src)
        steps.append(h.float() @ w.float().T)
    want = ref.decode_logits(WEIGHTS, CFG, TOKENS, *ref_memory())
    return rel(torch.stack(steps, dim=1), want)


@torch.no_grad()
def beam_err(model) -> float:
    """The recognizer's n-best (beam 3, 6 steps, EOS off) against the
    reference's summed log-probs over the same tokens, penalised."""
    rec = base.SpeechToTextRecognizer(model, beam_width=BEAM, max_len=STEPS, penalty=PENALTY,
                                      eos_id=V)
    hyp = rec.recognize_arrays(FEATS, MASK)
    memory, mask = ref_memory()
    worst = 0.0
    for i in range(FEATS.shape[0]):
        toks = hyp.tokens[i]
        logp = ref.decode_logp(WEIGHTS, CFG, toks[:, :-1], memory[i:i + 1], mask[i:i + 1])
        want = logp.gather(-1, toks[:, 1:, None])[..., 0].sum(-1) / ref.penalty(STEPS + 1,
                                                                               PENALTY)
        worst = max(worst, float(((hyp.scores[i] - want).abs() / want.abs()).max()))
    return worst


# (measure, tolerance, why, the planted departures it must catch)
CHECKS = {
    "encoder": (encoder_err, 1.5e-6,
                "float32 in both, summed in other orders (fused q/k/v, the key bias the softmax "
                "removes): 3.5e-7 measured; ε 1e-6 moves it 5.9e-6",
                (tanh_gelu, flax_eps, interleaved_encoder_positions)),
    "forced_logits": (forced_err, 2e-6,
                      "float32 orders as above through 2 + 2 blocks: 4.6e-7 measured; the tanh "
                      "GELU moves it 1.6e-4, ε 1e-6 6.8e-3 (embeddings of 0.02)",
                      (tanh_gelu, flax_eps, interleaved_decoder_positions)),
    "cached_logits": (cached_err, 2e-6,
                      "the cached step sums the same products one position at a time: 4.3e-7 "
                      "measured, under the forced pass's limit",
                      (tanh_gelu, flax_eps, interleaved_decoder_positions)),
    "beam_scores": (beam_err, 1e-6,
                    "a sum of 6 float32 log-probs (~27 nats) over its size: 1.1e-7 measured; "
                    "the tanh GELU moves it 2.9e-6",
                    (tanh_gelu, flax_eps, interleaved_decoder_positions)),
}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_port_matches_reference(check):
    measure, tol, _, _ = CHECKS[check]
    assert measure(port()) <= tol


@pytest.mark.parametrize("check,departure", [(c, d) for c in sorted(CHECKS)
                                             for d in range(3)])
def test_planted_departure_fails(check, departure):
    measure, tol, _, planted = CHECKS[check]
    assert measure(port(planted[departure])) > tol


def test_reference_beam_agrees_with_port_nbest():
    """The reference's own beam (whole hypotheses each step) keeps the
    port's n-best for every utterance."""
    rec = base.SpeechToTextRecognizer(port(), beam_width=BEAM, max_len=STEPS, penalty=PENALTY,
                                      eos_id=V)
    hyp = rec.recognize_arrays(FEATS, MASK)
    memory, mask = ref_memory()
    for i in range(FEATS.shape[0]):
        toks, scores = ref.beam_search(WEIGHTS, CFG, memory[i:i + 1], mask[i:i + 1], BEAM, STEPS)
        assert torch.equal(toks, hyp.tokens[i])
        torch.testing.assert_close(scores / ref.penalty(STEPS + 1, PENALTY), hyp.scores[i],
                                   rtol=1e-5, atol=0)


def test_encode_in_three_slices_equals_one(monkeypatch):
    """A score budget that one slice of the batch overruns cuts the encode
    into 3 slices (3 ``encoder.slice`` spans); the memory is the one-slice
    encode's (float32 products over fewer rows may sum in another order)."""
    model = port()
    rec = base.SpeechToTextRecognizer(model, beam_width=BEAM, max_len=STEPS, eos_id=V)
    with torch.no_grad():
        whole, whole_mask = rec.encode(FEATS, MASK)
        t = model.frontend.output_length(FRAMES)
        monkeypatch.setattr(base, "ENCODE_SCORE_BYTES", 4 * 4 * t * t)  # one row's scores
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            sliced, sliced_mask = rec.encode(FEATS, MASK)
        names = [s.name for s in profiling.spans()]
    assert names.count("encoder.slice") == 3
    assert torch.equal(sliced_mask, whole_mask)
    torch.testing.assert_close(sliced, whole, rtol=1e-6, atol=1e-6)


def meta_model(cfg: dict):
    with torch.device("meta"):
        return build_model(cfg, device="meta")


def test_decode_cell_encodes_in_one_slice():
    """The decode cell's batches (1,024 utterances of up to 15 s, 4 heads:
    2.3 GB of scores) stay one slice; 128 Whisper windows (23 GB) take 6."""
    with open(os.path.join(CONF_DIR, "transformer_baseline.json")) as f:
        baseline = meta_model(json.load(f)["model"])
    assert base.encode_slice_rows(baseline, 1024, 1500) == 1024
    with open(os.path.join(CONF_DIR, "whisper_large_v3.json")) as f:
        whisper = meta_model(json.load(f)["model"])
    assert base.encode_slice_rows(whisper, 128, 3000) == 22


def test_whisper_large_v3_parameters():
    """conf/whisper_large_v3.json at the published widths: 1,543,490,560 in
    Whisper's count, which has no key biases (96 × 1,280 here) and keeps the
    encoder's 1,500 × 1,280 sinusoid table as an embedding (computed here)."""
    with open(os.path.join(CONF_DIR, "whisper_large_v3.json")) as f:
        model = meta_model(json.load(f)["model"])
    n = sum(p.numel() for p in model.parameters())
    assert n == 1_543_490_560 - 1500 * 1280 + 96 * 1280
    assert 1.54e9 <= n <= 1.55e9
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["frontend.conv1.weight"] == (1280, 128, 3)
    assert shapes["decoder.pos_embedding.weight"] == (448, 1280)
    assert shapes["decoder.embedding.weight"] == (51866, 1280)
    assert "decoder.output_bias" not in shapes
    assert shapes["encoder.block_31.ffn.w1.weight"] == (5120, 1280)


# each config's state dict before the Whisper keys: (tensors, elements, sha256 of
# the sorted [name, shape] list as JSON)
STATE_DICTS = {
    "anchor.json": (98, 2861298,
                    "79fdff1370b7ebe9b1795aed12b8304bfb65f710909c756b55152f1acdbf4a92"),
    "conformer_baseline.json": (524, 52178825,
                                "99cc371bb0fc42740fa3d2f06921b2322a0013fdda61faa8b80026ffdb059190"),
    "conformer_streaming.json": (524, 52178825,
                                 "99cc371bb0fc42740fa3d2f06921b2322a0013fdda61faa8b80026ffdb059190"),
    "flagship.json": (274, 37305618,
                      "b2d60dc88d215089f94ffe096e8828abd3db96ecedd9c644331048feae22b4e8"),
    "flagship_bench.json": (272, 36217737,
                            "15e74bfdcf209d8a87717524741ed6aba28c2792def74ed464cbb79fb8b4cc1f"),
    "flagship_cont.json": (274, 37305618,
                           "b2d60dc88d215089f94ffe096e8828abd3db96ecedd9c644331048feae22b4e8"),
    "rnn_lm.json": (26, 21124233,
                    "4ed8337e2939da463e7492b2aba823ce3aed87465b43e25d4ce957a96434fca4"),
    "transducer.json": (169, 25327753,
                        "f78ec89a83942b1bac889bb91c01a89d4153f20418300b442ce885b2a4f588d9"),
    "transducer_streaming.json": (169, 25327753,
                                  "f78ec89a83942b1bac889bb91c01a89d4153f20418300b442ce885b2a4f588d9"),
    "transformer_baseline.json": (272, 36217737,
                                  "15e74bfdcf209d8a87717524741ed6aba28c2792def74ed464cbb79fb8b4cc1f"),
    "transformer_lm.json": (74, 7405449,
                            "5314d4e60564aa015f8274c0caea3d6b821aba97cac7864e2339ece974f74017"),
    "transformer_moe.json": (284, 40959393,
                             "e494fe2eebfa63c491cb47ac661762b0edccc4cb2007ba7021dca8bcaa17bcf2"),
}


def test_every_other_config_is_listed():
    names = {os.path.basename(p) for p in glob.glob(os.path.join(CONF_DIR, "*.json"))}
    assert names - set(STATE_DICTS) == {"whisper_large_v3.json"}


@pytest.mark.parametrize("name", sorted(STATE_DICTS))
def test_existing_config_builds_as_before(name):
    with open(os.path.join(CONF_DIR, name)) as f:
        model = meta_model(json.load(f)["model"])
    items = sorted((k, list(v.shape)) for k, v in model.state_dict().items())
    digest = hashlib.sha256(json.dumps(items).encode()).hexdigest()
    numel = sum(int(torch.Size(s).numel()) for _, s in items)
    assert (len(items), numel, digest) == STATE_DICTS[name]


def imported_top_modules(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", ["opentransformer_tpu_torch/reference/whisper.py",
                                  "portbench/reference/whisper.py"])
def test_reference_imports_neither_port_nor_jax(path):
    """Plain torch only: no JAX, no package of this repo (a relative import
    would reach the package the file sits in; the benchmark's copy may
    reach its own ``precision`` module only)."""
    found = imported_top_modules(os.path.join(ROOT, path))
    allowed = {"__future__", "math", "torch", "."} if path.startswith("portbench") else {
        "__future__", "math", "torch"}
    assert found <= allowed, found
