"""The plain references agree with the port at a tiny size on the CPU
(float32, the port's plain kernel versions)."""

from __future__ import annotations

import copy

import torch

from conftest import tiny_config, tiny_mix

from portbench.core.weights import load_into, make_weights, param_shapes
from portbench.drivers import train_update
from portbench.reference import speech2text as ref
from portbench.reference import train as ref_train

SEED = 2 ** 31 + 7


def port_model(cfg, train=False):
    from opentransformer_tpu_torch.models.registry import build_model

    model = build_model(cfg["model"], dtype=torch.float32, device="cpu")
    w = make_weights(param_shapes(model), SEED, torch.device("cpu"), torch.float32)
    load_into(model, w)
    return model.train(train), w


def test_encoder_and_decoder_match_the_port():
    cfg = tiny_config("float32")
    model, w = port_model(cfg)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, 90, 40, generator=gen)
    lens = torch.tensor([90, 71, 40])
    mask = torch.arange(90)[None] < lens[:, None]
    x = x * mask[..., None]
    tokens = torch.randint(0, 50, (3, 6), generator=gen)
    with torch.no_grad():
        mem, mmask = model.encode(x, mask)
        logp = torch.log_softmax(model.decode_full(tokens, mem, mmask), -1)
    rmem, rmask = ref.encode(w, cfg["model"], x, mask)
    assert torch.equal(mmask, rmask)
    assert (mem - rmem).abs().max() < 1e-4
    rlogp = ref.decode_logp(w, cfg["model"], tokens, rmem, rmask)
    assert (logp - rlogp).abs().max() < 1e-4


def test_beam_search_matches_the_port():
    """The reference's beam of 5 over forced steps keeps the port's n-best,
    with the same summed log-probs."""
    from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer

    cfg = tiny_config("float32")
    model, w = port_model(cfg)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(2, 80, 40, generator=gen)
    mask = torch.arange(80)[None] < torch.tensor([80, 57])[:, None]
    x = x * mask[..., None]
    steps, pen = 6, 0.6
    rec = SpeechToTextRecognizer(model, beam_width=5, max_len=steps, penalty=pen, eos_id=50)
    with torch.no_grad():
        hyp = rec.recognize_arrays(x, mask)
    for b in range(2):
        memory, mmask = ref.encode(w, cfg["model"], x[b:b + 1], mask[b:b + 1])
        tokens, scores = ref.beam_search(w, cfg["model"], memory, mmask, 5, steps)
        assert torch.equal(hyp.tokens[b], tokens)
        want = scores / ((5.0 + steps + 1) / 6.0) ** pen
        assert (hyp.scores[b] - want).abs().max() < 1e-4


def test_training_micro_batch_matches_the_trainer():
    """Features, SpecAugment and dropout draws, and the loss of one
    micro-batch, as the port's trainer computes them, from one generator
    seed on both sides."""
    from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
    from opentransformer_tpu_torch.train.trainer import Trainer

    cfg = tiny_config("float32")
    model, w = port_model(cfg, train=True)
    stream = train_update.Stream(tiny_mix("train"), 50, SEED, torch.device("cpu"))
    waves, lens, targets = stream.make(0)
    seen = []
    frontend = make_device_frontend(cfg["data"], "cpu")
    trainer = Trainer(copy.deepcopy(cfg["train"]), model,
                      lambda *a, **k: seen.append(frontend(*a, **k)) or seen[-1],
                      torch.Generator().manual_seed(5))
    loss = trainer.micro_step(train_update.as_batch(waves, lens, targets))
    kl, count, rfeats = ref_train.micro_kl(w, cfg, waves, lens, targets,
                                           torch.Generator().manual_seed(5))
    assert (seen[0][0] - rfeats).abs().max() < 1e-4
    rloss = float(kl / count)
    assert abs(float(loss) - rloss) < 1e-5 * abs(rloss)


def test_conformer_ctc_matches_the_port():
    from opentransformer_tpu_torch.models.registry import build_model

    from portbench.reference import conformer_ctc

    cfg = tiny_config("float32", "conformer_streaming_ctc")["model"]
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    w = make_weights(param_shapes(model), SEED, torch.device("cpu"), torch.float32)
    load_into(model, w)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 300, 80, generator=gen)
    mask = torch.arange(300)[None] < torch.tensor([300, 217])[:, None]
    x = x * mask[..., None]
    with torch.no_grad():
        mem, mmask = model.encode(x, mask)
        logp = torch.log_softmax(model.ctc.project(mem), -1)
    rlogp, rmask = conformer_ctc.ctc_logp(w, cfg, x, mask)
    assert torch.equal(mmask, rmask)
    assert ((logp - rlogp).abs() * rmask[..., None]).max() < 1e-4
