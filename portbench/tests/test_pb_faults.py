"""A run with the timed path broken underneath comes out not correct, and
a sound one correct, by the cells' committed limits: the harness's look for
a chip skipped, the rest of a run driven at a tiny size on the CPU, the port
in float32 (its bfloat16 rounding at these widths is not what the limits,
set at the cells' sizes, were read from)."""

from __future__ import annotations

import pytest
import torch

from conftest import driver, tiny_ctx

from portbench.core import harness
from portbench.reference import speech2text as ref

DECODE_LIMITS = harness.load_limits("transformer_baseline.decode_beam5")
TRAIN_LIMITS = harness.load_limits("transformer_baseline.train")


def half_rows(hyp):
    n = hyp.tokens.shape[0] // 2
    return type(hyp)(hyp.tokens[:n], hyp.scores[:n], hyp.lengths[:n])


def altered_token(hyp):
    tokens = hyp.tokens.clone()
    tokens[:, 0, -1] = (tokens[:, 0, -1] + 17) % 50
    return type(hyp)(tokens, hyp.scores, hyp.lengths)


def own_best(cfg: dict, penalty: float):
    """The beam replaced by k greedy searches: after the first step each
    hypothesis extended by its own best token (the reference's search of
    that kind over the port's weights)."""
    def recognize(rec, x, m):
        hyp = rec.recognize_arrays(x, m)
        k, steps = hyp.tokens.shape[1], hyp.tokens.shape[2] - 1
        w = {n: v.float() for n, v in rec.model.state_dict().items()}
        tokens, scores = [], []
        for b in range(x.shape[0]):
            memory, mask = ref.encode(w, cfg, x[b:b + 1].float(), m[b:b + 1])
            t, s = ref.beam_search(w, cfg, memory, mask, k, steps, own_best=True)
            tokens.append(t)
            scores.append(s / ((5.0 + steps + 1) / 6.0) ** penalty)
        return type(hyp)(torch.stack(tokens), torch.stack(scores), hyp.lengths)
    return recognize


DECODE_FAULTS = {
    None: lambda hyp: hyp,
    "half of the batch left out": half_rows,
    "a token altered where it is produced": altered_token,
    "k greedy searches in place of the beam": own_best,
}


@pytest.mark.parametrize("fault", list(DECODE_FAULTS))
def test_decode(fault):
    ctx = tiny_ctx("decode_beam5", DECODE_LIMITS, precision="float32")
    broken = DECODE_FAULTS[fault]
    if broken is own_best:
        recognize = own_best(ctx.cell.config["model"], float(ctx.cell.mix["penalty"]))
    else:
        recognize = lambda rec, x, m: broken(rec.recognize_arrays(x, m))  # noqa: E731
    out = driver("offline_decode").run(ctx, recognize=recognize)
    assert out.correct is (fault is None), out.extra["readings"]


def unchanged_state(trainer):
    saved = [p.detach().clone() for p in trainer.model.parameters()]
    trainer.update()
    with torch.no_grad():
        for p, s in zip(trainer.model.parameters(), saved):
            p.copy_(s)


def half_batch(trainer, batch):
    _, inputs, targets = batch
    n = inputs["waveforms"].shape[0] // 2
    return trainer.micro_step((None, {k: v[:n] for k, v in inputs.items()},
                               {k: v[:n] for k, v in targets.items()}))


TRAIN_FAULTS = {
    None: {},
    "a step that returns its state unchanged": {"update": unchanged_state},
    "half of the batch left out, the mean over the rest": {"micro_step": half_batch},
}


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS))
def test_train(fault):
    out = driver("train_update").run(tiny_ctx("train", TRAIN_LIMITS, precision="float32"),
                                     **TRAIN_FAULTS[fault])
    assert out.correct is (fault is None), out.extra["readings"]
