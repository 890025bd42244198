"""Offline batch transcription: length-bucketed batches through
``SpeechToTextRecognizer.recognize_arrays`` (the conv front end, the
encoder, the KV-cached beam search and kernel 1), as the eval CLI decodes.

Mix parameters: the utterance distribution (``core/traffic.py``), ``batch``
rows a batch, ``beam``, ``penalty``. End of sentence is disabled (an id
outside the vocabulary), so each batch runs as many steps as the longest
transcript drawn in it. A round is every batch once, in the seed's order;
the window runs whole rounds until ``--seconds`` have passed, so every run
decodes the same work, and the rate is the audio of those rounds over the
window's time.

``correct``: after the window a sample of the decoded utterances, drawn
from the seed, with the longest utterance and the most steps in it, is
judged by the plain reference (``reference/speech2text.py``) in float32.
Over each served hypothesis, teacher-forced: ``token_gap`` is the widest
margin by which a served token's reference log-prob lies below the
reference's k-th best at its position (a beam of k extends a hypothesis
only by its k best tokens), ``score_rel_err`` the widest relative gap
between a served n-best score and the reference's length-penalised sum
over the same tokens. Over the beam's choices: ``kept_rel_gap`` is the
widest margin by which an extension at the last step of the served
hypotheses' prefixes that the beam did not keep scores (the reference's
summed log-prob) above the lowest one it kept, over that one's size (the
served n-best has to be the best k of those extensions). ``missing_rows``
counts the sampled utterances with no n-best.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.core import counts, traffic
from portbench.core.harness import Outcome, checks_of
from portbench.core.trace import Tracer
from portbench.core.weights import load_into, make_weights, param_shapes, subseed
from portbench.reference import speech2text as ref
from portbench.reference.precision import BELOW, FP32, no_tf32


def make_inputs(batches, n_mel: int, seed: int, device, dtype):
    """Per batch: features [B, T, n_mel] (seeded normal values, zero past
    each length) in the served type, and the frame mask."""
    out = []
    for j, batch in enumerate(batches):
        lens = torch.tensor([u[0] for u in batch], device=device)
        t = int(lens.max())
        gen = torch.Generator(device=device).manual_seed(subseed(seed, "feats", j))
        x = torch.randn((len(batch), t, n_mel), generator=gen, device=device)
        mask = torch.arange(t, device=device)[None] < lens[:, None]
        out.append(((x * mask[..., None]).to(dtype), mask))
    return out


def batch_flops(cfg: dict, batch, beam: int, steps: int) -> float:
    """Counted FLOPs of one batch: front end and encoder, cross keys and
    values, and ``steps`` decoder steps of ``beam`` rows an utterance."""
    fe, enc, dec = cfg["frontend"], cfg["encoder"], cfg["decoder"]
    total = 0.0
    for frames, _ in batch:
        f, t = counts.conv_frontend(frames, fe["input_size"], fe["mid_channel"],
                                    fe["out_channel"], fe["output_size"])
        total += f + counts.transformer_encoder(t, enc["d_model"], enc["d_ff"], enc["n_blocks"])
        total += counts.cross_kv(t, dec["d_model"], dec["n_blocks"])
        total += sum(counts.decoder_step(beam, s, t, dec["d_model"], dec["d_ff"],
                                         dec["n_blocks"], dec["vocab_size"])
                     for s in range(steps))
    return total


def run(ctx, recognize=None) -> Outcome:
    """One run of the cell; ``recognize(rec, feats, mask)`` replaces the
    call into the port (the fault tests break the path with it)."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer

    mix, cfg = ctx.cell.mix, ctx.cell.config
    model_cfg, dtype_name = cfg["model"], cfg["precision"]
    dtype = getattr(torch, dtype_name)
    dev = ctx.device
    tracer = Tracer(dev, ctx.traced)

    model = build_model(model_cfg, dtype=dtype, device=dev)
    weights = make_weights(param_shapes(model), ctx.seed, dev, dtype)
    load_into(model, weights)
    vocab = model_cfg["decoder"]["vocab_size"]
    beam = int(mix["beam"])
    batches = traffic.fixed_batches(traffic.utterances(mix), int(mix["batch"]))
    steps = [max(u[1] for u in b) for b in batches]
    inputs = make_inputs(batches, model_cfg["frontend"]["input_size"], ctx.seed, dev, dtype)
    recs = [SpeechToTextRecognizer(model, beam_width=beam, max_len=s,
                                   penalty=float(mix["penalty"]), eos_id=vocab)
            for s in steps]
    recognize = recognize or (lambda rec, x, m: rec.recognize_arrays(x, m))
    audio = [sum(u[0] for u in b) * mix["frame_shift_ms"] / 1000.0 for b in batches]

    for j in traffic.order(ctx.seed, len(batches), -1):  # every shape once
        recognize(recs[j], *inputs[j])
    tracer.sync()
    setup_s = time.perf_counter() - ctx.t_process

    if ctx.traced:  # spans around the calls into the encoder and the search
        encode = model.encode
        model.encode = lambda *a, **k: _spanned(tracer, "models.encode", encode, a, k)
        for rec in recs:
            search = rec.search
            rec.search = (lambda s: lambda *a: _spanned(tracer, "recognize.search", s, a, {}))(
                search)
    outputs, rounds = [], 0
    launches0 = project_logp_topk.launches
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            for j in traffic.order(ctx.seed, len(batches), rounds):
                hyp = recognize(recs[j], *inputs[j])
                outputs.append((rounds, j, hyp.tokens, hyp.scores))
            tracer.sync()
            rounds += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    window_s = tracer.window_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per_round = [batch_flops(model_cfg, b, beam, s) for b, s in zip(batches, steps)]
    tracer.add_work("flops", rounds * sum(per_round))
    tracer.add_work("flops_peak", counts.PEAK_FLOPS[dtype_name])
    d = model_cfg["decoder"]["d_model"]
    tracer.add_work("topk_bound_s", rounds * sum(
        s * counts.topk_bound(len(b) * beam, d, vocab, beam, dtype_name)
        for b, s in zip(batches, steps)))
    tracer.count("kernel1.launches", project_logp_topk.launches - launches0)
    tracer.count("decode.steps", rounds * sum(steps))
    tracer.count("decode.batches", rounds * len(batches))

    del recs, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    control = getattr(ctx, "control", False)
    sides = check(ctx, model_cfg, mix, weights, batches, steps, inputs, outputs, beam,
                  BELOW[dtype_name] if control else None)
    readings = sides.pop("program")
    out = Outcome(attempted=rounds * sum(len(b) for b in batches), failed=0,
                  metrics={"decode_audio_s_per_s": rounds * sum(audio) / window_s,
                           "setup_s": setup_s},
                  checks=checks_of(readings, ctx.limits), memory_peak_bytes=peak,
                  trace=tracer.data, extra={"readings": readings, "rounds": rounds, **sides})
    return out


def _spanned(tracer, name, fn, args, kwargs):
    with tracer.span(name):
        return fn(*args, **kwargs)


def sample(ctx, outputs, batches, steps, n: int) -> list[tuple[int, int]]:
    """(index into outputs, row): ``n`` drawn from the seed, plus the
    longest utterance and an utterance of the batch with the most steps."""
    rng = np.random.Generator(np.random.PCG64(subseed(ctx.seed, "sample")))
    picks = set()
    longest = max(range(len(batches)), key=lambda j: max(u[0] for u in batches[j]))
    deepest = max(range(len(batches)), key=lambda j: steps[j])
    for j, row in ((longest, int(np.argmax([u[0] for u in batches[longest]]))),
                   (deepest, int(np.argmax([u[1] for u in batches[deepest]])))):
        picks.add((max(i for i, o in enumerate(outputs) if o[1] == j), row))
    while len(picks) < n + 2 and len(picks) < sum(len(batches[o[1]]) for o in outputs):
        i = int(rng.integers(len(outputs)))
        picks.add((i, int(rng.integers(len(batches[outputs[i][1]])))))
    return sorted(picks)


READINGS = ("missing_rows", "token_gap", "score_rel_err", "kept_rel_gap")


class Judge:
    """The reference's view of one utterance, from its float32 memory."""

    def __init__(self, weights, model_cfg, x, m, beam: int, steps: int, pen: float):
        self.w, self.cfg, self.x, self.m = weights, model_cfg, x, m
        self.beam, self.steps, self.pen = beam, steps, pen
        self.memory, self.mask = ref.encode(weights, model_cfg, x, m, FP32)

    def logp(self, toks, prec=FP32):
        if prec is FP32:
            memory, mask = self.memory, self.mask
        else:
            memory, mask = ref.encode(self.w, self.cfg, self.x, self.m, prec)
        return ref.decode_logp(self.w, self.cfg, toks[:, :-1], memory.expand(self.beam, -1, -1),
                               mask.expand(self.beam, -1), prec)

    def judge(self, toks, scores) -> dict:
        """Readings of served tokens long[K, L + 1] and their served
        (length-penalised) scores."""
        vocab = self.cfg["decoder"]["vocab_size"]
        if bool((toks < 0).any() or (toks >= vocab).any()) or toks.shape[1] != self.steps + 1:
            return {k: float("inf") for k in READINGS[1:]}
        logp = self.logp(toks)
        served = toks[:, 1:]
        lp = logp.gather(-1, served[..., None])[..., 0]
        kth = logp.topk(self.beam, dim=-1).values[..., -1]
        want = lp.sum(-1)
        got = scores.float() * penalty(served.shape[1] + 1, self.pen)
        cand, first = self.extensions(logp, lp, toks)
        return {"token_gap": float((kth - lp).clamp_min(0).max()),
                "score_rel_err": float(((got - want).abs() / want.abs()).max()),
                "kept_rel_gap": self.kept_gap(cand, first, toks, toks)}

    @staticmethod
    def extensions(logp, lp, toks):
        """The reference's summed log-probs of every extension at the last
        step, f32[K, V], and which rows hold the first of equal prefixes."""
        cand = lp[:, :-1].sum(-1)[:, None] + logp[:, -1]
        same = (toks[:, None, :-1] == toks[None, :, :-1]).all(-1)
        first = ~same.tril(-1).any(-1)
        return cand, first

    @staticmethod
    def kept_gap(cand, first, toks, kept_toks) -> float:
        """The widest margin, over the lowest kept one's size, by which an
        extension not in ``kept_toks`` scores above the lowest kept one."""
        rows = [int((toks[:, :-1] == t[:-1]).all(-1).nonzero()[0]) for t in kept_toks]
        lowest = min(float(cand[r, int(t[-1])]) for r, t in zip(rows, kept_toks))
        rest = cand.masked_fill(~first[:, None], float("-inf"))
        for r, t in zip(rows, kept_toks):
            rest[r, int(t[-1])] = float("-inf")
        return max(0.0, float(rest.max()) - lowest) / abs(lowest)

    def control(self, prec, toks) -> dict:
        """The readings of the reference in ``prec`` put in the port's
        place: at the served tokens, the k best it would rank at each
        position and the k extensions it would keep at the last step."""
        logp, logp_c = self.logp(toks), self.logp(toks, prec)
        served = toks[:, 1:]
        lp = logp.gather(-1, served[..., None])[..., 0]
        kth = logp.topk(self.beam, dim=-1).values[..., -1]
        top_c = logp_c.topk(self.beam, dim=-1).indices
        want = lp.sum(-1)
        got = logp_c.gather(-1, served[..., None])[..., 0].sum(-1)
        cand, first = self.extensions(logp, lp, toks)
        lp_c = logp_c.gather(-1, served[..., None])[..., 0]
        cand_c, _ = self.extensions(logp_c, lp_c, toks)
        flat = cand_c.masked_fill(~first[:, None], float("-inf")).reshape(-1).topk(self.beam)
        rows, ids = flat.indices // cand.shape[1], flat.indices % cand.shape[1]
        kept_toks = torch.cat([toks[rows, :-1], ids[:, None]], dim=1)
        return {"token_gap": float((kth[..., None] - logp.gather(-1, top_c)).clamp_min(0).max()),
                "score_rel_err": float(((got - want).abs() / want.abs()).max()),
                "kept_rel_gap": self.kept_gap(cand, first, toks, kept_toks)}

    def own_best(self) -> dict:
        """The readings of a fault planted in the reference: a beam that
        extends each hypothesis by its own best token (k greedy searches)."""
        toks, scores = ref.beam_search(self.w, self.cfg, self.memory, self.mask, self.beam,
                                       self.steps, own_best=True)
        return self.judge(toks, scores / penalty(self.steps + 1, self.pen))


@torch.no_grad()
def check(ctx, model_cfg, mix, weights, batches, steps, inputs, outputs, beam, control=None):
    """The worst readings over the sampled utterances: the program's, and
    with ``control`` (a lower precision) the control's and a planted
    fault's."""
    no_tf32()
    picks = sample(ctx, outputs, batches, steps, int(mix["check_sample"]))
    names = ("program", "control", "fault_own_best") if control is not None else ("program",)
    worst = {n: dict.fromkeys(READINGS, 0.0) for n in names}
    for i, row in picks:
        _, j, tokens, scores = outputs[i]
        if row >= tokens.shape[0]:
            for n in names:
                worst[n]["missing_rows"] += 1
            continue
        x, m = inputs[j]
        u = Judge(weights, model_cfg, x[row:row + 1].float(), m[row:row + 1], beam, steps[j],
                  float(mix["penalty"]))
        toks = tokens[row].long()
        seen = {"program": u.judge(toks, scores[row])}
        if control is not None:
            seen["control"] = u.control(control, toks)
            seen["fault_own_best"] = u.own_best()
        for n, r in seen.items():
            for k, v in r.items():
                worst[n][k] = max(worst[n][k], v)
    worst["program"]["sampled"] = len(picks)
    return worst


def penalty(length: int, p: float, lamda: float = 5.0) -> float:
    return ((lamda + length) / (lamda + 1.0)) ** p
