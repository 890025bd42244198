"""Offline long-form transcription with Whisper large-v3: recordings cut into
consecutive full 30-s windows, batched in the order of their recordings,
through ``SpeechToTextRecognizer.recognize_arrays`` (Whisper's front end, the
encoder at 1,500 positions encoded in slices, the KV-cached beam over
1,500-frame cross caches with kernel 4 and kernel 1 at V = 51,866), as the
eval CLI decodes ``-c conf/whisper_large_v3.json``.

Mix parameters: the window law of ``core/traffic.py`` (every window 30 s;
tokens a window from ``chars_per_s`` and ``chars_spread``), ``batch``
windows a batch, ``beam``, ``penalty``, ``check_sample``. The windows are
batched in a fixed order drawn from ``pairing_seed`` (a recording's windows
come in time order, their transcripts' lengths in no order), so every batch
runs about the longest transcript's steps. End of sentence is disabled, a
round is every batch once in the seed's order, and the window runs whole
rounds, as ``offline_decode`` does.

``correct`` is ``offline_decode``'s method against the Whisper reference
(``reference/whisper.py``): over a seeded sample of windows with the batch
of the most steps in it, ``token_gap``, ``score_rel_err``, ``kept_rel_gap``
and ``missing_rows``; the control is the reference with fp8 products, the
planted fault k greedy searches.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.core import beam_counts, counts, traffic
from portbench.core.harness import Outcome, checks_of
from portbench.core.trace import Tracer
from portbench.core.weights import load_into, make_weights, param_shapes
from portbench.drivers.offline_decode import READINGS, Judge, make_inputs, penalty, sample
from portbench.reference import whisper as ref
from portbench.reference.precision import BELOW, FP32, no_tf32


def batches_of(mix: dict) -> list:
    """The mix's windows as (frames, tokens), in their fixed order, cut
    into batches of ``batch``."""
    utts = traffic.utterances(mix)
    order = np.random.RandomState(int(mix["pairing_seed"]) + 1).permutation(len(utts))
    return traffic.fixed_batches([utts[i] for i in order], int(mix["batch"]))


def zero_key_biases(weights: dict, d: int) -> None:
    """Whisper's key projections have no bias: the key thirds of the fused
    projections' biases set to zero."""
    for name, w in weights.items():
        if name.endswith(".slf_attn.qkv_proj.bias"):
            w[d:2 * d] = 0
        elif name.endswith(".src_attn.kv_proj.bias"):
            w[:d] = 0


def batch_flops(cfg: dict, batch, beam: int, steps: int) -> float:
    """Counted FLOPs of one batch: the Conv1d front end, the encoder (GELU
    feed-forwards), the cross keys and values, and ``steps`` decoder steps
    of ``beam`` rows a window."""
    fe, enc, dec = cfg["frontend"], cfg["encoder"], cfg["decoder"]
    total = 0.0
    for frames, _ in batch:
        f, t = beam_counts.conv1d_frontend(frames, fe["input_size"], fe["output_size"])
        total += f + counts.transformer_encoder(t, enc["d_model"], enc["d_ff"], enc["n_blocks"],
                                                glu=False)
        total += counts.cross_kv(t, dec["d_model"], dec["n_blocks"])
        total += sum(counts.decoder_step(beam, s, t, dec["d_model"], dec["d_ff"],
                                         dec["n_blocks"], dec["vocab_size"], glu=False)
                     for s in range(steps))
    return total


def run(ctx, recognize=None) -> Outcome:
    """One run of the cell; ``recognize(rec, feats, mask)`` replaces the
    call into the port (the fault tests break the path with it)."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.beam_attention import beam_cross_attention
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer

    mix, cfg = ctx.cell.mix, ctx.cell.config
    model_cfg, dtype_name = cfg["model"], cfg["precision"]
    dtype = getattr(torch, dtype_name)
    dev = ctx.device
    tracer = Tracer(dev, ctx.traced)
    dec = model_cfg["decoder"]

    with torch.device(dev):  # 1.5 B parameters: initialised on the device
        model = build_model(model_cfg, dtype=dtype, device=dev)
    shapes = param_shapes(model)
    weights = make_weights(shapes, ctx.seed, dev, dtype)
    zero_key_biases(weights, dec["d_model"])
    load_into(model, weights)
    # the window holds only what a deployment holds: the check draws the
    # same weights again from the seed once the model is gone
    del weights
    vocab, beam = dec["vocab_size"], int(mix["beam"])
    batches = batches_of(mix)
    steps = [max(u[1] for u in b) for b in batches]
    inputs = make_inputs(batches, model_cfg["frontend"]["input_size"], ctx.seed, dev, dtype)
    recs = [SpeechToTextRecognizer(model, beam_width=beam, max_len=s,
                                   penalty=float(mix["penalty"]), eos_id=vocab)
            for s in steps]
    recognize = recognize or (lambda rec, x, m: rec.recognize_arrays(x, m))
    audio = [sum(u[0] for u in b) * mix["frame_shift_ms"] / 1000.0 for b in batches]

    # every shape once: the batches differ only in their steps, so the
    # deepest batch of each input shape warms every kernel and product
    warm = {}
    for j in sorted(range(len(batches)), key=lambda j: -steps[j]):
        warm.setdefault(tuple(inputs[j][0].shape), j)
    for j in warm.values():
        recognize(recs[j], *inputs[j])
    tracer.sync()
    setup_s = time.perf_counter() - ctx.t_process

    outputs, rounds = [], 0
    launches0 = (project_logp_topk.launches, beam_cross_attention.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
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
    d, blocks = dec["d_model"], dec["n_blocks"]
    t_mem = model.frontend.output_length(batches[0][0][0])
    tracer.add_work("flops", rounds * sum(batch_flops(model_cfg, b, beam, s)
                                          for b, s in zip(batches, steps)))
    tracer.add_work("flops_peak", counts.PEAK_FLOPS[dtype_name])
    tracer.add_work("topk_bound_s", rounds * sum(
        s * counts.topk_bound(len(b) * beam, d, vocab, beam, dtype_name)
        for b, s in zip(batches, steps)))
    tracer.add_work("attn_bound_s", rounds * sum(
        beam_counts.attention_bound_s(len(b), beam, t_mem, s, d, blocks, dtype_name)
        for b, s in zip(batches, steps)))
    tracer.count("kernel1.launches", project_logp_topk.launches - launches0[0])
    tracer.count("kernel4.cross_launches", beam_cross_attention.launches - launches0[1])
    tracer.count("decode.steps", rounds * sum(steps))
    tracer.count("decode.batches", rounds * len(batches))
    tracer.count("mem.window_peak_bytes", peak)

    del recs, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(shapes, ctx.seed, dev, dtype)
    zero_key_biases(weights, dec["d_model"])
    control = getattr(ctx, "control", False)
    sides = check(ctx, model_cfg, mix, weights, batches, steps, inputs, outputs, beam,
                  BELOW[dtype_name] if control else None)
    readings = sides.pop("program")
    return Outcome(attempted=rounds * sum(len(b) for b in batches), failed=0,
                   metrics={"decode_audio_s_per_s": rounds * sum(audio) / window_s,
                            "setup_s": setup_s},
                   checks=checks_of(readings, ctx.limits), memory_peak_bytes=peak,
                   trace=tracer.data, extra={"readings": readings, "rounds": rounds, **sides})


class WhisperJudge(Judge):
    """``offline_decode``'s judge of one window, over the Whisper
    reference's float32 memory (one window's memory, shared by its k
    hypotheses)."""

    def __init__(self, weights, model_cfg, x, m, beam: int, steps: int, pen: float):
        self.w, self.cfg, self.x, self.m = weights, model_cfg, x, m
        self.beam, self.steps, self.pen = beam, steps, pen
        self.memory, self.mask = ref.encode(weights, model_cfg, x, m, FP32)

    def logp(self, toks, prec=FP32):
        if prec is FP32:
            memory, mask = self.memory, self.mask
        else:
            memory, mask = ref.encode(self.w, self.cfg, self.x, self.m, prec)
        return ref.decode_logp(self.w, self.cfg, toks[:, :-1], memory, mask, prec)

    def own_best(self) -> dict:
        toks, scores = ref.beam_search(self.w, self.cfg, self.memory, self.mask, self.beam,
                                       self.steps, own_best=True)
        return self.judge(toks, scores / penalty(self.steps + 1, self.pen))


@torch.no_grad()
def check(ctx, model_cfg, mix, weights, batches, steps, inputs, outputs, beam, control=None):
    """The worst readings over the sampled windows: the program's, and with
    ``control`` (a lower precision) the control's and the planted fault's."""
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
        u = WhisperJudge(weights, model_cfg, x[row:row + 1].float(), m[row:row + 1], beam,
                         steps[j], float(mix["penalty"]))
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
