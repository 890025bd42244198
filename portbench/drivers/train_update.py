"""Training updates: raw waveforms through the device front end (kernel 3,
normalisation, SpecAugment), ``Trainer.micro_step`` ``accum_steps`` times,
then ``Trainer.update``, as a training user's loop drives the trainer.

Mix parameters: the utterance distribution (``core/traffic.py``) and
``frames_per_micro_batch``, the padded frames a length-bucketed
micro-batch may hold. The micro-batches run as a stream, a round of them in
the seed's order after another, each with fresh seeded waveforms and
tokens. Set-up builds the trainer once and drives it through a whole round,
every shape once; its first three updates are the ones checked. The window
runs whole updates until ``--seconds`` have passed; the rate is the audio
of its updates over its time.

``correct``: once the window has closed and the trainer is freed, the plain
reference (``reference/train.py``) runs the first three updates again from
the same weights, inputs and draws in float32: ``loss_rel_err`` is the
widest relative gap of a micro-batch's loss; ``grad1_leaf_err`` the worst
leaf's gap between the norms of the first update's gradient as Adam took it
(read back from its first moment), over the larger of the reference's norm
of that leaf and of the median leaf; ``delta3_leaf_err`` the same of the
weights' change after three updates, each leaf over its elements whose
reference gradient is at least a thousandth of the median leaf's root mean
square (elsewhere, as in a key's bias, Adam moves a weight by round-off
alone); ``feat_rel_err`` the first micro-batch's features, the widest gap
over the largest value. The window's first update is checked too: the
weights, Adam's state and the generator's state are kept when the window
opens and the weights once its first update is done, and the reference
runs that update again from the kept state: ``win_loss_rel_err`` and
``win_delta_leaf_err`` are the gaps of its losses and of the weights'
change, as above. The control seeds of ``calibrate.py`` also read the
control and the faults planted in the reference (``controls``).
"""

from __future__ import annotations

import copy
import statistics
import time
from contextlib import nullcontext

import torch

from portbench.core import counts, traffic
from portbench.core.harness import Outcome, checks_of
from portbench.core.trace import Tracer
from portbench.core.weights import load_into, make_weights, param_shapes, subseed
from portbench.reference import train as ref_train
from portbench.reference.precision import BELOW, FP32, TF32, no_tf32

CHECKED_UPDATES = 3
FIRST_TOKEN = 3  # ids 0-2 are PAD/blank, BOS/EOS and UNK
SHIFT, WINDOW = 160, 400


class Stream:
    """The seed's micro-batches: round r's in the seed's order, each made
    on the device from its own generator (so any one can be made again)."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.batches = traffic.frame_budget_batches(traffic.utterances(mix),
                                                    int(mix["frames_per_micro_batch"]))
        self.vocab, self.seed, self.device = vocab, seed, device
        self.shift_s = mix["frame_shift_ms"] / 1000.0

    def index(self, k: int) -> tuple[int, int]:
        """(round, batch) of the stream's k-th micro-batch."""
        n = len(self.batches)
        return k // n, traffic.order(self.seed, n, k // n)[k % n]

    def make(self, k: int):
        """The k-th micro-batch: (waves f32[B, N], lengths, targets long[B, U])."""
        r, j = self.index(k)
        batch = self.batches[j]
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(subseed(self.seed, "micro", r, j))
        lens = torch.tensor([(f - 1) * SHIFT + WINDOW for f, _ in batch], device=dev)
        n = -(-int(lens.max()) // 16000) * 16000
        waves = 0.1 * torch.randn((len(batch), n), generator=gen, device=dev)
        waves = waves * (torch.arange(n, device=dev)[None] < lens[:, None])
        u_max = -(-(max(u for _, u in batch) + 2) // 8) * 8
        ids = torch.randint(FIRST_TOKEN, self.vocab, (len(batch), u_max), generator=gen,
                            device=dev)
        pos = torch.arange(u_max, device=dev)[None]
        ulen = torch.tensor([u for _, u in batch], device=dev)[:, None]
        targets = torch.where(pos <= ulen, ids, 0)
        targets = torch.where(pos == ulen + 1, 1, targets)
        targets[:, 0] = 1
        return waves, lens, targets

    def audio_s(self, k: int) -> float:
        return sum(f for f, _ in self.batches[self.index(k)[1]]) * self.shift_s


def as_batch(waves, lens, targets):
    """The trainer's batch of padded waveforms (utt_ids, inputs, targets)."""
    return (None, {"waveforms": waves, "wave_lengths": lens},
            {"targets": targets, "targets_length": (targets[:, 1:] > 1).sum(1) + 1})


def micro_flops(cfg: dict, batch) -> float:
    """Three times the forward's counted FLOPs at the real lengths."""
    fe, enc, dec = cfg["frontend"], cfg["encoder"], cfg["decoder"]
    total = 0.0
    for frames, u in batch:
        f, t = counts.conv_frontend(frames, fe["input_size"], fe["mid_channel"],
                                    fe["out_channel"], fe["output_size"])
        total += f + counts.transformer_encoder(t, enc["d_model"], enc["d_ff"], enc["n_blocks"])
        total += counts.decoder_forced(u + 1, t, dec["d_model"], dec["d_ff"], dec["n_blocks"],
                                       dec["vocab_size"])
    return 3.0 * total


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def leaf_err(got: dict, want: dict) -> float:
    """The worst leaf's |‖got‖ − ‖want‖| over max(‖want‖, the median leaf's)."""
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in want)


class TrainRun:
    """The trainer the driver drives, its stream and its loop: the model and
    the trainer built from the seed, the checked updates and the rest of a
    round in set-up, then whole updates in the window."""

    def __init__(self, ctx, micro_step=None, update=None):
        from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
        from opentransformer_tpu_torch.models.registry import build_model
        from opentransformer_tpu_torch.train.trainer import Trainer

        self.ctx, self.cfg = ctx, ctx.cell.config
        dev = ctx.device
        self.tracer = Tracer(dev, ctx.traced)
        self.micro_step = micro_step or (lambda tr, b: tr.micro_step(b))
        self.update = update or (lambda tr: tr.update())
        self.model = build_model(self.cfg["model"], dtype=torch.float32, device=dev).train()
        self.w0 = make_weights(param_shapes(self.model), ctx.seed, dev, torch.float32)
        load_into(self.model, self.w0)
        gen = torch.Generator(device=dev).manual_seed(subseed(ctx.seed, "trainer"))
        self.trainer = Trainer(copy.deepcopy(self.cfg["train"]), self.model,
                               make_device_frontend(self.cfg["data"], dev), gen,
                               log_interval=10 ** 9)
        self.accum = self.trainer.accum_steps
        self.stream = Stream(ctx.cell.mix, self.cfg["model"]["decoder"]["vocab_size"],
                             ctx.seed, dev)
        self.k, self.updates, self.audio, self.spans = 0, 0, 0.0, False

    def one_update(self) -> None:
        span = self.tracer.span if self.spans else lambda name: nullcontext()
        for i in range(self.k, self.k + self.accum):
            with span("train.micro_step"):
                self.micro_step(self.trainer, as_batch(*self.stream.make(i)))
            self.audio += self.stream.audio_s(i)
        with span("train.update"):
            self.update(self.trainer)
        self.k += self.accum

    def setup(self) -> dict:
        """The checked updates, then the rest of a round (every shape once);
        returns the program's side of the comparison."""
        trainer, named = self.trainer, dict(self.model.named_parameters())
        feats0, frontend = [], trainer.frontend
        trainer.frontend = lambda *a, **kw: feats0.append(frontend(*a, **kw)) or feats0[-1]
        self.one_update()
        trainer.frontend = frontend
        opt = trainer.optimizer
        b1 = float(self.cfg["train"]["optimizer"]["betas"][0])
        grad1 = leaf_norms({n: opt.state[p]["exp_avg"] / (1.0 - b1) for n, p in named.items()}
                           if opt.state else {n: torch.zeros(()) for n in named})
        while self.k < CHECKED_UPDATES * self.accum:
            self.one_update()
        program = {"losses": [x for rec in trainer.history[:CHECKED_UPDATES]
                              for x in rec["losses"]],
                   "grad1": grad1, "delta3": {n: p.detach() - self.w0[n] for n, p in named.items()},
                   "feats": feats0[0][0].detach().clone()}
        while self.k < len(self.stream.batches):
            self.one_update()
        self.tracer.sync()
        return program

    def keep_state(self) -> dict:
        """The state the window starts from, on the host: the weights,
        Adam's state ({name: (step, exp_avg, exp_avg_sq)}, empty before a
        first step), the generator's state, the schedule's step and the
        stream's position."""
        opt, host = self.trainer.optimizer, torch.device("cpu")
        named = dict(self.model.named_parameters())
        adam = {n: (float(opt.state[p]["step"]), opt.state[p]["exp_avg"].to(host, copy=True),
                    opt.state[p]["exp_avg_sq"].to(host, copy=True))
                for n, p in named.items() if p in opt.state}
        return {"w": {n: p.detach().to(host, copy=True) for n, p in named.items()}, "adam": adam,
                "generator": self.trainer.generator.get_state(),
                "step": int(self.trainer.global_step), "k": self.k,
                "history": len(self.trainer.history)}

    def window(self, done) -> tuple[int, dict]:
        """Whole updates until ``done(seconds elapsed)``; returns the
        window's peak memory and the program's side of the window's first
        update (the state it started from, its losses, the weights after)."""
        from opentransformer_tpu_torch.ops.fbank_kernel import spec_mel

        dev, tracer, stream = self.ctx.device, self.tracer, self.stream
        self.updates, self.audio, self.spans = 0, 0.0, self.ctx.traced
        flops, fbank_s = 0.0, 0.0
        launches0 = spec_mel.launches
        kept = self.keep_state()
        params = [p for _, p in self.model.named_parameters()]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                for i in range(self.k, self.k + self.accum):
                    batch = stream.batches[stream.index(i)[1]]
                    flops += micro_flops(self.cfg["model"], batch)
                    n = -(-((batch[-1][0] - 1) * SHIFT + WINDOW) // 16000) * 16000
                    fbank_s += counts.fbank_bound(len(batch) * (1 + (n - WINDOW) // SHIFT),
                                                  WINDOW, self.cfg["data"]["num_mel_bins"])
                self.one_update()
                if self.updates == 0:  # one copy on the device, read after the window
                    after1 = torch.cat([p.detach().reshape(-1) for p in params])
                self.updates += 1
                if done(time.perf_counter() - t0):
                    break
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        tracer.add_work("flops", flops)
        tracer.add_work("flops_peak", counts.PEAK_FLOPS[self.cfg["precision"]])
        tracer.add_work("fbank_bound_s", fbank_s)
        tracer.count("train.updates", self.updates)
        tracer.count("kernel3.launches", spec_mel.launches - launches0)
        tracer.count("mem.window_peak_bytes", peak)
        names = [n for n, _ in self.model.named_parameters()]
        after = dict(zip(names, after1.cpu().split([p.numel() for p in params])))
        first = {"losses": self.trainer.history[kept["history"]]["losses"],
                 "delta": {n: after[n].view_as(kept["w"][n]) - kept["w"][n] for n in names},
                 "kept": kept}
        return peak, first

    def free(self) -> None:
        """Drop the trainer and the model before the reference runs."""
        del self.trainer, self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def run(ctx, micro_step=None, update=None) -> Outcome:
    """One run of the cell; ``micro_step(trainer, batch)`` and
    ``update(trainer)`` replace the calls into the port (the fault tests
    break the path with them)."""
    dev = ctx.device
    tr = TrainRun(ctx, micro_step, update)
    program = tr.setup()
    setup_s = time.perf_counter() - ctx.t_process
    peak, first = tr.window(lambda elapsed: elapsed >= ctx.seconds)
    if dev.type == "cuda":
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    tr.free()
    cfg, w0 = ctx.cell.config, tr.w0
    want = reference_side(ctx, cfg, w0, tr.stream, tr.accum)
    want_win = window_side(ctx, cfg, first["kept"], tr.stream, tr.accum)
    readings = {**compare(program, want), **compare_window(first, want_win)}
    out = Outcome(attempted=tr.updates, failed=0,
                  metrics={"train_audio_s_per_s": tr.audio / tr.tracer.window_s,
                           "setup_s": setup_s},
                  checks=checks_of(readings, ctx.limits), memory_peak_bytes=peak,
                  trace=tr.tracer.data, extra={"readings": readings})
    if getattr(ctx, "control", False):
        out.extra.update(controls(ctx, cfg, w0, first["kept"], tr.stream, tr.accum, want,
                                  want_win))
    return out


def controls(ctx, cfg, w0, kept, stream, accum, want, want_win) -> dict:
    """The readings of the control and of the fault planted in the
    reference, on the first three updates and on the window's first."""
    def side(**kw):
        return {**compare(reference_side(ctx, cfg, w0, stream, accum, **kw), want),
                **compare_window(window_side(ctx, cfg, kept, stream, accum, **kw), want_win)}

    return {"control": side(prec=BELOW[cfg["precision"]], feat_prec=TF32),
            "fault_half_batch": side(rows=0.5)}


def micro_batches(stream, first: int, count: int, rows: float) -> list:
    """The stream's micro-batches ``first`` .. ``first + count - 1``, each
    cut to its first ``rows`` share of rows (a fault: the mean over those)."""
    out = []
    for i in range(first, first + count):
        waves, lens, targets = stream.make(i)
        n = max(1, int(round(waves.shape[0] * rows)))
        out.append((waves[:n], lens[:n], targets[:n]))
    return out


def reference_side(ctx, cfg, w0, stream, accum, prec=FP32, feat_prec=FP32, rows=1.0):
    """The reference's first updates as one side of the comparison: in
    another precision (a control), or on the first ``rows`` share of each
    micro-batch's rows (a fault)."""
    no_tf32()
    updates = [micro_batches(stream, u * accum, accum, rows) for u in range(CHECKED_UPDATES)]
    gen = torch.Generator(device=ctx.device).manual_seed(subseed(ctx.seed, "trainer"))
    losses, grad1, w3, feats = ref_train.train(w0, cfg, updates, gen, prec, feat_prec)
    return {"losses": losses, "grad1": grad1, "delta3": {n: w3[n] - w0[n] for n in w0},
            "feats": feats}


def window_side(ctx, cfg, kept, stream, accum, prec=FP32, feat_prec=FP32, rows=1.0):
    """The reference's run of the window's first update from the state the
    program kept when the window opened."""
    no_tf32()
    dev = ctx.device
    gen = torch.Generator(device=dev)
    gen.set_state(kept["generator"])
    w = {n: v.to(dev) for n, v in kept["w"].items()}
    adam = {n: (s, m.to(dev), v.to(dev)) for n, (s, m, v) in kept["adam"].items()}
    losses, grad, w1, _ = ref_train.train(w, cfg, [micro_batches(stream, kept["k"], accum, rows)],
                                          gen, prec, feat_prec, adam, kept["step"])
    return {"losses": losses, "grad": grad, "delta": {n: w1[n] - w[n] for n in w}}


def moved(grad: dict) -> dict:
    """Per leaf, its elements whose reference gradient is at least a
    thousandth of the median leaf's root mean square: the others (a key's
    bias under softmax) move under Adam by round-off alone."""
    rms = statistics.median(float(g.float().pow(2).mean().sqrt()) for g in grad.values())
    return {k: g.abs() >= 1e-3 * rms for k, g in grad.items()}


def loss_err(got: list, want: list) -> float:
    if len(got) != len(want):
        return float("inf")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def delta_err(got: dict, want: dict, grad: dict) -> float:
    """``leaf_err`` of the weights' change over the elements that ``moved``
    keeps by the reference's gradient ``grad``."""
    keep = moved(grad)
    kept = {k for k, m in keep.items() if bool(m.any())}
    dev = next(iter(want.values())).device
    return leaf_err({k: float(got[k].to(dev)[keep[k]].float().norm()) for k in kept},
                    {k: float(want[k][keep[k]].float().norm()) for k in kept})


def compare(side: dict, want: dict) -> dict:
    """Readings of ``side`` (the program's, a control's or a fault's)
    against the reference's ``want`` over the first three updates."""
    g_side = side["grad1"] if isinstance(next(iter(side["grad1"].values())), float) else \
        leaf_norms(side["grad1"])
    f, g = side["feats"], want["feats"]
    b, t = min(f.shape[0], g.shape[0]), min(f.shape[1], g.shape[1])
    feat_err = (float((f[:b, :t] - g[:b, :t]).abs().max() / g[:b, :t].abs().max())
                if b and t else float("inf"))
    keep = moved(want["grad1"])
    return {"loss_rel_err": loss_err(side["losses"], want["losses"]),
            "grad1_leaf_err": leaf_err(g_side, leaf_norms(want["grad1"])),
            "delta3_leaf_err": delta_err(side["delta3"], want["delta3"], want["grad1"]),
            "feat_rel_err": feat_err,
            "elements_left_out": int(sum(int((~m).sum()) for m in keep.values()))}


def compare_window(side: dict, want: dict) -> dict:
    """Readings of ``side`` against the reference's ``want`` over the
    window's first update."""
    return {"win_loss_rel_err": loss_err(side["losses"], want["losses"]),
            "win_delta_leaf_err": delta_err(side["delta"], want["delta"], want["grad"])}
