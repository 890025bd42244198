"""The port's recorder (``opentransformer_tpu_torch/profiling.py``): spans
at the beam step, the trainer's micro-step and update and the
multi-stream tick, recorded only under a ``torch.profiler`` session and
leaving every output as it was."""

from __future__ import annotations

import itertools
import json
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from opentransformer_tpu_torch import profiling
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.data import EOS, synth
from opentransformer_tpu_torch.data.device_pipeline import collate_waveforms, make_device_frontend
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize import multistream
from opentransformer_tpu_torch.recognize.base import make_memory_search
from opentransformer_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
V, D = 30, 16
FRONTEND = {"input_size": 12, "output_size": D, "mid_channel": 4, "out_channel": 8}
S2T_CFG = {
    "type": "speech2text", "frontend_type": "conv", "frontend": FRONTEND,
    "encoder_type": "transformer",
    "encoder": {"d_model": D, "n_heads": 2, "d_ff": 24, "n_blocks": 1, "residual_dropout": 0.0},
    "decoder": {"vocab_size": V, "d_model": D, "n_heads": 2, "d_ff": 24, "memory_dim": D,
                "n_blocks": 1, "residual_dropout": 0.0, "share_embedding": False},
    "ctc_weight": 0.0, "smoothing": 0.1,
}
CTC_CFG = {"type": "ctc", "frontend_type": "conv", "frontend": FRONTEND,
           "encoder_type": "conformer", "vocab_size": V, "lookahead_steps": 0,
           "encoder": {"d_model": D, "n_heads": 2, "d_ff": 24, "nblocks": 1,
                       "cov_kernel_size": 3, "residual_dropout": 0.0, "conv_causal": True,
                       "chunk_size": 4, "left_chunks": 2}}
TRAIN_CFG = {"optimizer_type": "adam",
             "optimizer": {"lr": 0.001, "betas": [0.9, 0.98], "eps": 1.0e-9},
             "scheduler_type": "constant", "scheduler": {"lr": 1e-3},
             "clip_grad": 5, "accum_steps": 2, "grad_noise": 0.0, "epochs": 1}
DATA_CFG = {"num_mel_bins": 12, "normalization": True, "spec_augment": False}
STEPS = 6

# every span of a case: name -> parent
SPANS = {
    "beam": {"beam.search": None, "beam.wait": "beam.search", "beam.decode": "beam.search",
             "beam.select": "beam.search"},
    "train": {"trainer.micro_step": None, "trainer.features": "trainer.micro_step",
              "trainer.forward": "trainer.micro_step", "trainer.backward": "trainer.micro_step",
              "trainer.update": None, "trainer.wait": "trainer.update",
              "trainer.optimizer": "trainer.update"},
    "tick": {"multistream.tick": None, "multistream.pack": "multistream.tick",
             "multistream.advance": "multistream.tick", "multistream.wait": "multistream.tick",
             "multistream.collect": "multistream.tick"},
}


def run_beam():
    """A beam-3 search with EOS off on a seeded tiny model: its tokens and scores."""
    torch.manual_seed(0)
    model = build_model(S2T_CFG, device="cpu").eval()
    x = torch.randn(2, 40, FRONTEND["input_size"])
    with torch.inference_mode():
        memory, mask = model.encode(x, torch.ones(2, 40, dtype=torch.bool))
        hyp = make_memory_search(model, 3, STEPS, eos_id=-1)(memory, mask)
    return {"tokens": hyp.tokens.numpy(), "scores": hyp.scores.numpy(), "steps": STEPS}


def run_train():
    """Two micro-batches of raw waves and an update: the losses and a weight."""
    torch.manual_seed(0)
    model = build_model(S2T_CFG, device="cpu").train()
    trainer = Trainer(dict(TRAIN_CFG), model, make_device_frontend(DATA_CFG, "cpu"),
                      torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    for k in range(2):
        utts = [(f"u{k}{i}", rng.normal(size=n).astype(np.float32) * 0.1, n,
                 list(rng.integers(3, V, size=4)), 4) for i, n in enumerate((4000, 5200))]
        trainer.micro_step(collate_waveforms(utts))
    rec = trainer.update()
    return {"losses": np.array(rec["losses"]),
            "weight": model.decoder.output_layer.weight.detach().numpy().copy()}


def run_tick():
    """Three streams of different lengths through a tiny multi-stream CTC:
    the final texts, the ticks and the slots advanced."""
    torch.manual_seed(0)
    model = build_model(CTC_CFG, device="cpu")
    ms = multistream.MultiStreamCTC(model, n_streams=3)
    rng = np.random.default_rng(3)
    finals = {}
    for i, n in enumerate((40, 57, 23)):
        slot = ms.open_stream(f"s{i}", lambda text: None,
                              lambda text, i=i: finals.setdefault(i, text))
        ms.push(slot, rng.normal(size=(n, FRONTEND["input_size"])).astype(np.float32))
        ms.close(slot)
    while ms.ready():
        ms.tick()
    return {"finals": finals, "ticks": ms.ticks, "rows": ms.chunks_advanced}


CASES = {"beam": run_beam, "train": run_train, "tick": run_tick}


@pytest.fixture
def recorder():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def probes(monkeypatch):
    """Counts of the recorder's clock reads and of CUDA events made."""
    seen = {"clock": 0, "events": 0}
    clock = profiling._now_ns

    def counted_clock():
        seen["clock"] += 1
        return clock()

    class CountedEvent:
        def __init__(self, *a, **kw):
            seen["events"] += 1

    monkeypatch.setattr(profiling, "_now_ns", counted_clock)
    monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
    return seen


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case", sorted(CASES))
def test_nothing_is_recorded_without_a_profiler(case, recorder, probes):
    CASES[case]()
    assert profiling.spans() == []
    assert probes == {"clock": 0, "events": 0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_profiled_call_records_every_span_with_its_parent(case, recorder):
    out = profiled(CASES[case])
    recorded = profiling.spans()
    assert {s.name: s.parent for s in recorded} == SPANS[case]
    by_name = {}
    for s in recorded:
        by_name.setdefault(s.name, []).append(s)
        assert s.start_ns <= s.end_ns and s.device_ms is None  # a CPU run has no events
        assert s.depth == (0 if s.parent is None else 1)
    for s in recorded:  # each child lies inside a span of its parent
        if s.parent is not None:
            assert any(p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
                       for p in by_name[s.parent])
    if case == "beam":  # a wait each loop iteration: no early exit with EOS off
        assert len(by_name["beam.search"]) == 1
        for name in ("beam.wait", "beam.decode", "beam.select"):
            assert len(by_name[name]) == out["steps"]
    elif case == "train":
        for name in ("trainer.micro_step", "trainer.features", "trainer.forward",
                     "trainer.backward"):
            assert len(by_name[name]) == 2
        for name in ("trainer.update", "trainer.wait", "trainer.optimizer"):
            assert len(by_name[name]) == 1
    else:
        assert out["rows"] > out["ticks"] > 1
        for name in SPANS["tick"]:
            assert len(by_name[name]) == out["ticks"]


def test_the_beam_waits_once_more_when_every_beam_ends_early(recorder):
    """With EOS on a search that ends before ``max_len`` reads the flag once
    more than the steps it ran, one ``beam.decode`` a step."""
    torch.manual_seed(0)
    model = build_model(S2T_CFG, device="cpu").eval()
    with torch.no_grad():  # every token's best continuation is EOS
        model.decoder.output_layer.bias.zero_()
        model.decoder.output_layer.bias[EOS] = 50.0
    x = torch.randn(2, 40, FRONTEND["input_size"])
    with torch.inference_mode():
        memory, mask = model.encode(x, torch.ones(2, 40, dtype=torch.bool))
        profiled(lambda: make_memory_search(model, 3, 20)(memory, mask))
    names = [s.name for s in profiling.spans()]
    steps = names.count("beam.decode")
    assert 0 < steps < 20 and names.count("beam.wait") == steps + 1
    assert names.count("beam.select") == steps


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_are_the_same_with_recording_on_and_off(case, recorder):
    same(CASES[case](), profiled(CASES[case]))


def test_an_off_span_is_one_check(recorder, probes):
    """No profiler: ten thousand spans read no clock, make no
    CUDA event and allocate nothing (tracemalloc's peak stays under a
    kilobyte, what one frame of the loop takes)."""
    dev = torch.device("cuda")
    loop = itertools.repeat(None, 10_000)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        for _ in loop:
            with profiling.span("x", dev):
                pass
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1024
    assert probes == {"clock": 0, "events": 0}
    assert profiling.spans() == []


@pytest.mark.parametrize("where", ["session's thread", "another thread"])
def test_recording_follows_the_profilers_process_wide_flag(where, recorder):
    """The flag the recorder reads exists in this torch and follows a
    ``torch.profiler`` session, in the session's thread and in others (the
    serve CLI's tick threads), where ``torch.autograd._profiler_enabled()``
    reads false."""
    from torch.autograd import profiler as autograd_profiler

    assert isinstance(autograd_profiler._is_profiler_enabled, bool)

    def look():
        if where == "session's thread":
            return profiling._recording()
        seen = []
        t = threading.Thread(target=lambda: seen.append(profiling._recording()))
        t.start()
        t.join(timeout=10)
        return seen[0]

    assert not look()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled and look()
        with profiling.span("on"):
            pass
    assert not look()
    assert [s.name for s in profiling.spans()] == ["on"]


def test_a_spanned_function_keeps_its_name_and_result(recorder):
    """``@spanned(name)`` opens the span around every call, passes the
    arguments and the result through and keeps the function's name."""
    @profiling.spanned("outer")
    def add(a, b=0):
        with profiling.span("inner"):
            return a + b

    assert add.__name__ == "add" and add(1, b=2) == 3
    assert profiling.spans() == []
    assert profiled(lambda: add(4, 5)) == 9
    got = {s.name: s for s in profiling.spans()}
    assert got["inner"].parent == "outer" and got["outer"].parent is None


def test_a_device_span_resolves_its_events_after_the_fact(recorder, monkeypatch):
    """A CUDA device adds an event on the current stream at each end; the
    device milliseconds come from them when ``spans()`` is read."""
    made = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at, self.waited = None, False
            made.append(self)

        def record(self, stream):
            self.at = 10.0 * len(made)

        def synchronize(self):
            self.waited = True

        def elapsed_time(self, other):
            assert other.waited
            return other.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)

    def work():
        with profiling.span("outer"):
            with profiling.span("dev", torch.device("cuda")):
                pass
            with profiling.span("cpu", torch.device("cpu")):
                pass

    profiled(work)
    assert len(made) == 2 and made[0].at is not None and not made[1].waited
    got = {s.name: s for s in profiling.spans()}
    assert got["dev"].device_ms == 10.0 and got["dev"].parent == "outer"
    assert got["cpu"].device_ms is None and got["outer"].device_ms is None


def test_the_parent_stack_is_per_thread(recorder):
    """Spans opened in two threads at once each find their own parent."""
    go = threading.Barrier(2, timeout=10)

    def worker(tag):
        with profiling.span(f"{tag}.outer"):
            go.wait()
            with profiling.span(f"{tag}.inner"):
                go.wait()

    def both():
        threads = [threading.Thread(target=worker, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)

    profiled(both)
    got = {s.name: s for s in profiling.spans()}
    assert got["a.inner"].parent == "a.outer" and got["b.inner"].parent == "b.outer"
    assert {s.depth for s in got.values()} == {0, 1}


def test_eval_profile_writes_the_spans_beside_the_trace(tmp_path, recorder):
    """``--profile DIR``: DIR/spans.json holds the search's spans and steps
    with the profiler's clock offset, and the decode is the one without."""
    data = tmp_path / "data"
    synth.write_corpus(str(data), splits=("test",), n_utts={"test": 2})
    base = ["--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
            "--feats", str(data / "test" / "feats.scp"), "--text", str(data / "test" / "text"),
            "--vocab", str(data / "vocab"), "-b", "2", "-bw", "3", "-ml", "8",
            "--device", "cpu"]
    assert eval_cli.main(base + ["--decode_dir", str(tmp_path / "off")]) == 0
    assert eval_cli.main(base + ["--decode_dir", str(tmp_path / "on"),
                                 "--profile", str(tmp_path / "prof")]) == 0
    for name in ("predict.txt", "predict.log"):
        assert (tmp_path / "on" / name).read_text() == (tmp_path / "off" / name).read_text()
    with open(tmp_path / "prof" / "spans.json", encoding="utf-8") as f:
        out = json.load(f)
    with open(tmp_path / "prof" / "trace.json", encoding="utf-8") as f:
        trace = json.load(f)
    names = {s["name"] for s in out["spans"]}
    assert names == {"beam.search", "beam.wait", "beam.decode", "beam.select"}
    steps = sum(s["name"] == "beam.decode" for s in out["spans"])
    waits = sum(s["name"] == "beam.wait" for s in out["spans"])
    assert 0 < steps <= 8 and steps <= waits <= steps + 1
    # the offset maps a span into the trace's time: the search lies within its events
    base_ns = trace.get("baseTimeNanoseconds", 0)
    ts = [e["ts"] * 1000 + base_ns for e in trace["traceEvents"] if e.get("ph") == "X"]
    search = next(s for s in out["spans"] if s["name"] == "beam.search")
    assert min(ts) <= search["start_ns"] + out["offset_ns"] <= max(ts)
