"""The readers of the port's own spans (``core/program.py`` and the eight
``metrics/*.py`` over it) on a hand-made trace: device events placed by
hand, the port's spans put in its recorder's place."""

from __future__ import annotations

import os
import random

import pytest

from conftest import PB

from opentransformer_tpu_torch import profiling
from portbench.core import harness, program
from portbench.core.trace import DeviceEvent, TraceData

MS = 1_000_000       # ns
OFFSET = 7 * MS      # device clock minus host clock
READERS = ("recognize.launch_ms.decode", "recognize.idle_ms.decode",
           "models.decode_step_ms.decode", "train.launch_ms.train", "train.idle_ms.train",
           "stream.host_ms.stream", "stream.idle_ms.stream", "stream.advance_ms.stream")


def reader(name: str):
    return harness.load_module(os.path.join(PB, "metrics", name + ".py"),
                               "pb_metric_" + name.replace(".", "_"))


def span(name, parent, depth, a, b, device_ms=None):
    """A recorded span from a to b host milliseconds."""
    return profiling.Span(name, parent, depth, int(a * MS), int(b * MS), device_ms)


def events(*busy):
    """Device events at the given host-millisecond intervals, on the device clock."""
    return [DeviceEvent("k", int(a * MS) + OFFSET, int(b * MS) + OFFSET) for a, b in busy]


def trace_of(evs, window_ms):
    return TraceData(window_s=window_ms / 1e3, events=evs, spans={}, offset_ns=OFFSET)


# two beam steps: wait, decode and select each; the first decode's events
# run 1.0-3.8 (2.8 ms), the second's 6.0-8.3 (2.3 ms: the stream reaches its
# start event at once, the device being idle)
DECODE_SPANS = [
    span("beam.wait", "beam.search", 1, 0, 1), span("beam.decode", "beam.search", 1, 1, 4, 2.8),
    span("beam.select", "beam.search", 1, 4, 5), span("beam.wait", "beam.search", 1, 5, 6),
    span("beam.decode", "beam.search", 1, 6, 8, 2.3), span("beam.select", "beam.search", 1, 8, 9.5),
    span("beam.search", None, 0, 0, 10)]
# gaps 0.4-1.0 (wait), 3.0-3.2 (decode), 5.8-6.4 (wait 0.2, decode 0.4),
# 7.5-7.9 (decode), 9.6-9.9 (the search after its children), 10.5-10.8 (no span)
DECODE_EVENTS = events((0, 0.4), (1.0, 3.0), (3.2, 5.8), (6.4, 7.5), (7.9, 9.6), (9.9, 10.5),
                       (10.8, 11))
# two micro-steps and an update
TRAIN_SPANS = [
    span("trainer.features", "trainer.micro_step", 1, 0, 1),
    span("trainer.forward", "trainer.micro_step", 1, 1, 3),
    span("trainer.backward", "trainer.micro_step", 1, 3, 4),
    span("trainer.micro_step", None, 0, 0, 4.5),
    span("trainer.features", "trainer.micro_step", 1, 5, 6),
    span("trainer.forward", "trainer.micro_step", 1, 6, 7),
    span("trainer.backward", "trainer.micro_step", 1, 7, 8),
    span("trainer.micro_step", None, 0, 5, 8.5),
    span("trainer.wait", "trainer.update", 1, 9, 10),
    span("trainer.optimizer", "trainer.update", 1, 10, 12),
    span("trainer.update", None, 0, 9, 12.5)]
# gaps 0.3-0.9 (features), 4.2-4.4 (the first micro-step after its children),
# 4.4-5.8 (micro-step 0.1, no span 0.5, features 0.8), 8.6-9.2 (no span 0.4,
# wait 0.2), 10.0-11.0 (optimizer)
TRAIN_EVENTS = events((0, 0.3), (0.9, 4.2), (4.4, 4.4), (5.8, 8.6), (9.2, 10.0), (11.0, 13))
# two ticks: pack, advance, wait, collect; the advances' events run 5-25
# (20 ms) and 52-80 (28 ms)
STREAM_SPANS = [
    span("multistream.pack", "multistream.tick", 1, 0, 5),
    span("multistream.advance", "multistream.tick", 1, 5, 15, 20.0),
    span("multistream.wait", "multistream.tick", 1, 15, 30),
    span("multistream.collect", "multistream.tick", 1, 30, 40),
    span("multistream.tick", None, 0, 0, 41),
    span("multistream.pack", "multistream.tick", 1, 50, 52),
    span("multistream.advance", "multistream.tick", 1, 52, 60, 28.0),
    span("multistream.wait", "multistream.tick", 1, 60, 85),
    span("multistream.collect", "multistream.tick", 1, 85, 90),
    span("multistream.tick", None, 0, 50, 91)]
# gaps 0-6 (pack 5, advance 1), 25-35 (wait 5, collect 5), 40-55 (tick 1, the
# benchmark's loop between ticks 9, pack 2, advance 3), 80-95 (wait 5, collect 5, tick 1,
# no span 4)
STREAM_EVENTS = events((-1, 0), (6, 25), (35, 40), (55, 80), (95, 96))

CELLS = {"decode": (DECODE_SPANS, DECODE_EVENTS, 12),
         "train": (TRAIN_SPANS, TRAIN_EVENTS, 14),
         "stream": (STREAM_SPANS, STREAM_EVENTS, 100)}
WANT = {
    # (decode 3 + 2, select 1 + 1.5) / 2 steps
    "recognize.launch_ms.decode": ("decode", 7.5 / 2),
    # wait 0.6 + 0.2, decode 0.2 + 0.4 + 0.4, search 0.3, over 2 steps
    "recognize.idle_ms.decode": ("decode", 2.1 / 2),
    # (2.8 - 0.2) + (2.3 - 0.8) over 2 steps
    "models.decode_step_ms.decode": ("decode", 4.1 / 2),
    "train.launch_ms.train": ("train", 8.0 / 2),
    # features 0.6 + 0.8, the micro-step 0.2 + 0.1, wait 0.2, the optimizer 1.0
    "train.idle_ms.train": ("train", 2.9),
    # pack 5 + 2, collect 10 + 5, over 2 ticks
    "stream.host_ms.stream": ("stream", 22 / 2),
    # pack 5 + 2, advance 1 + 3, wait 5 + 5, collect 5 + 5, tick 1 + 1
    "stream.idle_ms.stream": ("stream", 33 / 2),
    # (20 - 1) + (28 - 3) over 2 ticks
    "stream.advance_ms.stream": ("stream", 44 / 2),
}


def put(monkeypatch, spans):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_its_hand_computed_value(name, monkeypatch):
    cell, want = WANT[name]
    spans, evs, window_ms = CELLS[cell]
    put(monkeypatch, spans)
    assert reader(name).read(trace_of(evs, window_ms)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("program_has", ["no spans", "no recorder"])
@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_without_spans(name, program_has, monkeypatch):
    """A window the port recorded nothing in, and a port without the
    recorder (the parent of the change that added it): None, no raise."""
    cell = WANT[name][0]
    if program_has == "no spans":
        put(monkeypatch, [])
    else:
        monkeypatch.delattr(profiling, "spans")
    _, evs, window_ms = CELLS[cell]
    assert reader(name).read(trace_of(evs, window_ms)) is None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_idle_put_down_to_spans_is_at_most_the_windows(cell, monkeypatch):
    spans, evs, window_ms = CELLS[cell]
    trace = trace_of(evs, window_ms)
    window_idle_ms = (trace.window_s - trace.busy_s) * 1e3
    by_span = program.idle_by_span(trace, spans)
    assert 0 < sum(by_span.values()) / MS <= window_idle_ms
    put(monkeypatch, spans)
    idle, count = {"decode": ("recognize.idle_ms.decode", 2),
                   "train": ("train.idle_ms.train", 1),
                   "stream": ("stream.idle_ms.stream", 2)}[cell]
    assert reader(idle).read(trace) * count <= window_idle_ms


@pytest.mark.parametrize("seed", range(5))
def test_random_nests_never_put_down_more_than_the_idle(seed):
    """Spans nested three deep and events at random: each part of a gap
    goes to at most one span, so the sum stays within the gaps' total."""
    rng = random.Random(seed)
    spans, t = [], 0.0
    for _ in range(20):
        a = t + rng.uniform(0, 1)
        b = a + rng.uniform(1, 5)
        spans.append(span("outer", None, 0, a, b))
        x = a
        while x < b - 0.2:
            c = min(b, x + rng.uniform(0.05, 0.6))
            spans.append(span("mid", "outer", 1, x, c))
            if rng.random() < 0.5:
                spans.append(span("inner", "mid", 2, x, (x + c) / 2))
            x = c + rng.uniform(0, 0.1)
        t = b
    busy, x = [], 0.0
    while x < t:
        a = x + rng.uniform(0, 0.3)
        busy.append((a, a + rng.uniform(0, 0.4)))
        x = busy[-1][1]
    trace = trace_of(events(*busy), t + 1)
    gaps = sum(b - a for a, b in program.idle_gaps(trace.events))
    assert sum(program.idle_by_span(trace, spans).values()) <= gaps
    assert gaps / 1e9 <= trace.window_s - trace.busy_s + 1e-9


def test_a_gap_goes_to_the_innermost_span():
    """An outer span with thirty children, the even ones with a child of
    their own: a late gap inside a grandchild goes to it, one inside a child
    to the child, one between two children to the outer span, one after it
    to none."""
    spans = [span("outer", None, 0, 0, 100)]
    for i in range(30):
        spans.append(span("child", "outer", 1, 3 * i, 3 * i + 2))
        if i % 2 == 0:
            spans.append(span("grandchild", "child", 2, 3 * i + 0.5, 3 * i + 1.5))
    # gaps: 84.9-85.1 in grandchild 28 (84.5-85.5), 86.3-86.7 between children
    # 28 and 29, 87.8-88.2 in child 29 (87-89, no grandchild), 100.5-101.5
    # after the outer span
    trace = trace_of(events((0, 84.9), (85.1, 86.3), (86.7, 87.8), (88.2, 100.5),
                            (101.5, 102)), 110)
    got = {k: v / MS for k, v in program.idle_by_span(trace, spans).items()}
    assert got == pytest.approx({"grandchild": 0.2, "outer": 0.4, "child": 0.4})


def test_a_gap_across_spans_is_split_at_their_bounds():
    """One gap from inside a grandchild, through the rest of its child and
    the outer span between children, into the next child, and past the
    outer span's end: each span gets the part it holds innermost, and the
    part after the outer span goes to none (the benchmark's own loop)."""
    spans = [span("outer", None, 0, 0, 10), span("child", "outer", 1, 1, 4),
             span("grandchild", "child", 2, 2, 3), span("child", "outer", 1, 6, 9)]
    trace = trace_of(events((0, 2.5), (12, 13)), 14)
    got = {k: v / MS for k, v in program.idle_by_span(trace, spans).items()}
    assert got == pytest.approx({"grandchild": 0.5, "child": 1 + 3, "outer": 2 + 1})
