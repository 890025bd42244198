"""The long-form Whisper decode driver at a tiny size on the CPU: a sound
run is correct by the cell's committed limits, the control and the fault
planted in the reference are not, nor is a run with the timed path broken
underneath; the traffic and the counts of the cell at its own sizes."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import PB, driver

from portbench import calibrate
from portbench.core import beam_counts, counts, harness

LONGFORM = "whisper_large_v3.longform_beam5"


def longform_ctx(limits, precision="float32", control=False, seed=2 ** 31 + 11):
    cfg = harness.load_json(f"{PB}/configs/whisper_large_v3.json")
    m = cfg["model"]
    m["frontend"].update(input_size=16, output_size=64)
    for part in ("encoder", "decoder"):
        m[part].update(d_model=64, n_heads=4, d_ff=128, n_blocks=2)
    m["decoder"].update(vocab_size=97, memory_dim=64)
    cfg["precision"] = precision
    mix = harness.load_json(f"{PB}/mixes/longform_beam5.json")
    mix.update(utterances=8, batch=4, duration_s={"dist": "uniform", "min": 0.4, "max": 0.4},
               chars_per_s=10.0, check_sample=3)
    cell = harness.Cell(name="tiny.longform", chips=1, config=cfg, mix=mix)
    return harness.RunContext(cell=cell, seed=seed, seconds=0.05, traced=False,
                              device=torch.device("cpu"), t_process=time.perf_counter(),
                              limits=dict(limits), control=control)


def scaled_scores(hyp):
    return type(hyp)(hyp.tokens, hyp.scores * 1.05, hyp.lengths)


def first_row(hyp):
    return type(hyp)(hyp.tokens[:1], hyp.scores[:1], hyp.lengths[:1])


@pytest.mark.parametrize("fault", [None, "scores 5% off", "all but a batch's first window left out"])
def test_longform_run_and_its_broken_path(fault):
    limits = harness.load_limits(LONGFORM)
    alter = {None: lambda h: h, "scores 5% off": scaled_scores,
             "all but a batch's first window left out": first_row}[fault]
    out = driver("longform_decode").run(
        longform_ctx(limits), recognize=lambda rec, x, m: alter(rec.recognize_arrays(x, m)))
    assert out.correct == (fault is None), out.extra["readings"]


def test_longform_control_and_fault_fail_the_limits():
    limits = harness.load_limits(LONGFORM)
    out = driver("longform_decode").run(longform_ctx(limits, "bfloat16", control=True))
    assert calibrate.sides(out.extra, limits) == ["control", "fault_own_best"]
    for side in ("control", "fault_own_best"):
        assert not harness.passes(out.extra[side], limits), out.extra[side]


def test_longform_traffic_and_counts():
    """256 full 30-s windows in two batches of 128 in recording order, 60 to
    129 tokens each (both batches run ~129 steps); Whisper's Conv1d front
    end and kernel 4's bytes at the cell's sizes."""
    mix = harness.load_json(f"{PB}/mixes/longform_beam5.json")
    batches = driver("longform_decode").batches_of(mix)
    assert [len(b) for b in batches] == [128, 128]
    assert {u[0] for b in batches for u in b} == {3000}
    steps = [max(u[1] for u in b) for b in batches]
    assert min(u[1] for b in batches for u in b) == 60 and max(steps) == 129
    assert min(steps) >= 120
    flops, t = beam_counts.conv1d_frontend(3000, 128, 1280)
    assert t == 1500 and flops == 2.0 * 3 * (3000 * 128 * 1280 + 1500 * 1280 * 1280)
    cross = 128 * 1500 * 1280 * 2 * 2  # one block's cross keys and values, bf16
    step0 = beam_counts.attention_step_bytes(128, 5, 1500, 0, 1280, "bfloat16")
    assert cross < step0 < 1.02 * cross
    bound = beam_counts.attention_bound_s(128, 5, 1500, 129, 1280, 32, "bfloat16")
    assert 32 * 129 * cross / counts.PEAK_BYTES < bound < 1.1 * 32 * 129 * cross / counts.PEAK_BYTES
