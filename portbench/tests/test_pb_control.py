"""The control, the plain reference put in the port's place one precision
below the configuration's, fails the cell's committed limits at a tiny
size, and so do the faults planted in the reference. On the chip the same
readings are taken at the cell's own size by ``portbench/calibrate.py
--control-seeds``."""

from __future__ import annotations

import pytest

from conftest import driver, tiny_ctx

from portbench import calibrate
from portbench.core import harness

DECODE = "transformer_baseline.decode_beam5"
TRAIN = "transformer_baseline.train"
STREAM = "conformer_streaming_ctc.stream_paced"


def test_decode_control_and_fault_fail_the_limits():
    limits = harness.load_limits(DECODE)
    out = driver("offline_decode").run(tiny_ctx("decode_beam5", limits, control=True))
    assert calibrate.sides(out.extra, limits) == ["control", "fault_own_best"]
    for side in ("control", "fault_own_best"):
        assert not harness.passes(out.extra[side], limits), out.extra[side]


def test_train_control_and_fault_fail_the_limits():
    limits = harness.load_limits(TRAIN)
    out = driver("train_update").run(tiny_ctx("train", limits, control=True))
    assert calibrate.sides(out.extra, limits) == ["control", "fault_half_batch"]
    for side in ("control", "fault_half_batch"):
        assert not harness.passes(out.extra[side], limits), out.extra[side]


@pytest.mark.gpu
def test_stream_control_fails_the_limits():
    """TF32 has no effect on the CPU, so this control runs on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA device")
    from test_pb_stream import stream_ctx

    limits = harness.load_limits(STREAM)
    ctx = stream_ctx()
    ctx.device, ctx.control, ctx.limits = torch.device("cuda"), True, limits
    ctx.cell.config["model"]["encoder"].update(d_model=384, d_ff=768, nblocks=2)
    ctx.cell.config["model"]["frontend"].update(output_size=384, mid_channel=64,
                                                out_channel=64)
    ctx.cell.config["model"]["vocab_size"] = 4233
    out = driver("stream_paced").run(ctx)
    assert out.correct, out.extra["readings"]
    assert not harness.passes(out.extra["control"], limits), out.extra["control"]
