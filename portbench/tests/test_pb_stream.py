"""The paced streaming driver at a tiny size on the CPU: a sound run is
correct; with the tick broken underneath it is not, by the cell's
committed limits."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import driver, tiny_ctx

from portbench.core import harness

LIMITS = harness.load_limits("conformer_streaming_ctc.stream_paced")
SMALL = {"streams": 6, "utterances_per_session": 3, "drain_s": 3, "check_sessions": 3,
         "duration_s": {"dist": "lognormal", "median": 1.2, "sigma": 0.3, "min": 0.8,
                        "max": 2.0}}


def stream_ctx(**kw):
    ctx = tiny_ctx("stream_paced", LIMITS, precision="float32",
                   config="conformer_streaming_ctc", **SMALL, **kw)
    ctx.seconds = 2.5
    return ctx


def altered_ids(original):
    def advance(self, *args):
        ids = original(self, *args).copy()
        ids[:, 3] = (ids[:, 3] + 7) % 40
        return ids
    return advance


def half_left_out(original):
    def advance(self, window, start, cache_len, chunk_mask, adv, fresh, fin_now):
        adv = adv.copy()
        adv[len(adv) // 2:] = False
        return original(self, window, start, cache_len, chunk_mask, adv, fresh, fin_now)
    return advance


FAULTS = {None: None, "a token altered where it is produced": altered_ids,
          "half of the batch left out": half_left_out}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_stream(fault, monkeypatch):
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamCTC

    if FAULTS[fault] is not None:
        monkeypatch.setattr(MultiStreamCTC, "_advance_rows",
                            FAULTS[fault](MultiStreamCTC._advance_rows))
    out = driver("stream_paced").run(stream_ctx())
    assert out.correct is (fault is None), (out.failed, out.extra["readings"])
    if fault is None:
        assert out.failed == 0 and np.isfinite(out.metrics["stream_p95_ms"])
