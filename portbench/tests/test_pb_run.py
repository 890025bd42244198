"""The one command: no result without a card, and on the card a whole run
of a cell (marked ``gpu``)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import PB

ROOT = os.path.dirname(PB)


def run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "transformer_baseline.decode_beam5", "--seed", str(2 ** 31 + 3),
                           "--seconds", "1", *extra], cwd=cwd, capture_output=True,
                          text=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                          timeout=300)


def test_no_card_no_result():
    proc = run(ROOT)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run(tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "transformer_baseline.decode_beam5", "--seed", str(2 ** 31 + 3),
                           "--seconds", "2", "--trace", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "breakdown"}


@pytest.mark.parametrize("loads_jax", [False, True])
def test_a_reader_that_loads_jax_stops_the_result(loads_jax, tmp_path, monkeypatch, capsys):
    """The look for forbidden modules comes after the per-layer readers: a
    reader that imports a module named ``jax`` leaves no result line."""
    import torch

    from portbench.core import harness
    from portbench.core.trace import TraceData

    assert "jax" not in sys.modules
    stubs, pb = tmp_path / "stubs", tmp_path / "pb"
    (stubs / "jax").mkdir(parents=True)
    (stubs / "jax" / "__init__.py").write_text("")
    for sub in ("metrics", "limits"):
        (pb / sub).mkdir(parents=True)
    (pb / "metrics" / "stub.reader.py").write_text(
        ("import jax  # noqa: F401\n" if loads_jax else "") + "def read(trace):\n    return 1.0\n")
    (pb / "limits" / "stub.cell.json").write_text('{"limits": {"x": {"limit": 0}}}')
    monkeypatch.syspath_prepend(str(stubs))
    monkeypatch.setattr(harness, "PB_DIR", str(pb))
    cell = harness.Cell(name="stub.cell", chips=1, config={}, mix={},
                        per_layer=[{"name": "stub.reader", "unit": "%"}],
                        end_to_end=[{"name": "setup_s", "unit": "s"}])
    monkeypatch.setattr(harness, "resolve_cell", lambda name: cell)
    trace = TraceData(window_s=1.0, events=[], spans={})
    monkeypatch.setattr(trace, "breakdown", lambda: {}, raising=False)

    class Driver:
        @staticmethod
        def run(ctx):
            return harness.Outcome(attempted=1, failed=0, metrics={"setup_s": 1.0},
                                   checks=[harness.Check("x", 0.0, 0.0)],
                                   memory_peak_bytes=0, trace=trace)

    monkeypatch.setattr(harness, "load_driver", lambda c: Driver)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    try:
        rc = harness.main(["--workload", "stub.cell", "--seed", str(2 ** 31 + 9),
                           "--seconds", "1", "--trace", "1"])
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    if loads_jax:
        assert rc != 0 and not out.strip() and "jax" in err
    else:
        assert rc == 0 and json.loads(out.strip().splitlines()[-1])["correct"]
