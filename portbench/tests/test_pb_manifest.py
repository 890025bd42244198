"""BENCHMARK.json against the contract's shapes, and every cell's files
found by name."""

from __future__ import annotations

import os
import re

from conftest import PB

from portbench.core import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths(manifest):
    assert set(manifest) == TOP
    assert manifest["command"][:2] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in manifest["paths"])
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024


def test_names_units_and_texts(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"]) and text_ok(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in manifest["workloads"]:
        cell = harness.resolve_cell(w["name"], manifest)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_every_cell_finds_its_files_by_name(manifest):
    for w in manifest["workloads"]:
        cell = harness.resolve_cell(w["name"], manifest)
        assert os.path.exists(os.path.join(PB, "drivers", cell.mix["driver"] + ".py"))
        assert set(harness.load_limits(cell.name))
        assert cell.config["reference"]
        assert os.path.exists(os.path.join(PB, "reference", cell.config["reference"] + ".py"))
        for m in cell.per_layer:
            mod = harness.load_module(os.path.join(PB, "metrics", m["name"] + ".py"), "m")
            assert callable(mod.read)


def test_a_config_used_by_some_cell(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
