"""Tiny cells for the benchmark's CPU tests: the real configurations and
mixes cut to a width and a traffic that a CPU runs in seconds."""

from __future__ import annotations

import copy
import os
import sys
import time

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(PB))

from portbench.core import harness  # noqa: E402

SMALL_UTTS = {"dist": "lognormal", "median": 0.8, "sigma": 0.3, "min": 0.5, "max": 1.5}


def tiny_config(precision: str = "bfloat16", name: str = "transformer_baseline") -> dict:
    cfg = harness.load_json(os.path.join(PB, "configs", name + ".json"))
    m = cfg["model"]
    m["frontend"].update(output_size=32, mid_channel=4, out_channel=8)
    if name == "conformer_streaming_ctc":
        m["encoder"].update(d_model=32, d_ff=48, nblocks=2)
        m["vocab_size"] = 40
    else:
        m["encoder"].update(d_model=32, d_ff=64, n_blocks=2)
        m["decoder"].update(d_model=32, d_ff=64, n_blocks=2, memory_dim=32, vocab_size=50)
        cfg["train"]["scheduler"]["model_size"] = 32
        cfg["train"]["dtype"] = precision
    cfg["precision"] = precision
    return cfg


def tiny_mix(name: str, **over) -> dict:
    mix = harness.load_json(os.path.join(PB, "mixes", name + ".json"))
    mix.update(utterances=24, duration_s=dict(SMALL_UTTS))
    if mix["driver"] == "offline_decode":
        mix.update(batch=8, check_sample=6)
    elif mix["driver"] == "train_update":
        mix.update(utterances=48, frames_per_micro_batch=900)
    mix.update(over)
    return mix


def tiny_ctx(mix_name: str, limits: dict, seed: int = 2 ** 31 + 11, precision="bfloat16",
             control: bool = False, config: str = "transformer_baseline", **mix_over):
    import torch

    cell = harness.Cell(name="tiny." + mix_name, chips=1, config=tiny_config(precision, config),
                        mix=tiny_mix(mix_name, **mix_over))
    return harness.RunContext(cell=cell, seed=seed, seconds=0.05, traced=False,
                              device=torch.device("cpu"), t_process=time.perf_counter(),
                              limits=dict(limits), control=control)


def driver(name: str):
    return harness.load_module(os.path.join(PB, "drivers", name + ".py"), "tiny_" + name)


@pytest.fixture
def manifest():
    return copy.deepcopy(harness.load_json(harness.MANIFEST))
