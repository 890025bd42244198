"""The general generator: the same sizes for every seed, read off the
mix's distributions, in the seed's order."""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from conftest import PB

from portbench.core import harness, traffic
from portbench.core.weights import make_weights, subseed

MIXES = ("decode_beam5", "train")


def mix(name):
    return harness.load_json(os.path.join(PB, "mixes", name + ".json"))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_match_their_parameters(name):
    m = mix(name)
    utts = traffic.utterances(m)
    dur = np.array([f for f, _ in utts]) * m["frame_shift_ms"] / 1000.0
    d = m["duration_s"]
    assert len(utts) == m["utterances"]
    assert d["min"] <= dur.min() and dur.max() <= d["max"]
    want = d["median"] * math.exp(d["sigma"] ** 2 / 2)  # the lognormal's mean
    assert abs(dur.mean() / want - 1) < 0.02
    assert abs(np.median(dur) / d["median"] - 1) < 0.01
    rate = np.array([u for _, u in utts]) / dur
    assert abs(rate.mean() / m["chars_per_s"] - 1) < 0.05


@pytest.mark.parametrize("name", MIXES)
def test_sizes_do_not_depend_on_the_seed(name):
    assert traffic.utterances(mix(name)) == traffic.utterances(mix(name))


def test_order_is_the_seeds():
    a = traffic.order(2 ** 33 + 1, 24, 0)
    assert a == traffic.order(2 ** 33 + 1, 24, 0)
    assert sorted(a) == list(range(24))
    assert a != traffic.order(2 ** 33 + 2, 24, 0) or a != traffic.order(2 ** 33 + 1, 24, 1)


def test_buckets():
    utts = [(f, 1) for f in range(100, 1100, 10)]
    fixed = traffic.fixed_batches(utts, 32)
    assert [len(b) for b in fixed] == [32, 32, 32, 4]
    budget = traffic.frame_budget_batches(utts, 5000)
    assert sum(len(b) for b in budget) == len(utts)
    assert all(len(b) * b[-1][0] <= 5000 for b in budget)


def test_weights_are_the_seeds():
    shapes = {"a.weight": (8, 4), "a.norm.weight": (4,), "b": (3,)}
    w1 = make_weights(shapes, 2 ** 32 + 5, torch.device("cpu"), torch.float32)
    w2 = make_weights(shapes, 2 ** 32 + 5, torch.device("cpu"), torch.float32)
    w3 = make_weights(shapes, 2 ** 32 + 6, torch.device("cpu"), torch.float32)
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert abs(float(w1["a.norm.weight"].mean()) - 1.0) < 0.2
    assert subseed(1, "x") != subseed(1, "y") < 2 ** 63
