"""The general traffic generator: sizes from a mix's parameters.

A mix (``portbench/mixes/<mix>.json``) states its distributions; this module
turns them into sizes. Every seed gets the same multiset of sizes, read off
the distribution at evenly spaced quantiles, so two seeds ask the same work
of the port; the seed only changes their order and the values in them
(features, waveforms, tokens).

Distributions: ``{"dist": "lognormal", "median": m, "sigma": s, "min": a,
"max": b}`` (clipped) and ``{"dist": "uniform", "min": a, "max": b}``.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` values of ``dist`` at the quantiles (i + 0.5) / n, ascending."""
    p = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(q)) for q in p])
        x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        x = dist["min"] + p * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(x, dist.get("min", -np.inf), dist.get("max", np.inf))


def utterances(mix: dict) -> list[tuple[int, int]]:
    """The mix's utterances as (feature frames, transcript tokens), sorted
    by frames: durations from ``duration_s``, ``frame_shift_ms`` a frame;
    transcripts of ``chars_per_s`` times the duration times a spread factor
    from ``chars_spread``, paired with the durations by a fixed
    permutation (``pairing_seed``), at least one token."""
    n = int(mix["utterances"])
    dur = quantiles(mix["duration_s"], n)
    spread = quantiles(mix["chars_spread"], n)
    spread = spread[np.random.RandomState(int(mix["pairing_seed"])).permutation(n)]
    frames = np.rint(dur * 1000.0 / mix["frame_shift_ms"]).astype(int)
    tokens = np.maximum(1, np.rint(dur * mix["chars_per_s"] * spread)).astype(int)
    return sorted(zip(frames.tolist(), tokens.tolist()))


def fixed_batches(utts: list, batch: int) -> list[list]:
    """Length buckets of ``batch`` utterances each, in order of length."""
    return [utts[i:i + batch] for i in range(0, len(utts), batch)]


def frame_budget_batches(utts: list, max_frames: int) -> list[list]:
    """Length buckets filled in order of length while the padded size
    (rows times the longest) stays within ``max_frames``."""
    out, cur = [], []
    for u in utts:
        if cur and (len(cur) + 1) * max(u[0], cur[-1][0]) > max_frames:
            out.append(cur)
            cur = []
        cur.append(u)
    if cur:
        out.append(cur)
    return out


def order(seed: int, n: int, round_index: int) -> list[int]:
    """The seed's order of ``n`` batches in round ``round_index``."""
    from .weights import subseed

    rng = np.random.Generator(np.random.PCG64(subseed(seed, "order", round_index)))
    return rng.permutation(n).tolist()
