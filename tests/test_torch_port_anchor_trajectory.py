"""``tools/torch_port_anchor_trajectory.py`` at a tiny width: the anchor
recipe made deterministic, trained in both packages from JAX's
``PRNGKey(1234)`` weights on the JAX loader's batches, agrees update by
update.

The corpus is the synthetic one cut to 128 training utterances (bucket
1152, batch 8, ``drop_last``: 16 batches an epoch); the model is the
anchor cut to width 32 with one encoder and one decoder block (the
vocabulary stays 4233); the warm-up is cut to 4 updates so that the 20
updates move the weights at the recipe's peak rate, 3e-4. Tolerance: each
update's loss within 1e-4 relative (float32 in both, other summation
orders, and 20 Adam steps compound them).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from opentransformer_tpu_torch.config import CONF_DIR, load_config
from opentransformer_tpu_torch.data import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_port_anchor_trajectory as trajectory  # noqa: E402

UPDATES = 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    m = cfg["model"]
    m["frontend"].update(output_size=32, mid_channel=4, out_channel=8)
    m["encoder"].update(d_model=32, d_ff=64, n_blocks=1)
    m["decoder"].update(d_model=32, d_ff=64, n_blocks=1, memory_dim=32)
    cfg["data"]["batch_size"] = 8
    cfg["train"]["scheduler"]["warmup_steps"] = 4
    return cfg


def test_tiny_anchor_trajectories_agree_update_by_update(tmp_path):
    data = str(tmp_path / "synth")
    synth.write_corpus(data, splits=("train",), n_utts={"train": 128})
    cfg = tiny(trajectory.deterministic(load_config(os.path.join(CONF_DIR, "anchor.json")),
                                        data))
    assert cfg["train"]["dtype"] == "float32" and cfg["data"]["additive_noise_std"] == 0.0
    assert cfg["model"]["encoder"]["residual_dropout"] == 0.0
    losses_j, losses_t, _ = trajectory.trajectories(cfg, UPDATES)
    assert len(losses_j) == len(losses_t) == UPDATES
    assert max(trajectory.relative(losses_j, losses_t)) <= 1e-4
    assert np.mean(losses_j[-4:]) < 0.99 * np.mean(losses_j[:4])  # the weights moved
