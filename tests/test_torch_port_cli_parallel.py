"""The CLIs' parallelism options on the port, on the CPU.

The training CLI's checks are the JAX CLI's (``opentransformer_tpu/cli/
run.py:244-262``), word for word: each config is given to both CLIs and the
``SystemExit`` messages compared. The trainer's refusals keep the JAX
trainer's messages (``opentransformer_tpu/train/trainer.py:138-183`` and
``parallel/pipeline.py:756-768``). ``-n``/``--tp``/``--pp``/``--ep`` give
JAX's mesh dimensions (``n_data`` = cards over tp·pp·ep). ``eval -n 2`` on
the committed anchor checkpoint over nine synthetic test utterances at
``-b 4`` (the last batch, one utterance, is a ragged tail that rank 0
decodes whole) writes the same ``predict.txt`` and ``RESULT`` (its CER,
oracle and utterance count; RTF and seconds are timings) as ``eval -n 1``,
and the same ``predict.log`` up to a score's last printed digit
(``chip_smoke.nbest_log_equal``: a smaller batch may sum in another order).
"""

import json
import os
import re
import types

import numpy as np
import pytest
import torch

import chip_smoke
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.data import synth
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
D = 32
ENC = {"d_model": D, "n_heads": 2, "d_ff": 48, "n_blocks": 4, "residual_dropout": 0.0}
MODEL = {"type": "speech2text", "frontend_type": "conv",
         "frontend": {"input_size": 16, "output_size": D, "mid_channel": 4, "out_channel": 8},
         "encoder_type": "transformer", "encoder": ENC,
         "decoder": {"vocab_size": 10, "d_model": D, "n_heads": 2, "d_ff": 48, "memory_dim": D,
                     "n_blocks": 1, "residual_dropout": 0.0}}
TCFG = {"optimizer_type": "adam", "optimizer": {}, "scheduler_type": "constant",
        "scheduler": {"lr": 1e-3}}


def write_conf(tmp_path, encoder=None, encoder_type="transformer"):
    cfg = {"data": {"dataset_type": "kaldi", "vocab": "vocab", "batch_size": 8},
           "model": dict(MODEL, encoder=dict(ENC, **(encoder or {})), encoder_type=encoder_type),
           "train": dict(TCFG, epochs=1)}
    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    return conf, cfg


CHECKS = {
    "ep_does_not_divide": (dict(moe_experts=4), "transformer", ["--ep", "3"]),
    "pp_needs_scan_layers": ({}, "transformer", ["--pp", "2"]),
    "pp_needs_a_transformer": (dict(scan_layers=True), "conformer", ["--pp", "2"]),
    "pp_must_divide_n_blocks": (dict(scan_layers=True), "transformer", ["--pp", "3"]),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_cli_checks_are_the_jax_cli_messages(tmp_path, case):
    from opentransformer_tpu.cli import run as jax_run

    encoder, encoder_type, flags = CHECKS[case]
    conf, cfg = write_conf(tmp_path, encoder, encoder_type)
    with pytest.raises(SystemExit) as want:
        jax_run.main(["-c", conf, "--expdir", str(tmp_path / "jax"), *flags])
    args = run_cli.build_argparser().parse_args(["-c", conf, "--device", "cpu", *flags])
    with pytest.raises(SystemExit) as got:
        run_cli.mesh_dims(args, cfg)
    assert str(got.value) == str(want.value) and str(got.value)


@pytest.mark.parametrize("flags,dims", [
    ([], None), (["-n", "1"], (1, 1, 1, 1)), (["-n", "2"], (2, 1, 1, 1)),
    (["--tp", "2"], (1, 2, 1, 1)), (["-n", "2", "--tp", "2", "--pp", "2"], (2, 2, 2, 1)),
    (["--pp-schedule", "sharded"], (1, 1, 1, 1))], ids=lambda v: " ".join(v or "-")
    if isinstance(v, list) else None)
def test_mesh_dims_follow_the_jax_cli(tmp_path, flags, dims):
    """n_data = -n, else the cards (one CPU) over tp x pp x ep, at least one;
    no parallel option: no mesh (the single-process run)."""
    conf, cfg = write_conf(tmp_path, dict(scan_layers=True))
    args = run_cli.build_argparser().parse_args(["-c", conf, "--device", "cpu", *flags])
    assert run_cli.mesh_dims(args, cfg) == dims


def fake_mesh(**sizes):
    dims = {"data": 1, "model": 1, "pipe": 1, "expert": 1, **sizes}
    return types.SimpleNamespace(size=dims.__getitem__, index=lambda a: 0)


TRAINER_REFUSALS = {
    "1f1b_needs_a_mesh": (dict(pp_schedule="1f1b"), None, {},
                          "pp_schedule=1f1b needs a mesh with a pipe axis"),
    "1f1b_mixspeech": (dict(pp_schedule="1f1b"), fake_mesh(pipe=2), dict(mixspeech=True),
                       "mixspeech is not supported under pp_schedule=1f1b"),
    "1f1b_steps_per_exec": (dict(steps_per_exec=2, pp_schedule="1f1b"), fake_mesh(pipe=2),
                            {},
                            "steps_per_exec > 1 does not support pp_schedule=1f1b"),
    "1f1b_fused_update": (dict(fused_update=True, pp_schedule="1f1b"), fake_mesh(pipe=2), {},
                          "train.fused_update does not compose with pp_schedule=1f1b"),
    "fused_update_model_axis": (dict(fused_update=True), fake_mesh(model=2), {},
                                "train.fused_update needs replicated params (data-axis-only "
                                "mesh): the flat moment buffer has no per-leaf shardings"),
    "1f1b_ctc_model": (dict(pp_schedule="1f1b"), fake_mesh(pipe=2), dict(model="ctc"),
                       "1F1B pipeline supports speech2text models (got CTCModel); "
                       "ctc/transducer heads are not wired as pipeline loss heads"),
    "1f1b_needs_scan_layers": (dict(pp_schedule="1f1b"), fake_mesh(pipe=2), {},
                               "1F1B pipeline requires encoder scan_layers: true"),
}


@pytest.mark.parametrize("case", sorted(TRAINER_REFUSALS))
def test_trainer_refusals_keep_the_jax_messages(case):
    train, mesh, kw, message = TRAINER_REFUSALS[case]
    kw = dict(kw)
    cfg = MODEL
    if kw.pop("model", None) == "ctc":
        cfg = {"type": "ctc", "frontend": MODEL["frontend"], "encoder": ENC, "vocab_size": 10}
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match=re.escape(message)):
        Trainer(dict(TCFG, **train), model, None, torch.Generator(), mesh=mesh, **kw)


@pytest.fixture(scope="module")
def anchor_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    synth.write_corpus(root, splits=("test",), n_utts={"test": 9})
    return root


def test_eval_on_two_ranks_writes_one_ranks_files(anchor_split, tmp_path):
    """Rows split over 2 ranks, the tail batch of one utterance decoded
    whole by rank 0, rank 0's gather in the loader's order: the files of a
    one-rank decode."""
    base = ["--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
            "--feats", os.path.join(anchor_split, "test", "feats.scp"),
            "--text", os.path.join(anchor_split, "test", "text"),
            "--vocab", os.path.join(anchor_split, "vocab"),
            "-b", "4", "-bw", "3", "-pn", "0.6", "-ml", "32", "--device", "cpu"]
    out = {}
    for n in ("1", "2"):
        d = str(tmp_path / f"n{n}")
        assert eval_cli.main(base + ["-n", n, "--decode_dir", d]) == 0
        out[n] = {}
        for name in ("predict.txt", "predict.log", "RESULT"):
            with open(os.path.join(d, name), encoding="utf-8") as f:
                out[n][name] = f.read()
    assert out["1"]["predict.txt"] == out["2"]["predict.txt"]
    assert chip_smoke.nbest_log_equal(out["1"]["predict.log"], out["2"]["predict.log"])
    timing = re.compile(r"^(RTF|UTTS \d+ DECODE_SECONDS) .*$", re.M)
    assert timing.sub(r"\1", out["1"]["RESULT"]) == timing.sub(r"\1", out["2"]["RESULT"])
    assert "UTTS 9 " in out["2"]["RESULT"] and len(out["2"]["predict.txt"].splitlines()) == 9
    assert np.isfinite([float(line.split("score=")[1].split()[0])
                        for line in out["2"]["predict.log"].splitlines()]).all()
